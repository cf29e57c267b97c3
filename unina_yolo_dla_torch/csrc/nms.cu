// Exact greedy class-aware NMS over K <= 1024 score-sorted candidates.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/nms_kernel.py nms_pallas
//   (_suppress_kernel, pallas_call at :111; _fixpoint_kernel, pallas_call
//   at :131, finished to stationarity at :140-159).
//   S[i, j] = IoU(i, j) > thr && class_i == class_j && j > i && valid_i &&
//   valid_j, with box_iou's arithmetic inter / max(union, 1e-9);
//   keep[j] = valid[j] && !any_i(keep[i] && S[i, j]).
//
// Bound on the H100: operations of a serial recurrence. The K x K IoU
//   matrix is 1M pair tests (~20 MFLOP) and a 128 KB bitmask; the greedy
//   scan is inherently sequential in the kept set.
// Design: kernel A writes S as a bitmask, one thread per (row, 32-column
//   word), 32 IoUs each. Kernel B is one block: it stages the whole mask in
//   shared memory, then one warp runs the greedy scan, each lane owning one
//   32-bit word of the keep set. The scan visits only candidates that are
//   still kept (find-first-set over the owner's word, broadcast by shuffle)
//   and clears their row from every word, so its length is the number of
//   kept boxes plus one step per word; no iteration budget, no tail guard:
//   the result is greedy NMS exactly, for any chain depth.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void suppress_kernel(const float* __restrict__ boxes,
                                const int* __restrict__ classes,
                                const uint8_t* __restrict__ valid,
                                uint32_t* __restrict__ mask, int K, int words,
                                float thr) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= K * words) return;
  int i = t / words, w = t - i * words;
  uint32_t bits = 0;
  if (valid[i]) {
    float ax1 = boxes[i * 4 + 0], ay1 = boxes[i * 4 + 1];
    float ax2 = boxes[i * 4 + 2], ay2 = boxes[i * 4 + 3];
    float area_a = (ax2 - ax1) * (ay2 - ay1);
    int ca = classes[i];
    for (int jj = 0; jj < 32; ++jj) {
      int j = w * 32 + jj;
      if (j <= i || j >= K || !valid[j] || classes[j] != ca) continue;
      float bx1 = boxes[j * 4 + 0], by1 = boxes[j * 4 + 1];
      float bx2 = boxes[j * 4 + 2], by2 = boxes[j * 4 + 3];
      float iw = fmaxf(fminf(ax2, bx2) - fmaxf(ax1, bx1), 0.f);
      float ih = fmaxf(fminf(ay2, by2) - fmaxf(ay1, by1), 0.f);
      float inter = iw * ih;
      float area_b = (bx2 - bx1) * (by2 - by1);
      float uni = (area_a + area_b) - inter;
      float iou = inter / fmaxf(uni, 1e-9f);
      if (iou > thr) bits |= 1u << jj;
    }
  }
  mask[t] = bits;
}

__global__ void scan_kernel(const uint32_t* __restrict__ mask,
                            const uint8_t* __restrict__ valid,
                            uint8_t* __restrict__ keep, int K, int words) {
  extern __shared__ uint32_t sm[];  // K * words mask words, then words keep
  uint32_t* keep_s = sm + (size_t)K * words;
  for (int i = threadIdx.x; i < K * words; i += blockDim.x) sm[i] = mask[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    const unsigned full = 0xffffffffu;
    int lane = threadIdx.x;
    uint32_t mine = 0;
    for (int w = 0; w < words; ++w) {
      int j = w * 32 + lane;
      uint32_t word = __ballot_sync(full, j < K && valid[j]);
      if (lane == w) mine = word;
    }
    for (int w = 0; w < words; ++w) {
      uint32_t done = 0;
      uint32_t cur = __shfl_sync(full, mine, w);
      while (cur & ~done) {
        int b = __ffs(cur & ~done) - 1;
        int i = w * 32 + b;
        if (lane < words) mine &= ~sm[(size_t)i * words + lane];
        done |= (b == 31) ? full : ((2u << b) - 1u);
        cur = __shfl_sync(full, mine, w);
      }
    }
    if (lane < words) keep_s[lane] = mine;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < K; j += blockDim.x)
    keep[j] = (keep_s[j / 32] >> (j % 32)) & 1u;
}

extern "C" int unina_nms(const void* boxes, const void* classes,
                         const void* valid, void* mask, void* keep, int K,
                         float thr, void* stream) {
  if (K <= 0 || K % 32 != 0 || K > 1024) return (int)cudaErrorInvalidValue;
  int words = K / 32;
  cudaStream_t s = (cudaStream_t)stream;
  int n = K * words, threads = 256;
  suppress_kernel<<<(n + threads - 1) / threads, threads, 0, s>>>(
      (const float*)boxes, (const int*)classes, (const uint8_t*)valid,
      (uint32_t*)mask, K, words, thr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  size_t smem = ((size_t)K * words + words) * sizeof(uint32_t);
  err = cudaFuncSetAttribute(scan_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, 1024, smem, s>>>((const uint32_t*)mask,
                                    (const uint8_t*)valid, (uint8_t*)keep, K,
                                    words);
  return (int)cudaGetLastError();
}
