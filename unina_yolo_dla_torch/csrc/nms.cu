// Exact greedy class-aware NMS over K <= 1024 score-sorted candidates, for
// each image of a batch.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/nms_kernel.py nms_pallas
//   (_suppress_kernel, pallas_call at :111; _fixpoint_kernel, pallas_call
//   at :131, finished to stationarity at :140-159).
//   S[i, j] = IoU(i, j) > thr && class_i == class_j && j > i && valid_i &&
//   valid_j, with box_iou's arithmetic inter / max(union, 1e-9);
//   keep[j] = valid[j] && !any_i(keep[i] && S[i, j]).
//
// Bound on the H100: operations of a serial recurrence. A served frame
//   hands over a few dozen valid candidates in its 1024 slots, so the time
//   is one launch's fixed cost unless the work follows the valid set; with
//   every slot valid it is 524 k pair tests and a scan that is sequential in
//   the kept set.
// Design: one launch, one cluster of 8 blocks per image (the grid's y axis
//   is the image; image b's candidates start at slot b * K).
//   1. Every block compacts the valid slots (any mask, not only a prefix)
//      by ballot and prefix count into shared memory, boxes, areas and
//      classes beside them: n candidates, still in score order.
//   2. n <= 96: block 0 works alone and the others leave at once (the
//      cluster's two barriers cost more than they save there). Above, all
//      8 blocks share the rows. A warp takes a row i and tests it
//      against one 32-candidate word a step, lane = candidate, from i's own
//      word on: only the upper triangle is computed. The ballot is the
//      mask word; it is written into block 0's shared memory (by the other
//      blocks through the cluster's distributed shared memory), never into
//      device memory. In i's own word the test is made both ways (IoU is
//      symmetric), so that word also tells which earlier candidates of the
//      word would suppress i.
//   3. One warp of block 0 scans word by word, lane = candidate inside the
//      word: keep_b = alive_b && !(earlier-suppressors_b & keep), taken by
//      ballot until the word stops changing. Bit b is final after b + 1
//      rounds, so the loop ends for any chain depth and its fixed point is
//      greedy NMS exactly; a word without chains takes two rounds, not one
//      step per kept box. The kept rows of the word are then cleared from
//      every later word, lane = word, as 32 independent loads (a row that
//      was not kept is predicated off). Rows are an odd number of words
//      apart, so a column of the mask has no bank conflicts.
//   The pair test skips the division when the boxes do not intersect
//   (IoU is 0 then, exactly as dividing would give).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MAX_K = 1024;
constexpr int THREADS = 1024;   // one thread per slot
constexpr int WARPS = THREADS / 32;
constexpr int CLUSTER = 8;
constexpr int ALONE_N = 96;     // up to here block 0 works alone

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
nms_kernel(const float* __restrict__ boxes, const int* __restrict__ classes,
           const uint8_t* __restrict__ valid, uint8_t* __restrict__ keep,
           int K, float thr) {
  extern __shared__ uint32_t rows[];  // [32 words][stride] mask words
  __shared__ float4 sbox[MAX_K];      // x1, y1, x2, y2
  __shared__ float2 sac[MAX_K];       // area, class (its bits)
  __shared__ uint32_t counts[WARPS];
  __shared__ uint32_t keep_w[WARPS];

  // image blockIdx.y: its K candidates and its keep mask
  const size_t at = (size_t)blockIdx.y * K;
  boxes += 4 * at, classes += at, valid += at, keep += at;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned full = 0xffffffffu;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;

  // 1. compact the valid slots, in order. Every slot's box and class are
  // asked for at once, beside its valid flag: one load latency, not two.
  const bool v = t < K && valid[t] != 0;
  float x1 = 0.f, y1 = 0.f, x2 = 0.f, y2 = 0.f;
  int cls = 0;
  if (t < K) {
    x1 = boxes[4 * t], y1 = boxes[4 * t + 1];
    x2 = boxes[4 * t + 2], y2 = boxes[4 * t + 3];
    cls = classes[t];
  }
  const uint32_t vw = __ballot_sync(full, v);
  if (lane == 0) counts[warp] = __popc(vw);
  __syncthreads();
  uint32_t incl = counts[lane];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    uint32_t up = __shfl_up_sync(full, incl, d);
    if (lane >= d) incl += up;
  }
  const int n = (int)__shfl_sync(full, incl, 31);
  const uint32_t before = __shfl_sync(full, incl, (warp + 31) & 31);
  const int pos =
      (int)((warp ? before : 0u) + __popc(vw & ((1u << lane) - 1u)));
  const int words = (n + 31) >> 5, stride = words | 1;
  const bool alone = n <= ALONE_N;
  if (alone && rank != 0) return;
  if (v) {
    sbox[pos] = make_float4(x1, y1, x2, y2);
    sac[pos] = make_float2((x2 - x1) * (y2 - y1), __int_as_float(cls));
  }
  // every block of the cluster runs before any writes into block 0
  if (alone) __syncthreads(); else cluster.sync();

  // 2. the upper triangle of the mask, a row a warp, into block 0
  uint32_t* rows0 = alone ? rows : cluster.map_shared_rank(rows, 0);
  const int nblk = alone ? 1 : CLUSTER;
  for (int i = warp * nblk + (int)rank; i < n; i += WARPS * nblk) {
    const float4 a = sbox[i];
    const float area_a = sac[i].x;
    const int ca = __float_as_int(sac[i].y);
    for (int w = i >> 5; w < words; ++w) {
      const int j = (w << 5) + lane;
      bool hit = false;
      if (j < n && j != i) {
        const float4 b = sbox[j];
        const float2 bc = sac[j];
        float iw = fmaxf(fminf(a.z, b.z) - fmaxf(a.x, b.x), 0.f);
        float ih = fmaxf(fminf(a.w, b.w) - fmaxf(a.y, b.y), 0.f);
        float inter = iw * ih;
        float iou = 0.f;
        if (inter > 0.f && __float_as_int(bc.y) == ca) {
          float uni = (area_a + bc.x) - inter;
          iou = inter / fmaxf(uni, 1e-9f);
        }
        hit = __float_as_int(bc.y) == ca && iou > thr;
      }
      const uint32_t bits = __ballot_sync(full, hit);
      if (lane == 0) rows0[i * stride + w] = bits;
    }
  }
  if (alone) __syncthreads(); else cluster.sync();
  if (rank != 0) return;

  // 3. the greedy scan
  if (warp == 0) {
    const int left = n - (lane << 5);
    uint32_t mine = left >= 32 ? full : left > 0 ? (1u << left) - 1u : 0u;
    for (int w = 0; w < words; ++w) {
      const int i = (w << 5) + lane;
      // candidates of this word, earlier than i, that would suppress i
      const uint32_t sup =
          i < n ? rows[(size_t)i * stride + w] & ((1u << lane) - 1u) : 0u;
      const uint32_t cur = __shfl_sync(full, mine, w);
      const bool me = (cur >> lane) & 1u;
      uint32_t kept = cur, prev;
      do {
        prev = kept;
        kept = __ballot_sync(full, me && !(sup & prev));
      } while (kept != prev);
      if (lane == w) mine = kept;
      // clear the kept rows of this word from the later words (lane =
      // word): 32 independent loads, no branch; a row that was not kept
      // (or lies past n: never written, never kept) is masked out
      if (w + 1 < words) {
        const bool later = lane > w && lane < words;
        const uint32_t* col =
            rows + (size_t)(w << 5) * stride + (later ? lane : 0);
        uint32_t part[32];
#pragma unroll
        for (int b = 0; b < 32; ++b) part[b] = col[b * stride];
        uint32_t acc = 0u;
#pragma unroll
        for (int b = 0; b < 32; ++b) acc |= part[b] & (0u - ((kept >> b) & 1u));
        if (later) mine &= ~acc;
      }
    }
    keep_w[lane] = lane < words ? mine : 0u;
  }
  __syncthreads();
  if (t < K) keep[t] = v ? (keep_w[pos >> 5] >> (pos & 31)) & 1u : 0u;
}

}  // namespace

extern "C" int unina_nms(const void* boxes, const void* classes,
                         const void* valid, void* keep, int B, int K,
                         float thr, void* stream) {
  if (K <= 0 || K > MAX_K || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int words = (K + 31) / 32;
  const size_t smem = (size_t)32 * words * (words | 1) * sizeof(uint32_t);
  static bool configured = false;  // once per process, not per call
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_K * (MAX_K / 32 + 1) * (int)sizeof(uint32_t));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  nms_kernel<<<dim3(CLUSTER, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)boxes, (const int*)classes, (const uint8_t*)valid,
      (uint8_t*)keep, K, thr);
  return (int)cudaGetLastError();
}
