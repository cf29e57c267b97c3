// Per-level anchor-free head decode.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/decode_kernel.py
//   decode_level_pallas / _decode_kernel (pallas_call at :94).
//   Per cell: sigmoid of the class logits; score = max, class = first
//   argmax; TLBR distances x stride -> xyxy around the cell centre
//   ((x + 0.5) * stride, (y + 0.5) * stride); conformal dilation by
//   q_factor; valid = score > conf. Output is the packed 7-float row
//   [x1, y1, x2, y2, score, class, valid] that ops/decode.py gathers.
//
// Bound on the H100: bytes. 32 B read (4 logits + 4 distances) and 28 B
//   written per cell, a few dozen flops; at 160^2 + 80^2 + 40^2 = 33,600
//   cells that is 2 MB, so the three launches are latency-bound.
// Design: one thread per cell; the sigmoid, the first-match argmax and the
//   box arithmetic are written in the plain version's operation order and
//   compiled without multiply-add contraction, so the two agree bit for
//   bit.
#include <cuda_runtime.h>

#define MAX_CLASSES 16

__global__ void decode_kernel(const float* __restrict__ cls,
                              const float* __restrict__ reg,
                              float* __restrict__ out, int H, int W, int C,
                              float stride, float conf, float q) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  int y = i / W, x = i - y * W;
  float best = 0.f;
  int klass = 0;
  for (int c = 0; c < C; ++c) {
    float p = 1.0f / (1.0f + expf(-cls[i * C + c]));
    if (c == 0 || p > best) {  // first maximum wins ties
      best = p;
      klass = c;
    }
  }
  float cx = ((float)x + 0.5f) * stride;
  float cy = ((float)y + 0.5f) * stride;
  float l = reg[i * 4 + 0] * stride, t = reg[i * 4 + 1] * stride;
  float r = reg[i * 4 + 2] * stride, b = reg[i * 4 + 3] * stride;
  float x1 = cx - l, y1 = cy - t, x2 = cx + r, y2 = cy + b;
  if (q > 0.f) {
    float dw = (x2 - x1) * q;
    float dh = (y2 - y1) * q;
    x1 = x1 - dw;
    y1 = y1 - dh;
    x2 = x2 + dw;
    y2 = y2 + dh;
  }
  float* o = out + (size_t)i * 7;
  o[0] = x1;
  o[1] = y1;
  o[2] = x2;
  o[3] = y2;
  o[4] = best;
  o[5] = (float)klass;
  o[6] = best > conf ? 1.f : 0.f;
}

extern "C" int unina_decode_level(const void* cls, const void* reg, void* out,
                                  int H, int W, int C, float stride,
                                  float conf, float q, void* stream) {
  if (C <= 0 || C > MAX_CLASSES) return (int)cudaErrorInvalidValue;
  int n = H * W;
  int threads = 256;
  decode_kernel<<<(n + threads - 1) / threads, threads, 0,
                  (cudaStream_t)stream>>>((const float*)cls,
                                          (const float*)reg, (float*)out, H,
                                          W, C, stride, conf, q);
  return (int)cudaGetLastError();
}
