// uint8 frame -> ImageNet-normalised float32, one pass.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/preprocess_kernel.py
//   normalize_pallas / _normalize_kernel (pallas_call at :66), generalised
//   to the merged (S/2, S/4, 24) serving layout whose mean/std tile 8x
//   (runtime/pipeline.py:35-47). The uint8 -> f32 widen, which the TPU
//   version leaves to XLA, is fused here.
//
// Bound on the H100: bytes. 1 B read + 4 B written per output element,
//   no reuse; at the serving shape 1.23 MB in, 4.92 MB out.
// Design: one thread per output element, consecutive threads on
//   consecutive elements, so the u8 reads and f32 writes coalesce. The
//   per-channel constants and the source-channel map (which carries the
//   optional B/R swap and drops alpha) travel by value in the launch.
//   The arithmetic is (x / 255 - mean) / std with IEEE division, the
//   reference formula, so the plain PyTorch version agrees bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CH 32

struct NormParams {
  float mean[MAX_CH];
  float std[MAX_CH];
  int src[MAX_CH];
};

__global__ void normalize_kernel(const uint8_t* __restrict__ in,
                                 float* __restrict__ out, long long n_out,
                                 int c_in, int c_out, NormParams p) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  long long pix = i / c_out;
  int c = (int)(i - pix * c_out);
  float x = (float)in[pix * c_in + p.src[c]];
  out[i] = (x / 255.0f - p.mean[c]) / p.std[c];
}

extern "C" int unina_normalize(const void* in, void* out, long long n_pix,
                               int c_in, int c_out, const float* mean,
                               const float* stdv, const int* src,
                               void* stream) {
  if (c_out > MAX_CH || c_out <= 0) return (int)cudaErrorInvalidValue;
  NormParams p;
  for (int c = 0; c < c_out; ++c) {
    p.mean[c] = mean[c];
    p.std[c] = stdv[c];
    p.src[c] = src[c];
  }
  long long n_out = n_pix * c_out;
  int threads = 256;
  long long blocks = (n_out + threads - 1) / threads;
  normalize_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)in, (float*)out, n_out, c_in, c_out, p);
  return (int)cudaGetLastError();
}
