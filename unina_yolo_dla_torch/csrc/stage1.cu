// Stage1 2x2 blocked downsample over the column-merged stem output.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/stage1_kernel.py
//   fused_downsample_merged (_pallas_merged, pallas_call at :127).
//   out[r, w, o] = ReLU(b[o] + sum_{kh,kw,di,c} xp[2r+2kh+di, w+kw, c]
//                                * wb[kh, kw, di*CM + c, o])
//   where xp is the merged stem output (H, W2, CM = 2 x 32) padded with 2
//   zero rows on top and 1 zero merged column on the left: the TPU
//   kernel's kw = 1 half of each kw-packed product shifted by one column.
//
// Bound on the H100: at (320,160,64) -> (160,160,64) the work is
//   1.68 GFLOP over 6.6 MB in and 3.3 MB out: a few microseconds on bf16
//   tensor cores, bound by bytes. This first kernel runs the MACs as f32
//   FMAs on the CUDA cores, so it is bound by those operations instead.
// Design: the stage1 half of csrc/stem.cu, reading the stem output from
//   device memory instead of computing it. One block per 4 x 32 output
//   tile (batch on grid z) stages its 10 x 33 input window (as f32, zero
//   outside the image) and the bf16 weights (64 KB) in shared memory;
//   each thread accumulates one output pixel x 32 channels over the 512
//   taps. Column index fastest in shared memory, so a warp's 32 threads
//   read 32 consecutive words; weights are warp-wide broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CM = 64;      // merged input channels (2 columns x 32)
constexpr int CO = 64;      // output channels
constexpr int K1 = 8 * CM;  // taps: (kh, kw, di, c) = 2*2*2*64
constexpr int TR = 4;       // output rows per block
constexpr int TW = 32;      // output columns per block
constexpr int SR = 2 * TR + 2, SC = TW + 1;  // input window
constexpr int OG = 32;      // output channels per thread
constexpr int THREADS = 256;

constexpr size_t W_BYTES = (size_t)K1 * CO * 2;  // bf16
constexpr size_t X_BYTES = (size_t)SR * CM * SC * 4;
constexpr size_t SMEM_BYTES = W_BYTES + X_BYTES;

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stage1_merged_kernel(const __nv_bfloat16* __restrict__ xm,
                     const __nv_bfloat16* __restrict__ wb,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* x_s = reinterpret_cast<float*>(smem + W_BYTES);

  const int tid = threadIdx.x;
  const int H2 = H / 2;
  const int R0 = blockIdx.y * TR;
  const int W0 = blockIdx.x * TW;
  const int b = blockIdx.z;
  const __nv_bfloat16* x = xm + (size_t)b * H * W2 * CM;

  // weights: (kh, kw, di*CM + c, o) rows, copied 16 B at a time
  {
    const uint4* src = reinterpret_cast<const uint4*>(wb);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    for (int i = tid; i < (int)(W_BYTES / 16); i += THREADS) dst[i] = src[i];
  }
  // input window, zero outside the image: x_s[(sr*CM + c)*SC + scl] holds
  // row 2*R0-2+sr, merged column W0-1+scl; 8 channels per 16 B load
  for (int i = tid; i < SR * SC * (CM / 8); i += THREADS) {
    int c8 = i % (CM / 8);
    int t = i / (CM / 8);
    int scl = t % SC;
    int sr = t / SC;
    int s = 2 * R0 - 2 + sr;
    int sc = W0 - 1 + scl;
    float v[8];
    if (s >= 0 && s < H && sc >= 0 && sc < W2) {
      uint4 raw = *reinterpret_cast<const uint4*>(
          x + ((size_t)s * W2 + sc) * CM + c8 * 8);
      unpack8(raw, v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) x_s[(sr * CM + c8 * 8 + e) * SC + scl] = v[e];
  }
  __syncthreads();

  // one output pixel x 32 channels per thread
  const int p = tid % (TR * TW);
  const int og = tid / (TR * TW);
  const int rl = p / TW, wl = p % TW;
  const int r = R0 + rl, w = W0 + wl;
  float acc[OG];
#pragma unroll
  for (int j = 0; j < OG; ++j) acc[j] = 0.f;
  for (int kh = 0; kh < 2; ++kh)
    for (int kw = 0; kw < 2; ++kw)
      for (int di = 0; di < 2; ++di) {
        const float* srow = x_s + ((2 * rl + 2 * kh + di) * CM) * SC + wl + kw;
        const __nv_bfloat16* wbase =
            w_s + (size_t)((kh * 2 + kw) * 2 * CM + di * CM) * CO + og * OG;
        for (int c = 0; c < CM; ++c) {
          float xv = srow[c * SC];
          const uint4* wv = reinterpret_cast<const uint4*>(wbase + c * CO);
#pragma unroll
          for (int q = 0; q < OG / 8; ++q) {
            float wf[8];
            unpack8(wv[q], wf);
#pragma unroll
            for (int e = 0; e < 8; ++e)
              acc[q * 8 + e] = __fmaf_rn(xv, wf[e], acc[q * 8 + e]);
          }
        }
      }
  if (r < H2 && w < W2) {
    __nv_bfloat16* dst = out + (((size_t)b * H2 + r) * W2 + w) * CO + og * OG;
#pragma unroll
    for (int q = 0; q < OG / 8; ++q) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int o = og * OG + q * 8 + e;
        v[e] = __float2bfloat16_rn(
            fmaxf(__fadd_rn(acc[q * 8 + e], bias[o]), 0.f));
      }
      reinterpret_cast<uint4*>(dst)[q] = *reinterpret_cast<uint4*>(v);
    }
  }
}

}  // namespace

extern "C" int unina_stage1_merged(const void* xm, const void* wb,
                                   const void* bias, void* out, int B, int H,
                                   int W2, void* stream) {
  if (H % 2 != 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stage1_merged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W2 + TW - 1) / TW, (H / 2 + TR - 1) / TR, B);
  stage1_merged_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)xm, (const __nv_bfloat16*)wb, (const float*)bias,
      (__nv_bfloat16*)out, H, W2);
  return (int)cudaGetLastError();
}
