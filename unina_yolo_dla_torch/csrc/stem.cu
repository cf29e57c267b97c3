// Fused stem + stage1 downsample over the column-merged frame.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/stem_kernel.py fused_stem_stage1
//   (_pallas_form, pallas_call at :192; the resident variant at :171 is
//   the same function). out = ReLU(stage1(bf16(ReLU(stem(xm))))):
//   stem   2x2 stride-1 conv, pad ((1,0),(1,0)), (H, W2, 24) -> (H, W2, 64)
//          merged columns;
//   stage1 folded 2x2 blocked downsample over the merged stem output,
//          pad top 2 rows / left 1 column -> (H/2, W2, 64).
//   Stem rows or columns outside the image are stage1's zero padding, so
//   they are masked to 0 (not ReLU(bias)); the stem output is rounded to
//   bf16 before stage1, as the composed graph stores it.
//
// Bound on the H100: at (320,160,24) -> (160,160,64) the work is
//   2.3 GFLOP (0.31 G stem MACs + 0.84 G stage1 MACs) over 2.5 MB of
//   frame in and 3.3 MB out; the 6.5 MB stem intermediate never reaches
//   device memory. On bf16 tensor cores that is operations-light (a few
//   microseconds); this first kernel runs the MACs as f32 FMAs on the CUDA
//   cores, so it is bound by those operations, not by bytes.
// Design: one block per 4 x 32 output tile (batch on grid z). The block
//   stages the 11 x 34 frame window, both weight sets and its 10 x 33 stem
//   window in shared memory (about 206 KB), computes the stem window once
//   (each thread: one stem pixel x 32 channels), masks it, rounds it to
//   bf16, then each thread accumulates one output pixel x 32 channels
//   over the 512 stage1 taps. Shared layouts keep the column index
//   fastest so a warp's 32 threads read 32 consecutive words, and the
//   weights are read as warp-wide broadcasts. Tensor-core (wgmma / mma)
//   versions of both contractions are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CM = 24;   // merged frame channels (2 columns x 4 s2d x RGB)
constexpr int O2 = 64;   // merged stem channels (2 columns x c1 = 32)
constexpr int C2 = 64;   // stage1 output channels
constexpr int K1 = 8 * O2;  // stage1 taps: (kh, kw, di, c) = 2*2*2*64
constexpr int TR = 4;    // output rows per block
constexpr int TW = 32;   // output columns per block
constexpr int FR = 2 * TR + 3, FC = TW + 2;  // frame window
constexpr int SR = 2 * TR + 2, SC = TW + 1;  // stem window
constexpr int OG = 32;   // output channels per thread
constexpr int THREADS = 256;

constexpr size_t W1_BYTES = (size_t)K1 * C2 * 2;          // bf16
constexpr size_t FR_BYTES = (size_t)FR * CM * FC * 4;
constexpr size_t WS_BYTES = (size_t)4 * CM * O2 * 4;
constexpr size_t ST_BYTES = (size_t)SR * O2 * SC * 4;
constexpr size_t SMEM_BYTES = W1_BYTES + FR_BYTES + WS_BYTES + ST_BYTES;

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
fused_stem_stage1_kernel(const __nv_bfloat16* __restrict__ xm,
                         const __nv_bfloat16* __restrict__ ws,
                         const float* __restrict__ bs,
                         const __nv_bfloat16* __restrict__ w1,
                         const float* __restrict__ b1,
                         __nv_bfloat16* __restrict__ out, int H, int W2) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w1_s = reinterpret_cast<__nv_bfloat16*>(smem);
  float* fr_s = reinterpret_cast<float*>(smem + W1_BYTES);
  float* ws_s = reinterpret_cast<float*>(smem + W1_BYTES + FR_BYTES);
  float* st_s =
      reinterpret_cast<float*>(smem + W1_BYTES + FR_BYTES + WS_BYTES);

  const int tid = threadIdx.x;
  const int H2 = H / 2;
  const int R0 = blockIdx.y * TR;
  const int W0 = blockIdx.x * TW;
  const int b = blockIdx.z;
  const __nv_bfloat16* x = xm + (size_t)b * H * W2 * CM;

  // stage1 weights: (kh, kw, di*O2 + c, o) rows, copied 16 B at a time
  {
    const uint4* src = reinterpret_cast<const uint4*>(w1);
    uint4* dst = reinterpret_cast<uint4*>(w1_s);
    for (int i = tid; i < (int)(W1_BYTES / 16); i += THREADS) dst[i] = src[i];
  }
  // stem weights as f32: ws_s[((kh*2+kw)*CM + c)*O2 + o]
  for (int i = tid; i < 4 * CM * O2; i += THREADS)
    ws_s[i] = __bfloat162float(ws[i]);
  // frame window, zero outside the image: fr_s[(fr*CM + c)*FC + fc]
  for (int i = tid; i < FR * FC * CM; i += THREADS) {
    int c = i % CM;
    int t = i / CM;
    int fcl = t % FC;
    int frl = t / FC;
    int f = 2 * R0 - 3 + frl;
    int fc = W0 - 2 + fcl;
    float v = 0.f;
    if (f >= 0 && f < H && fc >= 0 && fc < W2)
      v = __bfloat162float(x[((size_t)f * W2 + fc) * CM + c]);
    fr_s[(frl * CM + c) * FC + fcl] = v;
  }
  __syncthreads();

  // stem window: st_s[(sr*O2 + o)*SC + scl], stem row 2*R0-2+sr, col W0-1+scl
  for (int item = tid; item < (O2 / OG) * SR * SC; item += THREADS) {
    int scl = item % SC;
    int t = item / SC;
    int sr = t % SR;
    int og = t / SR;
    float acc[OG];
#pragma unroll
    for (int j = 0; j < OG; ++j) acc[j] = 0.f;
    for (int kh = 0; kh < 2; ++kh)
      for (int kw = 0; kw < 2; ++kw)
        for (int c = 0; c < CM; ++c) {
          float xv = fr_s[((sr + kh) * CM + c) * FC + scl + kw];
          const float* wr = ws_s + ((kh * 2 + kw) * CM + c) * O2 + og * OG;
#pragma unroll
          for (int j = 0; j < OG; ++j) acc[j] = __fmaf_rn(xv, wr[j], acc[j]);
        }
    int s = 2 * R0 - 2 + sr;
    int sc = W0 - 1 + scl;
    bool inside = s >= 0 && s < H && sc >= 0 && sc < W2;
#pragma unroll
    for (int j = 0; j < OG; ++j) {
      int o = og * OG + j;
      float v = fmaxf(__fadd_rn(acc[j], bs[o]), 0.f);
      v = inside ? __bfloat162float(__float2bfloat16_rn(v)) : 0.f;
      st_s[(sr * O2 + o) * SC + scl] = v;
    }
  }
  __syncthreads();

  // stage1: one output pixel x 32 channels per thread
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
        const float* srow = st_s + ((2 * rl + 2 * kh + di) * O2) * SC + wl + kw;
        const __nv_bfloat16* wbase =
            w1_s + (size_t)((kh * 2 + kw) * 2 * O2 + di * O2) * C2 + og * OG;
        for (int c = 0; c < O2; ++c) {
          float xv = srow[c * SC];
          const uint4* wv = reinterpret_cast<const uint4*>(wbase + c * C2);
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
    __nv_bfloat16* dst = out + (((size_t)b * H2 + r) * W2 + w) * C2 + og * OG;
#pragma unroll
    for (int q = 0; q < OG / 8; ++q) {
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int o = og * OG + q * 8 + e;
        v[e] = __float2bfloat16_rn(fmaxf(__fadd_rn(acc[q * 8 + e], b1[o]), 0.f));
      }
      reinterpret_cast<uint4*>(dst)[q] = *reinterpret_cast<uint4*>(v);
    }
  }
}

}  // namespace

extern "C" int unina_fused_stem_stage1(const void* xm, const void* ws,
                                       const void* bs, const void* w1,
                                       const void* b1, void* out, int B,
                                       int H, int W2, void* stream) {
  if (H % 2 != 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_stem_stage1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W2 + TW - 1) / TW, (H / 2 + TR - 1) / TR, B);
  fused_stem_stage1_kernel<<<grid, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)xm, (const __nv_bfloat16*)ws, (const float*)bs,
      (const __nv_bfloat16*)w1, (const float*)b1, (__nv_bfloat16*)out, H, W2);
  return (int)cudaGetLastError();
}
