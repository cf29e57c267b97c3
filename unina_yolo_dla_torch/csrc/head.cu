// Fused decoupled detection head: both branches in one pass over x.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/head_kernel.py fused_head
//   (_pallas_head, pallas_call at :127 gridless / :137 row-gridded).
//   Per branch (cls, then reg), over the same input x (H, W, 64):
//     c1   = bf16(ReLU(conv3x3(x)  + b1))
//     c2   = bf16(ReLU(conv3x3(c1) + b2))
//     pred = c2 @ wp + bp      (f32, never rounded to bf16)
//   The TPU kernel writes one (H, W, Ccls+4) f32 block that its caller
//   splits; this kernel writes the cls and reg predictions as two
//   contiguous f32 tensors, which the decode kernel takes as they are.
//
// Bound on the H100: at head_p2, (160,160,64) -> 2 x (160,160,4), the
//   four 3x3 convs are 7.6 GFLOP over 4.1 MB: on bf16 tensor cores it is
//   bound by operations (~8 us). This first kernel runs the MACs as f32
//   FMAs on the CUDA cores, so it is bound by those operations, a
//   hundred times slower than that.
// Design: one block per 4 x 32 output tile (batch on grid z) stages x on
//   the tile plus a 2-pixel halo (8 x 36 pixels, f32, zero outside the
//   image) once for both branches. Per branch it stages the 3x3 weights
//   of one conv at a time (bf16, 72 KB), computes conv1 on the tile plus a
//   1-pixel halo (6 x 34) and masks it to 0 outside the image, so conv2
//   sees the image's zero padding in rows and columns (the TPU kernel's
//   `valid` mask, which covers rows only because it grids rows only);
//   conv2's result is parked over the spent weights for the 1x1 pred.
//   ~195 KB of shared memory, one block per SM. Each thread computes one
//   pixel x 32 channels; activations are read column-fastest, weights as
//   warp-wide broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 64;     // head width (P2 channels)
constexpr int OG = 32;    // output channels per thread in the 3x3s
constexpr int TR = 4;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int XR = TR + 4, XC = TW + 4;  // x window (halo 2)
constexpr int CR = TR + 2, CC = TW + 2;  // conv1 window (halo 1)
constexpr int NOMAX = 8;  // pred outputs per branch
constexpr int THREADS = 256;

constexpr size_t X_BYTES = (size_t)XR * C * XC * 4;
constexpr size_t C1_BYTES = (size_t)CR * C * CC * 4;
constexpr size_t W_BYTES = (size_t)9 * C * C * 2;
constexpr size_t SMEM_BYTES = X_BYTES + C1_BYTES + W_BYTES;
static_assert((size_t)TR * TW * C * 4 <= W_BYTES, "c2 must fit over w");
static_assert(THREADS == TR * TW * (C / OG), "conv2: one item per thread");

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void unpack8(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc[j] += 3x3 conv of the window `a` ([row][c][col], row stride C*ld)
// at (r, col) with bf16 weights w_s[((kh*3+kw)*C + c)*C + og*OG + j]
__device__ __forceinline__ void conv3x3_px(const float* a, int ld, int r,
                                           int col, const bf16* w_s, int og,
                                           float* acc) {
  for (int kh = 0; kh < 3; ++kh)
    for (int kw = 0; kw < 3; ++kw) {
      const float* src = a + (r + kh) * C * ld + col + kw;
      const bf16* wt = w_s + (kh * 3 + kw) * C * C + og * OG;
      for (int c = 0; c < C; ++c) {
        float xv = src[c * ld];
        const uint4* wv = reinterpret_cast<const uint4*>(wt + c * C);
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
}

__device__ __forceinline__ void copy_w(bf16* dst, const bf16* src, int tid) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = tid; i < (int)(W_BYTES / 16); i += THREADS) d[i] = s[i];
}

struct Branch {
  const bf16* w1;
  const float* b1;
  const bf16* w2;
  const float* b2;
  const bf16* wp;   // (C, no)
  const float* bp;  // (no,)
  int no;
  float* out;       // (B, H, W, no)
};

__global__ void __launch_bounds__(THREADS, 1)
head_kernel(const bf16* __restrict__ x, Branch cls, Branch reg, int H,
            int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* x_s = reinterpret_cast<float*>(smem);                 // [XR][C][XC]
  float* c1_s = reinterpret_cast<float*>(smem + X_BYTES);      // [CR][C][CC]
  bf16* w_s = reinterpret_cast<bf16*>(smem + X_BYTES + C1_BYTES);
  float* c2_s = reinterpret_cast<float*>(w_s);                 // [C][TR*TW]

  const int tid = threadIdx.x;
  const int R0 = blockIdx.y * TR, W0 = blockIdx.x * TW;
  const int b = blockIdx.z;
  const bf16* xb = x + (size_t)b * H * W * C;

  // x window: row R0-2+xr, column W0-2+xc, 8 channels per 16 B load
  for (int i = tid; i < XR * XC * (C / 8); i += THREADS) {
    int c8 = i % (C / 8);
    int t = i / (C / 8);
    int xc = t % XC, xr = t / XC;
    int gy = R0 - 2 + xr, gx = W0 - 2 + xc;
    float v[8];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      unpack8(__ldg(reinterpret_cast<const uint4*>(
                  xb + ((size_t)gy * W + gx) * C + c8 * 8)),
              v);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) x_s[(xr * C + c8 * 8 + e) * XC + xc] = v[e];
  }

  for (int br = 0; br < 2; ++br) {
    const Branch p = br == 0 ? cls : reg;
    __syncthreads();  // x staged / the previous pred is done with c2_s
    copy_w(w_s, p.w1, tid);
    __syncthreads();
    // conv1 on the tile + 1-pixel halo, 0 outside the image
    for (int item = tid; item < CR * CC * (C / OG); item += THREADS) {
      int px = item % (CR * CC), og = item / (CR * CC);
      int cr = px / CC, cc = px % CC;
      int gy = R0 - 1 + cr, gx = W0 - 1 + cc;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float acc[OG];
#pragma unroll
      for (int j = 0; j < OG; ++j) acc[j] = 0.f;
      conv3x3_px(x_s, XC, cr, cc, w_s, og, acc);
#pragma unroll
      for (int j = 0; j < OG; ++j) {
        float v = bf16r(fmaxf(__fadd_rn(acc[j], __ldg(p.b1 + og * OG + j)),
                              0.f));
        c1_s[(cr * C + og * OG + j) * CC + cc] = inside ? v : 0.f;
      }
    }
    __syncthreads();
    copy_w(w_s, p.w2, tid);
    __syncthreads();
    // conv2 on the tile: one pixel x 32 channels per thread
    const int px = tid % (TR * TW), og = tid / (TR * TW);
    float acc[OG];
#pragma unroll
    for (int j = 0; j < OG; ++j) acc[j] = 0.f;
    conv3x3_px(c1_s, CC, px / TW, px % TW, w_s, og, acc);
    __syncthreads();  // every thread is done reading the conv2 weights
#pragma unroll
    for (int j = 0; j < OG; ++j)
      c2_s[(og * OG + j) * (TR * TW) + px] = bf16r(
          fmaxf(__fadd_rn(acc[j], __ldg(p.b2 + og * OG + j)), 0.f));
    __syncthreads();
    // 1x1 pred in f32: one pixel x one output per item
    for (int item = tid; item < TR * TW * p.no; item += THREADS) {
      int q = item % (TR * TW), jo = item / (TR * TW);
      int gy = R0 + q / TW, gx = W0 + q % TW;
      float a = 0.f;
      for (int c = 0; c < C; ++c)
        a = __fmaf_rn(c2_s[c * (TR * TW) + q],
                      __bfloat162float(p.wp[c * p.no + jo]), a);
      if (gy < H && gx < W)
        p.out[(((size_t)b * H + gy) * W + gx) * p.no + jo] =
            __fadd_rn(a, __ldg(p.bp + jo));
    }
  }
}

}  // namespace

extern "C" int unina_fused_head(const void* x, const void* wc1,
                                const void* bc1, const void* wc2,
                                const void* bc2, const void* wcp,
                                const void* bcp, int nc, const void* wr1,
                                const void* br1, const void* wr2,
                                const void* br2, const void* wrp,
                                const void* brp, int nr, void* out_cls,
                                void* out_reg, int B, int H, int W,
                                void* stream) {
  if (B <= 0 || nc < 1 || nc > NOMAX || nr < 1 || nr > NOMAX)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  Branch cls{(const bf16*)wc1, (const float*)bc1, (const bf16*)wc2,
             (const float*)bc2, (const bf16*)wcp, (const float*)bcp, nc,
             (float*)out_cls};
  Branch reg{(const bf16*)wr1, (const float*)br1, (const bf16*)wr2,
             (const float*)br2, (const bf16*)wrp, (const float*)brp, nr,
             (float*)out_reg};
  dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
  head_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, cls, reg, H, W);
  return (int)cudaGetLastError();
}
