// Fused C3k2 block (CSP split-process-concat) in one pass, and its pair
// form over concat([upsample2x?(xa), xb]).
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/c3k2_kernel.py
//   fused_c3k2     (_pallas_c3k2, pallas_call at :324 gridless / :338
//                   row-gridded)       -> entry point unina_fused_c3k2
//   fused_c3k2_cat (_pallas_c3k2_cat, pallas_call at :356 / :371)
//                                      -> entry point unina_fused_c3k2_cat
//   p1 = bf16(ReLU(x @ w1 + b1)), p2 = bf16(ReLU(x @ w2 + b2)); n times
//   t = bf16(ReLU(p1 @ wb1 + bb1)), t = bf16(ReLU(conv3x3(t) + bb2)),
//   p1 = bf16(p1 + t) (or t without shortcut); then
//   out = bf16(ReLU((p1 @ w3[:h] + p2 @ w3[h:]) + b3)): cv3 is the f32
//   sum of two split products, no concat tensor. In the pair form the
//   first products are (xa @ w[:Ca]) + (xb @ w[Ca:]) in f32, with xa read
//   at its coarse pixel (r/2, c/2) when it is upsampled: the same f32
//   value the TPU kernel computes at the coarse resolution and copies.
//
// Bound on the H100: at stage1_block, (160,160,64) -> (160,160,64) with
//   hidden 32, the block moves 6.6 MB (input once, output once) for
//   0.94 GFLOP: on bf16 tensor cores it is bound by bytes (~2 us). This
//   first kernel runs the MACs as f32 FMAs on the CUDA cores, bound by
//   those operations, and keeps every intermediate on chip.
// Design: one block per 4 x 32 output tile (batch on grid z) computes p1
//   on the tile plus a halo of n pixels on every side (one per chained
//   3x3), p2 on the tile, the bottlenecks and cv3, with p1, t and p2 in
//   shared memory as f32 (bf16-exact values) and all bf16 weights staged
//   there too (~111 KB at fpn_c3k2_2, two blocks per SM). Pixels of the
//   halo outside the image are masked to 0 after every stage, so each 3x3
//   sees the image's zero padding in rows AND columns (the TPU kernel
//   grids rows only and masks rows). Each thread computes one pixel x 32
//   channels; activations are read column-fastest (a warp reads 32
//   consecutive words), weights as warp-wide broadcasts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HID = 32;   // hidden width (C3k2 features // 2)
constexpr int FO = 64;    // output features
constexpr int OG = 32;    // output channels per thread in cv3
constexpr int TR = 4;     // output rows per block
constexpr int TW = 32;    // output columns per block
constexpr int NMAX = 2;   // bottlenecks the shared-memory plan covers
constexpr int THREADS = 256;

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

// acc[j] += sum_c px[c] * w[c*HID + j], px a bf16 pixel in device memory
// (C channels, 16 B aligned), w bf16 rows in shared memory.
__device__ __forceinline__ void dot_pixel(const bf16* __restrict__ px, int C,
                                          const bf16* w, float* acc) {
  for (int c8 = 0; c8 < C / 8; ++c8) {
    float xv[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(px) + c8), xv);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint4* wv = reinterpret_cast<const uint4*>(w + (c8 * 8 + e) * HID);
#pragma unroll
      for (int q = 0; q < HID / 8; ++q) {
        float wf[8];
        unpack8(wv[q], wf);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          acc[q * 8 + k] = __fmaf_rn(xv[e], wf[k], acc[q * 8 + k]);
      }
    }
  }
}

// acc[j] += sum_k a[k*stride] * w[k*ldw + j] over K shared-memory values
template <int NJ>
__device__ __forceinline__ void dot_smem(const float* a, int stride, int K,
                                         const bf16* w, int ldw, float* acc) {
  for (int k = 0; k < K; ++k) {
    float xv = a[k * stride];
    const uint4* wv = reinterpret_cast<const uint4*>(w + k * ldw);
#pragma unroll
    for (int q = 0; q < NJ / 8; ++q) {
      float wf[8];
      unpack8(wv[q], wf);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[q * 8 + e] = __fmaf_rn(xv, wf[e], acc[q * 8 + e]);
    }
  }
}

__host__ __device__ inline size_t smem_bytes(int cin, int n) {
  size_t w = (size_t)(2 * cin * HID + n * HID * HID + n * 9 * HID * HID +
                      2 * HID * FO) * 2;
  size_t win = (size_t)(TR + 2 * n) * HID * (TW + 2 * n) * 4;
  return w + 2 * win + (size_t)TR * HID * TW * 4;
}

__device__ __forceinline__ void copy16(bf16* dst, const bf16* src,
                                       int count, int tid) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(dst);
  for (int i = tid; i < count / 8; i += THREADS) d[i] = s[i];
}

// CAT: the pair form (xa's products added to xb's); a template parameter
// so that the two forms are two device functions, told apart by name.
template <bool CAT>
__global__ void __launch_bounds__(THREADS, 2)
c3k2_kernel(const bf16* __restrict__ xa, const bf16* __restrict__ xb, int ca,
            int cb, int up_a, const bf16* __restrict__ w1,
            const float* __restrict__ b1, const bf16* __restrict__ wb1,
            const float* __restrict__ bb1, const bf16* __restrict__ wb2,
            const float* __restrict__ bb2, const bf16* __restrict__ w2,
            const float* __restrict__ b2, const bf16* __restrict__ w3,
            const float* __restrict__ b3, bf16* __restrict__ out, int H,
            int W, int n, int shortcut) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int cin = ca + cb;
  const int WR = TR + 2 * n, WC = TW + 2 * n;
  bf16* w1_s = reinterpret_cast<bf16*>(smem);
  bf16* w2_s = w1_s + cin * HID;
  bf16* wb1_s = w2_s + cin * HID;
  bf16* wb2_s = wb1_s + n * HID * HID;
  bf16* w3_s = wb2_s + n * 9 * HID * HID;
  float* p1_s = reinterpret_cast<float*>(w3_s + 2 * HID * FO);  // [wr][k][wc]
  float* t_s = p1_s + WR * HID * WC;                             // [wr][k][wc]
  float* p2_s = t_s + WR * HID * WC;                             // [rl][k][wl]

  const int tid = threadIdx.x;
  const int R0 = blockIdx.y * TR, W0 = blockIdx.x * TW;
  const int b = blockIdx.z;
  const int Ha = up_a ? H / 2 : H, Wa = up_a ? W / 2 : W;
  const bf16* xa_b = xa + (size_t)b * Ha * Wa * ca;
  const bf16* xb_b = xb + (size_t)b * H * W * cb;

  copy16(w1_s, w1, cin * HID, tid);
  copy16(w2_s, w2, cin * HID, tid);
  copy16(wb1_s, wb1, n * HID * HID, tid);
  copy16(wb2_s, wb2, n * 9 * HID * HID, tid);
  copy16(w3_s, w3, 2 * HID * FO, tid);
  __syncthreads();

  // first products of one pixel: ReLU((xa-part + xb-part) + bias), bf16
  auto first = [&](int gy, int gx, const bf16* w_s, const float* bias,
                   float* v) {
    float za[HID], zb[HID];
#pragma unroll
    for (int j = 0; j < HID; ++j) za[j] = zb[j] = 0.f;
    if constexpr (CAT) {
      int ay = up_a ? gy >> 1 : gy, ax = up_a ? gx >> 1 : gx;
      dot_pixel(xa_b + ((size_t)ay * Wa + ax) * ca, ca, w_s, za);
    }
    dot_pixel(xb_b + ((size_t)gy * W + gx) * cb, cb, w_s + ca * HID, zb);
#pragma unroll
    for (int j = 0; j < HID; ++j)
      v[j] = bf16r(fmaxf(__fadd_rn(__fadd_rn(za[j], zb[j]), __ldg(bias + j)),
                         0.f));
  };

  // p1 = cv1 on the tile and its halo (0 outside the image)
  for (int item = tid; item < WR * WC; item += THREADS) {
    int wr = item / WC, wc = item % WC;
    int gy = R0 - n + wr, gx = W0 - n + wc;
    float v[HID];
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      first(gy, gx, w1_s, b1, v);
    } else {
#pragma unroll
      for (int j = 0; j < HID; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HID; ++j) p1_s[(wr * HID + j) * WC + wc] = v[j];
  }
  // p2 = cv2 on the tile
  for (int item = tid; item < TR * TW; item += THREADS) {
    int rl = item / TW, wl = item % TW;
    int gy = R0 + rl, gx = W0 + wl;
    float v[HID];
    if (gy < H && gx < W) {
      first(gy, gx, w2_s, b2, v);
    } else {
#pragma unroll
      for (int j = 0; j < HID; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < HID; ++j) p2_s[(rl * HID + j) * TW + wl] = v[j];
  }
  __syncthreads();

  for (int i = 0; i < n; ++i) {
    // t = bottleneck cv1 (1x1) on the window, 0 outside the image
    for (int item = tid; item < WR * WC; item += THREADS) {
      int wr = item / WC, wc = item % WC;
      int gy = R0 - n + wr, gx = W0 - n + wc;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float acc[HID];
#pragma unroll
      for (int j = 0; j < HID; ++j) acc[j] = 0.f;
      dot_smem<HID>(p1_s + wr * HID * WC + wc, WC, HID,
                    wb1_s + i * HID * HID, HID, acc);
#pragma unroll
      for (int j = 0; j < HID; ++j) {
        float v = bf16r(fmaxf(__fadd_rn(acc[j], __ldg(bb1 + i * HID + j)),
                              0.f));
        t_s[(wr * HID + j) * WC + wc] = inside ? v : 0.f;
      }
    }
    __syncthreads();
    // 3x3 on the window's interior, residual into p1 in place (each
    // thread reads t_s and only its own pixel of p1_s)
    for (int item = tid; item < (WR - 2) * (WC - 2); item += THREADS) {
      int wr = 1 + item / (WC - 2), wc = 1 + item % (WC - 2);
      int gy = R0 - n + wr, gx = W0 - n + wc;
      bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
      float acc[HID];
#pragma unroll
      for (int j = 0; j < HID; ++j) acc[j] = 0.f;
      for (int kh = 0; kh < 3; ++kh)
        for (int kw = 0; kw < 3; ++kw)
          dot_smem<HID>(t_s + (wr - 1 + kh) * HID * WC + wc - 1 + kw, WC,
                        HID, wb2_s + ((i * 9 + kh * 3 + kw) * HID) * HID,
                        HID, acc);
#pragma unroll
      for (int j = 0; j < HID; ++j) {
        float u = bf16r(fmaxf(__fadd_rn(acc[j], __ldg(bb2 + i * HID + j)),
                              0.f));
        float* p = p1_s + (wr * HID + j) * WC + wc;
        float v = shortcut ? bf16r(__fadd_rn(*p, u)) : u;
        *p = inside ? v : 0.f;
      }
    }
    __syncthreads();
  }

  // cv3: one tile pixel x 32 output channels per thread
  for (int item = tid; item < TR * TW * (FO / OG); item += THREADS) {
    int p = item % (TR * TW), og = item / (TR * TW);
    int rl = p / TW, wl = p % TW;
    int gy = R0 + rl, gx = W0 + wl;
    float a1[OG], a2[OG];
#pragma unroll
    for (int j = 0; j < OG; ++j) a1[j] = a2[j] = 0.f;
    dot_smem<OG>(p1_s + (rl + n) * HID * WC + wl + n, WC, HID,
                 w3_s + og * OG, FO, a1);
    dot_smem<OG>(p2_s + rl * HID * TW + wl, TW, HID,
                 w3_s + HID * FO + og * OG, FO, a2);
    if (gy < H && gx < W) {
      bf16* dst = out + (((size_t)b * H + gy) * W + gx) * FO + og * OG;
#pragma unroll
      for (int q = 0; q < OG / 8; ++q) {
        __align__(16) bf16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          int j = q * 8 + e;
          v[e] = __float2bfloat16_rn(fmaxf(
              __fadd_rn(__fadd_rn(a1[j], a2[j]), __ldg(b3 + og * OG + j)),
              0.f));
        }
        reinterpret_cast<uint4*>(dst)[q] = *reinterpret_cast<uint4*>(v);
      }
    }
  }
}

template <bool CAT>
int launch(const void* xa, const void* xb, int ca, int cb, int up_a,
           const void* w1, const void* b1, const void* wb1, const void* bb1,
           const void* wb2, const void* bb2, const void* w2, const void* b2,
           const void* w3, const void* b3, void* out, int B, int H, int W,
           int n, int shortcut, void* stream) {
  int cin = ca + cb;
  if (B <= 0 || n < 1 || n > NMAX || cb % 8 || ca % 8 || cb <= 0 ||
      (up_a && (H % 2 || W % 2)))
    return (int)cudaErrorInvalidValue;
  size_t smem = smem_bytes(cin, n);
  cudaError_t err = cudaFuncSetAttribute(
      c3k2_kernel<CAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TW - 1) / TW, (H + TR - 1) / TR, B);
  c3k2_kernel<CAT><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)xa, (const bf16*)xb, ca, cb, up_a, (const bf16*)w1,
      (const float*)b1, (const bf16*)wb1, (const float*)bb1,
      (const bf16*)wb2, (const float*)bb2, (const bf16*)w2, (const float*)b2,
      (const bf16*)w3, (const float*)b3, (bf16*)out, H, W, n, shortcut);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int unina_fused_c3k2(const void* x, int cin, const void* w1,
                                const void* b1, const void* wb1,
                                const void* bb1, const void* wb2,
                                const void* bb2, const void* w2,
                                const void* b2, const void* w3,
                                const void* b3, void* out, int B, int H,
                                int W, int n, int shortcut, void* stream) {
  return launch<false>(nullptr, x, 0, cin, 0, w1, b1, wb1, bb1, wb2, bb2,
                       w2, b2, w3, b3, out, B, H, W, n, shortcut, stream);
}

extern "C" int unina_fused_c3k2_cat(const void* xa, const void* xb, int ca,
                                    int cb, int up_a, const void* w1,
                                    const void* b1, const void* wb1,
                                    const void* bb1, const void* wb2,
                                    const void* bb2, const void* w2,
                                    const void* b2, const void* w3,
                                    const void* b3, void* out, int B, int H,
                                    int W, int n, int shortcut,
                                    void* stream) {
  if (ca <= 0) return (int)cudaErrorInvalidValue;
  return launch<true>(xa, xb, ca, cb, up_a, w1, b1, wb1, bb1, wb2, bb2, w2,
                      b2, w3, b3, out, B, H, W, n, shortcut, stream);
}
