// Fused decoupled detection head: both branches in one pass over x, the
// 3x3 convs on the tensor cores.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/head_kernel.py fused_head
//   (_pallas_head, pallas_call at :127 gridless / :137 row-gridded).
//   Per branch (cls, reg), over the same input x (H, W, 64):
//     c1   = bf16(ReLU(conv3x3(x)  + b1))
//     c2   = bf16(ReLU(conv3x3(c1) + b2))
//     pred = c2 @ wp + bp      (f32, never rounded to bf16)
//   The TPU kernel writes one (H, W, Ccls+4) f32 block that its caller
//   splits; this kernel writes the cls and reg predictions as two
//   contiguous f32 tensors, which the decode kernel takes as they are.
//
// Bound on the H100: at head_p2, (160,160,64) -> 2 x (160,160,4), the
//   four 3x3 convs are 7.6 GFLOP over 4.1 MB: bound by operations, about
//   8 us at the bf16 tensor-core peak.
// Design: implicit GEMMs with K = 9 taps x 64 channels (operand layouts
//   in csrc/mma_sm90.cuh). Persistent blocks, one per SM, walk 8 x 16
//   output tiles; a block is two warpgroups, one per branch.
//   - x on the tile plus a 2-pixel halo (12 x 20 bf16 pixels, zero-filled
//     outside the image by cp.async) is staged once for both branches.
//   - conv1 runs on the tile plus a 1-pixel halo: 180 pixels, padded to
//     three m64 products per branch (96 f32 accumulators a thread). Its
//     result goes to shared memory already rounded to bf16, and 0 where
//     the halo pixel lies outside the image: that is the zero padding
//     conv2 must see, in rows and in columns, not ReLU(b1). conv2 is two
//     m64 products per branch over that c1.
//   - The weights are packed on the host as 18 slabs (conv1 taps, then
//     conv2 taps) of [cls | reg] swizzled B tiles; both convs' taps
//     stream through a two-slot ring per warpgroup, tap s+1 copied by
//     cp.async under tap s's products. The warpgroups only meet at the
//     tile boundary, so one's barriers and epilogues overlap the other's
//     products.
//   - conv2's accumulators become the A fragments of a warp-level
//     m16n8k16 product with the 1x1 pred weights (bf16-rounded c2, f32
//     accumulate, up to 8 outputs), so c2 never leaves registers.
// That tiled kernel is compiled for C = 64 (P2); any other width goes to
// the wide form at the end of this file (warp-level products,
// csrc/wide_mma.cuh). The entry point picks the form by C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wide_mma.cuh"

namespace {

using namespace mma90;
typedef __nv_bfloat16 bf16;

constexpr int C = 64;            // head width (P2 channels)
constexpr int TR = 8, TW = 16;   // output tile
constexpr int XR = TR + 4, XC = TW + 4;  // x window (halo 2)
constexpr int CR = TR + 2, CC = TW + 2;  // conv1 window (halo 1)
constexpr int C1_PX = CR * CC;   // 180, computed as 3 x 64 rows
constexpr int MT1 = 3, MT2 = 2;  // m64 products of conv1 / conv2
constexpr int NOMAX = 8;         // pred outputs per branch
constexpr int TAPS = 18;         // conv1's nine, then conv2's nine
constexpr int X_BYTES = XR * XC * PIX_BYTES;
constexpr int C1_BYTES = C1_PX * PIX_BYTES;
constexpr int RING_BYTES = 2 * B_TILE_BYTES;  // per warpgroup
constexpr int THREADS = 256;
constexpr int SMEM_BYTES = 1024 + 2 * RING_BYTES + X_BYTES + 2 * C1_BYTES;
static_assert(MT1 * 64 >= C1_PX && MT2 * 64 == TR * TW, "m64 products");
static_assert(TW == 16, "conv2 rows are m >> 4");

struct Branch {
  const float* b1;
  const float* b2;
  const bf16* wp;   // (C, no)
  const float* bp;  // (no,)
  int no;
  float* out;       // (B, H, W, no)
};

__global__ void __launch_bounds__(THREADS, 1)
head_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w33,
                Branch cls, Branch reg, int H, int W, int tiles_x,
                int tiles_y, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;  // 0: cls branch, 1: reg branch
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t ring = base + wg * RING_BYTES;
  const uint32_t x_s = base + 2 * RING_BYTES;
  const uint32_t c1_s = x_s + X_BYTES + wg * C1_BYTES;
  unsigned char* c1_p = smem_raw + (c1_s - smem_u32(smem_raw));
  const Branch br = wg == 0 ? cls : reg;
  // slab s of this branch: w33 + (s * 2 + wg) tiles
  const bf16* wsrc = w33 + (size_t)wg * (B_TILE_BYTES / 2);

  // this lane's A rows: conv1 over x (m < 180 real, the rest repeat the
  // last pixel and are dropped), conv2 over c1
  int xpix[MT1], cpix[MT2];
#pragma unroll
  for (int mt = 0; mt < MT1; ++mt) {
    int m = min(mt * 64 + warp * 16 + (lane & 15), C1_PX - 1);
    xpix[mt] = (m / CC) * XC + m % CC;
  }
#pragma unroll
  for (int mt = 0; mt < MT2; ++mt) {
    int m = mt * 64 + warp * 16 + (lane & 15);
    cpix[mt] = (m >> 4) * CC + (m & 15);
  }
  // pred weights as m16n8k16 B fragments: k = 16 ks + 2 tq (+1) (+8), n = g
  uint32_t wpf[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      int k = 16 * ks + 8 * h + 2 * tq;
      bf16 lo = g < br.no ? br.wp[k * br.no + g] : __float2bfloat16_rn(0.f);
      bf16 hi =
          g < br.no ? br.wp[(k + 1) * br.no + g] : __float2bfloat16_rn(0.f);
      wpf[ks][h] = (uint32_t)__bfloat16_as_ushort(lo) |
                   ((uint32_t)__bfloat16_as_ushort(hi) << 16);
    }

  float acc[MT1][32];
  uint32_t a[MT1][4][4];

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_x * tiles_y);
    const int rem = tile - b * tiles_x * tiles_y;
    const int R0 = (rem / tiles_x) * TR, W0 = (rem % tiles_x) * TW;
    const bf16* xb = x + (size_t)b * H * W * C;

    __syncthreads();  // both branches are done with the previous x window
    // x window: row R0-2+xr, column W0-2+xc; zeros outside the image
    for (int i = threadIdx.x; i < XR * XC * 8; i += THREADS) {
      int ch = i & 7, p = i >> 3;
      int xr = p / XC, xc = p - xr * XC;
      int gy = R0 - 2 + xr, gx = W0 - 2 + xc;
      bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* src = ok ? xb + ((size_t)gy * W + gx) * C + ch * 8 : xb;
      cp_async16(x_s + pix_chunk(p, ch), src, ok ? 16 : 0);
    }
    for (int i = t; i < B_TILE_BYTES / 16; i += 128)
      cp_async16(ring + i * 16, wsrc + i * 8, 16);
    cp_async_commit();

#pragma unroll
    for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[mt][j] = 0.f;

#pragma unroll 1
    for (int s = 0; s < TAPS; ++s) {
      // slab s has landed, tap s-1's products are done: its slot is free
      cp_async_wait<0>();
      fence_proxy_async();
      wgmma_wait<0>();
      if (s == 0)
        __syncthreads();  // the x window came from all 256 threads
      else
        warpgroup_barrier(1 + wg);
      if (s + 1 < TAPS) {
        const bf16* src = wsrc + (size_t)(s + 1) * B_TILE_BYTES;  // 2 tiles
        const uint32_t dst = ring + ((s + 1) & 1) * B_TILE_BYTES;
        for (int i = t; i < B_TILE_BYTES / 16; i += 128)
          cp_async16(dst + i * 16, src + i * 8, 16);
        cp_async_commit();
      }
      const uint64_t desc = b_desc(ring + (s & 1) * B_TILE_BYTES);
      if (s < 9) {
        const int shift = (s / 3) * XC + s % 3;
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt)
          load_a64(a[mt], x_s, xpix[mt] + shift, lane);
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < MT1; ++mt) mma_a64(acc[mt], a[mt], desc);
        wgmma_commit();
        if (s == 8) {
          // conv1 done: bias, ReLU, bf16, the image mask -> c1
          wgmma_wait<0>();
#pragma unroll
          for (int mt = 0; mt < MT1; ++mt)
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int m = mt * 64 + warp * 16 + g + 8 * half;
              if (m < C1_PX) {
                const int gy = R0 - 1 + m / CC, gx = W0 - 1 + m % CC;
                const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                  const int col = 8 * j + 2 * tq;
                  float v0 = fmaxf(__fadd_rn(acc[mt][4 * j + 2 * half],
                                             __ldg(br.b1 + col)), 0.f);
                  float v1 = fmaxf(__fadd_rn(acc[mt][4 * j + 2 * half + 1],
                                             __ldg(br.b1 + col + 1)), 0.f);
                  *reinterpret_cast<uint32_t*>(c1_p + pix_chunk(m, j) +
                                               tq * 4) =
                      inside ? pack_bf16(v0, v1) : 0u;
                }
              }
            }
#pragma unroll
          for (int mt = 0; mt < MT2; ++mt)
#pragma unroll
            for (int j = 0; j < 32; ++j) acc[mt][j] = 0.f;
        }
      } else {
        const int tap = s - 9;
        const int shift = (tap / 3) * CC + tap % 3;
#pragma unroll
        for (int mt = 0; mt < MT2; ++mt)
          load_a64(a[mt], c1_s, cpix[mt] + shift, lane);
        wgmma_fence();
#pragma unroll
        for (int mt = 0; mt < MT2; ++mt) mma_a64(acc[mt], a[mt], desc);
        wgmma_commit();
      }
    }
    wgmma_wait<0>();

    // c2 = bf16(ReLU(conv2 + b2)) straight into A fragments; the 1x1 pred
    // on them in f32
#pragma unroll
    for (int mt = 0; mt < MT2; ++mt) {
      float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t af[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // q: 0 row g, 1 row g+8 (columns 16ks+2tq), 2/3 the same +8
          const int col = 16 * ks + 8 * (q >> 1) + 2 * tq;
          af[q] = pack_bf16(
              fmaxf(__fadd_rn(acc[mt][8 * ks + 2 * q], __ldg(br.b2 + col)),
                    0.f),
              fmaxf(__fadd_rn(acc[mt][8 * ks + 2 * q + 1],
                              __ldg(br.b2 + col + 1)), 0.f));
        }
        mma_m16n8k16(pd, af, wpf[ks]);
      }
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 64 + warp * 16 + g + 8 * half;
        const int gy = R0 + (m >> 4), gx = W0 + (m & 15);
        if (gy < H && gx < W) {
          float* o = br.out + (((size_t)b * H + gy) * W + gx) * br.no;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 2 * tq + e;
            if (col < br.no)
              o[col] = __fadd_rn(pd[2 * half + e], __ldg(br.bp + col));
          }
        }
      }
    }
  }
}

// ---- the wide form: any other width C, warp-level products ----
//
// The P3/P4 heads of the bf16 engines (C = 128 and 256) do not fit the
// tiled kernel above: its conv1 accumulators alone would be 2-4x the
// registers. This form keeps the activations in shared memory and reads
// the weights as m16n8k16 B fragments from global memory (L2,
// csrc/wide_mma.cuh). A block is one branch of one 8 x 8 output tile
// (blockIdx.y: 0 cls, 1 reg), eight warps:
//   conv1 on the tile plus a 1-pixel halo (100 pixels), K = 9 x C, over
//     the x window with a 2-pixel halo; c1 = bf16(ReLU(acc + b1)), 0
//     outside the image, into shared memory;
//   conv2 on the tile (64 pixels) over c1; c2 = bf16(ReLU(acc + b2)) into
//     the x window's space;
//   pred = c2 @ wp + bp, f32, one n8 tile (up to 8 outputs), four warps.
// Bound on the H100 at head_p4 (40 x 40 x 256): 3.8 GFLOP over 1 MB of
// activations and 4.7 MB of weights, about 4 us at the bf16 peak.
namespace wide_head {

using namespace wide;

constexpr int TR = 8, TW = 8;
constexpr int XR = TR + 4, XC = TW + 4;   // x window (halo 2)
constexpr int CR = TR + 2, CC = TW + 2;   // conv1 region (halo 1)
constexpr int WARPS = 8, THREADS = WARPS * 32;

__host__ __device__ inline int smem_bytes(int c) {
  return (XR * XC + CR * CC) * row_bytes(c);
}

struct Branch {
  const float* b1;
  const float* b2;
  const bf16* wp;   // (C, no)
  const float* bp;  // (no,)
  int no;
  float* out;       // (B, H, W, no)
};

__global__ void __launch_bounds__(THREADS, 1)
head_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w33,
                 Branch cls, Branch reg, int C, int H, int W, int tiles_x,
                 int tiles_y) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int br_i = blockIdx.y;
  const Branch br = br_i == 0 ? cls : reg;
  const int RB = row_bytes(C), KS = C >> 4;
  const uint32_t x_s = smem_u32(wide_smem);
  const uint32_t c1_s = x_s + XR * XC * RB;
  const uint32_t c2_s = x_s;  // conv2's output reuses the x window
  unsigned char* c1_p = wide_smem + XR * XC * RB;
  unsigned char* c2_p = wide_smem;
  // the branch's 3x3 weights: w33 = [wc1 | wr1 | wc2 | wr2] fragment images
  const size_t mat = (size_t)9 * C * C / 4;  // uint2 of one (9C, C) image
  const uint2* wq1 = reinterpret_cast<const uint2*>(w33) + br_i * mat;
  const uint2* wq2 = reinterpret_cast<const uint2*>(w33) + (2 + br_i) * mat;

  const int tile = blockIdx.x;
  const int b = tile / (tiles_x * tiles_y);
  const int rem = tile - b * tiles_x * tiles_y;
  const int R0 = (rem / tiles_x) * TR, W0 = (rem % tiles_x) * TW;
  const bf16* xb = x + (size_t)b * H * W * C;
  const int lrow = lane & 15, lhalf = (lane >> 4) * 16;

  // x window: row R0-2+xr, column W0-2+xc; zeros outside the image
  const int c8 = C >> 3;
  for (int i = threadIdx.x; i < XR * XC * c8; i += THREADS) {
    const int p = i / c8, q = i - p * c8;
    const int xr = p / XC, xc = p - xr * XC;
    const int gy = R0 - 2 + xr, gx = W0 - 2 + xc;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const bf16* src = ok ? xb + ((size_t)gy * W + gx) * C + q * 8 : xb;
    cp_async16(x_s + p * RB + q * 16, src, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const int nc = (C + 63) >> 6;
  // ---- conv1 on the tile plus a 1-pixel halo ----
  {
    constexpr int RP = CR * CC;
    const int mt = (RP + 15) >> 4;
    for (int item = warp; item < mt * nc; item += WARPS) {
      const int m0 = (item / nc) * 16, nt0 = (item % nc) * 8;
      const int nj = min(NJ, (C >> 3) - nt0);
      const int m = min(m0 + lrow, RP - 1);
      const int xp = (m / CC) * XC + m % CC;  // its top-left tap
      float acc[NJ][4];
      zero(acc);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        gemm_k(acc, x_s + (xp + (tap / 3) * XC + tap % 3) * RB + lhalf, KS,
               wq1, 9 * KS, tap * KS, nt0, nj, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = m0 + g + 8 * half;
        if (mm >= RP) continue;
        const int gy = R0 - 1 + mm / CC, gx = W0 - 1 + mm % CC;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) continue;
          const int col = (nt0 + j) * 8 + 2 * tq;
          const uint32_t v =
              relu_pack(acc[j][2 * half], acc[j][2 * half + 1], br.b1 + col);
          *reinterpret_cast<uint32_t*>(c1_p + mm * RB + col * 2) =
              inside ? v : 0u;
        }
      }
    }
  }
  __syncthreads();
  // ---- conv2 on the tile ----
  {
    constexpr int RP = TR * TW;
    const int mt = RP >> 4;
    for (int item = warp; item < mt * nc; item += WARPS) {
      const int m0 = (item / nc) * 16, nt0 = (item % nc) * 8;
      const int nj = min(NJ, (C >> 3) - nt0);
      const int m = m0 + lrow;
      const int cp = (m / TW) * CC + m % TW;  // its top-left tap in c1
      float acc[NJ][4];
      zero(acc);
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap)
        gemm_k(acc, c1_s + (cp + (tap / 3) * CC + tap % 3) * RB + lhalf, KS,
               wq2, 9 * KS, tap * KS, nt0, nj, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = m0 + g + 8 * half;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) continue;
          const int col = (nt0 + j) * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(c2_p + mm * RB + col * 2) =
              relu_pack(acc[j][2 * half], acc[j][2 * half + 1], br.b2 + col);
        }
      }
    }
  }
  __syncthreads();
  // ---- pred = c2 @ wp + bp (f32), warps 0-3 one m16 tile each ----
  if (warp < (TR * TW) / 16) {
    const int m0 = warp * 16;
    const uint32_t arow = c2_s + (m0 + lrow) * RB + lhalf;
    float pd[4] = {0.f, 0.f, 0.f, 0.f};
    const bf16 zero_bf = __float2bfloat16_rn(0.f);
#pragma unroll 1
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, arow + ks * 32);
      uint32_t bfr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 16 * ks + 8 * h + 2 * tq;
        const bf16 lo = g < br.no ? br.wp[k * br.no + g] : zero_bf;
        const bf16 hi = g < br.no ? br.wp[(k + 1) * br.no + g] : zero_bf;
        bfr[h] = (uint32_t)__bfloat16_as_ushort(lo) |
                 ((uint32_t)__bfloat16_as_ushort(hi) << 16);
      }
      mma_m16n8k16(pd, a, bfr);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int mm = m0 + g + 8 * half;
      const int gy = R0 + mm / TW, gx = W0 + mm % TW;
      if (gy < H && gx < W) {
        float* o = br.out + (((size_t)b * H + gy) * W + gx) * br.no;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * tq + e;
          if (col < br.no)
            o[col] = __fadd_rn(pd[2 * half + e], __ldg(br.bp + col));
        }
      }
    }
  }
}

int launch(const bf16* x, const bf16* w33, Branch cls, Branch reg, int C,
           int B, int H, int W, void* stream) {
  if (C <= 0 || C % 16) return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(C);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        head_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TR - 1) / TR;
  const dim3 grid(tiles_x * tiles_y * B, 2);
  head_wide_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      x, w33, cls, reg, C, H, W, tiles_x, tiles_y);
  return (int)cudaGetLastError();
}

}  // namespace wide_head

}  // namespace

extern "C" int unina_fused_head(const void* x, const void* w33,
                                const void* bc1, const void* bc2,
                                const void* wcp, const void* bcp, int nc,
                                const void* br1, const void* br2,
                                const void* wrp, const void* brp, int nr,
                                void* out_cls, void* out_reg, int B, int H,
                                int W, int c, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || nc < 1 || nc > NOMAX || nr < 1 ||
      nr > NOMAX)
    return (int)cudaErrorInvalidValue;
  if (c != C) {
    wide_head::Branch wc{(const float*)bc1, (const float*)bc2,
                         (const bf16*)wcp, (const float*)bcp, nc,
                         (float*)out_cls};
    wide_head::Branch wr{(const float*)br1, (const float*)br2,
                         (const bf16*)wrp, (const float*)brp, nr,
                         (float*)out_reg};
    return wide_head::launch((const bf16*)x, (const bf16*)w33, wc, wr, c, B,
                             H, W, stream);
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(head_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  Branch cls{(const float*)bc1, (const float*)bc2, (const bf16*)wcp,
             (const float*)bcp, nc, (float*)out_cls};
  Branch reg{(const float*)br1, (const float*)br2, (const bf16*)wrp,
             (const float*)brp, nr, (float*)out_reg};
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TR - 1) / TR;
  const int ntiles = tiles_x * tiles_y * B;
  const int blocks = ntiles < sms ? ntiles : sms;
  head_mma_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w33, cls, reg, H, W, tiles_x, tiles_y,
      ntiles);
  return (int)cudaGetLastError();
}
