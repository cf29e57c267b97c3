// Fused C3k2 block (CSP split-process-concat) in one pass, and its pair
// form over concat([upsample2x?(xa), xb]), on the tensor cores.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/c3k2_kernel.py
//   fused_c3k2     (_pallas_c3k2, pallas_call at :324 gridless / :338
//                   row-gridded)       -> entry point unina_fused_c3k2
//   fused_c3k2_cat (_pallas_c3k2_cat, pallas_call at :356 / :371)
//                                      -> entry point unina_fused_c3k2_cat
//   p1 = bf16(ReLU(x @ w1 + b1)), p2 = bf16(ReLU(x @ w2 + b2)); n times
//   t = bf16(ReLU(p1 @ wb1 + bb1)), t = bf16(ReLU(conv3x3(t) + bb2)),
//   p1 = bf16(p1 + t) (or t without shortcut); then
//   out = bf16(ReLU(p1 @ w3[:h] + p2 @ w3[h:] + b3)). In the pair form the
//   first products run over xa's and xb's channels, with xa read at its
//   coarse pixel (r/2, c/2) when it is upsampled. The split sums of the
//   TPU kernel ((za + zb) + b, (p1 @ w3a + p2 @ w3b) + b3) are one f32
//   accumulator each here: only the summation order differs. Every point
//   where the TPU kernel rounds to bf16 is a rounding point here.
//
// Bound on the H100: at stage1_block, (160,160,64) -> (160,160,64) with
//   hidden 32, the block moves 6.6 MB (input once, output once) for
//   0.94 GFLOP: bound by bytes (~2 us against ~1 us of bf16 tensor-core
//   time); every intermediate stays on chip.
// Design: implicit GEMMs over NHWC pixels (operand layouts in
//   csrc/mma_sm90.cuh). Persistent blocks of two warpgroups, as many per
//   SM as their shared memory allows (two at the served shapes), walk
//   8 x 16 output tiles; the warpgroups share a tile and split each
//   stage's m64 products. All weights (36-44 KB, packed on the host into
//   swizzled B tiles) are copied to shared memory once per block. Per
//   tile, on the tile plus a halo of n pixels (one per chained 3x3):
//   A  [p1 | p2] = ReLU(xwin @ [w1 | w2] + [b1 | b2]), one N = 64 product
//      over K = Ca + Cb in 64-deep chunks (zero-filled by cp.async where
//      Ca or Cb is no multiple of 64), M = the window's 180 (n = 1) or 240
//      pixels as three or four m64 products. The result is one 64-channel
//      pixel in the `p` window, 0 outside the image. xa's chunk reads a
//      coarse window at (r >> 1, c >> 1): every lane gives ldmatrix its
//      own row address, so the upsample costs no copy.
//   B  t = ReLU(p1 @ wb1 + bb1) on the same pixels, K = 32 (the first half
//      of the p pixel), N = 32 (wgmma m64n32k16), 0 outside the image,
//      into a `t` window of 64-byte pixels. For the first bottleneck A's
//      rounded accumulators are B's A fragments as they lie in the
//      registers (a 1x1 needs no neighbour), so A and B are one pass.
//   C  the 3x3 over t on the window shrunk by one pixel: nine taps x
//      K = 32, N = 32, A double-buffered by tap; u = bf16(ReLU(acc + bb2))
//      and p1 = bf16(p1 + u) (or u) back into the p window's first half, 0
//      outside the image. For n = 2, B and C repeat, C one pixel smaller.
//   D  out = ReLU([p1 | p2] @ w3 + b3): one K = 64, N = 64 product over the
//      tile's 128 pixels, out through shared memory as 16-byte stores. The
//      last bottleneck's C covers exactly the tile, so its new p1 goes to
//      D in registers too (p2 comes from the p window): C and D are one
//      pass, and a tile takes two block-wide barriers between its stages.
//   Halo pixels outside the image are set to 0 after every stage, so each
//   3x3 sees the image's zero padding in rows and columns. Edge tiles are
//   masked: any H, W and batch; n = 1 or 2; Ca, Cb multiples of 8.
// That tiled kernel is compiled for hidden 32 and F 64 (the int8 engine's
// float blocks); every other width goes to the wide form at the end of
// this file (warp-level products, csrc/wide_mma.cuh). The entry points
// pick the form by (hidden, F).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wide_mma.cuh"

namespace {

using namespace mma90;
typedef __nv_bfloat16 bf16;

constexpr int HID = 32;   // hidden width (C3k2 features // 2)
constexpr int FO = 64;    // output features
constexpr int TR = 8, TW = 16;  // output tile
constexpr int NMAX = 2;   // bottlenecks (the halo) the plan covers
constexpr int AR = TR / 2 + 2, AC = TW / 2 + 2;  // coarse xa window
constexpr int WGS = 2;                           // warpgroups of a block
constexpr int THREADS = WGS * 128;
constexpr int T_PIX_BYTES = 2 * HID;             // one t pixel
constexpr int N32_TILE_BYTES = B_TILE_BYTES / 2; // one [32 n][64 k] tile
// per bottleneck ten K = 32 slabs (wb1, then the nine taps), two a tile
constexpr int BN_TILES = 5;
constexpr int SMEM_MAX = 232448;  // 227 KB a block
static_assert(TW == 16 && TR * TW == 128, "stage D: two m64 products");

struct Params {
  const bf16* xa;   // (B, Ha, Wa, ca), pair form only
  const bf16* xb;   // (B, H, W, cb)
  const bf16* wpk;  // pack_c3k2_mma image
  const float *b1, *bb1, *bb2, *b2, *b3;
  bf16* out;        // (B, H, W, FO)
  int ca, cb, up_a, H, W, n, shortcut, tiles_x, tiles_y, ntiles;
};

__host__ __device__ inline int chunks64(int c) { return (c + 63) >> 6; }
__host__ __device__ inline int weight_bytes(int kc, int n) {
  return kc * B_TILE_BYTES + n * BN_TILES * N32_TILE_BYTES + B_TILE_BYTES;
}
// shared memory of one block (1024 bytes of alignment slack included)
__host__ __device__ inline int smem_bytes(int ca, int cb, int up_a, int n) {
  const int wp = (TR + 2 * n) * (TW + 2 * n);
  const int apx = up_a ? AR * AC : wp;
  return 1024 + weight_bytes(chunks64(ca) + chunks64(cb), n) +
         (chunks64(ca) * apx + chunks64(cb) * wp + wp) * PIX_BYTES +
         wp * T_PIX_BYTES;
}

// byte offset of 16-byte chunk `chunk` (0..3) of pixel `pix` in the t
// window: two 64-byte pixels share a 128-byte line, so eight consecutive
// pixels spread over all banks with chunk ^ ((pix >> 1) & 3)
__device__ __forceinline__ uint32_t t_chunk(int pix, int chunk) {
  return (uint32_t)(pix * T_PIX_BYTES + ((chunk ^ ((pix >> 1) & 3)) << 4));
}

// The A fragment of k16 step `ks` of a K = 32 product, from the bf16 pairs
// an epilogue has just rounded: pk[half][j] holds rows g + 8 half, columns
// 8j + 2tq (+1) of this warp's 16 rows.
__device__ __forceinline__ void frag_from_pairs(uint32_t (&af)[4],
                                                const uint32_t (&pk)[2][4],
                                                int ks) {
  af[0] = pk[0][2 * ks];
  af[1] = pk[1][2 * ks];
  af[2] = pk[0][2 * ks + 1];
  af[3] = pk[1][2 * ks + 1];
}

// t's epilogue: ReLU(acc + bb1), 0 outside the image, bf16 into the t
// window, for this thread's rows of product `mt` over the window
__device__ __forceinline__ void store_t(const float (&acc)[16],
                                        const float* bb1, unsigned char* t_p,
                                        int mt, int warp, int g, int tq,
                                        int WP, int WC, int gy0, int gx0,
                                        int H, int W) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int mm = mt * 64 + warp * 16 + g + 8 * half;
    if (mm < WP) {
      const int gy = gy0 + mm / WC, gx = gx0 + mm % WC;
      const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = 8 * j + 2 * tq;
        float v0 =
            fmaxf(__fadd_rn(acc[4 * j + 2 * half], __ldg(bb1 + col)), 0.f);
        float v1 = fmaxf(
            __fadd_rn(acc[4 * j + 2 * half + 1], __ldg(bb1 + col + 1)), 0.f);
        *reinterpret_cast<uint32_t*>(t_p + t_chunk(mm, j) + tq * 4) =
            inside ? pack_bf16(v0, v1) : 0u;
      }
    }
  }
}

// CAT: the pair form (xa's chunks before xb's); a template parameter so
// that the two forms are two device functions, told apart by name.
template <bool CAT>
__global__ void __launch_bounds__(THREADS, 2)
c3k2_kernel(const Params P) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int t = threadIdx.x;
  const int wg = t >> 7, warp = (t >> 5) & 3, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n = P.n, H = P.H, W = P.W;
  const int WC = TW + 2 * n, WP = (TR + 2 * n) * WC;  // window + halo n
  const int MTA = (WP + 63) >> 6;
  const int KA = CAT ? chunks64(P.ca) : 0, KB = chunks64(P.cb);
  const int KC = KA + KB;
  const bool up = CAT && P.up_a;
  const int APX = up ? AR * AC : WP;
  const int Ha = up ? H / 2 : H, Wa = up ? W / 2 : W;

  const uint32_t wa_s = base;                       // stage A: KC tiles
  const uint32_t wbn_s = wa_s + KC * B_TILE_BYTES;  // n x BN_TILES
  const uint32_t w3_s = wbn_s + n * BN_TILES * N32_TILE_BYTES;
  const uint32_t xa_s = w3_s + B_TILE_BYTES;        // KA windows
  const uint32_t xb_s = xa_s + KA * APX * PIX_BYTES;  // KB windows
  const uint32_t p_s = xb_s + KB * WP * PIX_BYTES;  // [p1 | p2]
  const uint32_t t_s = p_s + WP * PIX_BYTES;
  unsigned char* p_p = smem_raw + (p_s - raw);
  unsigned char* t_p = smem_raw + (t_s - raw);
  // the staged output tile reuses xb's first window (dead after stage A)
  unsigned char* o_p = smem_raw + (xb_s - raw);

  for (int i = t; i < weight_bytes(KC, n) / 16; i += THREADS)
    cp_async16(wa_s + i * 16, P.wpk + i * 8, 16);
  cp_async_commit();  // waited for with the first tile's windows

  for (int tile = blockIdx.x; tile < P.ntiles; tile += gridDim.x) {
    const int b = tile / (P.tiles_x * P.tiles_y);
    const int rem = tile - b * P.tiles_x * P.tiles_y;
    const int R0 = (rem / P.tiles_x) * TR, W0 = (rem % P.tiles_x) * TW;
    const bf16* xb_b = P.xb + (size_t)b * H * W * P.cb;
    bf16* out_b = P.out + (size_t)b * H * W * FO;
    // coarse window origin (up): fine rows R0-n.. start at (R0 >> 1) - 1
    const int ay0 = up ? (R0 >> 1) - 1 : R0 - n;
    const int ax0 = up ? (W0 >> 1) - 1 : W0 - n;

    __syncthreads();  // the previous tile's copy-out is done with o_p
    // windows: pixel (wr, wc) <- image (R0-n+wr, W0-n+wc), 64 channels a
    // chunk; zeros outside the image and past the last channel
    for (int i = t; i < KB * WP * 8; i += THREADS) {
      const int ch = i & 7, pq = i >> 3;
      const int q = pq / WP, p = pq - q * WP;
      const int wr = p / WC, wc = p - wr * WC;
      const int gy = R0 - n + wr, gx = W0 - n + wc, c0 = q * 64 + ch * 8;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 < P.cb;
      const bf16* src = ok ? xb_b + ((size_t)gy * W + gx) * P.cb + c0 : xb_b;
      cp_async16(xb_s + q * WP * PIX_BYTES + pix_chunk(p, ch), src,
                 ok ? 16 : 0);
    }
    if constexpr (CAT) {
      const bf16* xa_b = P.xa + (size_t)b * Ha * Wa * P.ca;
      const int AWC = up ? AC : WC;
      for (int i = t; i < KA * APX * 8; i += THREADS) {
        const int ch = i & 7, pq = i >> 3;
        const int q = pq / APX, p = pq - q * APX;
        const int ar = p / AWC, ac = p - ar * AWC;
        const int ay = ay0 + ar, ax = ax0 + ac, c0 = q * 64 + ch * 8;
        const bool ok =
            ay >= 0 && ay < Ha && ax >= 0 && ax < Wa && c0 < P.ca;
        const bf16* src =
            ok ? xa_b + ((size_t)ay * Wa + ax) * P.ca + c0 : xa_b;
        cp_async16(xa_s + q * APX * PIX_BYTES + pix_chunk(p, ch), src,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();  // the weights are wgmma's B (first tile)
    __syncthreads();

    // ---- A: [p1 | p2] on the window, and the first bottleneck's B ----
#pragma unroll 1
    for (int mt = wg; mt < MTA; mt += WGS) {
      // this lane's A row; rows past the window repeat its last pixel
      const int m = min(mt * 64 + warp * 16 + (lane & 15), WP - 1);
      int pa = m;
      if (up) {
        const int wr = m / WC, wc = m - wr * WC;
        pa = (((R0 - n + wr) >> 1) - ay0) * AC + (((W0 - n + wc) >> 1) - ax0);
      }
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
      uint32_t a[4][4];
#pragma unroll 1
      for (int q = 0; q < KC; ++q) {
        if (q < KA)
          load_a64(a, xa_s + q * APX * PIX_BYTES, pa, lane);
        else
          load_a64(a, xb_s + (q - KA) * WP * PIX_BYTES, m, lane);
        wgmma_fence();
        mma_a64(acc, a, b_desc(wa_s + q * B_TILE_BYTES));
        wgmma_commit();
        wgmma_wait<0>();
      }
      uint32_t p1[2][4];  // the rounded p1 of this thread's rows
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = mt * 64 + warp * 16 + g + 8 * half;
        const int gy = R0 - n + mm / WC, gx = W0 - n + mm % WC;
        const bool inside =
            mm < WP && gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * tq;
          const float* bias = j < 4 ? P.b1 + col : P.b2 + col - HID;
          float v0 =
              fmaxf(__fadd_rn(acc[4 * j + 2 * half], __ldg(bias)), 0.f);
          float v1 = fmaxf(
              __fadd_rn(acc[4 * j + 2 * half + 1], __ldg(bias + 1)), 0.f);
          const uint32_t v = inside ? pack_bf16(v0, v1) : 0u;
          if (j < 4) p1[half][j] = v;
          if (mm < WP)
            *reinterpret_cast<uint32_t*>(p_p + pix_chunk(mm, j) + tq * 4) = v;
        }
      }
      float acc2[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) acc2[j] = 0.f;
      uint32_t af[2][4];
      frag_from_pairs(af[0], p1, 0);
      frag_from_pairs(af[1], p1, 1);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        wgmma_m64n32k16(acc2, af[ks],
                        b_desc(wbn_s) + (uint64_t)(ks * 32 >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      store_t(acc2, P.bb1, t_p, mt, warp, g, tq, WP, WC, R0 - n, W0 - n, H,
              W);
    }
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const uint32_t wb_s = wbn_s + i * BN_TILES * N32_TILE_BYTES;
      const float* bb2 = P.bb2 + i * HID;
      if (i > 0) {
        // ---- B: t = ReLU(p1 @ wb1 + bb1) on the window ----
#pragma unroll 1
        for (int mt = wg; mt < MTA; mt += WGS) {
          const int m = min(mt * 64 + warp * 16 + (lane & 15), WP - 1);
          float acc[16];
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[j] = 0.f;
          uint32_t a[2][4];
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            ldmatrix_x4(a[ks], p_s + pix_chunk(m, 2 * ks + (lane >> 4)));
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            wgmma_m64n32k16(acc, a[ks],
                            b_desc(wb_s) + (uint64_t)(ks * 32 >> 4));
          wgmma_commit();
          wgmma_wait<0>();
          store_t(acc, P.bb1 + i * HID, t_p, mt, warp, g, tq, WP, WC, R0 - n,
                  W0 - n, H, W);
        }
        __syncthreads();
      }

      // ---- C: the 3x3 over t, residual into p1; D after the last ----
      // the region this bottleneck's result is needed on: the tile plus a
      // halo of hh pixels, at (off, off) in the window
      const bool last = i == n - 1;
      const int hh = n - 1 - i, off = n - hh;
      const int RC = TW + 2 * hh, RP = (TR + 2 * hh) * RC;
      const int MTC = (RP + 63) >> 6;
#pragma unroll 1
      for (int mt = wg; mt < MTC; mt += WGS) {
        const int m = min(mt * 64 + warp * 16 + (lane & 15), RP - 1);
        const int tp0 = (m / RC + off - 1) * WC + (m % RC + off - 1);
        float acc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[j] = 0.f;
        uint32_t a[2][2][4];
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
          const int tp = tp0 + (tap / 3) * WC + tap % 3;
          const int slab = 1 + tap;  // slab 0 is wb1
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            ldmatrix_x4(a[tap & 1][ks],
                        t_s + t_chunk(tp, 2 * ks + (lane >> 4)));
          wgmma_fence();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            wgmma_m64n32k16(
                acc, a[tap & 1][ks],
                b_desc(wb_s + (slab >> 1) * N32_TILE_BYTES) +
                    (uint64_t)(((slab & 1) * 64 + ks * 32) >> 4));
          wgmma_commit();
          wgmma_wait<1>();  // tap - 1 is done with the other A buffer
        }
        wgmma_wait<0>();
        uint32_t p1[2][4];  // the new p1 of this thread's rows
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int mm = mt * 64 + warp * 16 + g + 8 * half;
          const bool real = mm < RP;
          const int wr = mm / RC + off, wc = mm % RC + off;
          const int gy = R0 - n + wr, gx = W0 - n + wc;
          const bool inside =
              real && gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int pw = wr * WC + wc;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = 8 * j + 2 * tq;
            uint32_t* dst = reinterpret_cast<uint32_t*>(
                p_p + pix_chunk(pw, j) + tq * 4);
            uint32_t u = pack_bf16(
                fmaxf(__fadd_rn(acc[4 * j + 2 * half], __ldg(bb2 + col)),
                      0.f),
                fmaxf(__fadd_rn(acc[4 * j + 2 * half + 1],
                                __ldg(bb2 + col + 1)), 0.f));
            if (P.shortcut && real) {
              const uint32_t old = *dst;
              u = pack_bf16(__fadd_rn(bf16_lo(old), bf16_lo(u)),
                            __fadd_rn(bf16_hi(old), bf16_hi(u)));
            }
            p1[half][j] = inside ? u : 0u;
            if (real && !last) *dst = p1[half][j];
          }
        }
        if (last) {
          // ---- D: out = ReLU([p1 | p2] @ w3 + b3) on the tile; the
          // region is the tile (RP = 128, RC = TW), p1 is in registers
          float acc3[32];
#pragma unroll
          for (int j = 0; j < 32; ++j) acc3[j] = 0.f;
          uint32_t af[4][4];
          frag_from_pairs(af[0], p1, 0);
          frag_from_pairs(af[1], p1, 1);
          const int pw = ((m >> 4) + n) * WC + (m & 15) + n;
#pragma unroll
          for (int ks = 2; ks < 4; ++ks)  // p2: the pixel's second half
            ldmatrix_x4(af[ks], p_s + pix_chunk(pw, 2 * ks + (lane >> 4)));
          wgmma_fence();
          mma_a64(acc3, af, b_desc(w3_s));
          wgmma_commit();
          wgmma_wait<0>();
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int mm = mt * 64 + warp * 16 + g + 8 * half;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int col = 8 * j + 2 * tq;
              float v0 = fmaxf(
                  __fadd_rn(acc3[4 * j + 2 * half], __ldg(P.b3 + col)), 0.f);
              float v1 = fmaxf(
                  __fadd_rn(acc3[4 * j + 2 * half + 1],
                            __ldg(P.b3 + col + 1)), 0.f);
              *reinterpret_cast<uint32_t*>(o_p + pix_chunk(mm, j) +
                                           tq * 4) = pack_bf16(v0, v1);
            }
          }
        }
      }
      __syncthreads();
    }

    for (int i = t; i < TR * TW * 8; i += THREADS) {
      const int ch = i & 7, m = i >> 3;
      const int gy = R0 + (m >> 4), gx = W0 + (m & 15);
      if (gy < H && gx < W)
        *reinterpret_cast<uint4*>(out_b + ((size_t)gy * W + gx) * FO +
                                  ch * 8) =
            *reinterpret_cast<const uint4*>(o_p + pix_chunk(m, ch));
    }
  }
}

template <bool CAT>
int launch(Params P, int B, void* stream) {
  if (B <= 0 || P.H <= 0 || P.W <= 0 || P.n < 1 || P.n > NMAX ||
      P.cb <= 0 || P.cb % 8 || P.ca % 8 || (CAT && P.ca <= 0) ||
      (P.up_a && (P.H % 2 || P.W % 2)))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(P.ca, P.cb, P.up_a, P.n);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static int sms = 0;  // one per form
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(c3k2_kernel<CAT>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_MAX);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          c3k2_kernel<CAT>, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, c3k2_kernel<CAT>, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidValue;
  P.tiles_x = (P.W + TW - 1) / TW;
  P.tiles_y = (P.H + TR - 1) / TR;
  P.ntiles = P.tiles_x * P.tiles_y * B;
  const int blocks = P.ntiles < sms * per_sm ? P.ntiles : sms * per_sm;
  c3k2_kernel<CAT><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// ---- the wide form: any other (hidden, F), warp-level products ----
//
// The shapes of the bf16 engines' other C3k2s (hidden 64 or 128, F 128 or
// 256, inputs of 128 to 384 channels) do not fit the tiled weights of the
// kernel above in shared memory. This form keeps only activations there
// and reads each weight as m16n8k16 B fragments from global memory (L2,
// csrc/wide_mma.cuh). One block of eight warps a 8 x 8 output tile, the
// same stages and rounding points on the tile plus a halo of n pixels:
//   A  [p1 | p2] = ReLU(xwin @ [w1 | w2] + [b1 | b2]) on the window (the
//      input window staged by cp.async, xa's channels ahead of xb's and
//      read at the coarse pixel (r >> 1, c >> 1) when upsampled);
//   B  t = ReLU(p1 @ wb1 + bb1) on the window less i pixels;
//   C  the 3x3 over t, K = 9 taps x hidden, on one pixel less, then the
//      residual into p1;
//   D  out = ReLU([p1 | p2] @ w3 + b3) on the tile, stored from registers.
// Each stage is a set of 16-row x 64-column blocks handed to the warps in
// turn; halo pixels outside the image are 0 after every stage. Bound on
// the H100 at stage3_c3k2 (40 x 40 x 256, hidden 128, n = 2): 1.47 GFLOP
// over 1.7 MB, about 1.5 us at the bf16 peak; the 25 tiles of a 40 x 40
// image leave most SMs idle, which this simple form accepts.
namespace wide_c3k2 {

using namespace wide;

constexpr int TR = 8, TW = 8;   // output tile
constexpr int WARPS = 8, THREADS = WARPS * 32;

struct Params {
  const bf16* xa;   // (B, Ha, Wa, ca), pair form only
  const bf16* xb;   // (B, H, W, cb)
  const bf16* wimg; // pack_c3k2_mma image (fragment form)
  const float *b1, *bb1, *bb2, *b2, *b3;
  bf16* out;        // (B, H, W, fo)
  int ca, cb, up_a, H, W, n, shortcut, hid, fo, tiles_x, tiles_y;
};

__host__ __device__ inline int window_pixels(int n) {
  return (TR + 2 * n) * (TW + 2 * n);
}
// shared memory: the input window (later the t window), then [p1 | p2]
__host__ __device__ inline int smem_bytes(int cin, int hid, int n) {
  const int wp = window_pixels(n);
  const int x = wp * row_bytes(cin), t = wp * row_bytes(hid);
  return (x > t ? x : t) + wp * row_bytes(2 * hid);
}

// CAT: the pair form, a template parameter (as above) so that the two
// forms are two device functions, told apart by name
template <bool CAT>
__global__ void __launch_bounds__(THREADS, 1)
c3k2_wide_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int n = P.n, H = P.H, W = P.W, hid = P.hid, fo = P.fo;
  const int cin = P.ca + P.cb;
  const int WC = TW + 2 * n, WP = window_pixels(n);
  const int XB = row_bytes(cin), PB = row_bytes(2 * hid), TB = row_bytes(hid);
  const uint32_t x_s = smem_u32(wide_smem);
  const uint32_t t_s = x_s;  // the t window reuses the input's
  const int xt = WP * XB > WP * TB ? WP * XB : WP * TB;
  const uint32_t p_s = x_s + xt;
  unsigned char* p_p = wide_smem + xt;
  unsigned char* t_p = wide_smem;

  const int tile = blockIdx.x;
  const int b = tile / (P.tiles_x * P.tiles_y);
  const int rem = tile - b * P.tiles_x * P.tiles_y;
  const int R0 = (rem / P.tiles_x) * TR, W0 = (rem % P.tiles_x) * TW;
  const bool up = P.up_a != 0;
  const int Ha = up ? H / 2 : H, Wa = up ? W / 2 : W;
  const bf16* xa_b = P.xa + (size_t)b * Ha * Wa * P.ca;
  const bf16* xb_b = P.xb + (size_t)b * H * W * P.cb;

  // input window: pixel (wr, wc) <- image (R0-n+wr, W0-n+wc), xa's
  // channels then xb's; zeros outside the image
  const int c8 = cin >> 3;
  for (int i = threadIdx.x; i < WP * c8; i += THREADS) {
    const int p = i / c8, q = i - p * c8;
    const int wr = p / WC, wc = p - wr * WC;
    const int gy = R0 - n + wr, gx = W0 - n + wc;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const int c = q * 8;
    const bf16* src = xb_b;
    if (ok) {
      if (CAT && c < P.ca)
        src = up ? xa_b + ((size_t)(gy >> 1) * Wa + (gx >> 1)) * P.ca + c
                 : xa_b + ((size_t)gy * W + gx) * P.ca + c;
      else
        src = xb_b + ((size_t)gy * W + gx) * P.cb + (c - P.ca);
    }
    cp_async16(x_s + p * XB + c * 2, src, ok ? 16 : 0);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  const uint2* w12 = reinterpret_cast<const uint2*>(P.wimg);
  const int KSA = cin >> 4, KSH = hid >> 4;
  const uint2* wbn = w12 + (size_t)(cin * 2 * hid) / 4;  // 4 bf16 a uint2
  const uint2* w3 = wbn + (size_t)n * 10 * hid * hid / 4;
  const int lrow = lane & 15, lhalf = (lane >> 4) * 16;

  // ---- A: [p1 | p2] on the window ----
  {
    const int mt = (WP + 15) >> 4, nc = (2 * hid + 63) >> 6;
    for (int item = warp; item < mt * nc; item += WARPS) {
      const int m0 = (item / nc) * 16, nt0 = (item % nc) * 8;
      const int nj = min(NJ, (2 * hid >> 3) - nt0);
      const int m = min(m0 + lrow, WP - 1);
      float acc[NJ][4];
      zero(acc);
      gemm_k(acc, x_s + m * XB + lhalf, KSA, w12, KSA, 0, nt0, nj, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = m0 + g + 8 * half;
        if (mm >= WP) continue;
        const int gy = R0 - n + mm / WC, gx = W0 - n + mm % WC;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) continue;
          const int col = (nt0 + j) * 8 + 2 * tq;
          const float* bias = col < hid ? P.b1 + col : P.b2 + col - hid;
          const uint32_t v =
              relu_pack(acc[j][2 * half], acc[j][2 * half + 1], bias);
          *reinterpret_cast<uint32_t*>(p_p + mm * PB + col * 2) =
              inside ? v : 0u;
        }
      }
    }
  }
  __syncthreads();

#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const uint2* wb1 = wbn + (size_t)i * 10 * hid * hid / 4;
    const uint2* wb2 = wb1 + (size_t)hid * hid / 4;
    // ---- B: t = ReLU(p1 @ wb1 + bb1) on the window less i pixels ----
    {
      const int RC = TW + 2 * (n - i), RP = (TR + 2 * (n - i)) * RC;
      const int mt = (RP + 15) >> 4, nc = (hid + 63) >> 6;
      for (int item = warp; item < mt * nc; item += WARPS) {
        const int m0 = (item / nc) * 16, nt0 = (item % nc) * 8;
        const int nj = min(NJ, (hid >> 3) - nt0);
        const int m = min(m0 + lrow, RP - 1);
        const int pw = (m / RC + i) * WC + m % RC + i;
        float acc[NJ][4];
        zero(acc);
        gemm_k(acc, p_s + pw * PB + lhalf, KSH, wb1, KSH, 0, nt0, nj, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int mm = m0 + g + 8 * half;
          if (mm >= RP) continue;
          const int wr = mm / RC + i, wc = mm % RC + i;
          const int gy = R0 - n + wr, gx = W0 - n + wc;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (j >= nj) continue;
            const int col = (nt0 + j) * 8 + 2 * tq;
            const uint32_t v = relu_pack(acc[j][2 * half],
                                         acc[j][2 * half + 1],
                                         P.bb1 + i * hid + col);
            *reinterpret_cast<uint32_t*>(t_p + (wr * WC + wc) * TB +
                                         col * 2) = inside ? v : 0u;
          }
        }
      }
    }
    __syncthreads();
    // ---- C: u = ReLU(conv3x3(t) + bb2), p1 = p1 + u (or u) ----
    {
      const int hh = n - 1 - i, off = i + 1;
      const int RC = TW + 2 * hh, RP = (TR + 2 * hh) * RC;
      const int mt = (RP + 15) >> 4, nc = (hid + 63) >> 6;
      for (int item = warp; item < mt * nc; item += WARPS) {
        const int m0 = (item / nc) * 16, nt0 = (item % nc) * 8;
        const int nj = min(NJ, (hid >> 3) - nt0);
        const int m = min(m0 + lrow, RP - 1);
        // the top-left tap of this lane's row
        const int tp = (m / RC + off - 1) * WC + m % RC + off - 1;
        float acc[NJ][4];
        zero(acc);
#pragma unroll 1
        for (int tap = 0; tap < 9; ++tap)
          gemm_k(acc, t_s + (tp + (tap / 3) * WC + tap % 3) * TB + lhalf,
                 KSH, wb2, 9 * KSH, tap * KSH, nt0, nj, lane);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int mm = m0 + g + 8 * half;
          if (mm >= RP) continue;
          const int wr = mm / RC + off, wc = mm % RC + off;
          const int gy = R0 - n + wr, gx = W0 - n + wc;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (j >= nj) continue;
            const int col = (nt0 + j) * 8 + 2 * tq;
            uint32_t* dst = reinterpret_cast<uint32_t*>(
                p_p + (wr * WC + wc) * PB + col * 2);
            uint32_t u = relu_pack(acc[j][2 * half], acc[j][2 * half + 1],
                                   P.bb2 + i * hid + col);
            if (P.shortcut) {
              const uint32_t old = *dst;
              u = pack_bf16(__fadd_rn(bf16_lo(old), bf16_lo(u)),
                            __fadd_rn(bf16_hi(old), bf16_hi(u)));
            }
            *dst = inside ? u : 0u;
          }
        }
      }
    }
    __syncthreads();
  }

  // ---- D: out = ReLU([p1 | p2] @ w3 + b3) on the tile ----
  {
    const int KS3 = (2 * hid) >> 4;
    const int mt = (TR * TW) >> 4, nc = (fo + 63) >> 6;
    bf16* out_b = P.out + (size_t)b * H * W * fo;
    for (int item = warp; item < mt * nc; item += WARPS) {
      const int m0 = (item / nc) * 16, nt0 = (item % nc) * 8;
      const int nj = min(NJ, (fo >> 3) - nt0);
      const int m = m0 + lrow;
      const int pw = (m / TW + n) * WC + m % TW + n;
      float acc[NJ][4];
      zero(acc);
      gemm_k(acc, p_s + pw * PB + lhalf, KS3, w3, KS3, 0, nt0, nj, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int mm = m0 + g + 8 * half;
        const int gy = R0 + mm / TW, gx = W0 + mm % TW;
        if (gy >= H || gx >= W) continue;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          if (j >= nj) continue;
          const int col = (nt0 + j) * 8 + 2 * tq;
          *reinterpret_cast<uint32_t*>(
              out_b + ((size_t)gy * W + gx) * fo + col) =
              relu_pack(acc[j][2 * half], acc[j][2 * half + 1], P.b3 + col);
        }
      }
    }
  }
}

template <bool CAT>
int launch(Params P, int B, void* stream) {
  const int cin = P.ca + P.cb;
  if (B <= 0 || P.H <= 0 || P.W <= 0 || P.n < 1 || P.n > NMAX ||
      P.cb <= 0 || P.ca % 8 || cin % 16 || P.hid <= 0 || P.hid % 16 ||
      P.fo <= 0 || P.fo % 8 || (P.up_a && (P.H % 2 || P.W % 2)))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(cin, P.hid, P.n);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        c3k2_wide_kernel<CAT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  P.tiles_x = (P.W + TW - 1) / TW;
  P.tiles_y = (P.H + TR - 1) / TR;
  const int ntiles = P.tiles_x * P.tiles_y * B;
  c3k2_wide_kernel<CAT><<<ntiles, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace wide_c3k2

// the tiled kernel above at its compiled widths, the wide form otherwise
int dispatch(bool cat, const bf16* xa, const bf16* xb, int ca, int cb,
             int up_a, const void* wpk, const void* b1, const void* bb1,
             const void* bb2, const void* b2, const void* b3, void* out,
             int B, int H, int W, int n, int shortcut, int hid, int fo,
             void* stream) {
  if (hid == HID && fo == FO) {
    Params P{xa, xb, (const bf16*)wpk, (const float*)b1, (const float*)bb1,
             (const float*)bb2, (const float*)b2, (const float*)b3,
             (bf16*)out, ca, cb, up_a, H, W, n, shortcut, 0, 0, 0};
    return cat ? launch<true>(P, B, stream) : launch<false>(P, B, stream);
  }
  wide_c3k2::Params P{xa, xb, (const bf16*)wpk, (const float*)b1,
                      (const float*)bb1, (const float*)bb2,
                      (const float*)b2, (const float*)b3, (bf16*)out,
                      ca, cb, up_a, H, W, n, shortcut, hid, fo, 0, 0};
  if (cat && ca <= 0) return (int)cudaErrorInvalidValue;
  return cat ? wide_c3k2::launch<true>(P, B, stream)
             : wide_c3k2::launch<false>(P, B, stream);
}

}  // namespace

extern "C" int unina_fused_c3k2(const void* x, int cin, const void* wpk,
                                const void* b1, const void* bb1,
                                const void* bb2, const void* b2,
                                const void* b3, void* out, int B, int H,
                                int W, int n, int shortcut, int hid, int fo,
                                void* stream) {
  return dispatch(false, nullptr, (const bf16*)x, 0, cin, 0, wpk, b1, bb1,
                  bb2, b2, b3, out, B, H, W, n, shortcut, hid, fo, stream);
}

extern "C" int unina_fused_c3k2_cat(const void* xa, const void* xb, int ca,
                                    int cb, int up_a, const void* wpk,
                                    const void* b1, const void* bb1,
                                    const void* bb2, const void* b2,
                                    const void* b3, void* out, int B, int H,
                                    int W, int n, int shortcut, int hid,
                                    int fo, void* stream) {
  return dispatch(true, (const bf16*)xa, (const bf16*)xb, ca, cb, up_a, wpk,
                  b1, bb1, bb2, b2, b3, out, B, H, W, n, shortcut, hid, fo,
                  stream);
}
