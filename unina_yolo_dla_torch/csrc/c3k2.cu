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
// float blocks); hidden 16, 64, 128 and 256 go to the wide form at the end
// of this file (weights streamed, clusters, csrc/wide_mma.cuh). The entry
// points pick the form by (hidden, F).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "wide_mma.cuh"

namespace {

using namespace mma90;

// the last launch's shape, for the host to read
wide::LaunchShape last_launch{};

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
  last_launch = wide::LaunchShape{blocks, 1, 1, THREADS, smem};
  c3k2_kernel<CAT><<<blocks, THREADS, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

// ---- the wide form: hidden 16, 64, 128 and 256 (F = 2 hidden), wgmma ----
//
// The shapes of the bf16 engines' other C3k2s (hidden 64 to 256, F 128 to
// 512, inputs of 128 to 768 channels; hidden 16 at base 16) do not fit the
// tiled kernel's resident weights in shared memory. This form streams them
// (csrc/wide_mma.cuh) on 8 x 8 output tiles, in one of two plans (a third
// at hidden 64 on large grids, below). The same stages and rounding points
// as above, on the tile plus a halo of n:
//   A  [p1 | p2] = ReLU(xwin @ [w1 | w2] + [b1 | b2]) on the
//      (TR+2n) x (TW+2n) window (xa's planes ahead of xb's, xa read at the
//      coarse pixel (r >> 1, c >> 1) of a (TR/2+2) x (TW/2+2) window when
//      upsampled), 0 outside the image;
//   B  t = ReLU(p1 @ wb1 + bb1) on the window less i pixels;
//   C  the 3x3 over t, K = 9 taps x hidden, on one pixel less, then
//      p1 = bf16(p1 + u) (or u) in place;
//   D  out = ReLU([p1 | p2] @ w3 + b3) on the tile, from registers to
//      global memory.
// M is every region padded to whole m64 products (3, 3, 2, 2, 1, 1 at
// n = 2), the items of a stage spread over the two warpgroups.
//
// Replicated plan (`body`: hidden 16 and 64, one block a tile; hidden 128
// on small images, a cluster of 4): every block holds every plane of
// every window; each computes a quarter of every stage's output columns
// and stores them into the windows of all the cluster's blocks (4-byte
// distributed shared-memory stores), t in the input's space.
// Owned plan (`body_owned`: hidden 256, and hidden 128 where its grid,
// batch included, fills the card): a cluster of hidden / 64 blocks; block r owns plane r
// of p1, p2 and t (the only planes it keeps) and computes exactly those;
// A is gathered: the input window from L2 plane by plane into four window
// planes (two copied while two multiply), each peer's p1, t or [p1 | p2]
// plane copied from its shared memory (16-byte loads, the rows a stage
// reads) before B, C and D. Same K order as the replicated plan, so the
// same bits.
// Persistent plan (`body` with PERSIST: hidden 64, n = 1, where the
// replicated plan's grid, batch included, has wide::WALK_MIN_BLOCKS blocks
// or more: base 64's stage1_block and fpn_c3k2_2 at 160 x 160): one block
// an SM walks 8 x 16 tiles (200 at 160 x 160: two rounds of the 132 SMs,
// the second 68 of them, where the replicated plan's 400 8 x 8 tiles take
// four, the last 4 of 132), its weight ring running on from tile to tile
// (the next tile's first chunks land during this tile's D), the next
// tile's input copied into the input window during B, C and D (t gets a
// window of its own). Every stage splits its columns between the two
// warpgroups, so each chunk is copied from L2 once a block a tile (the
// replicated plan's C, one part, copies it into both rings). Shared
// memory at 160 x 160: 2,048 head + 98,304 ring + 46,080 [p1 | p2] +
// 46,080 xb + 23,040 t = 215,552 (stage1_block); + 15,360 of xa's coarse
// window = 230,912 (fpn_c3k2_2). Resident weights would fit stage1_block
// only beside 8 x 8 windows (147,456 + 2 x 25,600 input + 25,600 + 2,048
// = 226,304), fpn_c3k2_2's 180,224 beside none; one copy a cluster (two
// blocks on neighbouring tiles, each chunk multicast, its slot released
// to the copier by cluster-scope arrivals) was built and measured slower
// than a copy a block on the H100 (PERF.md): each chunk's latency, not
// L2's bandwidth, paces the ring. Same K order, so the same bits.
// Bound on the H100 at base 64's stage3_c3k2 (40 x 40 x 512, hidden 256,
// n = 2): 5.9 GFLOP over 6.9 MB, about 5.9 us at the bf16 peak; the owned
// plan's 25 tiles x 4 = 100 blocks (one wave, 229,376 B each) read 92 MB
// of weights from L2 and copy 276 KB a block from their peers, and run
// 12x that bound (PERF.md): the latency of each block's chain of six
// stages (input and peer copies, chunk steps, epilogues, cluster
// barriers), not the tensor cores, bounds it. At base 32's (40 x 40 x
// 256, hidden 128): 1.47 GFLOP, about 1.5 us; 25 tiles x 4 = 100 blocks in
// the replicated plan, 164-228 KB each.
namespace wide_c3k2 {

using namespace wide;

// the output tile of each compiled (hidden, n): 8 x 8 (at hidden 256 the
// blocks own their planes, and an 8 x 8 tile's windows fit)
__host__ __device__ constexpr int tile_rows(int hid, int n) { return 8; }
__host__ __device__ constexpr int tile_cols(int hid, int n) { return 8; }

struct Params {
  const bf16* xa;   // (B, Ha, Wa, ca), pair form only
  const bf16* xb;   // (B, H, W, cb)
  const bf16* wimg; // pack_c3k2_mma image (the wide stream)
  const float *b1, *bb1, *bb2, *b2, *b3;
  bf16* out;        // (B, H, W, fo)
  int ca, cb, up_a, H, W, n, shortcut, hid, fo, tiles_x, tiles_y;
  int units;        // the persistent plan's tiles (batch included)
};

// the widths this form is compiled for, and their cluster size
__host__ __device__ constexpr int split(int hid, int fo) {
  return fo != 2 * hid ? 0
         : hid == 256 || hid == 128 ? 4
         : hid == 64 || hid == 16 ? 1
                                  : 0;
}
// The hidden widths compiled in the owned plan (`body_owned`): a cluster
// of hidden / 64 blocks, each owning one 64-channel plane of p1, p2 and t.
// Their weight stream is packed for that cluster; at hidden 128 the
// replicated plan (`body`, clusters of 4) reads the same stream, each
// block half of an owned block's chunks. Hidden 256 runs the owned plan
// always, hidden 128 where the launch's grid (batch included) has
// OWNED_MIN_BLOCKS blocks or more (base 64's 80 x 80 from batch 1, base
// 32's 40 x 40 from batch 3), the replicated one below that (base 32's 40
// x 40 at batch 1: 100 blocks in clusters of 4, 6-13% faster than 50 in
// clusters of 2 on the H100; PERF.md). The two plans sum in the same
// order, so a frame's bits do not depend on the plan or the batch.
__host__ __device__ constexpr bool owned(int hid) {
  return hid == 256 || hid == 128;
}
constexpr int OWNED_MIN_BLOCKS = 128;
__host__ __device__ inline bool owned_plan(int hid, int ntiles) {
  return hid == 256 || (hid == 128 && ntiles * 2 >= OWNED_MIN_BLOCKS);
}
// the owned plan's input: at most XMAX 64-channel planes (xa's and xb's
// counted apart; 768 channels, the widest input the engines give it),
// streamed through XSLOTS window planes, two a step
constexpr int XMAX = 12;
constexpr int XSLOTS = 4;
// the owned plan's block columns: [p1 | p2] plane r in stages A and D (two
// 64-column warpgroup parts), t's plane r in B and C
constexpr int OWNED_COLS = 64;

// The persistent plan (`body` with PERSIST): hidden 64 with one
// bottleneck where the replicated plan's grid, batch included, has
// wide::WALK_MIN_BLOCKS blocks or more (two rounds of the H100's 132 SMs:
// base 64's 160 x 160, 400; base 32's 80 x 80 has 100) and its windows fit
// in shared memory: one block an SM walking 8 x 16 tiles, every stage in
// two warpgroup column parts (so each chunk goes into one ring). It sums
// as the replicated plan does, so the bits do not depend on the plan or
// the batch.
constexpr int PERSIST_TR = 8, PERSIST_TW = 16;
__host__ __device__ inline bool persist_plan(int hid, int n, int ntiles) {
  return hid == 64 && n == 1 && ntiles >= wide::WALK_MIN_BLOCKS;
}
// the persistent plan's widest warpgroup part: half of stage A's columns
__host__ __device__ constexpr int persist_cols(int hid) { return hid; }

// pixels of the region of stage A (i < 0), B_i, C_i (c) or D (i = n) of a
// tr x tw tile
__host__ __device__ constexpr int region(int tr, int tw, int n, int i,
                                         bool c) {
  return i < 0 ? (tr + 2 * n) * (tw + 2 * n)
         : i >= n ? tr * tw
         : c ? (tr + 2 * (n - 1 - i)) * (tw + 2 * (n - 1 - i))
             : (tr + 2 * (n - i)) * (tw + 2 * (n - i));
}
// the widest warpgroup part of any stage: sets the ring's slots
__host__ __device__ constexpr int ring_cols(int hid, int n) {
  const int s = split(hid, 2 * hid);
  const int tr = tile_rows(hid, n), tw = tile_cols(hid, n);
  int cols = cmax(stage_cols(2 * hid / s, region(tr, tw, n, -1, false)),
                  stage_cols(2 * hid / s, region(tr, tw, n, n, false)));
  for (int i = 0; i < n; ++i)
    cols = cmax(cols,
                cmax(stage_cols(hid / s, region(tr, tw, n, i, false)),
                     stage_cols(hid / s, region(tr, tw, n, i, true))));
  return cols;
}

// the owned plan's shared memory: the stream table and alignment, the ring,
// the block's three planes and XSLOTS planes for the input's and the peers'
// planes
__host__ __device__ inline int smem_owned(int hid, int n) {
  return wide::SMEM_HEAD + ring_bytes(OWNED_COLS) +
         (3 + XSLOTS) * region(tile_rows(hid, n), tile_cols(hid, n), n, -1,
                               false) * PIX_BYTES;
}
// the persistent plan's: the head, the ring, the [p1 | p2] window, the
// input windows and the t window (the next input lands during B, C, D)
__host__ __device__ inline int smem_persist(int ca, int cb, int up_a,
                                            int hid, int n) {
  constexpr int tr = PERSIST_TR, tw = PERSIST_TW;
  const int wp = region(tr, tw, n, -1, false);
  const int apx = up_a ? (tr / 2 + 2) * (tw / 2 + 2) : wp;
  return wide::SMEM_HEAD + ring_bytes(persist_cols(hid)) +
         (planes(2 * hid) * wp + planes(ca) * apx + planes(cb) * wp +
          planes(hid) * wp) *
             PIX_BYTES;
}
// the shared memory a width is admitted by: at hidden 256 the owned plan's
// (its input at most XMAX planes); otherwise the replicated plan's: the
// stream table and alignment, the ring, the [p1 | p2] window, the input
// windows (later the t window). At hidden 128 the owned plan needs no more
// than that for every input the replicated plan admits.
__host__ __device__ inline int smem_bytes(int ca, int cb, int up_a, int hid,
                                          int n) {
  const int tr = tile_rows(hid, n), tw = tile_cols(hid, n);
  const int wp = region(tr, tw, n, -1, false);
  if (hid == 256)
    return planes(ca) + planes(cb) > XMAX ? wide::SMEM_MAX + 1
                                          : smem_owned(hid, n);
  const int apx = up_a ? (tr / 2 + 2) * (tw / 2 + 2) : wp;
  const int x = planes(ca) * apx + planes(cb) * wp;
  const int t = planes(hid) * wp;
  return wide::SMEM_HEAD + ring_bytes(ring_cols(hid, n)) +
         (planes(2 * hid) * wp + (x > t ? x : t)) * PIX_BYTES;
}

// N: the bottlenecks, a template parameter so that every stage's region,
// and so its count of items, is known at compile time, and TR x TW the
// output tile, compile-time parameters as well. The replicated plan: one
// tile a block (or a cluster of S). PERSIST: the persistent plan (S = 1),
// each block walking its tiles with its ring running on from tile to tile
// and the next tile's input landing during this tile's B, C and D (t has
// a window of its own).
template <bool CAT, int HID, int N, int TR, int TW, bool PERSIST = false>
__device__ __forceinline__ void body(const Params& P,
                                     unsigned char* smem_raw, Stream& st) {
  constexpr int S = split(HID, 2 * HID);
  static_assert(!PERSIST || S == 1, "a persistent block owns its tiles");
  constexpr int PP = (2 * HID + 63) / 64, PT = (HID + 63) / 64;
  constexpr int NSA = 2 * HID / S, NSB = HID / S;  // F = 2 hidden: D as A
  constexpr int WC = TW + 2 * N, WP = (TR + 2 * N) * WC;  // window
  constexpr int AR = TR / 2 + 2, AC = TW / 2 + 2;  // coarse xa window
  using G = Ring<ring_slot(PERSIST ? persist_cols(HID) : ring_cols(HID, N))>;
  static_assert(TR % 2 == 0 && TW % 2 == 0, "even tile origins (up_a)");
  static_assert(HID % 64 == 0 || S == 1, "padded planes are zeroed locally");
  const Lane L;
  const int rank = cluster_rank<S>();
  // where the stream is packed for the owned plan's SO blocks, block rank
  // multiplies part h (of SUB) of owned block ro's columns of each stage
  constexpr int SO = owned(HID) ? HID / 64 : S, SUB = S / SO;
  static_assert(SO * SUB == S, "owned blocks split evenly");
  const int ro = rank / SUB, h = rank % SUB;
  // the [p1 | p2] channel of stage A's block column c
  auto a_chan = [&](int c) {
    if constexpr (owned(HID)) {
      const int oc = h * NSA + c;  // owned column: [p1 plane ro | p2's]
      return (oc < 64 ? 0 : HID) + 64 * ro + (oc & 63);
    } else {
      return rank * NSA + c;
    }
  };
  const int H = P.H, W = P.W;
  const bool up = CAT && P.up_a;
  const int APX = up ? AR * AC : WP;
  const int KA = CAT ? planes(P.ca) : 0, KB = planes(P.cb);
  const int Ha = up ? H / 2 : H, Wa = up ? W / 2 : W;
  // this block's tiles: one (replicated), or its walk (persistent)
  const Walk walk(P.units, P.tiles_x, P.tiles_y);
  const int count = PERSIST ? walk.count : 1;
  auto origin = [&](int k, int& b, int& R0, int& W0) {
    int ty, tx;
    if constexpr (PERSIST) {
      walk.tile(k, b, ty, tx);
    } else {
      const int tile = blockIdx.x / S;
      b = tile / (P.tiles_x * P.tiles_y);
      const int rem = tile - b * P.tiles_x * P.tiles_y;
      ty = rem / P.tiles_x;
      tx = rem % P.tiles_x;
    }
    R0 = ty * TR;
    W0 = tx * TW;
  };

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = ring_base(raw);
  const uint32_t p_s = ring + G::BYTES;                // [p1 | p2]
  const uint32_t xa_s = p_s + PP * WP * PIX_BYTES;     // KA planes
  const uint32_t xb_s = xa_s + KA * APX * PIX_BYTES;   // KB planes
  // t: in the input's space after A; the persistent plan's its own (the
  // next tile's input lands there during this tile's B, C and D)
  const uint32_t t_s = PERSIST ? xb_s + KB * WP * PIX_BYTES : xa_s;
  const uint32_t p_off = p_s - raw, t_off = t_s - raw;

  if (L.tid == 0) {
    st.nst = 0;
    st.first[0] = 0;
    st.add(KA + KB, NSA * 128,
           stage_nh(NSA, region(TR, TW, N, -1, false), PERSIST),
           SUB * NSA * 128, h * NSA * 128);
    for (int i = 0; i < N; ++i) {
      st.add(PT, NSB * 128,
             stage_nh(NSB, region(TR, TW, N, i, false), PERSIST),
             SUB * NSB * 128, h * NSB * 128);
      st.add(9 * PT, NSB * 128,
             stage_nh(NSB, region(TR, TW, N, i, true), PERSIST),
             SUB * NSB * 128, h * NSB * 128);
    }
    st.add(PP, NSA * 128,
           stage_nh(NSA, region(TR, TW, N, N, false), PERSIST),
           SUB * NSA * 128, h * NSA * 128);
    st.src = reinterpret_cast<const unsigned char*>(P.wimg) +
             ro * st.total_bytes();
  }
  // the weights' first chunks are on their way before the windows
  init_rings<G>(raw, L);
  __syncthreads();  // the stream's table, the rings' barriers
  Feeder<G, false, PERSIST> fd(st, ring, raw + BARS, L, count);
  for (int g = 0; g < G::DIST; ++g) fd.issue();
  // input windows of the tile at (R0, W0) of image b: pixel (wr, wc) <-
  // image (R0-N+wr, W0-N+wc), 64 channels a plane; zeros outside the image
  // and past the last channel
  auto load_x = [&](int b, int R0, int W0) {
    const bf16* xb_b = P.xb + (size_t)b * H * W * P.cb;
    for (int i = L.tid; i < KB * WP * 8; i += wide::THREADS) {
      const int ch = i & 7, pq = i >> 3;
      const int q = pq / WP, p = pq - q * WP;
      const int wr = p / WC, wc = p - wr * WC;
      const int gy = R0 - N + wr, gx = W0 - N + wc, c0 = q * 64 + ch * 8;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 < P.cb;
      const bf16* src = ok ? xb_b + ((size_t)gy * W + gx) * P.cb + c0 : xb_b;
      cp_async16(xb_s + q * WP * PIX_BYTES + pix_chunk(p, ch), src,
                 ok ? 16 : 0);
    }
    if constexpr (CAT) {
      const bf16* xa_b = P.xa + (size_t)b * Ha * Wa * P.ca;
      const int AWC = up ? AC : WC;
      const int ay0 = up ? (R0 >> 1) - 1 : R0 - N;
      const int ax0 = up ? (W0 >> 1) - 1 : W0 - N;
      for (int i = L.tid; i < KA * APX * 8; i += wide::THREADS) {
        const int ch = i & 7, pq = i >> 3;
        const int q = pq / APX, p = pq - q * APX;
        const int ar = p / AWC, ac = p - ar * AWC;
        const int ay = ay0 + ar, ax = ax0 + ac, c0 = q * 64 + ch * 8;
        const bool ok = ay >= 0 && ay < Ha && ax >= 0 && ax < Wa && c0 < P.ca;
        const bf16* src =
            ok ? xa_b + ((size_t)ay * Wa + ax) * P.ca + c0 : xa_b;
        cp_async16(xa_s + q * APX * PIX_BYTES + pix_chunk(p, ch), src,
                   ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  int b, R0, W0;
  origin(0, b, R0, W0);
  load_x(b, R0, W0);
  if constexpr (PP * 64 != 2 * HID)  // p2 ends inside a plane
    zero_smem(smem_raw + p_off, PP * WP * PIX_BYTES, L.tid);
  if constexpr (PERSIST && PT * 64 != HID)  // t ends inside a plane
    zero_smem(smem_raw + t_off, PT * WP * PIX_BYTES, L.tid);
  const Peers<S> peers(smem_raw);
  int g0 = 0;

  // one tile: the block's only one (replicated), or its k-th
  auto run_tile = [&](int k) {
    cp_async_wait<0>();
    __syncthreads();  // this tile's windows are in; the last tile is done
    if (!PERSIST && k == 0) cluster_sync<S>();  // every block runs first
    // coarse window origin (up): fine rows R0-N.. start at (R0 >> 1) - 1
    const int ay0 = up ? (R0 >> 1) - 1 : R0 - N;
    const int ax0 = up ? (W0 >> 1) - 1 : W0 - N;

    // ---- A: [p1 | p2] on the window ----
    {
      constexpr int NHA = stage_nh(NSA, WP, PERSIST), NIA = NSA / NHA;
      constexpr int NA = stage_items<NHA>(WP), MA = share(NA);
      constexpr int KSA = PERSIST ? step_chunks(MA, NIA) : KSTEP;
      const Items<NIA, NHA, MA> items{NA};
      int pix[MA], pa[MA];
#pragma unroll
      for (int i = 0; i < MA; ++i) {
        const int m = min(items.arow(i, L), WP - 1);
        pix[i] = m;
        pa[i] = m;
        if (up) {
          const int wr = m / WC, wc = m - wr * WC;
          pa[i] = (((R0 - N + wr) >> 1) - ay0) * AC +
                  (((W0 - N + wc) >> 1) - ax0);
        }
      }
      float acc[MA][NIA / 2];
      gemm<KSA>(acc, items, g0, KA + KB, fd, L,
                [&](int i, int kc, uint32_t& win, int& px) {
                  if (kc < KA) {
                    win = xa_s + kc * APX * PIX_BYTES;
                    px = pa[i];
                  } else {
                    win = xb_s + (kc - KA) * WP * PIX_BYTES;
                    px = pix[i];
                  }
                });
      g0 += KA + KB;
      each_pair(
          acc, items, L,
          [&](int c) {
            const int col = a_chan(c);
            return col < HID ? P.b1 + col : P.b2 + col - HID;
          },
          [&](int m) {
            const int gy = R0 - N + m / WC, gx = W0 - N + m % WC;
            return Row{p_off + m * PIX_BYTES, m & 7, m < WP,
                       gy >= 0 && gy < H && gx >= 0 && gx < W};
          },
          [&](const Row& r, int c, uint32_t v) {
            peers.put(r.off + col_off(a_chan(c), WP, r.x), r.inside ? v : 0u);
          });
      cluster_sync<S>();
    }
    int nb = b, nR0 = R0, nW0 = W0;
    if constexpr (PERSIST) {  // the next tile's input, under B, C and D
      if (k + 1 < count) {
        origin(k + 1, nb, nR0, nW0);
        load_x(nb, nR0, nW0);
      }
    } else if constexpr (PT * 64 != HID) {  // t ends inside a plane
      zero_smem(smem_raw + t_off, PT * WP * PIX_BYTES, L.tid);
    }

    // bottleneck I: B on the window less I pixels, then C one pixel less
    auto bottleneck = [&](auto ic) {
      constexpr int I = decltype(ic)::value;
      {
        // ---- B: t = ReLU(p1 @ wb1 + bb1) on the window less I pixels ----
        constexpr int RC = TW + 2 * (N - I), RP = (TR + 2 * (N - I)) * RC;
        constexpr int NHB = stage_nh(NSB, RP, PERSIST), NIB = NSB / NHB;
        constexpr int NB = stage_items<NHB>(RP), MB = share(NB);
        constexpr int KSB = PERSIST ? step_chunks(MB, NIB) : KSTEP;
        const Items<NIB, NHB, MB> items{NB};
        int pw[MB];
#pragma unroll
        for (int j = 0; j < MB; ++j) {
          const int m = min(items.arow(j, L), RP - 1);
          pw[j] = (m / RC + I) * WC + m % RC + I;
        }
        float acc[MB][NIB / 2];
        gemm<KSB>(acc, items, g0, PT, fd, L,
                  [&](int j, int kc, uint32_t& win, int& px) {
                    win = p_s + kc * WP * PIX_BYTES;
                    px = pw[j];
                  });
        g0 += PT;
        each_pair(
            acc, items, L,
            [&](int c) { return P.bb1 + I * HID + rank * NSB + c; },
            [&](int m) {
              const int wr = m / RC + I, wc = m % RC + I, p = wr * WC + wc;
              const int gy = R0 - N + wr, gx = W0 - N + wc;
              return Row{t_off + p * PIX_BYTES, p & 7, m < RP,
                         gy >= 0 && gy < H && gx >= 0 && gx < W};
            },
            [&](const Row& r, int c, uint32_t v) {
              peers.put(r.off + col_off(rank * NSB + c, WP, r.x),
                        r.inside ? v : 0u);
            });
        cluster_sync<S>();
      }
      {
        // ---- C: u = ReLU(conv3x3(t) + bb2), p1 = p1 + u (or u) ----
        constexpr int HH = N - 1 - I, OFF = I + 1;
        constexpr int RC = TW + 2 * HH, RP = (TR + 2 * HH) * RC;
        constexpr int NHB = stage_nh(NSB, RP, PERSIST), NIB = NSB / NHB;
        constexpr int NC = stage_items<NHB>(RP), MCI = share(NC);
        constexpr int KSC = PERSIST ? step_chunks(MCI, NIB) : KSTEP;
        const Items<NIB, NHB, MCI> items{NC};
        int tp[MCI];  // the top-left tap of this lane's row
#pragma unroll
        for (int j = 0; j < MCI; ++j) {
          const int m = min(items.arow(j, L), RP - 1);
          tp[j] = (m / RC + OFF - 1) * WC + m % RC + OFF - 1;
        }
        float acc[MCI][NIB / 2];
        gemm<KSC>(acc, items, g0, 9 * PT, fd, L,
                  [&](int j, int kc, uint32_t& win, int& px) {
                    const int tap = kc / PT, q = kc - tap * PT;
                    win = t_s + q * WP * PIX_BYTES;
                    px = tp[j] + (tap / 3) * WC + tap % 3;
                  });
        g0 += 9 * PT;
        each_pair(
            acc, items, L,
            [&](int c) { return P.bb2 + I * HID + rank * NSB + c; },
            [&](int m) {
              const int wr = m / RC + OFF, wc = m % RC + OFF;
              const int p = wr * WC + wc;
              const int gy = R0 - N + wr, gx = W0 - N + wc;
              return Row{p_off + p * PIX_BYTES, p & 7, m < RP,
                         gy >= 0 && gy < H && gx >= 0 && gx < W};
            },
            [&](const Row& r, int c, uint32_t u) {
              const uint32_t o = r.off + col_off(rank * NSB + c, WP, r.x);
              if (P.shortcut) {
                const uint32_t old =
                    *reinterpret_cast<const uint32_t*>(smem_raw + o);
                u = pack_bf16(__fadd_rn(bf16_lo(old), bf16_lo(u)),
                              __fadd_rn(bf16_hi(old), bf16_hi(u)));
              }
              peers.put(o, r.inside ? u : 0u);
            });
        cluster_sync<S>();
      }
    };
    bottleneck(std::integral_constant<int, 0>{});
    if constexpr (N == 2) bottleneck(std::integral_constant<int, 1>{});

    // ---- D: out = ReLU([p1 | p2] @ w3 + b3) on the tile ----
    {
      constexpr int NHA = stage_nh(NSA, TR * TW, PERSIST), NIA = NSA / NHA;
      constexpr int ND = stage_items<NHA>(TR * TW), MD = share(ND);
      constexpr int KSD = PERSIST ? step_chunks(MD, NIA) : KSTEP;
      const Items<NIA, NHA, MD> items{ND};
      int pw[MD];
#pragma unroll
      for (int j = 0; j < MD; ++j) {
        const int m = min(items.arow(j, L), TR * TW - 1);
        pw[j] = (m / TW + N) * WC + m % TW + N;
      }
      float acc[MD][NIA / 2];
      gemm<KSD>(acc, items, g0, PP, fd, L,
                [&](int j, int kc, uint32_t& win, int& px) {
                  win = p_s + kc * WP * PIX_BYTES;
                  px = pw[j];
                });
      g0 += PP;
      bf16* out_b = P.out + (size_t)b * H * W * (2 * HID);
      each_pair(
          acc, items, L, [&](int c) { return P.b3 + rank * NSA + c; },
          [&](int m) {
            const int gy = R0 + m / TW, gx = W0 + m % TW;
            return Row{(uint32_t)(gy * W + gx), 0, m < TR * TW && gy < H &&
                                                        gx < W, true};
          },
          [&](const Row& r, int c, uint32_t v) {
            *reinterpret_cast<uint32_t*>(out_b + (size_t)r.off * (2 * HID) +
                                         rank * NSA + c) = v;
          });
    }
    b = nb;
    R0 = nR0;
    W0 = nW0;
  };
  if constexpr (PERSIST) {
#pragma unroll 1
    for (int k = 0; k < count; ++k) run_tile(k);
  } else {
    run_tile(0);
  }
}

// ---- the owned plan: a cluster of hidden / 64 blocks on an 8 x 8 tile ----
//
// Block r of the cluster owns plane r (channels 64 r ..) of p1, of p2 and
// of t over the whole window, and computes exactly those: its stage-A
// columns are [p1 plane r | p2 plane r] (mma_pack.py orders them so), its
// B and C columns t's and p1's plane r, so every epilogue stores into the
// block's own shared memory, the residual included, and zeroes its planes
// outside the image. A is gathered: the input window is read from global
// memory (L2) plane by plane into XSLOTS window planes, two planes copied
// while two multiply; before B, C and D the block copies its peers'
// planes of p1, t or [p1 | p2] (only the window rows that stage reads)
// from their shared memory into the same slots (`gather`, 16-byte
// ld.shared::cluster), reading its own plane in place. Each stage reads
// its K chunks in the order the replicated plan does, so the sums and the
// bits are the same. A cluster barrier after every epilogue publishes the
// planes; the next stage's copies only read planes that no block writes
// until the barrier after that stage; the barrier after D's last copies
// keeps every block alive while its peers read it.
template <bool CAT, int HID, int N, int TR, int TW>
__device__ __forceinline__ void body_owned(const Params& P,
                                           unsigned char* smem_raw,
                                           Stream& st) {
  constexpr int S = HID / 64;  // a block owns one plane of p1, p2 and t
  constexpr int NSA = 128, NSB = 64;  // a block's columns: A and D; B and C
  constexpr int WC = TW + 2 * N, WR = TR + 2 * N, WP = WR * WC;  // window
  constexpr int AR = TR / 2 + 2, AC = TW / 2 + 2;  // coarse xa window
  constexpr uint32_t PLANE = WP * PIX_BYTES;
  using G = Ring<ring_slot(OWNED_COLS)>;
  static_assert(stage_cols(NSA, 64) == OWNED_COLS, "the ring's slots");
  static_assert(TR % 2 == 0 && TW % 2 == 0, "even tile origins (up_a)");
  static_assert(XSLOTS >= S - 1 && XSLOTS % 2 == 0, "the slots");
  const Lane L;
  const int rank = cluster_rank<S>();
  const int H = P.H, W = P.W;
  const int tile = blockIdx.x / S;
  const int b = tile / (P.tiles_x * P.tiles_y);
  const int rem = tile - b * P.tiles_x * P.tiles_y;
  const int R0 = (rem / P.tiles_x) * TR, W0 = (rem % P.tiles_x) * TW;
  const bool up = CAT && P.up_a;
  const int KA = CAT ? planes(P.ca) : 0, KB = planes(P.cb), KX = KA + KB;
  const int Ha = up ? H / 2 : H, Wa = up ? W / 2 : W;
  const int ay0 = up ? (R0 >> 1) - 1 : R0 - N;
  const int ax0 = up ? (W0 >> 1) - 1 : W0 - N;

  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = ring_base(raw);
  const uint32_t p1_s = ring + G::BYTES;  // p1's plane r, then p2's
  const uint32_t t_s = p1_s + 2 * PLANE;  // t's plane r
  const uint32_t ga = t_s + PLANE;        // XSLOTS planes
  // a peer's copy of one of this block's addresses
  auto peer = [&](uint32_t local, int q) { return peer_addr(local, q); };
  // the slot of peer q's plane (q != rank)
  auto slot = [&](int q) { return ga + (q - (q > rank)) * PLANE; };
  // copy rows [lo, hi) of every peer's plane at `local` into its slot
  auto gather_rows = [&](uint32_t local, int lo, int hi) {
    for (int q = 0; q < S; ++q)
      if (q != rank)
        gather(slot(q) + lo * WC * PIX_BYTES,
               peer(local, q) + lo * WC * PIX_BYTES,
               (hi - lo) * WC * PIX_BYTES, L.tid);
  };

  if (L.tid == 0) {
    st.nst = 0;
    st.first[0] = 0;
    st.add(KX, NSA * 128, stage_nh(NSA, WP));
    for (int i = 0; i < N; ++i) {
      st.add(S, NSB * 128, stage_nh(NSB, region(TR, TW, N, i, false)));
      st.add(9 * S, NSB * 128, stage_nh(NSB, region(TR, TW, N, i, true)));
    }
    st.add(2 * S, NSA * 128, stage_nh(NSA, TR * TW));
    st.src = reinterpret_cast<const unsigned char*>(P.wimg) +
             rank * st.total_bytes();
  }
  init_rings<G>(raw, L);
  __syncthreads();  // the stream's table, the rings' barriers
  Feeder<G> fd(st, ring, raw + BARS, L);
  for (int g = 0; g < G::DIST; ++g) fd.issue();
  // input plane k (xa's first) into slot k % XSLOTS: window pixel (wr, wc)
  // <- image (R0-N+wr, W0-N+wc), xa's at its coarse window when upsampled;
  // zeros outside the image and past the last channel
  const bf16* xb_b = P.xb + (size_t)b * H * W * P.cb;
  auto load_x = [&](int k) {
    const uint32_t dst = ga + (k % XSLOTS) * PLANE;
    if (CAT && k < KA) {
      const bf16* xa_b = P.xa + (size_t)b * Ha * Wa * P.ca;
      const int AWC = up ? AC : WC, npx = up ? AR * AC : WP;
      for (int i = L.tid; i < npx * 8; i += wide::THREADS) {
        const int ch = i & 7, p = i >> 3;
        const int ar = p / AWC, ac = p - ar * AWC;
        const int ay = ay0 + ar, ax = ax0 + ac, c0 = k * 64 + ch * 8;
        const bool ok = ay >= 0 && ay < Ha && ax >= 0 && ax < Wa && c0 < P.ca;
        const bf16* src =
            ok ? xa_b + ((size_t)ay * Wa + ax) * P.ca + c0 : xa_b;
        cp_async16(dst + pix_chunk(p, ch), src, ok ? 16 : 0);
      }
    } else {
      const int q = k - KA;
      for (int i = L.tid; i < WP * 8; i += wide::THREADS) {
        const int ch = i & 7, p = i >> 3;
        const int wr = p / WC, wc = p - wr * WC;
        const int gy = R0 - N + wr, gx = W0 - N + wc, c0 = q * 64 + ch * 8;
        const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 < P.cb;
        const bf16* src = ok ? xb_b + ((size_t)gy * W + gx) * P.cb + c0 : xb_b;
        cp_async16(dst + pix_chunk(p, ch), src, ok ? 16 : 0);
      }
    }
  };
  int g0 = 0;

  // ---- A: [p1 | p2] plane r on the window, the input two planes a step ----
  {
    constexpr int NHA = stage_nh(NSA, WP), NIA = NSA / NHA;
    constexpr int NA = stage_items<NHA>(WP), MA = share(NA);
    constexpr int KSA = step_chunks(MA, NIA);
    const Items<NIA, NHA, MA> items{NA};
    int pix[MA], pa[MA];
#pragma unroll
    for (int i = 0; i < MA; ++i) {
      const int m = min(items.arow(i, L), WP - 1);
      pix[i] = m;
      pa[i] = m;
      if (up) {
        const int wr = m / WC, wc = m - wr * WC;
        pa[i] = (((R0 - N + wr) >> 1) - ay0) * AC + (((W0 - N + wc) >> 1) - ax0);
      }
    }
    float acc[MA][NIA / 2];
    zero_acc<NIA>(acc);
    load_x(0);
    if (KX > 1) load_x(1);
    cp_async_commit();
#pragma unroll 1
    for (int k0 = 0; k0 < KX; k0 += 2) {
      if (k0 + 2 < KX) {
        load_x(k0 + 2);
        if (k0 + 3 < KX) load_x(k0 + 3);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // planes k0, k0 + 1 are in
      gemm_more<KSA>(acc, items, g0, k0, min(2, KX - k0), fd, L,
                     [&](int i, int kc, uint32_t& win, int& px) {
                       win = ga + (kc % XSLOTS) * PLANE;
                       px = CAT && kc < KA ? pa[i] : pix[i];
                     });
      __syncthreads();  // their slots may be filled again
    }
    g0 += KX;
    each_pair(
        acc, items, L,
        [&](int c) {
          const int col = rank * 64 + (c & 63);
          return c < 64 ? P.b1 + col : P.b2 + col;
        },
        [&](int m) {
          const int gy = R0 - N + m / WC, gx = W0 - N + m % WC;
          return Row{p1_s + m * PIX_BYTES, m & 7, m < WP,
                     gy >= 0 && gy < H && gx >= 0 && gx < W};
        },
        [&](const Row& r, int c, uint32_t v) {
          st_shared(r.off + col_off(c, WP, r.x), r.inside ? v : 0u);
        });
    cluster_sync<S>();
  }

  // bottleneck I: B on the window less I pixels, then C one pixel less;
  // both read window rows I .. WR - I - 1
  auto bottleneck = [&](auto ic) {
    constexpr int I = decltype(ic)::value;
    {
      // ---- B: t plane r = ReLU(p1 @ wb1 + bb1) ----
      constexpr int RC = TW + 2 * (N - I), RP = (TR + 2 * (N - I)) * RC;
      constexpr int NHB = stage_nh(NSB, RP), NIB = NSB / NHB;
      constexpr int NB = stage_items<NHB>(RP);
      const Items<NIB, NHB, share(NB)> items{NB};
      int pw[share(NB)];
#pragma unroll
      for (int j = 0; j < share(NB); ++j) {
        const int m = min(items.arow(j, L), RP - 1);
        pw[j] = (m / RC + I) * WC + m % RC + I;
      }
      gather_rows(p1_s, I, WR - I);
      __syncthreads();
      float acc[share(NB)][NIB / 2];
      gemm(acc, items, g0, S, fd, L,
           [&](int j, int kc, uint32_t& win, int& px) {
             win = kc == rank ? p1_s : slot(kc);
             px = pw[j];
           });
      g0 += S;
      each_pair(
          acc, items, L,
          [&](int c) { return P.bb1 + I * HID + rank * NSB + c; },
          [&](int m) {
            const int wr = m / RC + I, wc = m % RC + I, p = wr * WC + wc;
            const int gy = R0 - N + wr, gx = W0 - N + wc;
            return Row{t_s + p * PIX_BYTES, p & 7, m < RP,
                       gy >= 0 && gy < H && gx >= 0 && gx < W};
          },
          [&](const Row& r, int c, uint32_t v) {
            st_shared(r.off + col_off(c, WP, r.x), r.inside ? v : 0u);
          });
      cluster_sync<S>();
    }
    {
      // ---- C: u = ReLU(conv3x3(t) + bb2), p1 plane r = p1 + u (or u) ----
      constexpr int HH = N - 1 - I, OFF = I + 1;
      constexpr int RC = TW + 2 * HH, RP = (TR + 2 * HH) * RC;
      constexpr int NHB = stage_nh(NSB, RP), NIB = NSB / NHB;
      constexpr int NC = stage_items<NHB>(RP);
      const Items<NIB, NHB, share(NC)> items{NC};
      int tp[share(NC)];
#pragma unroll
      for (int j = 0; j < share(NC); ++j) {
        const int m = min(items.arow(j, L), RP - 1);
        tp[j] = (m / RC + OFF - 1) * WC + m % RC + OFF - 1;
      }
      gather_rows(t_s, I, WR - I);
      __syncthreads();
      float acc[share(NC)][NIB / 2];
      gemm(acc, items, g0, 9 * S, fd, L,
           [&](int j, int kc, uint32_t& win, int& px) {
             const int tap = kc / S, q = kc - tap * S;
             win = q == rank ? t_s : slot(q);
             px = tp[j] + (tap / 3) * WC + tap % 3;
           });
      g0 += 9 * S;
      each_pair(
          acc, items, L,
          [&](int c) { return P.bb2 + I * HID + rank * NSB + c; },
          [&](int m) {
            const int wr = m / RC + OFF, wc = m % RC + OFF;
            const int p = wr * WC + wc;
            const int gy = R0 - N + wr, gx = W0 - N + wc;
            return Row{p1_s + p * PIX_BYTES, p & 7, m < RP,
                       gy >= 0 && gy < H && gx >= 0 && gx < W};
          },
          [&](const Row& r, int c, uint32_t u) {
            const uint32_t o = r.off + col_off(c, WP, r.x);
            if (P.shortcut) {
              const uint32_t old = ld_shared(o);
              u = pack_bf16(__fadd_rn(bf16_lo(old), bf16_lo(u)),
                            __fadd_rn(bf16_hi(old), bf16_hi(u)));
            }
            st_shared(o, r.inside ? u : 0u);
          });
      cluster_sync<S>();
    }
  };
  bottleneck(std::integral_constant<int, 0>{});
  if constexpr (N == 2) bottleneck(std::integral_constant<int, 1>{});

  // ---- D: out = ReLU([p1 | p2] @ w3 + b3) on the tile: p1's planes, then
  // p2's, each the peers' copied first (the tile's rows) ----
  {
    constexpr int NHA = stage_nh(NSA, TR * TW), NIA = NSA / NHA;
    constexpr int ND = stage_items<NHA>(TR * TW), MD = share(ND);
    constexpr int KSD = step_chunks(MD, NIA);
    const Items<NIA, NHA, MD> items{ND};
    int pw[MD];
#pragma unroll
    for (int j = 0; j < MD; ++j) {
      const int m = min(items.arow(j, L), TR * TW - 1);
      pw[j] = (m / TW + N) * WC + m % TW + N;
    }
    float acc[MD][NIA / 2];
    zero_acc<NIA>(acc);
    gather_rows(p1_s, N, N + TR);
    __syncthreads();
    gemm_more<KSD>(acc, items, g0, 0, S, fd, L,
                   [&](int j, int kc, uint32_t& win, int& px) {
                     win = kc == rank ? p1_s : slot(kc);
                     px = pw[j];
                   });
    __syncthreads();  // the slots may be filled again
    gather_rows(p1_s + PLANE, N, N + TR);
    cluster_sync<S>();  // no block reads a peer past here
    gemm_more<KSD>(acc, items, g0, S, S, fd, L,
                   [&](int j, int kc, uint32_t& win, int& px) {
                     win = kc - S == rank ? p1_s + PLANE : slot(kc - S);
                     px = pw[j];
                   });
    bf16* out_b = P.out + (size_t)b * H * W * (2 * HID);
    each_pair(
        acc, items, L, [&](int c) { return P.b3 + rank * NSA + c; },
        [&](int m) {
          const int gy = R0 + m / TW, gx = W0 + m % TW;
          return Row{(uint32_t)(gy * W + gx), 0, m < TR * TW && gy < H &&
                                                      gx < W, true};
        },
        [&](const Row& r, int c, uint32_t v) {
          *reinterpret_cast<uint32_t*>(out_b + (size_t)r.off * (2 * HID) +
                                       rank * NSA + c) = v;
        });
  }
}

// the plans a compiled body runs
enum Plan { REPLICATED, OWNED, PERSISTENT };

// One kernel function a compiled body: CAT the pair form, HID the hidden
// width, N the bottlenecks, PLAN the plan; the launcher picks the instance
template <bool CAT, int HID, int N, int PLAN>
__global__ void __launch_bounds__(wide::THREADS, 1)
c3k2_wide_kernel(const Params P) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  Stream& st = *reinterpret_cast<Stream*>(wide_smem);
  if constexpr (PLAN == OWNED)
    body_owned<CAT, HID, N, tile_rows(HID, N), tile_cols(HID, N)>(
        P, wide_smem, st);
  else if constexpr (PLAN == PERSISTENT)
    body<CAT, HID, N, PERSIST_TR, PERSIST_TW, true>(P, wide_smem, st);
  else
    body<CAT, HID, N, tile_rows(HID, N), tile_cols(HID, N)>(P, wide_smem,
                                                            st);
}

template <bool CAT, int HID, int N, int PLAN>
int launch_body(Params P, int B, int smem, void* stream) {
  const auto kernel = c3k2_wide_kernel<CAT, HID, N, PLAN>;
  static int sms = 0;  // one per compiled body; the card's SMs
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, wide::SMEM_MAX);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  if constexpr (PLAN == PERSISTENT) {  // one block an SM walks the tiles
    P.tiles_x = (P.W + PERSIST_TW - 1) / PERSIST_TW;
    P.tiles_y = (P.H + PERSIST_TR - 1) / PERSIST_TR;
    P.units = P.tiles_x * P.tiles_y * B;
    return launch_cluster(last_launch, kernel, 1,
                          P.units < sms ? P.units : sms, 1, smem, stream, P);
  }
  constexpr int S = PLAN == OWNED ? HID / 64 : split(HID, 2 * HID);
  constexpr int tr = tile_rows(HID, N), tw = tile_cols(HID, N);
  P.tiles_x = (P.W + tw - 1) / tw;
  P.tiles_y = (P.H + tr - 1) / tr;
  const int ntiles = P.tiles_x * P.tiles_y * B;
  return launch_cluster(last_launch, kernel, S, ntiles * S, 1, smem, stream,
                        P);
}

// the body at hidden HID: the owned plan or the replicated one (hidden
// 128), the persistent plan or the replicated one (hidden 64, n = 1)
template <bool CAT, int HID, int N>
int launch_width(Params P, int B, int smem, void* stream) {
  const int ntiles = ((P.W + tile_cols(HID, N) - 1) / tile_cols(HID, N)) *
                     ((P.H + tile_rows(HID, N) - 1) / tile_rows(HID, N)) * B;
  if constexpr (HID == 256)
    return launch_body<CAT, HID, N, OWNED>(P, B, smem_owned(HID, N), stream);
  else if constexpr (HID == 128)
    return owned_plan(HID, ntiles)
               ? launch_body<CAT, HID, N, OWNED>(P, B, smem_owned(HID, N),
                                                 stream)
               : launch_body<CAT, HID, N, REPLICATED>(P, B, smem, stream);
  else if constexpr (HID == 64 && N == 1) {
    const int sp = smem_persist(P.ca, P.cb, P.up_a, HID, N);
    return persist_plan(HID, N, ntiles) && sp <= wide::SMEM_MAX
               ? launch_body<CAT, HID, N, PERSISTENT>(P, B, sp, stream)
               : launch_body<CAT, HID, N, REPLICATED>(P, B, smem, stream);
  } else
    return launch_body<CAT, HID, N, REPLICATED>(P, B, smem, stream);
}

template <bool CAT>
int launch(Params P, int B, void* stream) {
  const int S = split(P.hid, P.fo);
  if (B <= 0 || P.H <= 0 || P.W <= 0 || P.n < 1 || P.n > NMAX ||
      P.cb <= 0 || P.cb % 8 || P.ca % 8 || S == 0 || (CAT && P.ca <= 0) ||
      (P.up_a && (P.H % 2 || P.W % 2)))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes(P.ca, P.cb, P.up_a, P.hid, P.n);
  if (smem > wide::SMEM_MAX) return (int)cudaErrorInvalidValue;
  const bool two = P.n == 2;
  switch (P.hid) {
    case 256:
      return two ? launch_width<CAT, 256, 2>(P, B, smem, stream)
                 : launch_width<CAT, 256, 1>(P, B, smem, stream);
    case 128:
      return two ? launch_width<CAT, 128, 2>(P, B, smem, stream)
                 : launch_width<CAT, 128, 1>(P, B, smem, stream);
    case 64:
      return two ? launch_width<CAT, 64, 2>(P, B, smem, stream)
                 : launch_width<CAT, 64, 1>(P, B, smem, stream);
    default:
      return two ? launch_width<CAT, 16, 2>(P, B, smem, stream)
                 : launch_width<CAT, 16, 1>(P, B, smem, stream);
  }
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
                      ca, cb, up_a, H, W, n, shortcut, hid, fo, 0, 0, 0};
  if (cat && ca <= 0) return (int)cudaErrorInvalidValue;
  return cat ? wide_c3k2::launch<true>(P, B, stream)
             : wide_c3k2::launch<false>(P, B, stream);
}

}  // namespace

// the last launch of either entry point: grid x, grid y, cluster x,
// threads, dynamic shared memory
extern "C" int unina_c3k2_last_launch(int* out) {
  const wide::LaunchShape& l = last_launch;
  out[0] = l.grid_x, out[1] = l.grid_y, out[2] = l.cluster;
  out[3] = l.threads, out[4] = l.smem;
  return 0;
}

// the wide form's dynamic shared memory at these widths, -1 at a hidden
// width it is not compiled for
extern "C" int unina_c3k2_wide_smem(int ca, int cb, int up_a, int hid,
                                    int n) {
  if (wide_c3k2::split(hid, 2 * hid) == 0 || n < 1 || n > NMAX) return -1;
  return wide_c3k2::smem_bytes(ca, cb, up_a, hid, n);
}

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
