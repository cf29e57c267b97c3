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
// That tiled kernel is compiled for C = 64 (P2); C = 32, 128 and 256 go to
// the wide form at the end of this file (weights streamed, clusters,
// csrc/wide_mma.cuh; the preds' weights come from its packed image). The
// entry point picks the form by C.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "wide_mma.cuh"

namespace {

using namespace mma90;

// the last launch's shape, for the host to read
wide::LaunchShape last_launch{};

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

// ---- the wide form: C = 32, 128, 256 and 512, wgmma ----
//
// The P3/P4 heads of the bf16 engines (C = 128 and 256; 32 at base 16, 256
// and 512 at base 64) do not fit the tiled kernel above: its conv1
// accumulators alone would be 2-4x the registers. This form streams the
// weights (csrc/wide_mma.cuh), one branch of one output tile (blockIdx.y:
// 0 cls, 1 reg) per block or cluster:
//   conv1 on the tile plus a 1-pixel halo, K = 9 x C, over the x window
//     (halo 2); c1 = bf16(ReLU(acc + b1)), 0 outside the image;
//   conv2 on the tile over c1; c2 = bf16(ReLU(acc + b2));
//   pred = c2 @ wp + bp, f32: warp-level m16n8k16 over the tile's m16 row
//     tiles, the pred weights read as fragments packed at load (8-byte
//     loads).
// Replicated plan (`body`: C = 32 and 128, one block; C = 256 on small
// images, a cluster of 2; 8 x 8 tiles, 8 x 16 at 128): every block holds
// the whole x and c1 windows, computes half of every conv's output
// channels and stores them into both blocks' windows; the pred's m16 row
// tiles spread over the cluster.
// Owned plan (`body_owned`: C = 512, and 256 where one image's grid fills
// the card; 8 x 16 tiles, a cluster of C / 128): block r owns c1's and c2's
// channels 128 r .. (two planes each) and keeps only those; A is gathered:
// conv1's x window from L2 one plane at a time into two window planes,
// conv2's c1 from each peer's shared memory two planes at a time; the
// preds are split over K, block r adding the cluster's f32 partials of a
// quarter (half) of the pixels. Both convs take K plane by plane (at 256
// walking a stream packed tap by tap), so the owned plan's sums are in
// another order than the replicated plan's.
// Bound on the H100 at base 64's head_p4 (40 x 40 x 512): 30.2 GFLOP over
// 20.5 MB, about 30.5 us at the bf16 peak; the owned plan's 15 tiles x 2
// branches x 4 = 120 blocks (one wave) read 283 MB of weights from L2
// (944 MB on the replicated plan's 4 x 8 tiles) and run at 3.7x that
// bound (PERF.md): each block's 189 M MACs at 45% of an SM's tensor-core
// peak, behind its chain of chunk steps. At base 32's head_p4 (40 x 40 x
// 256): 7.6 GFLOP, 7.6 us; 25 tiles x 2 branches x 2 = 100 blocks in the
// replicated plan.
namespace wide_head {

using namespace wide;

// The output tile: 8 x 16 at C = 128 (head_p3: 50 tiles x 2 branches, one
// wave of blocks on the H100's 132 SMs where 8 x 8 tiles make two); 4 x 8
// at C = 512, whose 8-plane windows of an 8 x 8 tile would take 250 KB (a
// 4 x 8 tile's fit beside the 64 KB ring of a cluster of 8, whose 64
// columns a block make two 32-column warpgroup parts); 8 x 8 otherwise (at
// 256 wider windows would not fit in shared memory).
__host__ __device__ constexpr int tile_rows(int c) { return 8; }
__host__ __device__ constexpr int tile_w(int c) {
  return c == 128 || c == 512 ? 16 : 8;
}
// the owned plan's tile (`body_owned`): 8 x 16
constexpr int OWNED_TR = 8, OWNED_TW = 16;
// pixels of the x window (halo 2) and of conv1's region (halo 1)
__host__ __device__ constexpr int x_px(int tr, int tw) {
  return (tr + 4) * (tw + 4);
}
__host__ __device__ constexpr int c1_px(int tr, int tw) {
  return (tr + 2) * (tw + 2);
}

__host__ __device__ constexpr int split(int c) {
  return c == 512 ? 4 : c == 256 ? 2 : c == 128 || c == 32 ? 1 : 0;
}
// The widths compiled in the owned plan (`body_owned`): a cluster of C /
// 128 blocks, each owning 128 channels (two planes) of c1 and c2. 512 runs
// the owned plan always, and its stream is packed plane by plane, as the
// owned plan multiplies it; 256 runs it where one image's grid has
// OWNED_MIN_BLOCKS blocks or more (base 64's head_p3 at 80 x 80: 200), the
// replicated plan below that (base 32's head_p4 at 40 x 40: 60 owned
// blocks would leave most SMs idle where the replicated plan has 100), and
// its stream stays tap by tap, as the replicated plan multiplies it: the
// owned plan walks it (`Feeder`'s WALK). The two plans sum in different
// orders, so the plan is picked from the image's size, never the batch's:
// a frame gets the same bits alone and inside any batch.
__host__ __device__ constexpr bool plane_major(int c) { return c == 512; }
constexpr int OWNED_MIN_BLOCKS = 128;
__host__ __device__ inline bool owned_plan(int c, int h, int w) {
  const int tiles =
      ((h + OWNED_TR - 1) / OWNED_TR) * ((w + OWNED_TW - 1) / OWNED_TW);
  return c == 512 || (c == 256 && tiles * 2 * (c / 128) >= OWNED_MIN_BLOCKS);
}
// the widest warpgroup part of the two convs: sets the ring's slots
__host__ __device__ constexpr int ring_cols(int ns, int tr, int tw) {
  return cmax(stage_cols(ns, c1_px(tr, tw)), stage_cols(ns, tr * tw));
}
// shared memory: the block's stream table and alignment, the ring, the x
// window, c1
// window, c1's
__host__ __device__ inline int smem_replicated(int c) {
  const int tr = tile_rows(c), tw = tile_w(c);
  return wide::SMEM_HEAD + ring_bytes(ring_cols(c / split(c), tr, tw)) +
         (x_px(tr, tw) + c1_px(tr, tw)) * planes(c) * PIX_BYTES;
}
// the owned plan's: the head, the ring, the block's two c1 planes and two
// x planes (which later hold the peers' c1 planes, then c2's and the
// pred's partial sums)
__host__ __device__ inline int smem_owned(int c) {
  constexpr int tr = OWNED_TR, tw = OWNED_TW;
  return wide::SMEM_HEAD + ring_bytes(ring_cols(128, tr, tw)) +
         2 * (c1_px(tr, tw) + cmax(x_px(tr, tw), c1_px(tr, tw))) *
             PIX_BYTES;
}
// the shared memory a width is admitted by: at 512 the owned plan's, else
// the replicated plan's (at 256 the owned plan needs less)
__host__ __device__ inline int smem_bytes(int c) {
  return c == 512 ? smem_owned(c) : smem_replicated(c);
}

struct Branch {
  const float* b1;
  const float* b2;
  const float* bp;  // (no,)
  int no;
  float* out;       // (B, H, W, no)
};

template <int C>
__device__ __forceinline__ void body(const bf16* __restrict__ x,
                                     const bf16* __restrict__ w33,
                                     const Branch& br, int H, int W,
                                     int tiles_x, int tiles_y,
                                     unsigned char* smem_raw, Stream& st) {
  constexpr int S = split(C);
  constexpr int PC = (C + 63) / 64;                 // planes
  constexpr int NS = C / S;
  constexpr int TR = tile_rows(C), TW = tile_w(C);  // output tile
  constexpr int XC = TW + 4, XP = x_px(TR, TW);     // x window
  constexpr int CC = TW + 2, CP = c1_px(TR, TW);    // conv1 region
  using G = Ring<ring_slot(ring_cols(NS, TR, TW))>;
  static_assert(C % 64 == 0 || S == 1, "padded planes are zeroed locally");
  const Lane L;
  const int rank = cluster_rank<S>();
  const int tile = blockIdx.x / S;
  const int b = tile / (tiles_x * tiles_y);
  const int rem = tile - b * tiles_x * tiles_y;
  const int R0 = (rem / tiles_x) * TR, W0 = (rem % tiles_x) * TW;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = ring_base(raw);
  const uint32_t x_s = ring + G::BYTES;
  const uint32_t c1_s = x_s + PC * XP * PIX_BYTES;
  const uint32_t c2_s = x_s;  // after conv1
  const uint32_t c1_off = c1_s - raw, c2_off = c2_s - raw;
  // the branch's weights: [cls | reg] streams of S blocks, then the preds
  const long long per_block = 18LL * PC * NS * 128;
  const unsigned char* img = reinterpret_cast<const unsigned char*>(w33);
  const uint2* wpf = reinterpret_cast<const uint2*>(
                         img + 2 * S * per_block) + blockIdx.y * C * 2;

  if (L.tid == 0) {
    st.nst = 0;
    st.first[0] = 0;
    st.add(9 * PC, NS * 128, stage_nh(NS, CP));
    st.add(9 * PC, NS * 128, stage_nh(NS, TR * TW));
    st.src = img + (blockIdx.y * S + rank) * per_block;
  }
  // the weights' first chunks are on their way before the windows
  init_rings<G>(raw, L);
  __syncthreads();  // the stream's table, the rings' barriers
  Feeder<G> fd(st, ring, raw + BARS, L);
  for (int g = 0; g < G::DIST; ++g) fd.issue();
  // x window: row R0-2+xr, column W0-2+xc; zeros outside the image and
  // past the last channel
  const bf16* xb = x + (size_t)b * H * W * C;
  for (int i = L.tid; i < PC * XP * 8; i += wide::THREADS) {
    const int ch = i & 7, pq = i >> 3;
    const int q = pq / XP, p = pq - q * XP;
    const int xr = p / XC, xc = p - xr * XC;
    const int gy = R0 - 2 + xr, gx = W0 - 2 + xc, c0 = q * 64 + ch * 8;
    const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W && c0 < C;
    const bf16* src = ok ? xb + ((size_t)gy * W + gx) * C + c0 : xb;
    cp_async16(x_s + q * XP * PIX_BYTES + pix_chunk(p, ch), src, ok ? 16 : 0);
  }
  cp_async_commit();
  if constexpr (PC * 64 != C)  // c1 ends inside a plane: the rest 0
    zero_smem(smem_raw + c1_off, PC * CP * PIX_BYTES, L.tid);
  cp_async_wait<0>();
  __syncthreads();
  cluster_sync<S>();  // every block runs before any stores into it
  const Peers<S> peers(smem_raw);

  // ---- conv1 on the tile plus a 1-pixel halo ----
  {
    constexpr int NH = stage_nh(NS, CP), NI = NS / NH;
    constexpr int N1 = stage_items<NH>(CP);
    const Items<NI, NH, share(N1)> items{N1};
    int xp[share(N1)];  // the top-left tap of this lane's row
#pragma unroll
    for (int i = 0; i < share(N1); ++i) {
      const int m = min(items.arow(i, L), CP - 1);
      xp[i] = (m / CC) * XC + m % CC;
    }
    float acc[share(N1)][NI / 2];
    gemm(acc, items, 0, 9 * PC, fd, L,
         [&](int i, int kc, uint32_t& win, int& px) {
           const int tap = kc / PC, q = kc - tap * PC;
           win = x_s + q * XP * PIX_BYTES;
           px = xp[i] + (tap / 3) * XC + tap % 3;
         });
    each_pair(
        acc, items, L, [&](int c) { return br.b1 + rank * NS + c; },
        [&](int m) {
          const int gy = R0 - 1 + m / CC, gx = W0 - 1 + m % CC;
          return Row{c1_off + m * PIX_BYTES, m & 7, m < CP,
                     gy >= 0 && gy < H && gx >= 0 && gx < W};
        },
        [&](const Row& r, int c, uint32_t v) {
          peers.put(r.off + col_off(rank * NS + c, CP, r.x),
                    r.inside ? v : 0u);
        });
    cluster_sync<S>();
  }
  // ---- conv2 on the tile ----
  {
    constexpr int NH = stage_nh(NS, TR * TW), NI = NS / NH;
    constexpr int N2 = stage_items<NH>(TR * TW);
    const Items<NI, NH, share(N2)> items{N2};
    int cp[share(N2)];  // the top-left tap of this lane's row in c1
#pragma unroll
    for (int i = 0; i < share(N2); ++i) {
      const int m = min(items.arow(i, L), TR * TW - 1);
      cp[i] = (m / TW) * CC + m % TW;
    }
    float acc[share(N2)][NI / 2];
    gemm(acc, items, 9 * PC, 9 * PC, fd, L,
         [&](int i, int kc, uint32_t& win, int& px) {
           const int tap = kc / PC, q = kc - tap * PC;
           win = c1_s + q * CP * PIX_BYTES;
           px = cp[i] + (tap / 3) * CC + tap % 3;
         });
    each_pair(
        acc, items, L, [&](int c) { return br.b2 + rank * NS + c; },
        [&](int m) {
          return Row{c2_off + m * PIX_BYTES, m & 7, m < TR * TW, true};
        },
        [&](const Row& r, int c, uint32_t v) {
          peers.put(r.off + col_off(rank * NS + c, TR * TW, r.x), v);
        });
    cluster_sync<S>();
  }
  // ---- pred = c2 @ wp + bp (f32): m16 row tile `rank + S * warp` ----
  const int mt = rank + S * (L.tid >> 5);
  if (mt < (TR * TW) / 16) {
    float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, c2_s + (ks >> 2) * TR * TW * PIX_BYTES +
                         pix_chunk(mt * 16 + (L.lane & 15),
                                   2 * (ks & 3) + (L.lane >> 4)));
      const uint2 f = __ldg(wpf + ks * 32 + L.lane);
      const uint32_t bfr[2] = {f.x, f.y};
      mma_m16n8k16(pd, a, bfr);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + L.g + 8 * half;
      const int gy = R0 + m / TW, gx = W0 + m % TW;
      if (gy < H && gx < W) {
        float* o = br.out + (((size_t)b * H + gy) * W + gx) * br.no;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 2 * L.tq + e;
          if (col < br.no)
            o[col] = __fadd_rn(pd[2 * half + e], __ldg(br.bp + col));
        }
      }
    }
  }
}

// ---- the owned plan: a cluster of C / 128 blocks on an 8 x 16 tile ----
//
// Block r of a branch's cluster computes, and keeps, c1's channels 128 r ..
// (two planes) over conv1's region and c2's over the tile. A is gathered:
// conv1 reads the x window from global memory (L2) one 64-channel plane at
// a time into two window planes, one copied while the other multiplies;
// conv2 copies each peer's two c1 planes from its shared memory
// (`gather`, 16-byte ld.shared::cluster) into the same space in turn and
// reads its own in place. Both convs take their K chunks plane by plane,
// the nine taps of a plane together (at 512 the weight stream is packed in
// that order, mma_pack.py; at 256 it is walked so), where the replicated
// plan takes them tap by tap: the same products, summed in another order.
// The preds are split over K: each block sums its 128 channels' products
// (m16n8k16, one m16 row tile a warp) into f32 partials in its shared
// memory; after a cluster barrier block r adds the S partials of its
// 1/S of the tile's pixels in rank order, then the bias. The barrier also
// ends every read of a peer's c1; a last one keeps each block alive while
// its peers read its partials.
template <int C>
__device__ __forceinline__ void body_owned(const bf16* __restrict__ x,
                                           const bf16* __restrict__ w33,
                                           const Branch& br, int H, int W,
                                           int tiles_x, int tiles_y,
                                           unsigned char* smem_raw,
                                           Stream& st) {
  constexpr int S = C / 128;
  constexpr int PC = C / 64, NS = C / S;  // planes; a block's columns
  static_assert(NS == 128, "a block owns two planes of c1 and c2");
  constexpr int TR = OWNED_TR, TW = OWNED_TW;       // output tile
  constexpr int XC = TW + 4, XP = x_px(TR, TW);     // x window
  constexpr int CC = TW + 2, CP = c1_px(TR, TW);    // conv1 region
  constexpr int OP = TR * TW;                       // the tile
  constexpr uint32_t XPL = XP * PIX_BYTES, CPL = CP * PIX_BYTES;
  using G = Ring<ring_slot(ring_cols(NS, TR, TW))>;
  // a stream packed tap by tap (C = 256) is walked plane by plane: the nine
  // taps of a plane lie PC chunks apart
  constexpr bool WALK = !plane_major(C);
  static_assert(OP % (16 * S) == 0 && 2 * OP * PIX_BYTES + OP * 32 <=
                    2 * cmax(XPL, CPL), "the pred's partials");
  const Lane L;
  const int rank = cluster_rank<S>();
  const int tile = blockIdx.x / S;
  const int b = tile / (tiles_x * tiles_y);
  const int rem = tile - b * tiles_x * tiles_y;
  const int R0 = (rem / tiles_x) * TR, W0 = (rem % tiles_x) * TW;
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = ring_base(raw);
  const uint32_t c1_s = ring + G::BYTES;  // c1's two planes of this block
  const uint32_t ga = c1_s + 2 * CPL;     // x planes; peers' c1; c2
  const uint32_t c2_s = ga;               // after conv2
  const uint32_t pb_s = ga + 2 * OP * PIX_BYTES;  // OP x 8 f32 partials
  const long long per_block = 18LL * PC * NS * 128;
  const unsigned char* img = reinterpret_cast<const unsigned char*>(w33);
  const uint2* wpf = reinterpret_cast<const uint2*>(
                         img + 2 * S * per_block) + blockIdx.y * C * 2;

  if (L.tid == 0) {
    st.nst = 0;
    st.first[0] = 0;
    st.add(9 * PC, NS * 128, stage_nh(NS, CP), 0, 0, WALK ? 9 : 0, PC);
    st.add(9 * PC, NS * 128, stage_nh(NS, OP), 0, 0, WALK ? 9 : 0, PC);
    st.src = img + (blockIdx.y * S + rank) * per_block;
  }
  init_rings<G>(raw, L);
  __syncthreads();  // the stream's table, the rings' barriers
  Feeder<G, WALK> fd(st, ring, raw + BARS, L);
  for (int g = 0; g < G::DIST; ++g) fd.issue();
  // x plane q into space q & 1: row R0-2+xr, column W0-2+xc; zeros outside
  // the image
  const bf16* xb = x + (size_t)b * H * W * C;
  auto load_x = [&](int q) {
    const uint32_t dst = ga + (q & 1) * XPL;
    for (int i = L.tid; i < XP * 8; i += wide::THREADS) {
      const int ch = i & 7, p = i >> 3;
      const int xr = p / XC, xc = p - xr * XC;
      const int gy = R0 - 2 + xr, gx = W0 - 2 + xc;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bf16* src =
          ok ? xb + ((size_t)gy * W + gx) * C + q * 64 + ch * 8 : xb;
      cp_async16(dst + pix_chunk(p, ch), src, ok ? 16 : 0);
    }
  };

  // ---- conv1 on the tile plus a 1-pixel halo, x plane by plane ----
  {
    constexpr int NH = stage_nh(NS, CP), NI = NS / NH;
    constexpr int N1 = stage_items<NH>(CP), M1 = share(N1);
    constexpr int KS1 = M1 * NI >= 192 ? 1 : KSTEP;
    const Items<NI, NH, M1> items{N1};
    int xp[M1];  // the top-left tap of this lane's row
#pragma unroll
    for (int i = 0; i < M1; ++i) {
      const int m = min(items.arow(i, L), CP - 1);
      xp[i] = (m / CC) * XC + m % CC;
    }
    float acc[M1][NI / 2];
    zero_acc<NI>(acc);
    load_x(0);
    cp_async_commit();
#pragma unroll 1
    for (int q = 0; q < PC; ++q) {
      if (q + 1 < PC) {
        load_x(q + 1);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // plane q is in
      gemm_more<KS1>(acc, items, 0, 9 * q, 9, fd, L,
                     [&](int i, int kc, uint32_t& win, int& px) {
                       const int tap = kc - 9 * q;
                       win = ga + (q & 1) * XPL;
                       px = xp[i] + (tap / 3) * XC + tap % 3;
                     });
      __syncthreads();  // its space may be filled again
    }
    each_pair(
        acc, items, L, [&](int c) { return br.b1 + rank * NS + c; },
        [&](int m) {
          const int gy = R0 - 1 + m / CC, gx = W0 - 1 + m % CC;
          return Row{c1_s + m * PIX_BYTES, m & 7, m < CP,
                     gy >= 0 && gy < H && gx >= 0 && gx < W};
        },
        [&](const Row& r, int c, uint32_t v) {
          st_shared(r.off + col_off(c, CP, r.x), r.inside ? v : 0u);
        });
    cluster_sync<S>();
  }
  // ---- conv2 on the tile: the c1 planes of block o, o = 0 .. S-1 ----
  {
    constexpr int NH = stage_nh(NS, OP), NI = NS / NH;
    constexpr int N2 = stage_items<NH>(OP), M2 = share(N2);
    constexpr int KS2 = M2 * NI >= 192 ? 1 : KSTEP;
    const Items<NI, NH, M2> items{N2};
    int cp[M2];  // the top-left tap of this lane's row in c1
#pragma unroll
    for (int i = 0; i < M2; ++i) {
      const int m = min(items.arow(i, L), OP - 1);
      cp[i] = (m / TW) * CC + m % TW;
    }
    float acc[M2][NI / 2];
    zero_acc<NI>(acc);
#pragma unroll 1
    for (int o = 0; o < S; ++o) {
      uint32_t src = c1_s;
      if (o != rank) {
        gather(ga, peer_addr(c1_s, o), 2 * CPL, L.tid);
        __syncthreads();
        src = ga;
      }
      gemm_more<KS2>(acc, items, 9 * PC, 18 * o, 18, fd, L,
                     [&](int i, int kc, uint32_t& win, int& px) {
                       const int q = kc / 9, tap = kc - 9 * q;
                       win = src + (q & 1) * CPL;
                       px = cp[i] + (tap / 3) * CC + tap % 3;
                     });
      __syncthreads();  // the copies may be replaced
    }
    each_pair(
        acc, items, L, [&](int c) { return br.b2 + rank * NS + c; },
        [&](int m) {
          return Row{c2_s + m * PIX_BYTES, m & 7, m < OP, true};
        },
        [&](const Row& r, int c, uint32_t v) {
          st_shared(r.off + col_off(c, OP, r.x), v);
        });
    __syncthreads();
  }
  // ---- pred = c2 @ wp + bp (f32), split over the cluster's channels ----
  float* pb = reinterpret_cast<float*>(smem_raw + (pb_s - raw));
  for (int mt = L.tid >> 5; mt < OP / 16; mt += wide::THREADS / 32) {
    float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ks = 0; ks < NS / 16; ++ks) {
      uint32_t a[4];
      ldmatrix_x4(a, c2_s + (ks >> 2) * OP * PIX_BYTES +
                         pix_chunk(mt * 16 + (L.lane & 15),
                                   2 * (ks & 3) + (L.lane >> 4)));
      const uint2 f = __ldg(wpf + (rank * (NS / 16) + ks) * 32 + L.lane);
      const uint32_t bfr[2] = {f.x, f.y};
      mma_m16n8k16(pd, a, bfr);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = mt * 16 + L.g + 8 * half;
      pb[m * 8 + 2 * L.tq] = pd[2 * half];
      pb[m * 8 + 2 * L.tq + 1] = pd[2 * half + 1];
    }
  }
  cluster_sync<S>();  // the partials are in; no block reads a peer's c1
  for (int i = L.tid; i < OP / S * 8; i += wide::THREADS) {
    const int m = rank * (OP / S) + i / 8, col = i % 8;
    const uint32_t off = pb_s + (m * 8 + col) * 4;
    float v = ld_cluster_f32(peer_addr(off, 0));
#pragma unroll
    for (int q = 1; q < S; ++q)
      v = __fadd_rn(v, ld_cluster_f32(peer_addr(off, q)));
    const int gy = R0 + m / TW, gx = W0 + m % TW;
    if (gy < H && gx < W && col < br.no)
      br.out[(((size_t)b * H + gy) * W + gx) * br.no + col] =
          __fadd_rn(v, __ldg(br.bp + col));
  }
  cluster_sync<S>();  // no block exits while a peer reads its partials
}

// ---- the large plan: C = 128 on grids of two rounds of the card ----
//
// Base 64's head_p2 (160 x 160 x 128): the replicated plan's 400 branch-
// tiles of 8 x 16 take four rounds of the H100's 132 SMs for 3.03 rounds
// of work, and each block's two warpgroups split every product's columns
// (m64n64), so each A fragment is loaded twice, and load it only after
// waiting out their previous products. This plan changes the unit and the
// pipeline:
//   unit  one branch of a 10 x 14 tile: conv1 on the 12 x 16 region (192
//     pixels: three m64 tiles, no padding), conv2 on the tile's 140
//     pixels (three m64 tiles). 192 tiles (16 rows of 12) x 2 branches =
//     384 units at 160 x 160: three on the busiest SM, 2.91 on the mean.
//     Persistent: one block an SM takes units b, b + grid, .. (unit u:
//     tile u / 2, branch u % 2), the ring running on from unit to unit;
//     the next unit's x window is one tensor copy a plane (TMA: zeros
//     outside the image, the window's swizzle) issued once this unit's
//     conv1 is done, so no warpgroup waits for the others between units.
//   products  three warpgroups, warpgroup w multiplying all 128 columns of
//     m64 tile w of each conv (m64n128k16: every A fragment loaded once,
//     64 accumulators a thread). A is loaded by ldmatrix one k16 step
//     ahead into a second register set while the step before multiplies
//     (wgmma_wait<1>), so a warpgroup's products never wait for its own A
//     loads.
//   weights  one ring of three 32 KB slots (two chunks, [128 n][64 k]
//     each) that all three warpgroups read; each warpgroup releases a
//     slot on its `empty` mbarrier once its products of the slot are
//     done. When warpgroup g % 3 releases load g, its first thread
//     refills the slot of load g - 1, which the others released a load
//     earlier, with load g - 1 + RING (one bulk copy, completing on the
//     slot's `full` mbarrier). Waiting for the others' release of the
//     load just finished would hold the copying warpgroup behind theirs
//     at every load, and one warpgroup issuing every copy trails the
//     other two.
//   pred  from conv2's accumulators: bf16(ReLU(acc + b2)) are the A
//     fragments of the 1x1 pred's m16n8k16 products (as the tiled kernel
//     at 64 does), so c2 never goes to shared memory.
// Every output is summed in the replicated plan's order (conv1's and
// conv2's chunks tap by tap, the planes of a tap in turn, k16 steps in
// order; the pred's k16 steps in order): the same bits. Bound on the H100
// at head_p2: 15.1 G MACs, about 30.5 us at the bf16 peak; this plan
// issues 21.7 G (conv2's m64 padding and the halo), 170 M on the busiest
// SM, and runs at about 2x the bound (PERF.md).
namespace large {

constexpr int C = 128, PC = 2;                      // width, planes
constexpr int TR = 10, TW = 14;                     // output tile
constexpr int XR = TR + 4, XC = TW + 4;             // x window: 14 x 18
constexpr int CC = TW + 2, CP = (TR + 2) * CC;      // conv1 region: 192
constexpr int OP = TR * TW;                         // the tile: 140
constexpr int WGS = 3, THREADS = 128 * WGS;
static_assert(CP == 64 * WGS && OP <= 64 * WGS,
              "a warpgroup an m64 tile of each conv");
constexpr int CHUNK = C * 128;                      // [128 n][64 k] bf16
constexpr int SLOT = 2 * CHUNK, RING = 3;           // a load: two chunks
constexpr int KL = 9 * PC / 2;                      // loads of a conv
constexpr int LOADS = 2 * KL;                       // loads of a unit
constexpr long long PER = (long long)LOADS * SLOT;  // a branch's stream
constexpr int XPLANE = 32768;  // an x plane (1024-aligned for the swizzle)
constexpr int X_BYTES = XR * XC * PIX_BYTES;        // the copy of a plane
constexpr int SMEM = wide::SMEM_HEAD + RING * SLOT + PC * XPLANE +
                     PC * CP * PIX_BYTES;
static_assert(X_BYTES <= XPLANE && SMEM <= wide::SMEM_MAX,
              "the large plan fits a block");
// where one image's replicated grid (8 x 16 tiles, both branches) has
// wide::WALK_MIN_BLOCKS blocks or more (base 64's head_p2: 400). Picked
// by one image's size, never the batch's.
__host__ __device__ inline bool plan(int c, int h, int w) {
  return c == C &&
         ((h + 7) / 8) * ((w + 15) / 16) * 2 >= wide::WALK_MIN_BLOCKS;
}

// The kernel's arguments, one __grid_constant__ parameter (beside x's
// tensor map): read where they are used, not held in registers across
// the products
struct Params {
  const unsigned char* img;      // w33: the cls stream, the reg stream,
  wide_head::Branch br[2];       //   the preds; cls, reg
  int H, W, tiles_x, tiles_y, units;
};

// unit k of this block: branch, image, top row and left column of its
// tile
struct Unit {
  int branch, b, R0, W0;
  __device__ Unit(const Params& p, int k) {
    const int u = (int)blockIdx.x + k * (int)gridDim.x;
    const int tile = u >> 1;
    branch = u & 1;
    b = tile / (p.tiles_x * p.tiles_y);
    const int rem = tile - b * p.tiles_x * p.tiles_y;
    R0 = (rem / p.tiles_x) * TR;
    W0 = (rem % p.tiles_x) * TW;
  }
};
// this block's units
__device__ __forceinline__ int unit_count(const Params& p) {
  return (p.units - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
}

// The block's shared memory from `raw`: RING `full` mbarriers, RING
// `empty` ones, x's mbarrier, the ring's slots (1024-aligned), the x
// window's two planes, c1. Load g of the block's walk (unit g / LOADS of
// the block, load g % LOADS of that unit's branch stream: two chunks in
// stream order) lies in slot g % RING.
__device__ __forceinline__ uint32_t x_bar(uint32_t raw) {
  return raw + 2 * RING * 8;
}
__device__ __forceinline__ uint32_t slots_of(uint32_t raw) {
  return (raw + (2 * RING + 1) * 8 + 1023u) & ~1023u;
}
__device__ __forceinline__ uint32_t x_of(uint32_t raw) {
  return slots_of(raw) + RING * SLOT;
}
__device__ __forceinline__ uint32_t c1_of(uint32_t raw) {
  return x_of(raw) + PC * XPLANE;
}
__device__ __forceinline__ uint32_t slot(uint32_t raw, int g) {
  return slots_of(raw) + (g % RING) * SLOT;
}
__device__ __forceinline__ void wait_full(uint32_t raw, int g) {
  mbar_wait(raw + (g % RING) * 8, (g / RING) & 1);
}
__device__ __forceinline__ void issue(const Params& p, uint32_t raw, int g) {
  const int unit = (int)blockIdx.x + (g / LOADS) * (int)gridDim.x;
  const uint32_t bar = raw + (g % RING) * 8;
  mbar_expect(bar, SLOT);
  bulk_copy(slot(raw, g),
            p.img + (unit & 1) * PER + (long long)(g % LOADS) * SLOT, SLOT,
            bar);
}
// this warpgroup's products of load g are done; if g % 3 is this
// warpgroup, its first thread then copies load g - 1 + RING (of the
// block's `total`) into the slot of load g - 1 once every warpgroup has
// released that
__device__ __forceinline__ void release(const Params& p, uint32_t raw,
                                        int g, int total) {
  if ((threadIdx.x & 127) != 0) return;
  mbar_arrive(raw + (RING + g % RING) * 8);
  const int h = g - 1 + RING;
  if (g % WGS == (int)threadIdx.x >> 7 && g > 0 && h < total) {
    mbar_wait(raw + (RING + (g - 1) % RING) * 8, ((g - 1) / RING) & 1);
    issue(p, raw, h);
  }
}
// the x window of the block's unit k, a tensor copy a plane: rows R0 - 2
// .., columns W0 - 2 .., zeros outside the image
__device__ __forceinline__ void issue_x(const Params& p,
                                        const CUtensorMap* xmap,
                                        uint32_t raw, int k) {
  const Unit u(p, k);
  mbar_expect(x_bar(raw), PC * X_BYTES);
  for (int q = 0; q < PC; ++q)
    tensor_copy(x_of(raw) + q * XPLANE, xmap, q * 64, u.W0 - 2, u.R0 - 2,
                u.b, x_bar(raw));
}

// One conv's products for this warpgroup's m64 tile, all 128 columns: KL
// loads from the ring's load g0, two chunks of four k16 steps each, A one
// step ahead. `row` is this lane's A row, the top-left tap's pixel, in
// the window at `win` (planes `plane` bytes apart, rows `pitch` pixels).
__device__ __forceinline__ void gemm(float (&acc)[64], const Params& p,
                                     uint32_t raw, int total, int g0,
                                     uint32_t win, int plane, int row,
                                     int pitch) {
#pragma unroll
  for (int j = 0; j < 64; ++j) acc[j] = 0.f;
  const int hi = (threadIdx.x >> 4) & 1;  // lanes 16-31: the upper 8
  auto addr = [&](int kc, int ks) {        // chunk kc: tap kc / 2, plane
    const int tap = kc >> 1;
    return win + (kc & 1) * plane +
           pix_chunk(row + (tap / 3) * pitch + tap % 3, 2 * ks + hi);
  };
  uint32_t a[2][4];
  ldmatrix_x4(a[0], addr(0, 0));
  wait_full(raw, g0);
#pragma unroll 1
  for (int kl = 0; kl < KL; ++kl) {
    const uint64_t desc = b_desc(slot(raw, g0 + kl));
#pragma unroll
    for (int st = 0; st < 8; ++st) {  // chunk 2 kl + st / 4, k16 st % 4
      wgmma_fence();
      wgmma_m64n128k16(acc, a[st & 1],
                       desc + (uint64_t)((st >> 2) * (CHUNK >> 4) +
                                         (st & 3) * 2));
      wgmma_commit();
      wgmma_wait<1>();  // the step before is done with its A and slot
      if (st == 0 && kl > 0) release(p, raw, g0 + kl - 1, total);
      const int nc = st < 7 ? 2 * kl + ((st + 1) >> 2)
                            : min(2 * kl + 2, 2 * KL - 1);
      ldmatrix_x4(a[(st + 1) & 1], addr(nc, (st + 1) & 3));
      if (st == 7 && kl + 1 < KL) wait_full(raw, g0 + kl + 1);
    }
  }
  wgmma_wait<0>();
  release(p, raw, g0 + KL - 1, total);
}

// conv1 of the block's unit k, m64 tile w of the region: c1 =
// bf16(ReLU(acc + b1)), 0 outside the image, into the c1 window
__device__ __forceinline__ void conv1(const Params& p, uint32_t raw,
                                      int total, int k, int w) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int m0 = w * 64 + warp * 16 + (lane & 15);
  float acc[64];
  gemm(acc, p, raw, total, k * LOADS, x_of(raw), XPLANE,
       (m0 / CC) * XC + m0 % CC, XC);
  const Unit u(p, k);
  const float* __restrict__ b1 = p.br[u.branch].b1;
  const uint32_t c1_s = c1_of(raw);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = w * 64 + warp * 16 + g + 8 * half;
    const int gy = u.R0 - 1 + m / CC, gx = u.W0 - 1 + m % CC;
    const bool inside = gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * tq;
      const uint32_t v = pack_bf16(
          fmaxf(__fadd_rn(acc[4 * j + 2 * half], __ldg(b1 + col)), 0.f),
          fmaxf(__fadd_rn(acc[4 * j + 2 * half + 1], __ldg(b1 + col + 1)),
                0.f));
      st_shared(c1_s + (j >> 3) * CP * PIX_BYTES + pix_chunk(m, j & 7) +
                    tq * 4,
                inside ? v : 0u);
    }
  }
}

// conv2 of the block's unit k, m64 tile w of the tile (its rows past the
// tile's 140 repeat the last pixel and are dropped), and the pred: c2 =
// bf16(ReLU(acc + b2)) as m16n8k16 A fragments, f32 sums with the
// branch's fragment image, + bp, stored
__device__ __forceinline__ void conv2(const Params& p, uint32_t raw,
                                      int total, int k, int w) {
  const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
  const int m0 = min(w * 64 + warp * 16 + (lane & 15), OP - 1);
  float acc[64];
  gemm(acc, p, raw, total, k * LOADS + KL, c1_of(raw), CP * PIX_BYTES,
       (m0 / TW) * CC + m0 % TW, CC);
  const Unit u(p, k);
  const wide_head::Branch& br = p.br[u.branch];
  const uint2* __restrict__ wpf =
      reinterpret_cast<const uint2*>(p.img + 2 * PER) + u.branch * C * 2;
  const int g = lane >> 2, tq = lane & 3;
  float pd[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < C / 16; ++ks) {
    uint32_t af[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // q: 0 row g, 1 row g+8 (columns 16ks+2tq), 2/3 the same +8
      const int col = 16 * ks + 8 * (q >> 1) + 2 * tq;
      af[q] = pack_bf16(
          fmaxf(__fadd_rn(acc[8 * ks + 2 * q], __ldg(br.b2 + col)), 0.f),
          fmaxf(__fadd_rn(acc[8 * ks + 2 * q + 1], __ldg(br.b2 + col + 1)),
                0.f));
    }
    const uint2 f = __ldg(wpf + ks * 32 + lane);
    const uint32_t bfr[2] = {f.x, f.y};
    mma_m16n8k16(pd, af, bfr);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = w * 64 + warp * 16 + g + 8 * half;
    const int gy = u.R0 + m / TW, gx = u.W0 + m % TW;
    if (m < OP && gy < p.H && gx < p.W) {
      float* o = br.out + (((size_t)u.b * p.H + gy) * p.W + gx) * br.no;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 2 * tq + e;
        if (col < br.no)
          o[col] = __fadd_rn(pd[2 * half + e], __ldg(br.bp + col));
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
head_large_kernel(const __grid_constant__ Params p,
                  const __grid_constant__ CUtensorMap xmap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const int w = (int)threadIdx.x >> 7;  // warpgroup: its m64 tiles
  const int count = unit_count(p);
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(raw + s * 8, 1);               // full: the copy
      mbar_init(raw + (RING + s) * 8, WGS);    // empty: each warpgroup
    }
    mbar_init(x_bar(raw), 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int g = 0; g < RING && g < count * LOADS; ++g) issue(p, raw, g);
    issue_x(p, &xmap, raw, 0);
  }
#pragma unroll 1
  for (int k = 0; k < count; ++k) {
    mbar_wait(x_bar(raw), k & 1);  // unit k's x window is in
    conv1(p, raw, count * LOADS, k, w);
    __syncthreads();  // c1 is complete; every warpgroup is done with x
    if (threadIdx.x == 0 && k + 1 < count) issue_x(p, &xmap, raw, k + 1);
    // c1 is rewritten by unit k + 1's conv1 only after every warpgroup
    // has released this unit's conv2 loads: the ring's order keeps it
    conv2(p, raw, count * LOADS, k, w);
  }
}

int launch(const bf16* x, const bf16* w33, wide_head::Branch cls,
           wide_head::Branch reg, int B, int H, int W, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(head_large_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  CUtensorMap xmap;
  const int err = nhwc_tensor_map(&xmap, x, B, H, W, C, 64, XC, XR, true);
  if (err != 0) return err;
  Params p{reinterpret_cast<const unsigned char*>(w33), {cls, reg}, H, W,
           (W + TW - 1) / TW, (H + TR - 1) / TR, 0};
  p.units = 2 * B * p.tiles_x * p.tiles_y;
  const int blocks = p.units < sms ? p.units : sms;
  last_launch = wide::LaunchShape{blocks, 1, 1, THREADS, SMEM};
  return launch_ex(head_large_kernel, dim3(blocks, 1, 1), 1, THREADS, SMEM,
                   stream, p, xmap);
}

}  // namespace large

// One kernel function a compiled body: C the width, OWN the owned plan;
// the launcher picks the instance
template <int C, bool OWN>
__global__ void __launch_bounds__(wide::THREADS, 1)
head_wide_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w33,
                 Branch cls, Branch reg, int H, int W, int tiles_x,
                 int tiles_y) {
  extern __shared__ __align__(16) unsigned char wide_smem[];
  Stream& st = *reinterpret_cast<Stream*>(wide_smem);
  const Branch& br = blockIdx.y == 0 ? cls : reg;
  if constexpr (OWN)
    body_owned<C>(x, w33, br, H, W, tiles_x, tiles_y, wide_smem, st);
  else
    body<C>(x, w33, br, H, W, tiles_x, tiles_y, wide_smem, st);
}

template <int C, bool OWN>
int launch_body(const bf16* x, const bf16* w33, Branch cls, Branch reg,
                int B, int H, int W, void* stream) {
  constexpr int S = OWN ? C / 128 : split(C);
  const int smem = OWN ? smem_owned(C) : smem_replicated(C);
  if (smem > wide::SMEM_MAX) return (int)cudaErrorInvalidValue;
  static bool ready = false;  // one per compiled body
  if (!ready) {
    cudaError_t err = cudaFuncSetAttribute(
        head_wide_kernel<C, OWN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, wide::SMEM_MAX);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  constexpr int tr = OWN ? OWNED_TR : tile_rows(C);
  constexpr int tw = OWN ? OWNED_TW : tile_w(C);
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + tr - 1) / tr;
  return launch_cluster(last_launch, head_wide_kernel<C, OWN>, S,
                        tiles_x * tiles_y * B * S, 2, smem, stream, x, w33,
                        cls, reg, H, W, tiles_x, tiles_y);
}

int launch(const bf16* x, const bf16* w33, Branch cls, Branch reg, int C,
           int B, int H, int W, void* stream) {
  switch (C) {
    case 512:
      return launch_body<512, true>(x, w33, cls, reg, B, H, W, stream);
    case 256:
      return owned_plan(C, H, W)
                 ? launch_body<256, true>(x, w33, cls, reg, B, H, W, stream)
                 : launch_body<256, false>(x, w33, cls, reg, B, H, W,
                                           stream);
    case 128:
      return large::plan(C, H, W)
                 ? large::launch(x, w33, cls, reg, B, H, W, stream)
                 : launch_body<128, false>(x, w33, cls, reg, B, H, W,
                                           stream);
    case 32:
      return launch_body<32, false>(x, w33, cls, reg, B, H, W, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wide_head

}  // namespace

// the last launch: grid x, grid y, cluster x, threads, dynamic shared
// memory
extern "C" int unina_head_last_launch(int* out) {
  const wide::LaunchShape& l = last_launch;
  out[0] = l.grid_x, out[1] = l.grid_y, out[2] = l.cluster;
  out[3] = l.threads, out[4] = l.smem;
  return 0;
}

// the wide form's dynamic shared memory at width c, -1 at a width it is
// not compiled for
extern "C" int unina_head_wide_smem(int c) {
  return wide_head::split(c) == 0 ? -1 : wide_head::smem_bytes(c);
}

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
                         (const float*)bcp, nc, (float*)out_cls};
    wide_head::Branch wr{(const float*)br1, (const float*)br2,
                         (const float*)brp, nr, (float*)out_reg};
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
  last_launch = wide::LaunchShape{blocks, 1, 1, THREADS, SMEM_BYTES};
  head_mma_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)w33, cls, reg, H, W, tiles_x, tiles_y,
      ntiles);
  return (int)cudaGetLastError();
}
