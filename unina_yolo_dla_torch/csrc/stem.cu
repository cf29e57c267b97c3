// Fused stem + stage1 downsample over the column-merged frame, both
// contractions on the tensor cores.
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
//   device memory. About 2.3 us of bf16 tensor-core time against 1.7 us
//   of memory traffic: bound by operations, narrowly.
// Design: two implicit GEMMs per 4 x 16 output tile (operand layouts in
//   csrc/mma_sm90.cuh). Persistent blocks, one per SM, of two warpgroups;
//   each warpgroup walks its own tiles. Both weight images (16 KB stem,
//   64 KB stage1, packed on the host) are copied to shared memory once
//   per block.
//   - Stem: M = the 10 x 17 merged-stem pixels stage1 needs for the tile
//     (170, as three m64 products; rows >= 170 repeat a pixel and are
//     dropped), N = 64, K = 48 per kernel row kh. In NHWC a frame pixel's
//     left neighbour is the 48 bytes before it, so the taps (kw = 0..1, c)
//     of one kh are 96 contiguous bytes of the frame window: three k16
//     steps through ldmatrix, each lane giving the address of its own
//     window pixel. The window (11 x 18 frame pixels of 48 bytes, zero
//     outside the image, so "the pixel before" never wraps) needs no
//     swizzle: eight pixels 48 bytes apart fall into eight different
//     16-byte bank groups. B per kh is the (48, 64) slab zero-padded to
//     one [64 n][64 k] tile, of which three k16 steps are issued.
//   - The stem's epilogue (bias, ReLU, 0 outside the image, bf16) writes
//     stage1's swizzled window in shared memory; stage1's products and
//     store are csrc/stage1_tile.cuh, the code stage1.cu runs.
//   - The next tile's frame window arrives by cp.async under this tile's
//     products (two stages per warpgroup).
//   - Edge tiles are masked: any even H, any W2, any batch.
//   Other widths (base 16 and 64 engines; C = 2 x base stem output and
//   stage1 channels, csrc/stage1_tile.cuh Width): at C = 32 the same walk
//   with m64n32 products. At C = 128 (256 KB of stage1 weights) a cluster
//   of two blocks shares each tile (`fused_stem_stage1_kernel_pair`):
//   block r computes stem columns and stage1 columns 64 r.., so each stem
//   column of a window is computed once; a producer warpgroup runs the
//   stem and writes its 64 channels into its own plane of the window and
//   its peer's (distributed shared memory), a consumer warpgroup stage1;
//   the frame window arrives by one multicast tensor copy a tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_tile.cuh"

namespace {

using namespace stage1_tile;

constexpr int CF = 24;             // merged frame channels
constexpr int FPIX_BYTES = CF * 2; // one frame pixel: three 16-byte chunks
constexpr int FR = SR + 1, FC = SC + 1;  // frame window of one tile
constexpr int FWIN_PX = FR * FC;
constexpr int FWIN_BYTES = FWIN_PX * FPIX_BYTES;
constexpr int MT = (WIN_PX + 63) / 64;   // m64 products of the stem
constexpr int KS = 2 * CF / 16;          // k16 steps per kh
static_assert(FWIN_BYTES % 16 == 0 && 2 * CF % 16 == 0, "16-byte chunks");
static_assert(KS * 16 <= 64, "one B tile per kh");

template <int C>
struct Cfg {
  using W = Width<C>;
  static_assert(C < 128, "C = 128: the cluster kernel (Pair)");
  static constexpr int WS_TILE = C * 128;  // stem weights of one kh
  static constexpr int WS_BYTES = 2 * WS_TILE;
  static constexpr int WGS = 2;
  static constexpr int THREADS = WGS * 128;
  // per warpgroup: stage1's window, the staged output, two frame stages
  static constexpr int WG_BYTES =
      (W::WIN_BYTES + W::OUT_BYTES + 2 * FWIN_BYTES + 127) / 128 * 128;
  static constexpr int SMEM_BYTES =
      1024 + W::W_BYTES + WS_BYTES + WGS * WG_BYTES;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

// frame window pixel (fr, fc) <- frame row 2*r0 - 3 + fr, merged column
// w0 - 2 + fc; zeros outside the image
__device__ __forceinline__ void load_frame(uint32_t fwin, const Tile& tl,
                                           int H, int W2, int t) {
  for (int i = t; i < FWIN_PX * 3; i += 128) {
    int p = i / 3, ch = i - 3 * p;
    int fr = p / FC, fc = p - fr * FC;
    int f = 2 * tl.r0 - 3 + fr, c = tl.w0 - 2 + fc;
    bool ok = f >= 0 && f < H && c >= 0 && c < W2;
    const bf16* src = ok ? tl.x + ((size_t)f * W2 + c) * CF + ch * 8 : tl.x;
    cp_async16(fwin + p * FPIX_BYTES + ch * 16, src, ok ? 16 : 0);
  }
}

template <int C>
__global__ void __launch_bounds__(Cfg<C>::THREADS, 1)
fused_stem_stage1_kernel(const bf16* __restrict__ xm,
                         const bf16* __restrict__ wspk,
                         const float* __restrict__ bs,
                         const bf16* __restrict__ w1pk,
                         const float* __restrict__ b1, bf16* __restrict__ out,
                         int H, int W2, int tiles_x, int tiles_y,
                         int ntiles) {
  using W = Width<C>;
  using K = Cfg<C>;
  constexpr int N = W::N;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t w1_s = base;
  const uint32_t ws_s = base + W::W_BYTES;
  const uint32_t st_s = ws_s + K::WS_BYTES + wg * K::WG_BYTES;  // stage1 win
  const uint32_t out_s = st_s + W::WIN_BYTES;
  const uint32_t fr_s = out_s + W::OUT_BYTES;                  // frame stages
  unsigned char* st_p = smem_raw + (st_s - smem_u32(smem_raw));
  unsigned char* out_p = smem_raw + (out_s - smem_u32(smem_raw));

  const Walk wk = walk<K::WGS>(wg);
  const int stride = wk.stride;
  int tile = wk.first;

  for (int i = threadIdx.x; i < W::W_BYTES / 16; i += K::THREADS)
    cp_async16(w1_s + i * 16, w1pk + i * 8, 16);
  for (int i = threadIdx.x; i < K::WS_BYTES / 16; i += K::THREADS)
    cp_async16(ws_s + i * 16, wspk + i * 8, 16);
  if (tile < ntiles)
    load_frame(fr_s, tile_at<CF, C>(tile, tiles_x, tiles_y, xm, out, H, W2),
               H, W2, t);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float bsv[N / 4], b1v[N / 4];
  load_bias<N>(bsv, bs, lane);
  load_bias<N>(b1v, b1, lane);
  const uint64_t w1desc = b_desc(w1_s);
  const uint64_t wsdesc = b_desc(ws_s);
  // this lane's stem A rows: stem window pixel m = (sr, sc) reads frame
  // window pixels (sr + kh, sc) and (sr + kh, sc + 1), 96 contiguous bytes
  uint32_t frow[MT];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    int m = min(mt * 64 + warp * 16 + (lane & 15), WIN_PX - 1);
    frow[mt] = ((m / SC) * FC + m % SC) * FPIX_BYTES + (lane >> 4) * 16;
  }

  for (int it = 0; tile < ntiles; tile += stride, ++it) {
    const Tile tl = tile_at<CF, C>(tile, tiles_x, tiles_y, xm, out, H, W2);
    const uint32_t fwin = fr_s + (it & 1) * FWIN_BYTES;
    if (tile + stride < ntiles)
      load_frame(
          fr_s + ((it + 1) & 1) * FWIN_BYTES,
          tile_at<CF, C>(tile + stride, tiles_x, tiles_y, xm, out, H, W2), H,
          W2, t);
    cp_async_commit();

    {
      // the stem: three m64 products, A double-buffered by product
      float sacc[MT][W::ACC];
      uint32_t a[2][2][KS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < W::ACC; ++j) sacc[mt][j] = 0.f;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            ldmatrix_x4(a[mt & 1][kh][ks],
                        fwin + frow[mt] + kh * FC * FPIX_BYTES + ks * 32);
        wgmma_fence();
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            wgmma_k16<N>(sacc[mt], a[mt & 1][kh][ks],
                         wsdesc + (uint64_t)((kh * K::WS_TILE + ks * 32) >>
                                             4));
        wgmma_commit();
        wgmma_wait<1>();  // product mt-1 is done with the other A buffer
      }
      wgmma_wait<0>();

      // bias, ReLU, 0 outside the image, bf16 -> stage1's window. Every
      // warp left the previous tile's stage1 products before store()'s
      // barriers.
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = mt * 64 + warp * 16 + g + 8 * half;
          if (m < WIN_PX) {
            const int s = 2 * tl.r0 - 2 + m / SC, c = tl.w0 - 1 + m % SC;
            const bool inside = s >= 0 && s < H && c >= 0 && c < W2;
#pragma unroll
            for (int j = 0; j < N / 8; ++j) {
              float v0 = fmaxf(
                  __fadd_rn(sacc[mt][4 * j + 2 * half], bsv[2 * j]), 0.f);
              float v1 = fmaxf(
                  __fadd_rn(sacc[mt][4 * j + 2 * half + 1], bsv[2 * j + 1]),
                  0.f);
              *reinterpret_cast<uint32_t*>(st_p + px_chunk<C>(m, j) +
                                           tq * 4) =
                  inside ? pack_bf16(v0, v1) : 0u;
            }
          }
        }
    }
    warpgroup_barrier(1 + wg);  // the window is whole

    float acc[W::ACC];
    products<W>(acc, st_s, w1desc, warp, lane);
    // store() also waits for the next frame window's copies
    store<W>(acc, b1v, out_p, tl.out, tl.r0, tl.w0, H / 2, W2, 0, t,
             1 + wg);
  }
}

// C = 128: the two blocks of a cluster share every tile, block `rank`
// computing stem columns and stage1 output columns 64 rank.. (16 KB of
// stem and 128 KB of stage1 weights a block), so each stem column of a
// window is computed once. The stage1 window is two 64-channel planes:
// the block's own (its stem columns) and a landing plane for the peer's.
// Two warpgroups a block: the producer (warpgroup 0) runs a tile's stem
// products and epilogue (bias, ReLU, 0 outside the image, bf16; gathered
// into whole 16-byte chunks by lane exchanges, `quad_chunks`), writes the
// own plane once the consumer has read the last tile's, and sends it by
// bulk copies (one a warp: its rows) into the peer's landing plane; the
// consumer (warpgroup 1) runs stage1's products over both planes and the
// store. The landing plane has two buffers (a copy may land while the
// peer's consumer still multiplies the last tile), and the producer's stem
// of tile i+1 runs under the consumer's products of tile i; what stands
// between two tiles' products is the own plane's write and its copy to
// the peer. The frame window arrives by one tensor copy a tile (zeros
// outside the image), multicast to both blocks by one of them in turn,
// into one stage.
//
// Shared memory (bytes): stage1 weights 131,072 + stem weights 16,384 +
// own plane 21,760 + two landing planes 43,520 + staging 8,192 + frame
// 9,504 + mbarriers 56 (+ 1,024 alignment) = 231,512 of 232,448: a second
// own plane or frame stage does not fit.
struct Pair {
  using W = Width<128>;
  static constexpr int N = 64;                   // a block's columns
  static constexpr int WS_BYTES = 2 * N * 128;   // its stem weights
  static constexpr int PLANE = WIN_PX * 128;     // 64 channels of a window
  static constexpr int WS_OFF = W::W_BYTES;
  static constexpr int OWN_OFF = WS_OFF + WS_BYTES;
  static constexpr int LAND_OFF = OWN_OFF + PLANE;
  static constexpr int OUT_OFF = LAND_OFF + 2 * PLANE;
  static constexpr int FR_OFF = OUT_OFF + W::OUT_BYTES;
  static constexpr int BAR_OFF = FR_OFF + FWIN_BYTES;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 56;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(WS_OFF % 1024 == 0 && FR_OFF % 128 == 0, "alignment");
  // mbarriers: the frame stage full (1 arrival + bytes) and free (one
  // arrival from each block's producer, at the block that copies next);
  // landing plane b full (this block's expecting arrival + the bytes of
  // the peer's copies) and free (1 from the peer's consumer, at the block
  // that copies into it); the own plane copied (1 from the peer's
  // consumer)
  static constexpr int FR_FULL = 0, FR_FREE = 8, LAND_FULL = 16,
                       LAND_FREE = 32, OWN_READ = 48;
  // named barriers: the producer's own, the consumer's own (store), the
  // own plane written, the own plane read
  static constexpr int BAR_PROD = 1, BAR_CONS = 2, OWN_FULL = 3,
                       OWN_FREE = 4;
};

// A row's 64 channels as the accumulator layout spreads them over a quad
// of lanes (lane tq: word tq of each 16-byte chunk j, v[j]), gathered by
// two exchanges into whole chunks: lane tq returns chunks tq and tq + 4.
__device__ __forceinline__ void quad_chunks(const uint32_t (&v)[8], int tq,
                                            uint4& c0, uint4& c1) {
  const bool odd = tq & 1, upper = tq & 2;
  uint2 piece[4];  // bytes 8 (tq >> 1).. of chunk 2p + (tq & 1)
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const uint32_t y =
        __shfl_xor_sync(0xffffffffu, odd ? v[2 * p] : v[2 * p + 1], 1);
    piece[p] = odd ? make_uint2(y, v[2 * p + 1]) : make_uint2(v[2 * p], y);
  }
  uint4 c[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint2 send = upper ? piece[2 * h] : piece[2 * h + 1];
    const uint2 r = make_uint2(__shfl_xor_sync(0xffffffffu, send.x, 2),
                               __shfl_xor_sync(0xffffffffu, send.y, 2));
    c[h] = upper ? make_uint4(r.x, r.y, piece[2 * h + 1].x,
                              piece[2 * h + 1].y)
                 : make_uint4(piece[2 * h].x, piece[2 * h].y, r.x, r.y);
  }
  c0 = c[0];
  c1 = c[1];
}

__global__ void __launch_bounds__(256, 1)
fused_stem_stage1_kernel_pair(const __grid_constant__ CUtensorMap frame,
                              const bf16* __restrict__ xm,
                              const bf16* __restrict__ wspk,
                              const float* __restrict__ bs,
                              const bf16* __restrict__ w1pk,
                              const float* __restrict__ b1,
                              bf16* __restrict__ out, int H, int W2,
                              int tiles_x, int tiles_y, int ntiles) {
  using W = Width<128>;
  using K = Pair;
  constexpr int N = K::N;
  constexpr int C = 128;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int rank = cluster_ctarank(), peer = rank ^ 1;
  const uint32_t w1_s = base, ws_s = base + K::WS_OFF;
  const uint32_t own_s = base + K::OWN_OFF, land_s = base + K::LAND_OFF;
  const uint32_t fr_s = base + K::FR_OFF, bar_s = base + K::BAR_OFF;
  const uint32_t peer_bars = peer_addr(bar_s, peer);
  const int stride = gridDim.x / 2;
  const int first = blockIdx.x / 2;
  const int n = first < ntiles ? (ntiles - 1 - first) / stride + 1 : 0;
  auto at = [&](int i) {
    return tile_at<CF, C>(first + i * stride, tiles_x, tiles_y, xm, out, H,
                          W2);
  };

  if (threadIdx.x == 0) {
    mbar_init(bar_s + K::FR_FULL, 1);
    mbar_init(bar_s + K::FR_FREE, 2);
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_s + K::LAND_FULL + 8 * b, 1);
      mbar_init(bar_s + K::LAND_FREE + 8 * b, 1);
    }
    mbar_init(bar_s + K::OWN_READ, 1);
    mbar_init_fence();
  }
  // this block's half of the stage1 image, and of each kh's stem tile
  const bf16* w1src = w1pk + (size_t)rank * (W::W_BYTES / 2);
  for (int i = threadIdx.x; i < W::W_BYTES / 16; i += 256)
    cp_async16(w1_s + i * 16, w1src + i * 8, 16);
  for (int i = threadIdx.x; i < K::WS_BYTES / 16; i += 256) {
    const int kh = i / (N * 8), j = i - kh * N * 8;
    cp_async16(ws_s + i * 16, wspk + ((size_t)kh * C + rank * N) * 64 + j * 8,
               16);
  }
  cp_async_commit();
  // both blocks' mbarriers are set up before either signals the other
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == 0 && n > 0) {
    mbar_expect(bar_s + K::FR_FULL, FWIN_BYTES);
    if (rank == 0) {
      const Tile tl = at(0);
      tensor_copy_mc(fr_s, &frame, 0, tl.w0 - 2, 2 * tl.r0 - 3, tl.b,
                     bar_s + K::FR_FULL, 0x3);
    }
  }
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  if (wg == 0) {
    // ---- producer: the stem ----
    float bsv[N / 4];
    load_bias<N>(bsv, bs + rank * N, lane);
    const uint64_t wsdesc = b_desc(ws_s);
    const uint32_t peer_land = peer_addr(land_s, peer);
    // this lane's stem A rows (as the one-block form's)
    uint32_t frow[MT];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      int m = min(mt * 64 + warp * 16 + (lane & 15), WIN_PX - 1);
      frow[mt] = ((m / SC) * FC + m % SC) * FPIX_BYTES + (lane >> 4) * 16;
    }
    for (int i = 0; i < n; ++i) {
      const Tile tl = at(i);
      mbar_wait(bar_s + K::FR_FULL, i & 1);

      // stem columns 64 rank..: three m64 products, A double-buffered by
      // product, the K order of the one-block form
      float sacc[MT][W::ACC];
      uint32_t a[2][2][KS][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < W::ACC; ++j) sacc[mt][j] = 0.f;
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            ldmatrix_x4(a[mt & 1][kh][ks],
                        fr_s + frow[mt] + kh * FC * FPIX_BYTES + ks * 32);
        wgmma_fence();
#pragma unroll
        for (int kh = 0; kh < 2; ++kh)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            wgmma_k16<N>(sacc[mt], a[mt & 1][kh][ks],
                         wsdesc + (uint64_t)((kh * N * 128 + ks * 32) >> 4));
        wgmma_commit();
        wgmma_wait<1>();
      }
      wgmma_wait<0>();

      if (i + 1 < n) {
        // every producer thread of this block has read the frame: tell the
        // block that copies the next one, which waits for both blocks
        // (warp 0 waits as a whole: its lanes shuffle together below)
        named_sync(K::BAR_PROD, 128);
        const int next = (i + 1) & 1;
        if (t == 0) {
          mbar_expect(bar_s + K::FR_FULL, FWIN_BYTES);
          mbar_arrive_cluster_relaxed(
              (next == rank ? bar_s : peer_bars) + K::FR_FREE);
        }
        if (warp == 0 && next == rank) {
          mbar_poll(bar_s + K::FR_FREE, (i >> 1) & 1);
          if (t == 0) {
            const Tile nt = at(i + 1);
            tensor_copy_mc(fr_s, &frame, 0, nt.w0 - 2, 2 * nt.r0 - 3, nt.b,
                           bar_s + K::FR_FULL, 0x3);
          }
        }
        __syncwarp();
      }

      // bias, ReLU, 0 outside the image, bf16, in registers ...
      uint32_t v[MT][2][N / 8];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = mt * 64 + warp * 16 + g + 8 * half;
          const int sr = 2 * tl.r0 - 2 + m / SC, c = tl.w0 - 1 + m % SC;
          const bool inside = sr >= 0 && sr < H && c >= 0 && c < W2;
#pragma unroll
          for (int j = 0; j < N / 8; ++j) {
            float v0 = fmaxf(
                __fadd_rn(sacc[mt][4 * j + 2 * half], bsv[2 * j]), 0.f);
            float v1 = fmaxf(
                __fadd_rn(sacc[mt][4 * j + 2 * half + 1], bsv[2 * j + 1]),
                0.f);
            v[mt][half][j] = inside ? pack_bf16(v0, v1) : 0u;
          }
        }
      // ... as whole 16-byte chunks (lane tq: chunks tq and tq + 4 of its
      // rows) ...
      uint4 ch[MT][2][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half)
          quad_chunks(v[mt][half], tq, ch[mt][half][0], ch[mt][half][1]);
      // (the peer's consumer is long done with the tile before last)
      const int lb = i & 1;
      if (lane == 0 && i >= 2)
        mbar_poll(bar_s + K::LAND_FREE + 8 * lb, ((i >> 1) + 1) & 1);
      // ... into the own plane, once the consumer has read the last tile's
      // and the peer's consumer has its copy of it ...
      if (i > 0) {
        named_sync(K::OWN_FREE, 256);
        mbar_poll(bar_s + K::OWN_READ, (i - 1) & 1);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int m = mt * 64 + warp * 16 + g + 8 * half;
          if (m < WIN_PX) {
            st_shared_v4(own_s + pix_chunk(m, tq), ch[mt][half][0]);
            st_shared_v4(own_s + pix_chunk(m, tq + 4), ch[mt][half][1]);
          }
        }
      // ... for the consumer, and, each warp its rows (16 pixels of each
      // m64 product: contiguous) by bulk copies, into the peer's landing
      // plane i % 2
      fence_proxy_async();
      named_arrive(K::OWN_FULL, 256);
      __syncwarp();
      if (lane == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int p = mt * 64 + warp * 16;
          const int px = min(16, WIN_PX - p);
          if (px > 0)
            bulk_copy_peer(peer_land + lb * K::PLANE + p * 128,
                           own_s + p * 128, px * 128,
                           peer_bars + K::LAND_FULL + 8 * lb);
        }
      }
    }
  } else {
    // ---- consumer: stage1 ----
    float b1v[N / 4];
    load_bias<N>(b1v, b1 + rank * N, lane);
    const uint64_t w1desc = b_desc(w1_s);
    unsigned char* out_p = smem_raw + (base + K::OUT_OFF - raw);
    for (int i = 0; i < n; ++i) {
      const Tile tl = at(i);
      const int lb = i & 1;
      const uint32_t land = land_s + lb * K::PLANE;
      if (t == 0) mbar_expect(bar_s + K::LAND_FULL + 8 * lb, K::PLANE);
      named_sync(K::OWN_FULL, 256);
      mbar_wait(bar_s + K::LAND_FULL + 8 * lb, (i >> 1) & 1);
      // the peer's own plane of this tile is copied: it may rewrite it
      if (t == 0) mbar_arrive_cluster_relaxed(peer_bars + K::OWN_READ);
      float acc[W::ACC];
      products_on<W>(acc, Planes{{rank == 0 ? own_s : land,
                                  rank == 0 ? land : own_s}},
                     w1desc, warp, lane);
      // done reading both planes (the products waited for every read)
      if (i + 1 < n) named_arrive(K::OWN_FREE, 256);
      if (t == 0 && i + 2 < n)
        mbar_arrive_cluster_relaxed(peer_bars + K::LAND_FREE + 8 * lb);
      store<W>(acc, b1v, out_p, tl.out, tl.r0, tl.w0, H / 2, W2, rank * N,
               t, K::BAR_CONS);
    }
  }
  // no block leaves while its peer may still signal it or copy into it
  cluster_arrive();
  cluster_wait();
}

template <int C>
int launch(const void* xm, const void* wspk, const void* bs,
           const void* w1pk, const void* b1, void* out, int B, int H, int W2,
           void* stream) {
  if (H % 2 != 0 || H <= 0 || W2 <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  // per width: SMs (C < 128) or clusters the card holds (C = 128)
  static int units = 0;
  if (units == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if constexpr (C == 128) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fused_stem_stage1_kernel_pair,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Pair::SMEM_BYTES);
      if (err == cudaSuccess) {
        units = max_clusters(fused_stem_stage1_kernel_pair, 2, 256,
                             Pair::SMEM_BYTES);
        if (units == 0) err = cudaErrorLaunchOutOfResources;
      }
    } else {
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&units, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(fused_stem_stage1_kernel<C>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Cfg<C>::SMEM_BYTES);
    }
    if (err != cudaSuccess) {
      units = 0;
      return (int)err;
    }
  }
  const int tiles_x = (W2 + TW - 1) / TW, tiles_y = (H / 2 + TR - 1) / TR;
  const int ntiles = tiles_x * tiles_y * B;
  if constexpr (C == 128) {
    CUtensorMap frame;
    const int err = nhwc_tensor_map(&frame, xm, B, H, W2, CF, CF, FC, FR,
                                    false);
    if (err != 0) return err;
    const int clusters = ntiles < units ? ntiles : units;
    return launch_ex(fused_stem_stage1_kernel_pair, dim3(2 * clusters, 1, 1),
                     2, 256, Pair::SMEM_BYTES, stream, frame,
                     (const bf16*)xm, (const bf16*)wspk, (const float*)bs,
                     (const bf16*)w1pk, (const float*)b1, (bf16*)out, H, W2,
                     tiles_x, tiles_y, ntiles);
  } else {
    using K = Cfg<C>;
    const int blocks = grid_blocks(ntiles, K::WGS, units);
    fused_stem_stage1_kernel<C>
        <<<blocks, K::THREADS, K::SMEM_BYTES, (cudaStream_t)stream>>>(
            (const bf16*)xm, (const bf16*)wspk, (const float*)bs,
            (const bf16*)w1pk, (const float*)b1, (bf16*)out, H, W2, tiles_x,
            tiles_y, ntiles);
    return (int)cudaGetLastError();
  }
}

}  // namespace

// one entry point a width: C = 64 (base 32), 32 (base 16), 128 (base 64)
extern "C" int unina_fused_stem_stage1(const void* xm, const void* wspk,
                                       const void* bs, const void* w1pk,
                                       const void* b1, void* out, int B,
                                       int H, int W2, void* stream) {
  return launch<64>(xm, wspk, bs, w1pk, b1, out, B, H, W2, stream);
}
extern "C" int unina_fused_stem_stage1_c32(const void* xm, const void* wspk,
                                           const void* bs, const void* w1pk,
                                           const void* b1, void* out, int B,
                                           int H, int W2, void* stream) {
  return launch<32>(xm, wspk, bs, w1pk, b1, out, B, H, W2, stream);
}
extern "C" int unina_fused_stem_stage1_c128(const void* xm, const void* wspk,
                                            const void* bs, const void* w1pk,
                                            const void* b1, void* out, int B,
                                            int H, int W2, void* stream) {
  return launch<128>(xm, wspk, bs, w1pk, b1, out, B, H, W2, stream);
}
