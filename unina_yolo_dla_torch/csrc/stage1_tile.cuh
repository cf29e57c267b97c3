// One 4 x 16 output tile of the stage1 2x2 blocked downsample on the tensor
// cores: the part stage1.cu (window copied from device memory) and stem.cu
// (window written by the stem product's epilogue) have in common, at each
// width the engines take. Not compiled on its own.
//
//   out[r, w, o] = ReLU(b[o] + sum_{kh,kw,di,c} win[2r+2kh+di, w+kw, c]
//                                * wb[kh, kw, di*C + c, o])
//   over a window of SR = 10 rows x SC = 17 merged columns of swizzled
//   bf16 pixels of C channels (window pixel (wr, wc) is input row
//   2*r0 - 2 + wr, merged column w0 - 1 + wc, zero outside the image): an
//   implicit GEMM with M = 64 output pixels (one output row per warp),
//   K = 8 taps (kh, kw, di) x C in 64-deep chunks, B from pack_stage1_mma.
//
// Widths (Width<C>): C = 2 x the base width is both the merged stem
// output's channels and stage1's output channels: 32, 64 or 128. One
// wgmma covers N = min(C, 64) output columns; at C = 128 the two 64-column
// halves of a tile go to the two blocks of a cluster, since the whole 256
// KB of stage1 weights would not fit in one block's shared memory; their
// window is two 64-channel planes (Planes).
#pragma once
#include "mma_sm90.cuh"

namespace stage1_tile {

using namespace mma90;
typedef __nv_bfloat16 bf16;

constexpr int TAPS = 8;         // (kh, kw, di)
constexpr int TR = 4, TW = 16;  // output tile of one warpgroup
constexpr int SR = 2 * TR + 2, SC = TW + 1;  // its input window
constexpr int WIN_PX = SR * SC;
static_assert(TW == 16 && TR == 4, "one output row per warp");

template <int C_>
struct Width {
  static_assert(C_ == 32 || C_ == 64 || C_ == 128, "compiled widths");
  static constexpr int C = C_;                  // channels in and out
  static constexpr int N = C < 64 ? C : 64;     // columns of one wgmma
  static constexpr int ACC = N / 2;             // accumulators a thread
  static constexpr int KC = TAPS * C / 64;      // 64-deep K chunks
  static constexpr int BT = N * 128;            // one [N n][64 k] B tile
  static constexpr int W_BYTES = KC * BT;       // a block's stage1 weights
  static constexpr int WIN_BYTES = WIN_PX * C * 2;
  static constexpr int OUT_BYTES = TR * TW * N * 2;
};

// Byte offset of 16-byte chunk `chunk` of pixel `pix` in a buffer of
// pixels of CH bf16 channels. Eight consecutive pixels' same chunk (one
// ldmatrix phase) fall into eight different bank groups: the low three
// bits of the chunk are XORed with the pixel (CH >= 64; at 64 this is
// mma_sm90.cuh's pix_chunk), or, with four chunks a pixel (CH = 32), the
// chunk with bits 1-2 of the pixel.
template <int CH>
__device__ __forceinline__ uint32_t px_chunk(int pix, int chunk) {
  if constexpr (CH >= 64)
    return (uint32_t)(pix * CH * 2 +
                      (((chunk & ~7) | ((chunk ^ pix) & 7)) << 4));
  else
    return (uint32_t)(pix * CH * 2 + ((chunk ^ ((pix >> 1) & 3)) << 4));
}

// d += A(64 x 16) @ B(16 x N) for the compiled N
template <int N>
__device__ __forceinline__ void wgmma_k16(float (&d)[N / 2],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  if constexpr (N == 64)
    wgmma_m64n64k16(d, a, desc);
  else
    wgmma_m64n32k16(d, a, desc);
}

struct Tile {
  const bf16* x;  // this image
  bf16* out;
  int b;          // the image
  int r0, w0;     // first output row / merged column
};

// tile t of (batch, tiles_y, tiles_x) over an input of CIN channels a
// pixel and an output of COUT
template <int CIN, int COUT>
__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y,
                                        const bf16* xm, bf16* out, int H,
                                        int W2) {
  int b = t / (tiles_x * tiles_y);
  int rem = t - b * tiles_x * tiles_y;
  Tile tl;
  tl.x = xm + (size_t)b * H * W2 * CIN;
  tl.out = out + (size_t)b * (H / 2) * W2 * COUT;
  tl.b = b;
  tl.r0 = (rem / tiles_x) * TR;
  tl.w0 = (rem % tiles_x) * TW;
  return tl;
}

// bias of this thread's accumulator columns 8j + 2(lane%4) (+1) of N
template <int N>
__device__ __forceinline__ void load_bias(float (&bv)[N / 4],
                                          const float* bias, int lane) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    bv[2 * j] = __ldg(bias + 8 * j + 2 * (lane & 3));
    bv[2 * j + 1] = __ldg(bias + 8 * j + 2 * (lane & 3) + 1);
  }
}

// Where a window keeps 16-byte chunk `chunk` of pixel `pix`: one buffer
// of whole pixels, each swizzled in place (px_chunk), or one buffer a
// 64-channel plane (C = 128: the planes the two blocks of a cluster fill),
// 128 bytes a pixel swizzled as mma_sm90.cuh's pix_chunk.
template <int CH>
struct Swizzled {
  uint32_t base;
  __device__ __forceinline__ uint32_t at(int pix, int chunk) const {
    return base + px_chunk<CH>(pix, chunk);
  }
};
struct Planes {
  uint32_t base[2];
  __device__ __forceinline__ uint32_t at(int pix, int chunk) const {
    return (chunk & 8 ? base[1] : base[0]) + pix_chunk(pix, chunk & 7);
  }
};

// acc = the tile's 64 x N products over the window `win` (a layout
// above; `products`: a Swizzled window at shared address `win`); `wdesc`
// describes the first of this block's KC weight tiles. K index k = tap *
// C + channel; A comes through ldmatrix, double-buffered by chunk, so
// chunk q+1 loads while chunk q multiplies.
template <class W, class L>
__device__ __forceinline__ void products_on(float (&acc)[W::ACC],
                                            const L& win, uint64_t wdesc,
                                            int warp, int lane) {
  // this lane's A row: output pixel (row `warp`, column lane % 16)
  const int p0 = 2 * warp * SC + (lane & 15);
#pragma unroll
  for (int j = 0; j < W::ACC; ++j) acc[j] = 0.f;
  uint32_t a[2][4][4];
#pragma unroll
  for (int kc = 0; kc < W::KC; ++kc) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k0 = 64 * kc + 16 * ks;
      const int q = k0 / W::C, c0 = k0 % W::C;
      const int kh = q >> 2, kw = (q >> 1) & 1, di = q & 1;
      ldmatrix_x4(a[kc & 1][ks], win.at(p0 + (2 * kh + di) * SC + kw,
                                        (c0 >> 3) + (lane >> 4)));
    }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_k16<W::N>(acc, a[kc & 1][ks],
                      wdesc + (uint64_t)((kc * W::BT + ks * 32) >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // chunk kc-1 is done with the other A buffer
  }
  wgmma_wait<0>();
}

template <class W>
__device__ __forceinline__ void products(float (&acc)[W::ACC], uint32_t win,
                                         uint64_t wdesc, int warp,
                                         int lane) {
  products_on<W>(acc, Swizzled<W::C>{win}, wdesc, warp, lane);
}

// The tile's epilogue and store, in two halves. `stage_tile`: bias, ReLU
// and the bf16 rounding in registers, the tile's N columns staged in the
// warpgroup's buffer `out_p` (whole pixels, px_chunk), and this thread's
// 16-byte pieces of them read back into `v`; after it the buffer is free
// once the warpgroup has met. It also waits for this thread's outstanding
// cp.async copies (the next tile's window) before its second barrier, so
// the window is whole for every thread after it. `t` is the thread's
// index in its warpgroup, `bar` the warpgroup's barrier.
template <class W>
__device__ __forceinline__ void stage_tile(
    const float (&acc)[W::ACC], const float (&bv)[W::N / 4],
    unsigned char* out_p, int t, int bar,
    uint4 (&v)[TR * TW * (W::N / 8) / 128]) {
  constexpr int N = W::N, CH = N / 8;
  const int warp = t >> 5, lane = t & 31;
  // every warp is done with the previous tile's staged output
  warpgroup_barrier(bar);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = warp * 16 + (lane >> 2) + 8 * half;
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      float v0 = fmaxf(__fadd_rn(acc[4 * j + 2 * half], bv[2 * j]), 0.f);
      float v1 =
          fmaxf(__fadd_rn(acc[4 * j + 2 * half + 1], bv[2 * j + 1]), 0.f);
      *reinterpret_cast<uint32_t*>(out_p + px_chunk<N>(m, j) +
                                   (lane & 3) * 4) = pack_bf16(v0, v1);
    }
  }
  cp_async_wait<0>();
  warpgroup_barrier(bar);
#pragma unroll
  for (int k = 0; k < TR * TW * CH / 128; ++k) {
    const int i = t + 128 * k;
    v[k] = *reinterpret_cast<const uint4*>(out_p + px_chunk<N>(i / CH,
                                                               i % CH));
  }
}
// `write_tile`: the pieces as 16-byte stores of whole pixels at columns
// n0.. of C; rows >= H2 and columns >= W2 are dropped. `out` is this
// image's output.
template <class W>
__device__ __forceinline__ void write_tile(
    const uint4 (&v)[TR * TW * (W::N / 8) / 128], bf16* out, int r0, int w0,
    int H2, int W2, int n0, int t) {
  constexpr int CH = W::N / 8;
#pragma unroll
  for (int k = 0; k < TR * TW * CH / 128; ++k) {
    const int i = t + 128 * k, ch = i % CH, m = i / CH;
    const int r = r0 + (m >> 4), w = w0 + (m & 15);
    if (r < H2 && w < W2)
      *reinterpret_cast<uint4*>(out + ((size_t)r * W2 + w) * W::C + n0 +
                                ch * 8) = v[k];
  }
}
// both halves
template <class W>
__device__ __forceinline__ void store(const float (&acc)[W::ACC],
                                      const float (&bv)[W::N / 4],
                                      unsigned char* out_p, bf16* out, int r0,
                                      int w0, int H2, int W2, int n0, int t,
                                      int bar) {
  uint4 v[TR * TW * (W::N / 8) / 128];
  stage_tile<W>(acc, bv, out_p, t, bar, v);
  write_tile<W>(v, out, r0, w0, H2, W2, n0, t);
}

// C = 32 and 64: persistent blocks of WGS warpgroups, one block an SM;
// warpgroup g of block b takes tiles g*nb + b, + WGS*nb, ... with nb =
// gridDim. (C = 128 walks in clusters of two: stem.cu, stage1.cu Pair.)
struct Walk {
  int first, stride;
};
template <int WGS>
__device__ __forceinline__ Walk walk(int wg) {
  return Walk{wg * (int)gridDim.x + (int)blockIdx.x, WGS * (int)gridDim.x};
}

// blocks to launch: one warpgroup a tile at most, one block per SM
__host__ inline int grid_blocks(int ntiles, int wgs, int sms) {
  const int want = (ntiles + wgs - 1) / wgs;
  return want < sms ? want : sms;
}

}  // namespace stage1_tile
