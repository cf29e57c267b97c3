// One 4 x 16 output tile of the stage1 2x2 blocked downsample on the tensor
// cores: the part stage1.cu (window copied from device memory) and stem.cu
// (window written by the stem product's epilogue) have in common. Not
// compiled on its own.
//
//   out[r, w, o] = ReLU(b[o] + sum_{kh,kw,di,c} win[2r+2kh+di, w+kw, c]
//                                * wb[kh, kw, di*CM + c, o])
//   over a window of SR = 10 rows x SC = 17 merged columns of swizzled
//   bf16 pixels (window pixel (wr, wc) is input row 2*r0 - 2 + wr, merged
//   column w0 - 1 + wc, zero outside the image): an implicit GEMM with
//   M = 64 output pixels (one output row per warp), N = 64, K = 512 in
//   eight 64-deep chunks q = (kh, kw, di), B from pack_stage1_mma.
#pragma once
#include "mma_sm90.cuh"

namespace stage1_tile {

using namespace mma90;
typedef __nv_bfloat16 bf16;

constexpr int CM = 64;          // merged input channels (2 columns x 32)
constexpr int CO = 64;          // output channels
constexpr int CHUNKS = 8;       // K chunks: (kh, kw, di)
constexpr int TR = 4, TW = 16;  // output tile of one warpgroup
constexpr int SR = 2 * TR + 2, SC = TW + 1;  // its input window
constexpr int WIN_PX = SR * SC;
constexpr int WIN_BYTES = WIN_PX * PIX_BYTES;
constexpr int OUT_BYTES = TR * TW * PIX_BYTES;
constexpr int W_BYTES = CHUNKS * B_TILE_BYTES;
static_assert(TW == 16 && TR == 4, "one output row per warp");

struct Tile {
  const bf16* x;  // this image
  bf16* out;
  int r0, w0;     // first output row / merged column
};

// tile t of (batch, tiles_y, tiles_x) over an input of CIN channels a pixel
template <int CIN>
__device__ __forceinline__ Tile tile_at(int t, int tiles_x, int tiles_y,
                                        const bf16* xm, bf16* out, int H,
                                        int W2) {
  int b = t / (tiles_x * tiles_y);
  int rem = t - b * tiles_x * tiles_y;
  Tile tl;
  tl.x = xm + (size_t)b * H * W2 * CIN;
  tl.out = out + (size_t)b * (H / 2) * W2 * CO;
  tl.r0 = (rem / tiles_x) * TR;
  tl.w0 = (rem % tiles_x) * TW;
  return tl;
}

// bias of this thread's accumulator columns 8j + 2(lane%4) (+1)
__device__ __forceinline__ void load_bias(float (&bv)[16], const float* bias,
                                          int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bv[2 * j] = __ldg(bias + 8 * j + 2 * (lane & 3));
    bv[2 * j + 1] = __ldg(bias + 8 * j + 2 * (lane & 3) + 1);
  }
}

// acc = the tile's 64 x 64 products over the window at shared address
// `win`; `wdesc` describes the first of the eight weight tiles. A comes
// through ldmatrix, double-buffered by chunk, so chunk q+1 loads while
// chunk q multiplies.
__device__ __forceinline__ void products(float (&acc)[32], uint32_t win,
                                         uint64_t wdesc, int warp, int lane) {
  // this lane's A row: output pixel (row `warp`, column lane % 16)
  const int p0 = 2 * warp * SC + (lane & 15);
#pragma unroll
  for (int j = 0; j < 32; ++j) acc[j] = 0.f;
  uint32_t a[2][4][4];
#pragma unroll
  for (int q = 0; q < CHUNKS; ++q) {
    const int kh = q >> 2, kw = (q >> 1) & 1, di = q & 1;
    load_a64(a[q & 1], win, p0 + (2 * kh + di) * SC + kw, lane);
    wgmma_fence();
    mma_a64(acc, a[q & 1], wdesc + (uint64_t)(q * B_TILE_BYTES >> 4));
    wgmma_commit();
    wgmma_wait<1>();  // chunk q-1 is done with the other A buffer
  }
  wgmma_wait<0>();
}

// Bias, ReLU and the bf16 rounding in registers, then the tile leaves
// through the warpgroup's staging buffer `out_p` as 16-byte stores of whole
// pixels; rows >= H2 and columns >= W2 are dropped. `out` is this image's
// output, `t` the thread's index in its warpgroup, `bar` the warpgroup's
// barrier. Also waits for this thread's outstanding cp.async copies (the
// next tile's window) before the second barrier, so the window is whole
// for every thread after it.
__device__ __forceinline__ void store(const float (&acc)[32],
                                      const float (&bv)[16],
                                      unsigned char* out_p, bf16* out, int r0,
                                      int w0, int H2, int W2, int t,
                                      int bar) {
  const int warp = t >> 5, lane = t & 31;
  // every warp is done with the previous tile's staged output
  warpgroup_barrier(bar);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = warp * 16 + (lane >> 2) + 8 * half;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v0 = fmaxf(__fadd_rn(acc[4 * j + 2 * half], bv[2 * j]), 0.f);
      float v1 =
          fmaxf(__fadd_rn(acc[4 * j + 2 * half + 1], bv[2 * j + 1]), 0.f);
      *reinterpret_cast<uint32_t*>(out_p + pix_chunk(m, j) +
                                   (lane & 3) * 4) = pack_bf16(v0, v1);
    }
  }
  cp_async_wait<0>();
  warpgroup_barrier(bar);
  for (int i = t; i < TR * TW * 8; i += 128) {
    int ch = i & 7, m = i >> 3;
    int r = r0 + (m >> 4), w = w0 + (m & 15);
    if (r < H2 && w < W2)
      *reinterpret_cast<uint4*>(out + ((size_t)r * W2 + w) * CO + ch * 8) =
          *reinterpret_cast<const uint4*>(out_p + pix_chunk(m, ch));
  }
}

}  // namespace stage1_tile
