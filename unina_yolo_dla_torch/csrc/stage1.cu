// Stage1 2x2 blocked downsample over the column-merged stem output, on the
// tensor cores.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/stage1_kernel.py
//   fused_downsample_merged (_pallas_merged, pallas_call at :127).
//   out[r, w, o] = ReLU(b[o] + sum_{kh,kw,di,c} xp[2r+2kh+di, w+kw, c]
//                                * wb[kh, kw, di*CM + c, o])
//   where xp is the merged stem output (H, W2, CM = 2 x 32) padded with 2
//   zero rows on top and 1 zero merged column on the left: the TPU
//   kernel's kw = 1 half of each kw-packed product shifted by one column.
//
// Bound on the H100: at (320,160,64) -> (160,160,64) the work is
//   1.68 GFLOP over 6.6 MB in and 3.3 MB out: about 3 us of memory traffic
//   against 1.7 us of bf16 tensor-core time, so it is bound by bytes.
// Design: an implicit GEMM, M = output pixels, N = 64, K = 512 in eight
//   64-deep chunks (kh, kw, di), each chunk one input pixel row shifted by
//   kw (csrc/mma_sm90.cuh has the operand layouts; csrc/stage1_tile.cuh
//   the tile's products and its store, shared with stem.cu).
//   - Persistent blocks, one per SM, of two warpgroups. The 64 KB of
//     weights (packed on the host into eight swizzled B tiles) are copied
//     into shared memory once per block, not once per tile.
//   - Each warpgroup walks its own 4 x 16 output tiles (64 pixels: one
//     m64 product, one output row per warp). A tile's input window, 10
//     rows x 17 merged columns of bf16 pixels, arrives by cp.async (zero
//     fill outside the image) into a ring of two stages, so the next
//     tile's loads run under this tile's 32 k16 steps.
//   - A comes through ldmatrix, double-buffered by chunk, so chunk q+1
//     loads while chunk q multiplies; bias, ReLU and the bf16 rounding
//     happen in registers, and the tile leaves through shared memory as
//     16-byte stores of whole pixels.
//   - Edge tiles are masked: any even H, any W2, any batch.
//   Other widths (base 16 and 64 engines, csrc/stage1_tile.cuh Width):
//   C = 32 is the same walk with m64n32 products and two taps to a 64-deep
//   K chunk (4 chunks, 16 KB of weights); C = 128 has 256 KB of weights, so
//   each block takes one 64-column half of its tiles (128 KB of weights)
//   with one warpgroup, whose two window stages of 256-byte pixels take
//   the rest of the shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_tile.cuh"

namespace {

using namespace stage1_tile;

template <int C>
struct Cfg {
  using W = Width<C>;
  static constexpr int WGS = W::NSPLIT > 1 ? 1 : 2;
  static constexpr int THREADS = WGS * 128;
  static constexpr int WG_BYTES = 2 * W::WIN_BYTES + W::OUT_BYTES;
  static constexpr int SMEM_BYTES = 1024 + W::W_BYTES + WGS * WG_BYTES;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
};

// window pixel (wr, wc) <- input row 2*r0 - 2 + wr, merged column
// w0 - 1 + wc; zeros outside the image
template <int C>
__device__ __forceinline__ void load_window(uint32_t win, const Tile& tl,
                                            int H, int W2, int t) {
  constexpr int CH = C / 8;
  for (int i = t; i < WIN_PX * CH; i += 128) {
    int ch = i % CH, p = i / CH;
    int wr = p / SC, wc = p - wr * SC;
    int s = 2 * tl.r0 - 2 + wr, sc = tl.w0 - 1 + wc;
    bool ok = s >= 0 && s < H && sc >= 0 && sc < W2;
    const bf16* src = ok ? tl.x + ((size_t)s * W2 + sc) * C + ch * 8 : tl.x;
    cp_async16(win + px_chunk<C>(p, ch), src, ok ? 16 : 0);
  }
}

template <int C>
__global__ void __launch_bounds__(Cfg<C>::THREADS, 1)
stage1_mma_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ wpk,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  int H, int W2, int tiles_x, int tiles_y, int ntiles) {
  using W = Width<C>;
  using K = Cfg<C>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const uint32_t w_s = base;
  const uint32_t win_s = base + W::W_BYTES + wg * K::WG_BYTES;  // 2 stages
  const uint32_t out_s = win_s + 2 * W::WIN_BYTES;
  unsigned char* out_p = smem_raw + (out_s - smem_u32(smem_raw));

  const Walk wk = walk<W::NSPLIT, K::WGS>(wg);
  const int stride = wk.stride;
  int tile = wk.first;
  const bf16* wsrc = wpk + (size_t)wk.nh * (W::W_BYTES / 2);

  for (int i = threadIdx.x; i < W::W_BYTES / 16; i += K::THREADS)
    cp_async16(w_s + i * 16, wsrc + i * 8, 16);
  if (tile < ntiles)
    load_window<C>(win_s, tile_at<C, C>(tile, tiles_x, tiles_y, xm, out, H,
                                        W2),
                   H, W2, t);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float bv[W::N / 4];
  load_bias<W::N>(bv, bias + wk.nh * W::N, lane);
  const uint64_t wdesc = b_desc(w_s);

  for (int it = 0; tile < ntiles; tile += stride, ++it) {
    const Tile tl = tile_at<C, C>(tile, tiles_x, tiles_y, xm, out, H, W2);
    const uint32_t win = win_s + (it & 1) * W::WIN_BYTES;
    if (tile + stride < ntiles)
      load_window<C>(
          win_s + ((it + 1) & 1) * W::WIN_BYTES,
          tile_at<C, C>(tile + stride, tiles_x, tiles_y, xm, out, H, W2), H,
          W2, t);
    cp_async_commit();

    float acc[W::ACC];
    products<W>(acc, win, wdesc, warp, lane);
    // store() also waits for the next window's copies
    store<W>(acc, bv, out_p, tl.out, tl.r0, tl.w0, H / 2, W2,
             wk.nh * W::N, t, 1 + wg);
  }
}

template <int C>
int launch(const void* xm, const void* wpk, const void* bias, void* out,
           int B, int H, int W2, void* stream) {
  using K = Cfg<C>;
  if (H % 2 != 0 || H <= 0 || W2 <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stage1_mma_kernel<C>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 K::SMEM_BYTES);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int tiles_x = (W2 + TW - 1) / TW, tiles_y = (H / 2 + TR - 1) / TR;
  const int ntiles = tiles_x * tiles_y * B;
  const int blocks = grid_blocks(ntiles, K::WGS, Width<C>::NSPLIT, sms);
  stage1_mma_kernel<C>
      <<<blocks, K::THREADS, K::SMEM_BYTES, (cudaStream_t)stream>>>(
          (const bf16*)xm, (const bf16*)wpk, (const float*)bias, (bf16*)out,
          H, W2, tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}

}  // namespace

// one entry point a width: C = 64 (base 32), 32 (base 16), 128 (base 64)
extern "C" int unina_stage1_merged(const void* xm, const void* wpk,
                                   const void* bias, void* out, int B, int H,
                                   int W2, void* stream) {
  return launch<64>(xm, wpk, bias, out, B, H, W2, stream);
}
extern "C" int unina_stage1_merged_c32(const void* xm, const void* wpk,
                                       const void* bias, void* out, int B,
                                       int H, int W2, void* stream) {
  return launch<32>(xm, wpk, bias, out, B, H, W2, stream);
}
extern "C" int unina_stage1_merged_c128(const void* xm, const void* wpk,
                                        const void* bias, void* out, int B,
                                        int H, int W2, void* stream) {
  return launch<128>(xm, wpk, bias, out, B, H, W2, stream);
}
