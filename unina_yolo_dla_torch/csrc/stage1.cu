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
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_tile.cuh"

namespace {

using namespace stage1_tile;

constexpr int WG_BYTES = 2 * WIN_BYTES + OUT_BYTES;
constexpr int WGS = 2;
constexpr int THREADS = WGS * 128;
constexpr int SMEM_BYTES = 1024 + W_BYTES + WGS * WG_BYTES;

// window pixel (wr, wc) <- input row 2*r0 - 2 + wr, merged column
// w0 - 1 + wc; zeros outside the image
__device__ __forceinline__ void load_window(uint32_t win, const Tile& tl,
                                            int H, int W2, int t) {
  for (int i = t; i < WIN_PX * 8; i += 128) {
    int ch = i & 7, p = i >> 3;
    int wr = p / SC, wc = p - wr * SC;
    int s = 2 * tl.r0 - 2 + wr, sc = tl.w0 - 1 + wc;
    bool ok = s >= 0 && s < H && sc >= 0 && sc < W2;
    const bf16* src = ok ? tl.x + ((size_t)s * W2 + sc) * CM + ch * 8 : tl.x;
    cp_async16(win + pix_chunk(p, ch), src, ok ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
stage1_mma_kernel(const bf16* __restrict__ xm, const bf16* __restrict__ wpk,
                  const float* __restrict__ bias, bf16* __restrict__ out,
                  int H, int W2, int tiles_x, int tiles_y, int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const uint32_t w_s = base;
  const uint32_t win_s = base + W_BYTES + wg * WG_BYTES;  // two stages
  const uint32_t out_s = win_s + 2 * WIN_BYTES;
  unsigned char* out_p = smem_raw + (out_s - smem_u32(smem_raw));

  // warpgroup g of block b takes tiles g*gridDim.x + b, + WGS*gridDim.x, ...
  const int stride = WGS * gridDim.x;
  int tile = wg * gridDim.x + blockIdx.x;

  for (int i = threadIdx.x; i < W_BYTES / 16; i += THREADS)
    cp_async16(w_s + i * 16, wpk + i * 8, 16);
  if (tile < ntiles)
    load_window(win_s, tile_at<CM>(tile, tiles_x, tiles_y, xm, out, H, W2), H,
                W2, t);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float bv[16];
  load_bias(bv, bias, lane);
  const uint64_t wdesc = b_desc(w_s);

  for (int it = 0; tile < ntiles; tile += stride, ++it) {
    const Tile tl = tile_at<CM>(tile, tiles_x, tiles_y, xm, out, H, W2);
    const uint32_t win = win_s + (it & 1) * WIN_BYTES;
    if (tile + stride < ntiles)
      load_window(
          win_s + ((it + 1) & 1) * WIN_BYTES,
          tile_at<CM>(tile + stride, tiles_x, tiles_y, xm, out, H, W2), H, W2,
          t);
    cp_async_commit();

    float acc[32];
    products(acc, win, wdesc, warp, lane);
    // store() also waits for the next window's copies
    store(acc, bv, out_p, tl.out, tl.r0, tl.w0, H / 2, W2, t, 1 + wg);
  }
}

}  // namespace

extern "C" int unina_stage1_merged(const void* xm, const void* wpk,
                                   const void* bias, void* out, int B, int H,
                                   int W2, void* stream) {
  if (H % 2 != 0 || H <= 0 || W2 <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(stage1_mma_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 SMEM_BYTES);
    if (err != cudaSuccess) {
      sms = 0;
      return (int)err;
    }
  }
  const int tiles_x = (W2 + TW - 1) / TW, tiles_y = (H / 2 + TR - 1) / TR;
  const int ntiles = tiles_x * tiles_y * B;
  const int want = (ntiles + WGS - 1) / WGS;
  const int blocks = want < sms ? want : sms;
  stage1_mma_kernel<<<blocks, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const bf16*)xm, (const bf16*)wpk, (const float*)bias, (bf16*)out, H, W2,
      tiles_x, tiles_y, ntiles);
  return (int)cudaGetLastError();
}
