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
constexpr int WS_BYTES = 2 * B_TILE_BYTES;  // stem weights: one tile per kh
// per warpgroup: stage1's window, the staged output, two frame stages
constexpr int WG_BYTES =
    (WIN_BYTES + OUT_BYTES + 2 * FWIN_BYTES + 127) / 128 * 128;
constexpr int WGS = 2;
constexpr int THREADS = WGS * 128;
constexpr int SMEM_BYTES = 1024 + W_BYTES + WS_BYTES + WGS * WG_BYTES;
static_assert(FWIN_BYTES % 16 == 0 && 2 * CF % 16 == 0, "16-byte chunks");
static_assert(KS * 16 <= 64, "one B tile per kh");

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

__global__ void __launch_bounds__(THREADS, 1)
fused_stem_stage1_kernel(const bf16* __restrict__ xm,
                         const bf16* __restrict__ wspk,
                         const float* __restrict__ bs,
                         const bf16* __restrict__ w1pk,
                         const float* __restrict__ b1, bf16* __restrict__ out,
                         int H, int W2, int tiles_x, int tiles_y,
                         int ntiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, tq = lane & 3;
  const uint32_t w1_s = base;
  const uint32_t ws_s = base + W_BYTES;
  const uint32_t st_s = ws_s + WS_BYTES + wg * WG_BYTES;  // stage1's window
  const uint32_t out_s = st_s + WIN_BYTES;
  const uint32_t fr_s = out_s + OUT_BYTES;                // two stages
  unsigned char* st_p = smem_raw + (st_s - smem_u32(smem_raw));
  unsigned char* out_p = smem_raw + (out_s - smem_u32(smem_raw));

  // warpgroup g of block b takes tiles g*gridDim.x + b, + WGS*gridDim.x, ...
  const int stride = WGS * gridDim.x;
  int tile = wg * gridDim.x + blockIdx.x;

  for (int i = threadIdx.x; i < W_BYTES / 16; i += THREADS)
    cp_async16(w1_s + i * 16, w1pk + i * 8, 16);
  for (int i = threadIdx.x; i < WS_BYTES / 16; i += THREADS)
    cp_async16(ws_s + i * 16, wspk + i * 8, 16);
  if (tile < ntiles)
    load_frame(fr_s, tile_at<CF>(tile, tiles_x, tiles_y, xm, out, H, W2), H,
               W2, t);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float bsv[16], b1v[16];
  load_bias(bsv, bs, lane);
  load_bias(b1v, b1, lane);
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
    const Tile tl = tile_at<CF>(tile, tiles_x, tiles_y, xm, out, H, W2);
    const uint32_t fwin = fr_s + (it & 1) * FWIN_BYTES;
    if (tile + stride < ntiles)
      load_frame(
          fr_s + ((it + 1) & 1) * FWIN_BYTES,
          tile_at<CF>(tile + stride, tiles_x, tiles_y, xm, out, H, W2), H, W2,
          t);
    cp_async_commit();

    // stem: three m64 products, A double-buffered by product
    float sacc[MT][32];
    uint32_t a[2][2][KS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int j = 0; j < 32; ++j) sacc[mt][j] = 0.f;
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
          wgmma_m64n64k16(
              sacc[mt], a[mt & 1][kh][ks],
              wsdesc + (uint64_t)((kh * B_TILE_BYTES + ks * 32) >> 4));
      wgmma_commit();
      wgmma_wait<1>();  // product mt-1 is done with the other A buffer
    }
    wgmma_wait<0>();

    // bias, ReLU, 0 outside the image, bf16 -> stage1's window. Every warp
    // left the previous tile's stage1 products before store()'s barriers.
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = mt * 64 + warp * 16 + g + 8 * half;
        if (m < WIN_PX) {
          const int s = 2 * tl.r0 - 2 + m / SC, c = tl.w0 - 1 + m % SC;
          const bool inside = s >= 0 && s < H && c >= 0 && c < W2;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            float v0 = fmaxf(
                __fadd_rn(sacc[mt][4 * j + 2 * half], bsv[2 * j]), 0.f);
            float v1 = fmaxf(
                __fadd_rn(sacc[mt][4 * j + 2 * half + 1], bsv[2 * j + 1]),
                0.f);
            *reinterpret_cast<uint32_t*>(st_p + pix_chunk(m, j) + tq * 4) =
                inside ? pack_bf16(v0, v1) : 0u;
          }
        }
      }
    warpgroup_barrier(1 + wg);  // the window is whole

    float acc[32];
    products(acc, st_s, w1desc, warp, lane);
    // store() also waits for the next frame window's copies
    store(acc, b1v, out_p, tl.out, tl.r0, tl.w0, H / 2, W2, t, 1 + wg);
  }
}

}  // namespace

extern "C" int unina_fused_stem_stage1(const void* xm, const void* wspk,
                                       const void* bs, const void* w1pk,
                                       const void* b1, void* out, int B,
                                       int H, int W2, void* stream) {
  if (H % 2 != 0 || H <= 0 || W2 <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(fused_stem_stage1_kernel,
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
  fused_stem_stage1_kernel<<<blocks, THREADS, SMEM_BYTES,
                             (cudaStream_t)stream>>>(
      (const bf16*)xm, (const bf16*)wspk, (const float*)bs,
      (const bf16*)w1pk, (const float*)b1, (bf16*)out, H, W2, tiles_x,
      tiles_y, ntiles);
  return (int)cudaGetLastError();
}
