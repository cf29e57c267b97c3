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
//   a cluster of two blocks shares each tile, each block one 64-column half
//   (128 KB of weights), and each block loads one 64-channel plane of the
//   window into both blocks by a multicast tensor copy (`stage1_mma_kernel_pair`:
//   each window byte leaves device memory once per cluster).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "stage1_tile.cuh"

namespace {

using namespace stage1_tile;

template <int C>
struct Cfg {
  using W = Width<C>;
  static_assert(C < 128, "C = 128: the cluster kernel (Pair)");
  static constexpr int WGS = 2;
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

  const Walk wk = walk<K::WGS>(wg);
  const int stride = wk.stride;
  int tile = wk.first;

  for (int i = threadIdx.x; i < W::W_BYTES / 16; i += K::THREADS)
    cp_async16(w_s + i * 16, wpk + i * 8, 16);
  if (tile < ntiles)
    load_window<C>(win_s, tile_at<C, C>(tile, tiles_x, tiles_y, xm, out, H,
                                        W2),
                   H, W2, t);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float bv[W::N / 4];
  load_bias<W::N>(bv, bias, lane);
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
    store<W>(acc, bv, out_p, tl.out, tl.r0, tl.w0, H / 2, W2, 0, t,
             1 + wg);
  }
}

// C = 128: the two 64-column halves of every tile go to the two blocks of
// a cluster, which share the tile's window. Each block holds 128 KB of
// weights (its half) and two window stages, one for each of its two
// warpgroups, which take the cluster's tiles in turn. One warpgroup's
// products (m64n64, A from registers) keep the tensor cores well below
// their rate, so the two multiply at once, warpgroup 1 a step behind:
// one's store and the copy refilling its stage run under the other's
// products. A stage is two 64-channel planes of the 10 x 17 window,
// 1024-aligned: block `rank` loads plane `rank` of a tile by one tensor
// copy (TMA, zeros outside the image) multicast into both blocks' stage,
// so each byte of the window leaves device memory once per cluster; both
// copies complete on each block's own mbarrier of the stage. A warpgroup
// stages its output in its stage once it has multiplied it, and reads it
// back into registers before it frees the stage.
//
// Shared memory (bytes): weights 131,072 + two stages of 45,056 +
// mbarriers 32 (+ 1,024 alignment) = 222,240 of 232,448.
struct Pair {
  using W = Width<128>;
  static constexpr int PLANE_BYTES = WIN_PX * 128;             // 21,760
  static constexpr int PLANE = (PLANE_BYTES + 1023) / 1024 * 1024;
  static constexpr int STAGE = 2 * PLANE;
  static constexpr int WIN_OFF = W::W_BYTES;
  static constexpr int BAR_OFF = WIN_OFF + 2 * STAGE;
  static constexpr int SMEM_BYTES = 1024 + BAR_OFF + 32;
  static_assert(SMEM_BYTES <= 232448, "shared memory of one block");
  static_assert(W::OUT_BYTES <= PLANE, "staging inside a stage");
  // mbarriers of stage g: full (the copies' bytes) and free (one arrival
  // from warpgroup g of each block)
  static constexpr int FULL = 0, FREE = 16;
};

// plane `rank` of tile `tl`'s window into stage `stage` of both blocks;
// this block expects both planes' bytes on `bar`
__device__ __forceinline__ void pair_issue(uint32_t stage, uint32_t bar,
                                           const CUtensorMap* map,
                                           const Tile& tl, int rank) {
  mbar_expect(bar, 2 * Pair::PLANE_BYTES);
  tensor_copy_mc(stage + rank * Pair::PLANE, map, 64 * rank, tl.w0 - 1,
                 2 * tl.r0 - 2, tl.b, bar, 0x3);
}

// Two warpgroups a block, clusters of two walking the tiles together:
// cluster k takes tiles k, k + clusters, ... (i = 0, 1, ... of its list),
// warpgroup g of both blocks the tiles i = g, g + 2, ...; block `rank`
// their output columns 64 rank...
__global__ void __launch_bounds__(256, 1)
stage1_mma_kernel_pair(const __grid_constant__ CUtensorMap map,
                   const bf16* __restrict__ xm, const bf16* __restrict__ wpk,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int H, int W2, int tiles_x, int tiles_y, int ntiles) {
  using W = Width<128>;
  using K = Pair;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127, warp = t >> 5, lane = t & 31;
  const int rank = cluster_ctarank();
  const uint32_t w_s = base, bar_s = base + K::BAR_OFF;
  const uint32_t stage = base + K::WIN_OFF + wg * K::STAGE;
  const uint32_t full = bar_s + K::FULL + 8 * wg;
  const uint32_t free_ = bar_s + K::FREE + 8 * wg;
  const int stride = gridDim.x / 2;
  const int first = blockIdx.x / 2;
  const int n = first < ntiles ? (ntiles - 1 - first) / stride + 1 : 0;
  auto at = [&](int i) {
    return tile_at<128, 128>(first + i * stride, tiles_x, tiles_y, xm, out,
                             H, W2);
  };

  if (threadIdx.x < 2) {
    mbar_init(bar_s + K::FULL + 8 * threadIdx.x, 1);
    mbar_init(bar_s + K::FREE + 8 * threadIdx.x, 2);
    mbar_init_fence();
  }
  const bf16* wsrc = wpk + (size_t)rank * (W::W_BYTES / 2);
  for (int i = threadIdx.x; i < W::W_BYTES / 16; i += 256)
    cp_async16(w_s + i * 16, wsrc + i * 8, 16);
  cp_async_commit();
  // both blocks' mbarriers are set up before either copies into them
  cluster_arrive();
  cluster_wait();
  if (t == 0 && wg < n) pair_issue(stage, full, &map, at(wg), rank);
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();

  float bv[W::N / 4];
  load_bias<W::N>(bv, bias + rank * W::N, lane);
  const uint64_t wdesc = b_desc(w_s);
  const uint32_t peer_free = peer_addr(free_, rank ^ 1);
  unsigned char* out_p = smem_raw + (stage - raw);

  for (int i = wg; i < n; i += 2) {
    const Tile tl = at(i);
    mbar_wait(full, (i >> 1) & 1);
    if (i == 1) named_sync(5, 256);  // warpgroup 1 starts a step behind
    float acc[W::ACC];
    products_on<W>(acc, Planes{{stage, stage + K::PLANE}}, wdesc, warp,
                   lane);
    if (i == 0 && n > 1) named_arrive(5, 256);
    // the output is staged in the stage, which every warp has read, and
    // read back into registers; the staging precedes the copies that
    // refill the stage, which wait for this warpgroup of both blocks
    uint4 v[TR * TW * (W::N / 8) / 128];
    stage_tile<W>(acc, bv, out_p, t, 1 + wg, v);
    const bool refill = i + 2 < n;
    if (refill) {
      // every write and read of the stage is done once the warpgroup has
      // met (the staging was read back), so the arrival need not release
      // anything: a releasing one would wait for the device-memory stores
      fence_proxy_async();
      warpgroup_barrier(1 + wg);
      if (t == 0) {
        mbar_arrive_cluster_relaxed(free_);
        mbar_arrive_cluster_relaxed(peer_free);
      }
    }
    write_tile<W>(v, tl.out, tl.r0, tl.w0, H / 2, W2, rank * W::N, t);
    if (refill && t == 0) {
      mbar_poll(free_, (i >> 1) & 1);
      pair_issue(stage, full, &map, at(i + 2), rank);
    }
  }
  // no block leaves while its peer may still signal it or copy into it
  cluster_arrive();
  cluster_wait();
}

template <int C>
int launch(const void* xm, const void* wpk, const void* bias, void* out,
           int B, int H, int W2, void* stream) {
  if (H % 2 != 0 || H <= 0 || W2 <= 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  // per width: SMs (C < 128) or clusters the card holds (C = 128)
  static int units = 0;
  if (units == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if constexpr (C == 128) {
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(stage1_mma_kernel_pair,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Pair::SMEM_BYTES);
      if (err == cudaSuccess) {
        units = max_clusters(stage1_mma_kernel_pair, 2, 256, Pair::SMEM_BYTES);
        if (units == 0) err = cudaErrorLaunchOutOfResources;
      }
    } else {
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&units, cudaDevAttrMultiProcessorCount,
                                     dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(stage1_mma_kernel<C>,
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
    CUtensorMap map;
    const int err = nhwc_tensor_map(&map, xm, B, H, W2, 128, 64, SC, SR,
                                    true);
    if (err != 0) return err;
    const int clusters = ntiles < units ? ntiles : units;
    return launch_ex(stage1_mma_kernel_pair, dim3(2 * clusters, 1, 1), 2, 256,
                     Pair::SMEM_BYTES, stream, map, (const bf16*)xm,
                     (const bf16*)wpk, (const float*)bias, (bf16*)out, H, W2,
                     tiles_x, tiles_y, ntiles);
  } else {
    using K = Cfg<C>;
    const int blocks = grid_blocks(ntiles, K::WGS, units);
    stage1_mma_kernel<C>
        <<<blocks, K::THREADS, K::SMEM_BYTES, (cudaStream_t)stream>>>(
            (const bf16*)xm, (const bf16*)wpk, (const float*)bias,
            (bf16*)out, H, W2, tiles_x, tiles_y, ntiles);
    return (int)cudaGetLastError();
  }
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
