// Shared device code of the tensor-core kernels (sm_90a): asynchronous
// copies, ldmatrix, the warpgroup matrix multiply and the 16-byte-chunk
// XOR swizzle. Included by stage1.cu, stem.cu, c3k2.cu, head.cu and
// int8_conv.cu (its s8 warpgroup products, tensor copies and int8 tensor
// maps); not compiled on its own.
//
// The products these kernels run are implicit GEMMs over NHWC pixels of
// 64 bf16 channels (128 bytes a pixel):
//
//   A (activations)  rows are pixels of a window in shared memory. The rows
//     of one filter tap are the same pixels shifted by whole pixels. A
//     shared-memory matrix descriptor can start at any pixel (base-offset
//     field 0: the swizzle follows the address bits;
//     tools/torch_wgmma_probe.py), but it reads 8-row groups of
//     consecutive pixels at one stride, and a tap's rows over a tile's
//     region wrap from one window row to the next at the region's width,
//     not the window's; copies of the window at the region's pitch would
//     not fit beside the weights. So A goes through registers: every lane
//     hands `ldmatrix` the address of its own pixel row (`load_a64`). A
//     pixel's eight 16-byte chunks are stored at chunk ^ (pixel & 7),
//     which spreads the eight rows of one ldmatrix phase over all banks.
//   B (weights)  never shifts, so `wgmma` reads it from shared memory
//     through a descriptor: one tile is [64 n][64 k] bf16, K contiguous
//     (128 bytes a row), 128-byte swizzle, 8 KB, 1024-byte aligned (or
//     [32 n][64 k], 4 KB, for the m64n32 products). The host packs the
//     weights into exactly this image (ops/cuda/mma_pack.py) so the device
//     copy is a flat 16-byte-chunk copy.
//   D  f32 accumulators in registers, 32 a thread for m64n64 (16 for
//     m64n32, 64 for m64n128): thread (warp w, lane l) holds rows 16w +
//     l/4 (+8), columns 8j + 2(l%4) (+1).
//
// Also the pieces of thread-block clusters the kernels share: distributed
// shared memory, the cluster barrier, named barriers, mbarriers (local and
// remote arrivals), bulk copies (TMA without a tensor map: from device
// memory, or from this block's shared memory into a peer's), tensor copies
// multicast to the cluster (TMA with a tensor map the host encodes), and a
// launch with a cluster dimension.
#pragma once
#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma90 {

constexpr int PIX_BYTES = 128;       // one pixel: 64 bf16 channels
constexpr int B_TILE_BYTES = 8192;   // one [64 n][64 k] weight tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// byte offset of 16-byte chunk `chunk` of pixel `pix` inside a window
__device__ __forceinline__ uint32_t pix_chunk(int pix, int chunk) {
  return (uint32_t)(pix * PIX_BYTES + ((chunk ^ (pix & 7)) << 4));
}

// ---- cp.async: 16 bytes global -> shared; src_bytes = 0 writes zeros ----
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// one arrival on the mbarrier `bar` when this thread's cp.async copies so
// far have landed (the barrier's count includes it: noinc)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// makes shared-memory writes of this thread (cp.async included) visible
// to wgmma's reads of B, which go through the async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of one warpgroup (128 threads); id 0 is __syncthreads' own
__device__ __forceinline__ void warpgroup_barrier(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// a named barrier of `count` threads: arrive without waiting, or wait
// (producer / consumer hand-offs between warpgroups)
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- A operand ----
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
// The four k16 fragments of one pixel row x 64 channels. `win` is the
// window's shared address, `pix` the pixel of this lane's row (row =
// 16 * warp + lane % 16 of the warpgroup's 64), lanes 16-31 take the upper
// 8 channels of each k16 step.
__device__ __forceinline__ void load_a64(uint32_t (&a)[4][4], uint32_t win,
                                         int pix, int lane) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    ldmatrix_x4(a[ks], win + pix_chunk(pix, 2 * ks + (lane >> 4)));
}

// ---- B operand: descriptor of a 128-byte-swizzled K-major tile ----
__device__ __forceinline__ uint64_t b_desc(uint32_t tile_addr) {
  return (uint64_t)((tile_addr & 0x3FFFF) >> 4)  // start address
         | (1ull << 16)                          // leading offset (unused)
         | ((uint64_t)(1024 >> 4) << 32)         // 8-row group stride
         | (1ull << 62);                         // 128-byte swizzle
}

// ---- wgmma ----
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d += A(64 x 16, registers) @ B(16 x 64, shared through `desc`); the
// predicate is wgmma's scale-d (0 would overwrite d instead of adding)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}
// the same with N = 32: B is 16 x 32, 16 accumulators a thread
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}
// the same with N = 128: B is 16 x 128, 64 accumulators a thread
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}
// One 64-deep K chunk: four k16 steps over one weight tile. The caller
// fences before (after its ldmatrix loads) and commits after.
__device__ __forceinline__ void mma_a64(float (&d)[32],
                                        const uint32_t (&a)[4][4],
                                        uint64_t tile_desc) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_m64n64k16(d, a[ks], tile_desc + (uint64_t)(ks * 32 >> 4));
}

// ---- warp-level m16n8k16 (the head's 1x1 preds) ----
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---- s8 warpgroup products (the int8 conv, int8_conv.cu) ----
// Both operands come from shared memory, K-major (a row's K bytes
// contiguous), in the layout a tensor copy with `row_bytes`-byte swizzle
// (32, 64 or 128: one row of K) leaves them: 8-row groups of 8 * row_bytes
// bytes, the tile 1024-byte aligned. A k32 step further along the row is
// the descriptor of the address 32 bytes on (+2 in the address field).
// D is s32, exact, in the f32 layout above: thread (warp w, lane l) holds
// rows 16w + l/4 (+8), columns 8j + 2(l%4) (+1) in d[4j..4j+3].
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile_addr,
                                                int row_bytes) {
  const uint64_t layout = row_bytes == 128 ? 1 : row_bytes == 64 ? 2 : 3;
  return (uint64_t)((tile_addr & 0x3FFFF) >> 4)    // start address
         | (1ull << 16)                            // leading offset (unused)
         | ((uint64_t)((8 * row_bytes) >> 4) << 32)  // 8-row group stride
         | (layout << 62);                         // swizzle of the rows
}
// d += A(64 x 32, shared through `da`) @ B(32 x 8, shared through `db`),
// both s8 K-major; 4 s32 accumulators a thread
__device__ __forceinline__ void wgmma_m64n8k32_s8(int (&d)[4],
                                                  uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
      "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// d += A(64 x 32, shared through `da`) @ B(32 x 32, shared through `db`),
// both s8 K-major; 16 s32 accumulators a thread
__device__ __forceinline__ void wgmma_m64n32k32_s8(int (&d)[16],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// d += A(64 x 32, shared through `da`) @ B(32 x 64, shared through `db`),
// both s8 K-major; 32 s32 accumulators a thread
__device__ __forceinline__ void wgmma_m64n64k32_s8(int (&d)[32],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// two f32 -> one register of two bf16 (lo = first), round to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// and back: the two bf16 of one register as f32 (exact)
__device__ __forceinline__ float bf16_lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t v) {
  return __uint_as_float(v & 0xFFFF0000u);
}

// ---- clusters: distributed shared memory ----
// the shared::cluster address of `local` (this block's shared memory) in
// block `rank` of the cluster
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ uint32_t ld_shared(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
// this block's rank in its cluster
__device__ __forceinline__ int cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return (int)r;
}
// The cluster barrier in two halves: every thread of every block of the
// cluster arrives (releasing its earlier memory operations) and later
// waits (acquiring everyone's); work between the two overlaps the wait.
// A thread alternates arrive and wait, and all threads of a warp take
// both together.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- mbarriers and bulk copies (TMA without a tensor map) ----
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// one arrival on this block's mbarrier `bar` (a consumer releasing a slot
// it has finished reading)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// the same for a phase that a peer's arrivals complete, polling
// (test_wait) rather than suspending the thread
__device__ __forceinline__ void mbar_poll(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.test_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
// arrive on the mbarrier at shared::cluster address `bar` (a peer's, or
// this block's own), ordering none of this thread's memory operations: a
// signal that reads are done (they have completed) or that this block is
// past a point
__device__ __forceinline__ void mbar_arrive_cluster_relaxed(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.relaxed.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          bar)
      : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`; completes
// on the mbarrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// `bytes` (a multiple of 16) of this block's shared memory at `src` into
// a peer's at shared::cluster address `dst`, completing on the peer's
// mbarrier at shared::cluster address `bar`
__device__ __forceinline__ void bulk_copy_peer(uint32_t dst, uint32_t src,
                                               int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(src), "r"(bytes), "r"(bar)
      : "memory");
}
// ---- tensor copies (TMA through a tensor map) ----
// Box (c0.., c1.., c2.., c3) of the 4-d tensor `map` describes into shared
// memory at `dst` of every block of the cluster named in `mask`, at the
// same offset, each completing on its own mbarrier at `bar`'s offset.
// Elements outside the tensor arrive as zeros and count as bytes.
__device__ __forceinline__ void tensor_copy_mc(uint32_t dst,
                                               const CUtensorMap* map, int c0,
                                               int c1, int c2, int c3,
                                               uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar), "h"(mask)
      : "memory");
}
// The same into this block's shared memory alone
__device__ __forceinline__ void tensor_copy(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
// The tensor map of a bf16 NHWC tensor (B, H, W, C) at `ptr` whose boxes
// are (box_c channels, box_w columns, box_h rows, one image), 128-byte
// swizzled into shared memory (box_c = 64: a pixel's 128 bytes stored as
// pix_chunk lays them out, given a 1024-aligned destination) or stored
// densely. The encoder, cuTensorMapEncodeTiled, is looked up through the
// runtime, so the library links nothing beyond it. Returns a cudaError_t.
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);
inline int nhwc_tensor_map(CUtensorMap* map, const void* ptr, int B, int H,
                           int W, int C, int box_c, int box_w, int box_h,
                           bool swizzle) {
  static TensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = (TensorMapEncodeTiled)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_c, (cuuint32_t)box_w,
                             (cuuint32_t)box_h, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The tensor map of a 4-d int8 tensor at `ptr`: extents `dims` (innermost
// first), byte strides `strides` of dims 1-3, boxes of `box` elements read
// every `estride`-th element (a box of 2n elements at stride 2 lands n of
// them), rows of `row_bytes` (32, 64 or 128: box[0]) swizzled as
// `kmajor_desc` reads them. Elements outside the tensor (padding, past the
// image, past C or N) arrive as zeros. Returns a cudaError_t.
inline int s8_tensor_map(CUtensorMap* map, const void* ptr,
                         const uint64_t (&dims)[4],
                         const uint64_t (&strides)[3],
                         const uint32_t (&box)[4],
                         const uint32_t (&estride)[4], int row_bytes) {
  static TensorMapEncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = (TensorMapEncodeTiled)fn;
  }
  const cuuint64_t d[4] = {dims[0], dims[1], dims[2], dims[3]};
  const cuuint64_t st[3] = {strides[0], strides[1], strides[2]};
  const cuuint32_t bx[4] = {box[0], box[1], box[2], box[3]};
  const cuuint32_t es[4] = {estride[0], estride[1], estride[2], estride[3]};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(ptr), d, st,
      bx, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
// fetch a kernel parameter's tensor map ahead of its first copy
__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---- launch ----
// `kernel` over `grid` blocks of `threads`, in clusters of `cluster` along
// x (1: no cluster); returns the launch's error. The caller has raised the
// kernel's dynamic shared memory limit.
template <class... Args>
int launch_ex(void (*kernel)(Args...), dim3 grid, int cluster, int threads,
              int smem, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of `kernel` the card holds at once
// (0 on an error, which the caller's launch then reports). The caller has
// raised the kernel's dynamic shared memory limit.
template <class... Args>
int max_clusters(void (*kernel)(Args...), int cluster, int threads,
                 int smem) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kernel, &cfg) !=
      cudaSuccess)
    return 0;
  return n;
}

}  // namespace mma90
