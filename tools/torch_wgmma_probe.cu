// Probe kernels for tools/torch_wgmma_probe.py: how fast one SM's tensor
// cores run the wide head's products in the forms its redesign could take,
// and whether a shared-memory matrix descriptor can address a window's
// pixel rows at any pixel (the A operand of route (a)). Built by that
// script with nvcc for sm_90a; not part of the port's library.
//
// rate_kernel<N, MINE, NWG, MODE>: NWG warpgroups of one block an SM, each
// holding MINE accumulator tiles of m64 x N, multiply `chunks` 64-deep K
// chunks (4 k16 steps each). B cycles over four 16 KB slots of shared
// memory; A rows are pixels of a 336-pixel window (two 64-channel planes),
// one lane one pixel, as the wide kernels address them. MODE:
//   0  A by ldmatrix after waiting out the warpgroup's previous products
//      (the wide kernels' chunk_step), two chunks a step
//   1  A by ldmatrix one k16 step ahead into a second register set, the
//      products of the step before still in flight (wgmma_wait<1>)
//   2  A from shared memory through a descriptor, no A registers
// phase_kernel: one m64n64 K chunk with A read through a descriptor whose
// start lies at pixel `start` of a swizzled window (8-row groups
// `sbo_px` pixels apart), base-offset field 0 or the start's row phase.
#include <cuda_bf16.h>
#include <stdint.h>

#include "../unina_yolo_dla_torch/csrc/mma_sm90.cuh"

using namespace mma90;

namespace {

constexpr int WIN_PX = 336;
constexpr int SLOT = 16384;

__device__ __forceinline__ uint64_t a_desc(uint32_t addr, int sbo_bytes,
                                           int base_off) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         ((uint64_t)(sbo_bytes >> 4) << 32) | ((uint64_t)base_off << 49) |
         (1ull << 62);
}

// d += A(64 x 16, shared through `da`) @ B(16 x 64, shared through `db`)
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// d += A(64 x 16, shared through `da`) @ B(16 x 128, shared through `db`)
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}
// d += A(64 x 16, shared through `da`) @ B(16 x 256, shared through `db`)
__device__ __forceinline__ void wgmma_ss_m64n256k16(float (&d)[128],
                                                uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void mma_rs<64>(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  wgmma_m64n64k16(d, a, b);
}
template <>
__device__ __forceinline__ void mma_rs<128>(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b) {
  wgmma_m64n128k16(d, a, b);
}
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b);
template <>
__device__ __forceinline__ void mma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  wgmma_ss_m64n64k16(d, a, b);
}
template <>
__device__ __forceinline__ void mma_ss<128>(float (&d)[64], uint64_t a,
                                            uint64_t b) {
  wgmma_ss_m64n128k16(d, a, b);
}
template <>
__device__ __forceinline__ void mma_ss<256>(float (&d)[128], uint64_t a,
                                            uint64_t b) {
  wgmma_ss_m64n256k16(d, a, b);
}

template <int N, int MINE, int NWG, int MODE>
__global__ void __launch_bounds__(NWG * 128, 1)
    rate_kernel(int chunks, float* sink) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t win = base + 4 * SLOT;  // two planes of WIN_PX pixels
  const int tid = threadIdx.x, lane = tid & 31, warp = (tid >> 5) & 3;
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  // fill B and the window with small values (their bits are not checked)
  for (int i = tid; i < (4 * SLOT + 2 * WIN_PX * 128) / 4; i += NWG * 128)
    st_shared(base + 4 * i,
              0x3c003c00u ^ (uint32_t)(i * 2654435761u & 0x00ff00ffu));
  fence_proxy_async();
  __syncthreads();
  int pix[MINE];  // this lane's row: pixel of item i
#pragma unroll
  for (int i = 0; i < MINE; ++i)
    pix[i] = ((wg * MINE + i) * 64 + warp * 16 + (lane & 15)) % (WIN_PX - 48);
  float acc[MINE][N / 2];
#pragma unroll
  for (int i = 0; i < MINE; ++i)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) acc[i][j] = 0.f;
  auto bdesc = [&](int c, int ks) {
    return b_desc(base + (c & 3) * SLOT) + (uint64_t)(ks * 32 >> 4);
  };
  auto aaddr = [&](int i, int c, int ks) {  // plane c & 1, tap shift c % 9
    return win + (c & 1) * WIN_PX * 128 +
           pix_chunk(pix[i] + (c % 9), 2 * ks + (lane >> 4));
  };
  if constexpr (MODE == 0) {
    uint32_t a[2][MINE][4][4];
#pragma unroll 1
    for (int c = 0; c < chunks; c += 2) {
      wgmma_wait<0>();
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < MINE; ++i)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            ldmatrix_x4(a[k][i][ks], aaddr(i, c + k, ks));
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
#pragma unroll
        for (int i = 0; i < MINE; ++i)
#pragma unroll
          for (int ks = 0; ks < 4; ++ks)
            mma_rs<N>(acc[i], a[k][i][ks], bdesc(c + k, ks));
      wgmma_commit();
    }
  } else if constexpr (MODE == 1) {
    uint32_t a[2][MINE][4];
#pragma unroll
    for (int i = 0; i < MINE; ++i) ldmatrix_x4(a[0][i], aaddr(i, 0, 0));
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int s = ks & 1;
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < MINE; ++i) mma_rs<N>(acc[i], a[s][i], bdesc(c, ks));
        wgmma_commit();
        wgmma_wait<1>();
        const int nc = ks == 3 ? c + 1 : c, nk = (ks + 1) & 3;
#pragma unroll
        for (int i = 0; i < MINE; ++i)
          ldmatrix_x4(a[s ^ 1][i], aaddr(i, nc, nk));
      }
    }
  } else {
#pragma unroll 1
    for (int c = 0; c < chunks; ++c) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < MINE; ++i) {
          // 64 rows from a start inside the window (a tap shift c % 9)
          const uint32_t a0 = win + (c & 1) * WIN_PX * 128 +
                              ((wg * MINE + i) * 64 % 256 + c % 9) * 128 +
                              ks * 32;
          mma_ss<N>(acc[i], a_desc(a0, 1024, 0), bdesc(c, ks));
        }
      wgmma_commit();
      wgmma_wait<1>();
    }
  }
  wgmma_wait<0>();
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < MINE; ++i)
#pragma unroll
    for (int j = 0; j < N / 2; ++j) s += acc[i][j];
  if (s == 1234.5f) sink[tid] = s;  // keeps the products alive
}

__global__ void phase_kernel(const uint4* win, int win_chunks,
                             const uint4* tile, float* out, int start,
                             int sbo_px, int base_mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t raw = smem_u32(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* p = smem + (base - raw);
  const int tid = threadIdx.x;
  for (int i = tid; i < 512; i += 128)
    reinterpret_cast<uint4*>(p)[i] = tile[i];
  for (int i = tid; i < win_chunks; i += 128)
    reinterpret_cast<uint4*>(p + 8192)[i] = win[i];
  fence_proxy_async();
  __syncthreads();
  float d[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) d[j] = 0.f;
  const uint32_t a0 = base + 8192 + start * 128;
  const int bo = base_mode ? (int)((a0 >> 7) & 7) : 0;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_ss_m64n64k16(d, a_desc(a0 + ks * 32, sbo_px * 128, bo),
                       b_desc(base) + (uint64_t)(ks * 32 >> 4));
  wgmma_commit();
  wgmma_wait<0>();
  const int warp = tid >> 5, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = warp * 16 + (lane >> 2) + 8 * h;
      const int col = 8 * j + 2 * (lane & 3);
      out[row * 64 + col] = d[4 * j + 2 * h];
      out[row * 64 + col + 1] = d[4 * j + 2 * h + 1];
    }
}

template <int N, int MINE, int NWG, int MODE>
int launch_rate(int blocks, int chunks, float* sink, void* stream) {
  const int smem = 1024 + 4 * SLOT + 2 * WIN_PX * 128;
  cudaError_t err = cudaFuncSetAttribute(
      rate_kernel<N, MINE, NWG, MODE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  rate_kernel<N, MINE, NWG, MODE><<<blocks, NWG * 128, smem,
                                    (cudaStream_t)stream>>>(chunks, sink);
  return (int)cudaGetLastError();
}

}  // namespace

// variant v (the table in tools/torch_wgmma_probe.py) over `blocks`
// blocks of `chunks` chunks each; returns the launch's error
extern "C" int probe_rate(int v, int blocks, int chunks, float* sink,
                          void* stream) {
  switch (v) {
    case 0: return launch_rate<64, 3, 2, 0>(blocks, chunks, sink, stream);
    case 1: return launch_rate<64, 3, 2, 1>(blocks, chunks, sink, stream);
    case 2: return launch_rate<128, 2, 2, 1>(blocks, chunks, sink, stream);
    case 3: return launch_rate<128, 2, 3, 1>(blocks, chunks, sink, stream);
    case 4: return launch_rate<128, 1, 3, 1>(blocks, chunks, sink, stream);
    case 5: return launch_rate<128, 2, 1, 1>(blocks, chunks, sink, stream);
    case 6: return launch_rate<128, 2, 2, 2>(blocks, chunks, sink, stream);
    case 7: return launch_rate<128, 2, 3, 2>(blocks, chunks, sink, stream);
    case 8: return launch_rate<256, 1, 2, 2>(blocks, chunks, sink, stream);
    case 9: return launch_rate<64, 3, 2, 2>(blocks, chunks, sink, stream);
    case 10: return launch_rate<128, 2, 1, 2>(blocks, chunks, sink, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int probe_phase(const void* win, int win_chunks, const void* tile,
                           float* out, int start, int sbo_px, int base_mode,
                           void* stream) {
  const int smem = 1024 + 8192 + win_chunks * 16;
  cudaError_t err = cudaFuncSetAttribute(
      phase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  phase_kernel<<<1, 128, smem, (cudaStream_t)stream>>>(
      (const uint4*)win, win_chunks, (const uint4*)tile, out, start, sbo_px,
      base_mode);
  return (int)cudaGetLastError();
}
