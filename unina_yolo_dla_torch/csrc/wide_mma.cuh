// Shared device code of the wide C3k2 and head kernels (sm_90a): warp-level
// m16n8k16 bf16 products over NHWC windows in shared memory, the weights
// read as fragments straight from global memory (L2). Included by c3k2.cu
// and head.cu; not compiled on its own.
//
//   A (activations)  a window of pixels in shared memory, C bf16 channels a
//     pixel, rows padded to C + 8 elements (16 bytes): for C a multiple of
//     64 the eight rows of one ldmatrix phase then fall on eight different
//     16-byte bank groups. Every lane hands ldmatrix.x4 the address of its
//     own row (row = lane % 16 of the m16 tile, the upper 8 channels of the
//     k16 step for lanes 16-31), so a 3x3 tap is a shift of that address.
//   B (weights)  a (K, N) matrix, K a multiple of 16 and N of 8, stored as
//     its m16n8k16 B fragments (ops/cuda/mma_pack.py `pack_frag`): for n8
//     tile `nt` and k16 step `ks` the 32 lanes' 8-byte fragments lie
//     contiguous at ((nt * K/16 + ks) * 32 + lane) * 8 bytes, lane (g, tq)
//     holding W[16ks + 2tq (+1)][8nt + g] then W[16ks + 8 + 2tq (+1)][..]:
//     one coalesced 256-byte read per warp and product.
//   D  f32 accumulators in registers, a 16 x 64 block a warp at a time:
//     acc[j][0..1] row g, columns 8j + 2tq (+1); acc[j][2..3] row g + 8.
#pragma once
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace wide {

using namespace mma90;

constexpr int NJ = 8;  // n8 tiles of one warp's 16 x 64 block

// bytes of one padded pixel row of C bf16 channels
__host__ __device__ inline int row_bytes(int c) { return (c + 8) * 2; }

__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// acc[j] += A(16 rows x 16 ksteps) @ B(k16 steps ks0.., n8 tiles nt0 +
// j < nj). `arow`: this lane's row address in shared memory with its
// 16-byte half of the first k16 step already added; consecutive k16 steps
// are 32 bytes apart. `bmat` is the fragment image of a matrix of KS k16
// steps. The next step's B fragments are read while this step multiplies.
__device__ __forceinline__ void gemm_k(float (&acc)[NJ][4], uint32_t arow,
                                       int ksteps,
                                       const uint2* __restrict__ bmat,
                                       int KS, int ks0, int nt0, int nj,
                                       int lane) {
  const uint2* bp = bmat + ((size_t)nt0 * KS + ks0) * 32 + lane;
  const size_t jstride = (size_t)KS * 32;
  uint2 bcur[NJ], bnext[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) bnext[j] = make_uint2(0u, 0u);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
    bcur[j] = j < nj ? __ldg(bp + j * jstride) : make_uint2(0u, 0u);
#pragma unroll 1
  for (int ks = 0; ks < ksteps; ++ks) {
    if (ks + 1 < ksteps) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        bnext[j] = j < nj ? __ldg(bp + (ks + 1) * 32 + j * jstride)
                          : make_uint2(0u, 0u);
    }
    uint32_t a[4];
    ldmatrix_x4(a, arow + ks * 32);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j < nj) {
        const uint32_t b[2] = {bcur[j].x, bcur[j].y};
        mma_m16n8k16(acc[j], a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) bcur[j] = bnext[j];
  }
}

// ReLU(acc + bias) of two adjacent columns, packed to two bf16
__device__ __forceinline__ uint32_t relu_pack(float a0, float a1,
                                              const float* bias) {
  return pack_bf16(fmaxf(__fadd_rn(a0, __ldg(bias)), 0.f),
                   fmaxf(__fadd_rn(a1, __ldg(bias + 1)), 0.f));
}

}  // namespace wide
