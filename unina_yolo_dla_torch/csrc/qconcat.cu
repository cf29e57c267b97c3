// One int8 concat of the int8 chain, each part copied, requantised or
// quantised on the way: one launch for a concat and its rescales.
//
// Replaces: no pallas_call. On the TPU the int8 chain's concats and its
//   float -> int8 boundaries are XLA passes that the reference writes as
//   elementwise ops: qconcat (unina_yolo_dla_tpu/quant/qtensor.py:86, its
//   requantize at :74), the quantise of a conv's in_q (qtensor.py:65,
//   quant/fake_quant.py:160-167), the dequantising concat_features
//   (models/blocks.py:38-45) and the int8 upsample folded into a concat
//   (qtensor.py:126, models/blocks.py:393-407). The port ran each as a
//   chain of eager PyTorch ops (round, clamp, casts, cat).
//
//   out (B, H, W, C) int8 at amax t; its channels are the parts' in order,
//   each part (B, H, W, c_i), or (B, H/2, W/2, c_i) read at (h/2, w/2)
//   with UP. With s_t = max(t, 1e-9) / 127:
//   COPY   int8 at amax t               out = q
//   REQ    int8 at amax a               out = clamp(rint(f32(q) * r), +-127)
//                                       r = s_a / s_t rounded to f32 (host)
//   Q      bf16 or f32 v                out = clamp(rint(v / s_t), +-127)
//   DEQ_Q  int8 at amax a               v = bf16_rn(f32(q) * s_a), then Q
//   The quotient is the correctly rounded f32 one (`requant`,
//   quant_sm90.cuh), the product one f32 multiply (--fmad=false), rint
//   rounds half to even: the reference's steps, bit for bit.
//
// Bound on the H100: bytes. Each input read once, the output written
//   once; the shipped frame's nine launches move ~7 MB.
// Design: one thread for each (pixel, 16 output channels of one part):
//   threads of a pixel are consecutive, so the stores of a warp are one
//   contiguous run and so are each part's loads. A part whose channel
//   count, offset and pointers fall on 16 bytes takes 16-byte loads (one
//   for int8, two for bf16, four for f32) and one 16-byte store; any
//   other part, and its tail of fewer than 16 channels, goes byte by byte
//   (element by element on the load side).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_sm90.cuh"

namespace {

constexpr int MAX_PARTS = 8;
constexpr int THREADS = 256;
enum Mode { COPY = 0, REQ = 1, Q = 2, DEQ_Q = 3 };
enum Dtype { S8 = 0, BF16 = 1, F32 = 2 };

struct Part {
  const void* src;
  int c, off;        // channels; first output channel
  int mode, dtype;
  int up, vec;       // read at (h/2, w/2); 16-byte loads and stores
  int first;         // the part's first vector of a pixel
  float f;           // REQ: the ratio; DEQ_Q: s_a
};

struct Args {
  Part part[MAX_PARTS];
  int n_parts, nvec;  // parts; vectors of a pixel, all parts
  int H, W, C;
  long long pixels;
  float s_t;
  int8_t* out;
};

__device__ __forceinline__ float load_value(const Part& p, long long i) {
  if (p.dtype == BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p.src)[i]);
  if (p.dtype == F32) return static_cast<const float*>(p.src)[i];
  return (float)static_cast<const int8_t*>(p.src)[i];
}

// the four 32-bit words of a 16-byte load
__device__ __forceinline__ void words(const void* ptr, uint32_t (&w)[4]) {
  const uint4 raw = *static_cast<const uint4*>(ptr);
  w[0] = raw.x, w[1] = raw.y, w[2] = raw.z, w[3] = raw.w;
}

// the 16 values (or n < 16) of a part's vector, as f32 (int8 exactly)
__device__ __forceinline__ void load16(const Part& p, long long i, int n,
                                       float (&v)[16]) {
  uint32_t w[4];
  if (p.vec && p.dtype == S8) {
    words(static_cast<const int8_t*>(p.src) + i, w);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      v[k] = (float)(int8_t)(w[k / 4] >> (8 * (k % 4)));
  } else if (p.vec && p.dtype == BF16) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      words(static_cast<const __nv_bfloat16*>(p.src) + i + 8 * h, w);
#pragma unroll
      for (int k = 0; k < 8; ++k)  // a bf16 is the high half of its f32
        v[8 * h + k] = __uint_as_float(
            k % 2 ? w[k / 2] & 0xFFFF0000u : w[k / 2] << 16);
    }
  } else if (p.vec) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      words(static_cast<const float*>(p.src) + i + 4 * h, w);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[4 * h + k] = __uint_as_float(w[k]);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = k < n ? load_value(p, i + k) : 0.f;
  }
}

__device__ __forceinline__ int8_t convert(const Part& p, float v, double r) {
  switch (p.mode) {
    case COPY:
      return (int8_t)(int)v;
    case REQ:
      return (int8_t)(int)fminf(fmaxf(rintf(__fmul_rn(v, p.f)), -127.f),
                                127.f);
    case DEQ_Q:
      v = __bfloat162float(__float2bfloat16_rn(__fmul_rn(v, p.f)));
      return (int8_t)(int)requant(v, r);
    default:
      return (int8_t)(int)requant(v, r);
  }
}

__global__ void __launch_bounds__(THREADS)
qconcat_kernel(const __grid_constant__ Args a) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= a.pixels * a.nvec) return;
  const long long pix = t / a.nvec;
  const int v = (int)(t - pix * a.nvec);
  int j = 0;
#pragma unroll
  for (int k = 1; k < MAX_PARTS; ++k)
    if (k < a.n_parts && v >= a.part[k].first) j = k;
  const Part& p = a.part[j];
  const int ch = 16 * (v - p.first);
  const int n = min(16, p.c - ch);
  long long spix = pix;
  if (p.up) {
    const long long w = pix % a.W, hw = pix / a.W;
    const long long h = hw % a.H, b = hw / a.H;
    spix = (b * (a.H / 2) + h / 2) * (a.W / 2) + w / 2;
  }
  float x[16];
  load16(p, spix * p.c + ch, n, x);
  const double r = quant_reciprocal(a.s_t);
  int8_t* dst = a.out + pix * a.C + p.off + ch;
  if (p.vec) {
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k)
      o[k / 4] |= (uint32_t)(uint8_t)convert(p, x[k], r) << (8 * (k % 4));
    *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k)
      if (k < n) dst[k] = convert(p, x[k], r);
  }
}

}  // namespace

// out (B, H, W, C) int8; part i: srcs[i], meta[4 i ..] = channels, mode
// (0 COPY, 1 REQ, 2 Q, 3 DEQ_Q), dtype (0 int8, 1 bf16, 2 f32), up (0,
// 1: the source is (B, H/2, W/2, c) read at (h/2, w/2)); f[i] the REQ
// ratio or the DEQ_Q part's scale; s_t the output's scale. The parts'
// channels sum to C. COPY, REQ and DEQ_Q take int8 sources, Q bf16 or
// f32; UP needs H and W even.
extern "C" int unina_qconcat(const void* const* srcs, const int* meta,
                             const float* f, int n_parts, int B, int H, int W,
                             int C, float s_t, void* out, void* stream) {
  if (n_parts <= 0 || n_parts > MAX_PARTS || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.n_parts = n_parts, a.H = H, a.W = W, a.C = C, a.s_t = s_t;
  a.pixels = (long long)B * H * W;
  a.out = static_cast<int8_t*>(out);
  int off = 0, nvec = 0;
  const bool out16 = C % 16 == 0 && (uintptr_t)out % 16 == 0;
  for (int i = 0; i < n_parts; ++i) {
    Part& p = a.part[i];
    p.src = srcs[i];
    p.c = meta[4 * i], p.mode = meta[4 * i + 1], p.dtype = meta[4 * i + 2];
    p.up = meta[4 * i + 3];
    p.f = f[i];
    if (p.src == nullptr || p.c <= 0 || p.mode < COPY || p.mode > DEQ_Q ||
        p.dtype < S8 || p.dtype > F32 || (p.mode == Q) == (p.dtype == S8) ||
        p.up < 0 || p.up > 1 || (p.up && (H % 2 || W % 2)))
      return (int)cudaErrorInvalidValue;
    p.off = off, p.first = nvec;
    p.vec = out16 && p.c % 16 == 0 && off % 16 == 0 &&
            (uintptr_t)p.src % 16 == 0;
    off += p.c;
    nvec += (p.c + 15) / 16;
  }
  if (off != C) return (int)cudaErrorInvalidValue;
  a.nvec = nvec;
  const long long threads = a.pixels * nvec;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  qconcat_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
