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
//   with UP. With s_t = max(t, 1e-9) * f32(1 / 127) (the reference's
//   max(t, 1e-9) / 127 as its jitted program computes it; computed on the
//   host):
//   COPY   int8 at amax t               out = q
//   REQ    int8 at amax a               out = clamp(rint(f32(q) * r), +-127)
//                                       r = s_a / s_t rounded to f32 (host)
//   Q      bf16 or f32 v                out = clamp(rint(v / s_t), +-127)
//   DEQ_Q  int8 at amax a               v = bf16_rn(f32(q) * s_a), then Q
//   The quotient is the correctly rounded f32 one (`requant`'s, from the
//   double reciprocal of s_t taken once on the host), the product one f32
//   multiply (--fmad=false), the rounding half to even: the reference's
//   steps, bit for bit.
//
// Bound on the H100: bytes. Each input read once, the output written
//   once; the shipped frame's nine launches move ~7 MB, 0.0047 ms at
//   3.35 TB/s. A site is a few microseconds of latency: the launch, one
//   round trip to L2, the stores.
// Design:
//   - The site's mode set is a template argument (`Form`: int8 parts
//     copied or requantised; float parts quantised; dequantised int8 parts
//     beside quantised float ones), each with and without an upsampled
//     part, so no element meets a switch on its mode.
//   - Each part owns a run of blocks (the grid is the parts' runs one
//     after the other); a block finds its part once, so mode, type and
//     layout are uniform over it. A thread takes one of the part's source
//     vectors of 16 channels (two or four a thread measured slower at
//     every shipped site: PERF.md), a warp's 32 contiguous. A source
//     vector's pixel is its index shifted (a power-of-two count of
//     vectors a pixel) or divided once in 32 bits; an upsampled part
//     converts each source vector once and stores it four times.
//   - int8 -> f32 and the rounding to an int8 use the f32 adder (2^23 +
//     2^22 as a magic number) in place of the conversion units, which
//     take a quarter of the rate; a DEQ_Q part's 256 possible bytes are a
//     table that each block builds in shared memory while it waits for
//     the producer.
//   - Programmatic dependent launch: the launch may start while the
//     stream's previous kernel (a PDL int8 conv, as served) runs. A block
//     reads nothing global that a previous launch writes, and writes
//     nothing, before griddepcontrol.wait, which returns once the previous
//     grid has finished and its stores are visible; what it does before
//     (finding its part, the DEQ_Q table from the launch's own constants)
//     reads only the kernel's parameters. It lets the next launch start at
//     once (griddepcontrol.launch_dependents first): a dependent waits
//     for this whole grid at its own griddepcontrol.wait, so an early
//     start hides its launch and prologue and reads nothing early. Every
//     kernel that consumes this one's output in the port either waits so
//     or is launched without the attribute, after this grid has finished.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "quant_sm90.cuh"

namespace {

constexpr int MAX_PARTS = 8;
constexpr int THREADS = 256;
enum Mode { COPY = 0, REQ = 1, Q = 2, DEQ_Q = 3 };
enum Dtype { S8 = 0, BF16 = 1, F32 = 2 };
// the mode sets of a site: int8 parts at the output's amax or requantised;
// float parts quantised; int8 parts dequantised beside float parts
enum Form { INT8 = 0, QUANT = 1, DEQUANT = 2 };

constexpr float MAGIC = 12582912.f;  // 2^23 + 2^22: its ulp is 1

struct Part {
  const void* src;
  int c, off;        // channels; first output channel
  int mode, dtype;
  int up, vec;       // read at (h/2, w/2); 16-byte loads and stores
  int nv, shift;     // vectors of a source pixel; log2(nv), or -1
  unsigned begin;    // the part's first block
  unsigned items;    // its source vectors: source pixels x nv
  float f;           // REQ: the ratio; DEQ_Q: s_a
};

struct Args {
  Part part[MAX_PARTS];
  int n_parts, W, C, Ws;  // output width and channels; W / 2
  double r;               // 1 / s_t rounded to double
  int8_t* out;
};

// (float)q of a sign-extended byte, by the adder: 2^23 + 2^22 + q is exact
__device__ __forceinline__ float s8_to_f32(int q) {
  return __fsub_rn(__int_as_float(0x4B400000 + q), MAGIC);
}

// clamp(rint(y), -127, 127) as a byte, rounding half to even: clamping
// first to the integers +-127 gives the same, and 2^23 + 2^22 + y rounds y
// to an integer (an even sum where y is a tie) in the low mantissa bits
__device__ __forceinline__ uint32_t to_byte(float y) {
  const float t = __fadd_rn(fminf(fmaxf(y, -127.f), 127.f), MAGIC);
  return (uint32_t)__float_as_int(t) & 0xFFu;
}

// the correctly rounded f32 quotient v / s_t from r = 1 / s_t in double
// (quant_sm90.cuh's argument), before the rounding to an integer
__device__ __forceinline__ float quotient(float v, double r) {
  return __double2float_rn(__dmul_rn((double)v, r));
}

__device__ __forceinline__ int byte_of(const uint4& w, int k) {
  const uint32_t x = k < 4 ? w.x : k < 8 ? w.y : k < 12 ? w.z : w.w;
  return (int)(int8_t)(x >> (8 * (k % 4)));
}

// a source vector: 16 bytes of int8, or the 16 values' raw words
template <int DT>
struct Vec {
  uint4 w[DT == S8 ? 1 : DT == BF16 ? 2 : 4];
};

template <int DT>
__device__ __forceinline__ void load_vec(const Part& p, unsigned i,
                                         unsigned spix, int ch, int n,
                                         Vec<DT>& v) {
  constexpr int N = sizeof(Vec<DT>) / 16;
  if (p.vec) {
    // c % 16 == 0: the vector's first element is 16 i
    const uint4* s = reinterpret_cast<const uint4*>(
        static_cast<const uint8_t*>(p.src) + (size_t)i * 16 * N);
#pragma unroll
    for (int h = 0; h < N; ++h) v.w[h] = s[h];
    return;
  }
  const size_t e = (size_t)spix * p.c + ch;
  uint32_t u[4 * N];
#pragma unroll
  for (int k = 0; k < 4 * N; ++k) u[k] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k >= n) break;
    if constexpr (DT == S8) {
      u[k / 4] |= (uint32_t)static_cast<const uint8_t*>(p.src)[e + k]
                  << (8 * (k % 4));
    } else if constexpr (DT == BF16) {
      u[k / 2] |= (uint32_t)static_cast<const uint16_t*>(p.src)[e + k]
                  << (16 * (k % 2));
    } else {
      u[k] = static_cast<const uint32_t*>(p.src)[e + k];
    }
  }
#pragma unroll
  for (int h = 0; h < N; ++h)
    v.w[h] = make_uint4(u[4 * h], u[4 * h + 1], u[4 * h + 2], u[4 * h + 3]);
}

// the k-th value of a float vector, as f32
template <int DT>
__device__ __forceinline__ float value(const Vec<DT>& v, int k) {
  static_assert(DT != S8, "a float vector");
  if constexpr (DT == BF16) {
    const uint4& w = v.w[k / 8];
    const int j = k % 8;
    const uint32_t x = j < 2 ? w.x : j < 4 ? w.y : j < 6 ? w.z : w.w;
    return __uint_as_float(j % 2 ? x & 0xFFFF0000u : x << 16);
  } else {
    const uint4& w = v.w[k / 4];
    const int j = k % 4;
    return __uint_as_float(j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w);
  }
}

// the 16 output bytes of a source vector in MODE
template <int MODE, int DT>
__device__ __forceinline__ uint4 convert(const Vec<DT>& v, const Part& p,
                                         double r, const uint8_t* table) {
  if constexpr (MODE == COPY) {
    return v.w[0];
  } else {
    uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      uint32_t b;
      if constexpr (MODE == REQ)
        b = to_byte(__fmul_rn(s8_to_f32(byte_of(v.w[0], k)), p.f));
      else if constexpr (MODE == DEQ_Q)
        b = table[byte_of(v.w[0], k) & 0xFF];
      else
        b = to_byte(quotient(value<DT>(v, k), r));
      o[k / 4] |= b << (8 * (k % 4));
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

__device__ __forceinline__ void store16(int8_t* dst, const uint4& o, int n,
                                        bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = o;
    return;
  }
  const uint32_t w[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) dst[k] = (int8_t)(w[k / 4] >> (8 * (k % 4)));
}

// source vector i of part p in MODE (source type DT), read at half size
// where UPP
template <int MODE, int DT, bool UPP>
__device__ __forceinline__ void run(const Args& a, const Part& p,
                                    unsigned i, const uint8_t* table) {
  if (i >= p.items) return;
  const unsigned spix = p.shift >= 0 ? i >> p.shift : i / (unsigned)p.nv;
  const int ch = 16 * (int)(i - spix * (unsigned)p.nv);
  const int n = min(16, p.c - ch);
  Vec<DT> v;
  load_vec<DT>(p, i, spix, ch, n, v);
  const uint4 o = convert<MODE, DT>(v, p, a.r, table);
  if constexpr (UPP) {
    // source pixel (row, ws) of (B x H/2, W/2): output rows 2 row and
    // 2 row + 1 (H = 2 (H/2) keeps the image's rows together)
    const unsigned row = spix / (unsigned)a.Ws;
    const unsigned ws = spix - row * (unsigned)a.Ws;
    const size_t o00 = (size_t)2 * row * a.W + 2 * ws;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const size_t opix = o00 + (q >> 1) * (size_t)a.W + (q & 1);
      store16(a.out + opix * a.C + p.off + ch, o, n, p.vec);
    }
  } else {
    store16(a.out + (size_t)spix * a.C + p.off + ch, o, n, p.vec);
  }
}

template <int MODE, int DT, bool UP>
__device__ __forceinline__ void run_up(const Args& a, const Part& p,
                                       unsigned i, const uint8_t* table) {
  if constexpr (UP) {
    if (p.up) {
      run<MODE, DT, true>(a, p, i, table);
      return;
    }
  }
  run<MODE, DT, false>(a, p, i, table);
}

template <int FORM, bool UP>
__global__ void __launch_bounds__(THREADS)
qconcat_kernel(const __grid_constant__ Args a) {
  // a dependent launch may start now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  int j = 0;  // the block's part (uniform over the block)
#pragma unroll
  for (int k = 1; k < MAX_PARTS; ++k)
    if (k < a.n_parts && blockIdx.x >= a.part[k].begin) j = k;
  const Part& p = a.part[j];
  const unsigned i = (blockIdx.x - p.begin) * THREADS + threadIdx.x;
  __shared__ uint8_t table[256];
  if constexpr (FORM == DEQUANT) {
    if (p.mode == DEQ_Q) {
      // the DEQ_Q part's bytes: v = bf16_rn(f32(q) * s_a), then Q
      const int q = (int)threadIdx.x - 128;
      const float v = __bfloat162float(
          __float2bfloat16_rn(__fmul_rn(s8_to_f32(q), p.f)));
      table[q & 0xFF] = (uint8_t)to_byte(quotient(v, a.r));
      __syncthreads();
    }
  }
  // everything global below: after the previous grid has finished
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  if constexpr (FORM == INT8) {
    if (p.mode == COPY)
      run_up<COPY, S8, UP>(a, p, i, table);
    else
      run_up<REQ, S8, UP>(a, p, i, table);
  } else {
    if (FORM == DEQUANT && p.mode == DEQ_Q)
      run_up<DEQ_Q, S8, UP>(a, p, i, table);
    else if (p.dtype == BF16)
      run_up<Q, BF16, UP>(a, p, i, table);
    else
      run_up<Q, F32, UP>(a, p, i, table);
  }
}

template <int FORM, bool UP>
int launch(const Args& a, unsigned blocks, void* stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, qconcat_kernel<FORM, UP>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// out (B, H, W, C) int8; part i: srcs[i], meta[4 i ..] = channels, mode
// (0 COPY, 1 REQ, 2 Q, 3 DEQ_Q), dtype (0 int8, 1 bf16, 2 f32), up (0,
// 1: the source is (B, H/2, W/2, c) read at (h/2, w/2)); f[i] the REQ
// ratio or the DEQ_Q part's scale; r the reciprocal of the output's scale
// rounded to double.
// The parts' channels sum to C. COPY and REQ parts go together, Q and
// DEQ_Q parts together; COPY, REQ and DEQ_Q take int8 sources, Q bf16 or
// f32; UP needs H and W even. Launched with programmatic dependent launch.
extern "C" int unina_qconcat(const void* const* srcs, const int* meta,
                             const float* f, int n_parts, int B, int H, int W,
                             int C, double r, void* out, void* stream) {
  if (n_parts <= 0 || n_parts > MAX_PARTS || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || out == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.n_parts = n_parts, a.W = W, a.C = C, a.Ws = W / 2, a.r = r;
  a.out = static_cast<int8_t*>(out);
  const long long pixels = (long long)B * H * W;
  const bool out16 = C % 16 == 0 && (uintptr_t)out % 16 == 0;
  int off = 0, ups = 0, ints = 0, deqs = 0;
  long long blocks = 0;
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
    ints += p.mode == COPY || p.mode == REQ;
    deqs += p.mode == DEQ_Q;
    ups += p.up;
    p.off = off;
    p.nv = (p.c + 15) / 16;
    p.shift = -1;
    for (int s = 0; s < 31; ++s)
      if (p.nv == 1 << s) p.shift = s;
    p.vec = out16 && p.c % 16 == 0 && off % 16 == 0 &&
            (uintptr_t)p.src % 16 == 0;
    const long long items = (p.up ? pixels / 4 : pixels) * p.nv;
    if (blocks + items > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
    p.items = (unsigned)items;
    p.begin = (unsigned)blocks;
    blocks += (items + THREADS - 1) / THREADS;
    off += p.c;
  }
  // a site's modes are one form: int8 parts alone, or float parts with
  // or without dequantised ones
  if (off != C || (ints != 0 && ints != n_parts))
    return (int)cudaErrorInvalidValue;
  const int form = ints ? INT8 : deqs ? DEQUANT : QUANT;
  const unsigned n = (unsigned)blocks;
  if (form == INT8)
    return ups ? launch<INT8, true>(a, n, stream)
               : launch<INT8, false>(a, n, stream);
  if (form == QUANT)
    return ups ? launch<QUANT, true>(a, n, stream)
               : launch<QUANT, false>(a, n, stream);
  return ups ? launch<DEQUANT, true>(a, n, stream)
             : launch<DEQUANT, false>(a, n, stream);
}
