// Raw camera frame -> letterboxed (or stretched), ImageNet-normalised model
// input, one pass.
//
// Replaces: the camera program's preprocessing in
//   unina_yolo_dla_tpu/runtime/pipeline.py build_camera_serving_fn
//   (:191-207): colour conversion of the whole frame (BGRA, RGB, NV12 with
//   ops/preprocess.py nv12_to_rgb), ops/preprocess.py:97
//   resize_bilinear_mxu (two float32 interpolation matmuls, XLA on the
//   TPU: no pallas_call), the 114 pad into the (S, S) canvas, / 255 and
//   normalize.
//
// Bound on the H100: bytes. The kernel writes S*S*3 values (2.46 MB in
//   bfloat16 at S = 640) and needs only the source pixels its taps touch:
//   at the served 1080x1920 BGRA letterbox (ratio 3 on both axes, every
//   weight 0 or 1) one row and one column in three, 0.92 MB of the 8.3 MB
//   frame (a row it touches is read whole: its taps are 12 bytes apart,
//   closer than a 32-byte sector). About 40 f32 operations a pixel are far
//   below the f32 rate; what costs is latency, scattered accesses and
//   partial stores.
//
// Arithmetic: the tables give, for each output row (column) of the
//   resized window, the two source indices and float32 weights of that
//   row of the reference's interpolation matrix (built once on the host).
//   Each tap's colour is converted before it interpolates, as the
//   reference converts the whole frame first (the NV12 clip to [0, 255] is
//   not linear). Vertical first, then horizontal, each as a matmul row
//   with two nonzeros accumulates: the first product rounded, the second
//   added in one fused multiply-add. Then / 255 and (x - mean) / std as
//   IEEE divisions (the file compiles --fmad=false: no other
//   contraction), rounded to nearest-even on the way out for bfloat16.
//
// Two forms; the host picks one per geometry (`table`):
// - The lookup form, camera_preprocess_kernel (RGB and BGRA where every
//   weight of both tables is 0 or 1, as at the served geometry): each
//   interpolated value is one tap's byte, so normalising it is a lookup in
//   a 3 x 256 float32 table holding the plain formula's own results (built
//   by the host, copied into shared memory through L1, where the SM's
//   other blocks find it): no division a pixel, the same bits. One block
//   per canvas row (640 blocks at S = 640, all resident at once: a pad
//   row's block ends as soon as it has written). A pad row reads nothing
//   and writes the normalised 114 (three floats computed once on the host
//   by the plain formula) as three 16-byte patterns, the channel phase
//   fixed by the store's offset. A window row copies the one source row
//   its taps name into shared memory with 16-byte cp.async (an unaligned
//   head and tail, as RGB rows of 3w bytes have, are single bytes loaded
//   into registers beside the copy and written after it), reads its
//   x-taps while the copy flies, gathers two adjacent pixels a thread into
//   a staged output run (pad columns get the 114) and writes the run with
//   coalesced 16-byte stores. A row whose taps span more than SRC_TILE
//   bytes is done in steps of `chunk` canvas pixels, chosen by the host so
//   that any `chunk` consecutive window columns fit; OUT_TILE bounds the
//   staged output. Where a table's taps are affine in the row (column), as
//   at the served ratio 3 (row 3 dy + 1), the host passes the map and the
//   block computes its row and x-taps instead of loading them (the tables
//   stay the source of truth: the host derives the map from them, entry by
//   entry).
// - The division form, camera_pixel_kernel (fractional weights, and every
//   NV12 frame: BT.601 with the clip is not integral): one thread per
//   canvas pixel, its four taps read from global memory, six divisions.
//   A row-staged block of this form was slower than this at the
//   stretched and NV12 geometries (PERF.md, the camera kernel's
//   findings).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int SRC_TILE = 8192;  // bytes of one staged source row run
constexpr int OUT_TILE = 640;   // canvas pixels staged per step
// pixel pairs a thread computes per step
constexpr int PAIRS = (OUT_TILE / 2 + THREADS - 1) / THREADS;
constexpr int LUT_VALUES = 3 * 256;
enum Format { RGB = 0, BGRA = 1, NV12 = 2 };

// One camera geometry's launch arguments, built once by the host
// (ops/cuda/camera_kernel.py `_Args`, field for field).
struct Args {
  int cam_h, cam_w, size, new_h, new_w, pad_y, pad_x;
  int chunk;     // lookup form: canvas pixels per step, so that any run of
                 // as many window columns spans at most SRC_TILE bytes
  int fmt;
  int table;     // 1: the lookup form (every weight 0 or 1, RGB or BGRA)
  int out_bf16;
  // lookup form, where the host found a table's taps affine (idx[d] =
  // i0 + step * d for every d, as at the served ratio 3): the map, step
  // >= 0; else step -1
  int y_i0, y_step, x_i0, x_step;
  const int2* y_idx;
  const float2* y_wts;
  const int2* x_idx;
  const float2* x_wts;
  const int2* spans;  // lookup form, per step: the first and last source
                      // column it reads (last < first: none)
  const float* lut;   // (3, 256): the formula's value of every byte
  float mean[3];
  float std[3];
  float pad[3];      // the normalised 114
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
// the same through the L1 cache: a block's table, which the other blocks
// on its SM read too
__device__ __forceinline__ void cp_async16_l1(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Two pixels' six staged values from `d` on (d: a staged OutT), in pairs
// (one 8-byte f32 or 4-byte bf16 store for two values) where d allows.
__device__ __forceinline__ void put6(float* d, const float (&v)[6],
                                     bool paired) {
  if (paired) {
    float2* d2 = reinterpret_cast<float2*>(d);
#pragma unroll
    for (int k = 0; k < 3; ++k) d2[k] = make_float2(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) d[k] = v[k];
  }
}
__device__ __forceinline__ void put6(__nv_bfloat16* d, const float (&v)[6],
                                     bool paired) {
  if (paired) {
    __nv_bfloat162* d2 = reinterpret_cast<__nv_bfloat162*>(d);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      d2[k] = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < 6; ++k) d[k] = __float2bfloat16_rn(v[k]);
  }
}
__device__ __forceinline__ uint32_t bits(float v, const float*) {
  return __float_as_uint(v);
}
__device__ __forceinline__ uint32_t bits(float v, const __nv_bfloat16*) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// 16 bytes of the pad whose first value has channel PH.
template <typename OutT, int PH>
__device__ __forceinline__ uint4 pad_pattern(const float (&p)[3]) {
  const OutT* tag = nullptr;
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (sizeof(OutT) == 4)
      w[i] = bits(p[(PH + i) % 3], tag);
    else
      w[i] = bits(p[(PH + 2 * i) % 3], tag) |
             (bits(p[(PH + 2 * i + 1) % 3], tag) << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float chan(const float (&p)[3], int c) {
  return c == 0 ? p[0] : (c == 1 ? p[1] : p[2]);
}

// Values [0, n) of a pad row (value j has channel j mod 3).
template <typename OutT>
__device__ __forceinline__ void pad_run(OutT* dst, int n, const Args& a) {
  constexpr int V = 16 / (int)sizeof(OutT);
  const int lead = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(((16 - lead) & 15) / (int)sizeof(OutT), n);
  const int body = (n - head) / V;
  const int t = threadIdx.x;
  if (t < head) put(dst + t, chan(a.pad, t % 3));
  const uint4 v0 = pad_pattern<OutT, 0>(a.pad);
  const uint4 v1 = pad_pattern<OutT, 1>(a.pad);
  const uint4 v2 = pad_pattern<OutT, 2>(a.pad);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int k = t; k < body; k += THREADS) {
    const int ph = (head + k * V) % 3;
    d4[k] = ph == 0 ? v0 : (ph == 1 ? v1 : v2);
  }
  const int done = head + body * V;
  if (t < n - done) put(dst + done + t, chan(a.pad, (done + t) % 3));
}

// A byte of a staged run that is not part of its 16-byte copies: loaded
// into a register with the copies, written to shared memory after them.
struct Edge {
  int pos;  // byte offset in the staged row; < 0: none
  uint32_t byte;
  __device__ __forceinline__ void put(uint8_t* dst) const {
    if (pos >= 0) dst[pos] = (uint8_t)byte;
  }
};

// Starts copying n bytes at global `src` into shared `dst`, byte k to
// dst[(src & 15) + k]: 16-byte cp.async for the aligned middle; the
// unaligned head and tail are single bytes, one a thread (threads 0..head
// take the head, the next ones the tail), held in `edge` until the copies
// have landed. Returns src & 15.
__device__ __forceinline__ int stage_bytes(uint8_t* dst, const uint8_t* src,
                                           int n, Edge& edge) {
  const int lead = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int head = min((16 - lead) & 15, n);
  const int body = (n - head) >> 4;
  const int done = head + 16 * body;
  const int t = threadIdx.x;
  const uint32_t base = smem_u32(dst + lead + head);
  for (int k = t; k < body; k += THREADS)
    cp_async16(base + 16 * k, src + head + 16 * k);
  const int k = t < head ? t : done + t - head;
  edge.pos = (t < head || (t - head < n - done)) ? lead + k : -1;
  if (edge.pos >= 0) edge.byte = __ldg(src + k);
  return lead;
}

// Values [0, n) of `dst` from the staged run `st`, where value j sits at
// byte (dst & 15) + j * sizeof(OutT): 16-byte stores in the middle.
template <typename OutT>
__device__ __forceinline__ void store_run(OutT* dst, const uint8_t* st,
                                          int n) {
  constexpr int V = 16 / (int)sizeof(OutT);
  const int lead = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
  const int head = min(((16 - lead) & 15) / (int)sizeof(OutT), n);
  const int body = (n - head) / V;
  const int t = threadIdx.x;
  const OutT* sv = reinterpret_cast<const OutT*>(st + lead);
  if (t < head) dst[t] = sv[t];
  const uint4* s4 = reinterpret_cast<const uint4*>(sv + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int k = t; k < body; k += THREADS) d4[k] = s4[k];
  const int done = head + body * V;
  if (t < n - done) dst[done + t] = sv[done + t];
}

// The lookup form: one block per canvas row (see the note at the top).
// (No minimum of blocks an SM in its bounds: asked for five, ptxas held it
// to 48 registers and it ran slower; left free it takes 40, six blocks an
// SM.)
template <int FMT, typename OutT>
__global__ void __launch_bounds__(THREADS)
camera_preprocess_kernel(const uint8_t* __restrict__ frame,
                         OutT* __restrict__ out, const Args a) {
  constexpr int BPP = FMT == RGB ? 3 : 4;
  __shared__ __align__(16) uint8_t src[SRC_TILE + 16];
  __shared__ __align__(16) uint8_t st[OUT_TILE * 3 * sizeof(OutT) + 16];
  __shared__ __align__(16) float lut[LUT_VALUES];

  const int s = a.size, t = threadIdx.x;
  OutT* row = out + (size_t)blockIdx.x * s * 3;
  const int dy = (int)blockIdx.x - a.pad_y;
  if (dy < 0 || dy >= a.new_h) {
    pad_run(row, 3 * s, a);
    return;
  }
  // the host's copy of the formula's table, beside the row
  for (int e = t; e < LUT_VALUES / 4; e += THREADS)
    cp_async16_l1(smem_u32(lut) + 16 * e, a.lut + 4 * e);
  // the row's tap (weight 1): computed where affine, so that the copy
  // waits only for the step's span
  const int iy = a.y_step >= 0 ? a.y_i0 + a.y_step * dy
                               : __ldg(&a.y_idx[dy].x);
  const uint8_t* r0 = frame + (size_t)iy * a.cam_w * BPP;
  const int w_end = a.pad_x + a.new_w;

  for (int k = 0, p0 = 0; p0 < s; ++k, p0 += a.chunk) {
    const int p1 = min(p0 + a.chunk, s);
    const int w0 = max(p0, a.pad_x), w1 = min(p1, w_end);
    const int2 span = __ldg(a.spans + k);  // the source columns it reads
    const int lo = span.x, n = (span.y - span.x + 1) * BPP;
    int lead = 0;
    Edge edge;
    edge.pos = -1;
    if (n > 0) {
      if (n > SRC_TILE) __trap();  // the host's chunk guarantees it
      lead = stage_bytes(src, r0 + (size_t)lo * BPP, n, edge);
    }
    // this thread's x-taps (two pixels a pair): computed where affine,
    // else loaded while the row is in flight
    int ix[2 * PAIRS];
#pragma unroll
    for (int i = 0; i < 2 * PAIRS; ++i) {
      const int p = p0 + 2 * (t + (i >> 1) * THREADS) + (i & 1);
      const int dx = p - a.pad_x;
      ix[i] = 0;
      if (p >= w0 && p < w1)
        ix[i] = a.x_step >= 0 ? a.x_i0 + a.x_step * dx
                              : __ldg(&a.x_idx[dx].x);
    }
    cp_async_wait_all();
    edge.put(src);
    __syncthreads();
    const int lead_o =
        (int)(reinterpret_cast<uintptr_t>(row + (size_t)p0 * 3) & 15);
    OutT* sv = reinterpret_cast<OutT*>(st + lead_o);
    const bool paired = (lead_o & (2 * (int)sizeof(OutT) - 1)) == 0;
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int p = p0 + 2 * (t + i * THREADS);
      if (p >= p1) break;
      float v[6];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* o = v + 3 * h;
        if (p + h < w0 || p + h >= w1) {
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c] = a.pad[c];
        } else {
          const uint8_t* px = src + lead + (ix[2 * i + h] - lo) * BPP;
          uint32_t b[3];
          if (FMT == BGRA) {
            const uint32_t q = *reinterpret_cast<const uint32_t*>(px);
            b[0] = (q >> 16) & 255u;
            b[1] = (q >> 8) & 255u;
            b[2] = q & 255u;
          } else {
#pragma unroll
            for (int c = 0; c < 3; ++c) b[c] = px[c];
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) o[c] = lut[c * 256 + b[c]];
        }
      }
      put6(sv + (p - p0) * 3, v, paired && p + 1 < p1);
    }
    __syncthreads();
    // the next step's staging writes only what this step has read before
    // the barrier above, and its own barrier comes after this step's store
    store_run(row + (size_t)p0 * 3, st, (p1 - p0) * 3);
  }
}

__device__ __forceinline__ float clip255(float v) {
  return fminf(fmaxf(v, 0.0f), 255.0f);
}

// The RGB value (float, on [0, 255]) of source pixel (y, x).
template <int FMT>
__device__ __forceinline__ void pixel(const uint8_t* __restrict__ f, int h,
                                      int w, int y, int x, float (&c)[3]) {
  if (FMT == BGRA) {
    const uint32_t v =
        __ldg(reinterpret_cast<const uint32_t*>(f) + (size_t)y * w + x);
    c[0] = (float)((v >> 16) & 255u);  // R
    c[1] = (float)((v >> 8) & 255u);   // G
    c[2] = (float)(v & 255u);          // B
  } else if (FMT == RGB) {
    const uint8_t* q = f + ((size_t)y * w + x) * 3;
    c[0] = (float)__ldg(q);
    c[1] = (float)__ldg(q + 1);
    c[2] = (float)__ldg(q + 2);
  } else {
    // NV12: planar Y, then (H/2, W/2) interleaved U, V; chroma upsampled
    // by nearest neighbour; BT.601 as the reference, product by product
    const float yy = __fsub_rn((float)__ldg(f + (size_t)y * w + x), 16.0f);
    const uint8_t* uv = f + (size_t)h * w + (size_t)(y >> 1) * w + (x & ~1);
    const float u = __fsub_rn((float)__ldg(uv), 128.0f);
    const float v = __fsub_rn((float)__ldg(uv + 1), 128.0f);
    const float ly = __fmul_rn(1.164f, yy);
    c[0] = clip255(__fadd_rn(ly, __fmul_rn(1.596f, v)));
    c[1] = clip255(
        __fsub_rn(__fsub_rn(ly, __fmul_rn(0.392f, u)), __fmul_rn(0.813f, v)));
    c[2] = clip255(__fadd_rn(ly, __fmul_rn(2.017f, u)));
  }
}

// A matmul row with two nonzeros: w0 * a, then w1 * b added in one FMA.
__device__ __forceinline__ float lerp2(float w0, float a, float w1, float b) {
  return __fmaf_rn(w1, b, __fmul_rn(w0, a));
}

// The division form: one thread per canvas pixel.
template <int FMT, typename OutT>
__global__ void __launch_bounds__(THREADS)
camera_pixel_kernel(const uint8_t* __restrict__ frame, OutT* __restrict__ out,
                    const Args a) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= a.size * a.size) return;
  const int oy = p / a.size;
  const int dy = oy - a.pad_y, dx = p - oy * a.size - a.pad_x;
  float v[3] = {a.pad[0], a.pad[1], a.pad[2]};
  if (dy >= 0 && dy < a.new_h && dx >= 0 && dx < a.new_w) {
    const int2 iy = __ldg(a.y_idx + dy), ix = __ldg(a.x_idx + dx);
    const float2 wy = __ldg(a.y_wts + dy), wx = __ldg(a.x_wts + dx);
    const int h = a.cam_h, w = a.cam_w;
    float ta[3], tb[3], left[3], right[3];
    pixel<FMT>(frame, h, w, iy.x, ix.x, ta);
    pixel<FMT>(frame, h, w, iy.y, ix.x, tb);
#pragma unroll
    for (int c = 0; c < 3; ++c) left[c] = lerp2(wy.x, ta[c], wy.y, tb[c]);
    pixel<FMT>(frame, h, w, iy.x, ix.y, ta);
    pixel<FMT>(frame, h, w, iy.y, ix.y, tb);
#pragma unroll
    for (int c = 0; c < 3; ++c) right[c] = lerp2(wy.x, ta[c], wy.y, tb[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float x = lerp2(wx.x, left[c], wx.y, right[c]);
      v[c] = __fdiv_rn(__fsub_rn(__fdiv_rn(x, 255.0f), a.mean[c]), a.std[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) put(out + (size_t)p * 3 + c, v[c]);
}

template <typename OutT>
cudaError_t launch(const uint8_t* frame, OutT* out, const Args& a,
                   cudaStream_t s) {
  if (a.table) {
    if (a.fmt == RGB)
      camera_preprocess_kernel<RGB, OutT><<<a.size, THREADS, 0, s>>>(frame,
                                                                     out, a);
    else
      camera_preprocess_kernel<BGRA, OutT><<<a.size, THREADS, 0, s>>>(frame,
                                                                      out, a);
    return cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((a.size * a.size + THREADS - 1) / THREADS);
  if (a.fmt == RGB)
    camera_pixel_kernel<RGB, OutT><<<blocks, THREADS, 0, s>>>(frame, out, a);
  else if (a.fmt == BGRA)
    camera_pixel_kernel<BGRA, OutT><<<blocks, THREADS, 0, s>>>(frame, out, a);
  else
    camera_pixel_kernel<NV12, OutT><<<blocks, THREADS, 0, s>>>(frame, out, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int unina_camera_preprocess(const void* frame, void* out,
                                       const void* args, void* stream) {
  if (args == nullptr || frame == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args& a = *static_cast<const Args*>(args);
  if (a.size <= 0 || a.new_h <= 0 || a.new_w <= 0 || a.pad_y < 0 ||
      a.pad_x < 0 || a.pad_y + a.new_h > a.size ||
      a.pad_x + a.new_w > a.size || a.cam_h <= 0 || a.cam_w <= 0 ||
      (long long)a.size * a.size > (1LL << 30) || a.fmt < RGB ||
      a.fmt > NV12 || a.y_idx == nullptr || a.x_idx == nullptr ||
      (a.table && (a.fmt == NV12 || a.chunk < 1 || a.chunk > OUT_TILE ||
                   a.spans == nullptr || a.lut == nullptr ||
                   reinterpret_cast<uintptr_t>(a.lut) % 16 != 0 ||
                   reinterpret_cast<uintptr_t>(out) % 16 != 0)) ||
      (!a.table && (a.y_wts == nullptr || a.x_wts == nullptr)) ||
      (a.fmt == BGRA && reinterpret_cast<uintptr_t>(frame) % 4 != 0) ||
      (a.fmt == NV12 && (a.cam_h % 2 || a.cam_w % 2)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  if (a.out_bf16) return (int)launch(f, (__nv_bfloat16*)out, a, s);
  return (int)launch(f, (float*)out, a, s);
}
