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
//   frame. About 40 f32 operations a pixel are far below the f32 rate.
// Design: one thread per canvas pixel. Outside the resized window it
//   writes the pad; inside, it reads its two row taps and two column taps
//   (source index and float32 weight, the two nonzeros of that row of the
//   reference's interpolation matrix, from tables built once on the host)
//   and converts each of its four source pixels to RGB before it
//   interpolates, as the reference converts the whole frame first (the
//   NV12 clip to [0, 255] is not linear). It interpolates vertically first
//   and then horizontally, the order of the two matmuls, each as a matmul
//   row with two nonzeros accumulates: the first product rounded, the
//   second added to it in one fused multiply-add. Then / 255 and
//   (x - mean) / std as IEEE divisions (the file compiles --fmad=false:
//   no other contraction), rounded to nearest-even on the way out for
//   bfloat16. A 4-byte BGRA pixel is one load; a tap with weight 0 reads
//   the other tap's pixel (the tables repeat its index), so it costs no
//   extra memory traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
enum Format { RGB = 0, BGRA = 1, NV12 = 2 };

struct Norm {
  float mean[3];
  float std[3];
};

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

template <int FMT, typename OutT>
__global__ void __launch_bounds__(THREADS)
camera_preprocess_kernel(const uint8_t* __restrict__ frame,
                         OutT* __restrict__ out, int cam_h, int cam_w,
                         int size, int new_h, int new_w, int pad_y, int pad_x,
                         const int2* __restrict__ y_idx,
                         const float2* __restrict__ y_wts,
                         const int2* __restrict__ x_idx,
                         const float2* __restrict__ x_wts, Norm k) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= size * size) return;
  const int oy = p / size;
  const int dy = oy - pad_y, dx = p - oy * size - pad_x;
  float v[3] = {114.0f, 114.0f, 114.0f};
  if (dy >= 0 && dy < new_h && dx >= 0 && dx < new_w) {
    const int2 iy = __ldg(y_idx + dy), ix = __ldg(x_idx + dx);
    const float2 wy = __ldg(y_wts + dy), wx = __ldg(x_wts + dx);
    float a[3], b[3], left[3], right[3];
    pixel<FMT>(frame, cam_h, cam_w, iy.x, ix.x, a);
    pixel<FMT>(frame, cam_h, cam_w, iy.y, ix.x, b);
#pragma unroll
    for (int c = 0; c < 3; ++c) left[c] = lerp2(wy.x, a[c], wy.y, b[c]);
    pixel<FMT>(frame, cam_h, cam_w, iy.x, ix.y, a);
    pixel<FMT>(frame, cam_h, cam_w, iy.y, ix.y, b);
#pragma unroll
    for (int c = 0; c < 3; ++c) right[c] = lerp2(wy.x, a[c], wy.y, b[c]);
#pragma unroll
    for (int c = 0; c < 3; ++c) v[c] = lerp2(wx.x, left[c], wx.y, right[c]);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c)
    put(out + (size_t)p * 3 + c,
        __fdiv_rn(__fsub_rn(__fdiv_rn(v[c], 255.0f), k.mean[c]), k.std[c]));
}

template <typename OutT>
cudaError_t launch(int fmt, const uint8_t* frame, OutT* out, int cam_h,
                   int cam_w, int size, int new_h, int new_w, int pad_y,
                   int pad_x, const int2* y_idx, const float2* y_wts,
                   const int2* x_idx, const float2* x_wts, Norm k,
                   cudaStream_t s) {
  const unsigned blocks = (unsigned)((size * size + THREADS - 1) / THREADS);
#define UNINA_CAMERA_LAUNCH(F)                                              \
  camera_preprocess_kernel<F, OutT><<<blocks, THREADS, 0, s>>>(            \
      frame, out, cam_h, cam_w, size, new_h, new_w, pad_y, pad_x, y_idx,   \
      y_wts, x_idx, x_wts, k)
  switch (fmt) {
    case RGB: UNINA_CAMERA_LAUNCH(RGB); break;
    case BGRA: UNINA_CAMERA_LAUNCH(BGRA); break;
    case NV12: UNINA_CAMERA_LAUNCH(NV12); break;
    default: return cudaErrorInvalidValue;
  }
#undef UNINA_CAMERA_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" int unina_camera_preprocess(
    const void* frame, void* out, int fmt, int cam_h, int cam_w, int size,
    int new_h, int new_w, int pad_y, int pad_x, const void* y_idx,
    const void* y_wts, const void* x_idx, const void* x_wts,
    const float* mean, const float* stdv, int out_bf16, void* stream) {
  if (size <= 0 || new_h <= 0 || new_w <= 0 || pad_y < 0 || pad_x < 0 ||
      pad_y + new_h > size || pad_x + new_w > size || cam_h <= 0 ||
      cam_w <= 0 || (long long)size * size > (1LL << 30) ||
      (fmt == BGRA && reinterpret_cast<uintptr_t>(frame) % 4 != 0) ||
      (fmt == NV12 && (cam_h % 2 || cam_w % 2)))
    return (int)cudaErrorInvalidValue;
  Norm k;
  for (int c = 0; c < 3; ++c) {
    k.mean[c] = mean[c];
    k.std[c] = stdv[c];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* f = (const uint8_t*)frame;
  const int2* yi = (const int2*)y_idx;
  const float2* yw = (const float2*)y_wts;
  const int2* xi = (const int2*)x_idx;
  const float2* xw = (const float2*)x_wts;
  if (out_bf16)
    return (int)launch(fmt, f, (__nv_bfloat16*)out, cam_h, cam_w, size, new_h,
                       new_w, pad_y, pad_x, yi, yw, xi, xw, k, s);
  return (int)launch(fmt, f, (float*)out, cam_h, cam_w, size, new_h, new_w,
                     pad_y, pad_x, yi, yw, xi, xw, k, s);
}
