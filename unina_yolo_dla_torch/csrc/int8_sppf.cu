// SPPF's three chained int8 max-pools and their concat: one launch.
//
// Replaces: no pallas_call. On the TPU the int8 SPPF is three XLA
//   reduce_window maxima of 5 x 5, stride 1, padding 2 of -128
//   (unina_yolo_dla_tpu/quant/qtensor.py:115-123 qmaxpool, chained in
//   models/blocks.py:357-390), then a concat that rescales nothing: all
//   four parts keep x's amax (qtensor.py:86 qconcat). The port ran them as
//   three float max-pools through permutes and an int8 torch.cat.
//
//   out (B, H, W, 4C) int8 = [x, p(x), p(p(x)), p(p(p(x)))], p the 5 x 5
//   pool. Chained clipped pools compose: the three are the maxima over
//   the windows of radius 2, 4 and 6 clipped to the image (any point of a
//   clipped radius-4 window is within 2 of a point of the clipped
//   radius-2 window). Each window holds a real element, so filling the
//   outside with -128 changes no maximum: the reference's padding.
//
// Bound on the H100: bytes. x read once (the halo re-read from L2), out
//   written once: 1 + 4 bytes an element.
// Design: one block for each 8 x 8 patch of output pixels and 16
//   channels. The patch's input window with a 6-pixel halo (20 x 20, -128
//   outside the image) lands in shared memory as 16-byte vectors; the row
//   maxima of radius 2, 4 and 6 of each window row (20 rows x 8 columns)
//   follow, then each output pixel takes the column maxima of those.
//   Bytes are compared four at a time (__vmaxs4). Where C is a multiple
//   of 16 and the pointers fall on 16 bytes, each pixel's 16 channels are
//   one load and the four parts four stores; otherwise byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int T = 8;            // the patch's side
constexpr int R = 6;            // the largest radius
constexpr int S = T + 2 * R;    // the window's side
constexpr int THREADS = 128;
constexpr uint32_t NEG = 0x80808080u;  // -128 in four bytes

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

__device__ __forceinline__ uint4 load(const int8_t* p, int n, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint32_t w[4] = {NEG, NEG, NEG, NEG};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n)
      w[k / 4] = (w[k / 4] & ~(0xFFu << (8 * (k % 4)))) |
                 ((uint32_t)(uint8_t)p[k] << (8 * (k % 4)));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store(int8_t* p, uint4 v, int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) p[k] = (int8_t)(w[k / 4] >> (8 * (k % 4)));
}

__global__ void __launch_bounds__(THREADS)
int8_sppf_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                 int H, int W, int C, int tiles_w, int vec) {
  __shared__ uint4 win[S][S];
  __shared__ uint4 rows[3][S][T];  // row maxima of radius 2, 4, 6
  const int b = blockIdx.z, c0 = 16 * blockIdx.y;
  const int h0 = blockIdx.x / tiles_w * T, w0 = blockIdx.x % tiles_w * T;
  const int n = min(16, C - c0);
  const int8_t* xb = x + (long long)b * H * W * C + c0;
  for (int i = threadIdx.x; i < S * S; i += THREADS) {
    const int h = h0 - R + i / S, w = w0 - R + i % S;
    win[i / S][i % S] =
        h >= 0 && h < H && w >= 0 && w < W
            ? load(xb + ((long long)h * W + w) * C, n, vec)
            : make_uint4(NEG, NEG, NEG, NEG);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * T; i += THREADS) {
    const int r = i / T, j = i % T + R;
    uint4 m = win[r][j];
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      m = vmax(m, vmax(win[r][j - d], win[r][j + d]));
      if (d % 2 == 0) rows[d / 2 - 1][r][i % T] = m;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T * T; i += THREADS) {
    const int r = i / T + R, j = i % T;
    const int h = h0 + i / T, w = w0 + j;
    if (h >= H || w >= W) continue;
    int8_t* o = out + (((long long)b * H + h) * W + w) * 4 * C + c0;
    store(o, win[r][j + R], n, vec);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int rad = 2 * (k + 1);
      uint4 m = rows[k][r][j];
#pragma unroll
      for (int d = 1; d <= rad; ++d)
        m = vmax(m, vmax(rows[k][r - d][j], rows[k][r + d][j]));
      store(o + (k + 1) * C, m, n, vec);
    }
  }
}

}  // namespace

// x (B, H, W, C) int8 NHWC; out (B, H, W, 4C) int8: x and its 5 x 5
// stride-1 max-pools chained once, twice and three times (padding -128).
extern "C" int unina_int8_sppf(const void* x, void* out, int B, int H, int W,
                               int C, void* stream) {
  if (x == nullptr || out == nullptr || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + T - 1) / T;
  const long long tiles = (long long)tiles_w * ((H + T - 1) / T);
  const int chunks = (C + 15) / 16;
  if (tiles > 0x7FFFFFFF || chunks > 65535) return (int)cudaErrorInvalidValue;
  const int vec = C % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  int8_sppf_kernel<<<dim3((unsigned)tiles, chunks, B), THREADS, 0,
                     (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), H, W, C,
      tiles_w, vec);
  return (int)cudaGetLastError();
}
