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
//   outside with -128 changes no maximum: the reference's padding. A
//   window's maximum is the maximum over its columns of each column's
//   maximum over its rows.
//
// Bound on the H100: bytes. x read once, out written once: 1 + 4 bytes an
//   element (0.00031 ms for the shipped (1, 40, 40, 128)). The launch is a
//   few microseconds of latency: one round trip to L2, a short chain of
//   maxima, the stores.
// Design: one block for a band of BAND = 2 output rows, up to 40 columns
//   (two warps' worth) and 16 channels (one 16-byte vector a pixel): 160
//   blocks of 128 threads for the shipped shape, the fastest chained
//   under a conv at batch 1 of the layouts measured with the PDL
//   attribute (bands of 1, 2, 4 and 8 rows, column maxima through shared
//   memory, 8 channels a thread, the 8 x 8 patches before it: PERF.md).
//   Without the attribute, bands of 4 chained faster still. The
//   band's window with its 6-pixel halo ((BAND + 12) x 52 vectors, -128
//   outside the image) lands in shared memory in one round of loads, all
//   issued before any is stored, then one barrier. Each thread then owns
//   one output row and one window column (a warp: 32 consecutive columns,
//   the middle 20 of them its outputs): the column's maxima over rows of
//   radius 2, 4 and 6 from 13 shared loads, in registers; the maxima over
//   columns by warp shuffles (radius 1 twice, then 2 and 4 from those:
//   the halo columns of a warp are its own lanes). Bytes are compared four
//   at a time (__vmaxs4). Where C is a multiple of 16 and the pointers
//   fall on 16 bytes, each pixel's 16 channels are one load and the four
//   parts four 16-byte stores; otherwise byte by byte.
//   Programmatic dependent launch: the launch may start while the
//   stream's previous kernel (SPPF's cv1, a PDL int8 conv) runs; its
//   blocks read x and write out only after griddepcontrol.wait, which
//   returns once that grid has finished and its stores are visible. It
//   lets the next launch start once its maxima are in registers
//   (griddepcontrol.launch_dependents before the stores): a dependent
//   waits for this whole grid at its own griddepcontrol.wait (SPPF's cv2,
//   a PDL int8 conv), so its early start hides its launch and prologue
//   under the stores and reads nothing early. Triggered at the start
//   instead, a launch chained between two convs let the next conv start
//   while this one still waited for the previous conv: 1.3-2.4 us slower
//   a launch (PERF.md).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 6;             // the largest radius
constexpr int BAND = 2;          // output rows a block
constexpr int LANES = 32;
constexpr int OUT_COLS = LANES - 2 * R;   // a warp's output columns: 20
constexpr int WARPS_ROW = 2;              // warps across a row
constexpr int TW = WARPS_ROW * OUT_COLS;  // a block's output columns: 40
constexpr int WIN_H = BAND + 2 * R;       // 14
constexpr int WIN_W = TW + 2 * R;         // 52
constexpr int THREADS = BAND * WARPS_ROW * LANES;   // 128
constexpr int LOADS = (WIN_H * WIN_W + THREADS - 1) / THREADS;  // 6
constexpr uint32_t NEG = 0x80808080u;  // -128 in four bytes

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y),
                    __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}

// lane + d's value (lane - |d| for d < 0); a lane past the warp's edge
// keeps its own, and is no output
__device__ __forceinline__ uint4 from(uint4 v, int d) {
  if (d > 0)
    return make_uint4(__shfl_down_sync(~0u, v.x, d),
                      __shfl_down_sync(~0u, v.y, d),
                      __shfl_down_sync(~0u, v.z, d),
                      __shfl_down_sync(~0u, v.w, d));
  return make_uint4(__shfl_up_sync(~0u, v.x, -d), __shfl_up_sync(~0u, v.y, -d),
                    __shfl_up_sync(~0u, v.z, -d), __shfl_up_sync(~0u, v.w, -d));
}

// the maximum of the lanes within d of this one, from m, the maximum
// within e: within d + e
__device__ __forceinline__ uint4 widen(uint4 m, int d) {
  return vmax(m, vmax(from(m, -d), from(m, d)));
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
  __shared__ uint4 win[WIN_H][WIN_W];
  const int b = blockIdx.z, c0 = 16 * blockIdx.y;
  const int h0 = blockIdx.x / tiles_w * BAND;
  const int w0 = blockIdx.x % tiles_w * TW;
  const int n = min(16, C - c0);
  const int8_t* xb = x + (size_t)b * H * W * C + c0;
  const int tid = threadIdx.x;
  // x is the previous launch's output
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  uint4 v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    const int h = h0 - R + i / WIN_W, w = w0 - R + i % WIN_W;
    v[k] = i < WIN_H * WIN_W && h >= 0 && h < H && w >= 0 && w < W
               ? load(xb + ((size_t)h * W + w) * C, n, vec)
               : make_uint4(NEG, NEG, NEG, NEG);
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    if (i < WIN_H * WIN_W) win[i / WIN_W][i % WIN_W] = v[k];
  }
  __syncthreads();
  // this thread: output row r of the band, window column j
  const int lane = tid % LANES, r = tid / (WARPS_ROW * LANES);
  const int j = tid / LANES % WARPS_ROW * OUT_COLS + lane;
  const uint4 centre = win[r + R][j];
  // the column's maxima over rows of radius 2, 4, 6 about row r + R
  uint4 c2 = centre;
#pragma unroll
  for (int d = 1; d <= 2; ++d)
    c2 = vmax(c2, vmax(win[r + R - d][j], win[r + R + d][j]));
  uint4 c4 = c2;
#pragma unroll
  for (int d = 3; d <= 4; ++d)
    c4 = vmax(c4, vmax(win[r + R - d][j], win[r + R + d][j]));
  uint4 c6 = c4;
#pragma unroll
  for (int d = 5; d <= 6; ++d)
    c6 = vmax(c6, vmax(win[r + R - d][j], win[r + R + d][j]));
  // then over columns: radius 1 + 1 = 2; 2 + 2 = 4; 4 + 2 = 6
  const uint4 p2 = widen(widen(c2, 1), 1);
  const uint4 q4 = widen(widen(c4, 1), 1);
  const uint4 p4 = widen(q4, 2);
  const uint4 q6 = widen(widen(c6, 1), 1);
  const uint4 p6 = vmax(widen(q6, 2), vmax(from(q6, -4), from(q6, 4)));
  // a dependent launch may start now: it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int h = h0 + r, w = w0 + j - R;
  if (lane < R || lane >= LANES - R || h >= H || w >= W) return;
  int8_t* o = out + (((size_t)b * H + h) * W + w) * 4 * C + c0;
  store(o, centre, n, vec);
  store(o + C, p2, n, vec);
  store(o + 2 * C, p4, n, vec);
  store(o + 3 * C, p6, n, vec);
}

}  // namespace

// x (B, H, W, C) int8 NHWC; out (B, H, W, 4C) int8: x and its 5 x 5
// stride-1 max-pools chained once, twice and three times (padding -128).
// Launched with programmatic dependent launch.
extern "C" int unina_int8_sppf(const void* x, void* out, int B, int H, int W,
                               int C, void* stream) {
  if (x == nullptr || out == nullptr || B <= 0 || H <= 0 || W <= 0 ||
      C <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles = (long long)tiles_w * ((H + BAND - 1) / BAND);
  const int chunks = (C + 15) / 16;
  if (tiles > 0x7FFFFFFF || chunks > 65535) return (int)cudaErrorInvalidValue;
  const int vec = C % 16 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, chunks, B);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, int8_sppf_kernel, static_cast<const int8_t*>(x),
      static_cast<int8_t*>(out), H, W, C, tiles_w, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
