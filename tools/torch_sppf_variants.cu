// SPPF layout variants, for timing against each other on the card.
//
// Built and timed by tools/torch_sppf_variants.py; none of them is the
// port's kernel (csrc/int8_sppf.cu). Each computes what int8_sppf does,
// (B, H, W, C) int8 -> (B, H, W, 4C) int8, x and its 5 x 5 max-pools of
// radius 2, 4 and 6, and launches with the programmatic dependent launch
// attribute when `pdl` is 1, without it when 0. Where the trigger
// (griddepcontrol.launch_dependents) stands: at the start (TRIG 0) or
// after the maxima, before the stores (TRIG 1).
//
//   variant  layout
//   0-3      bands of 4 / 2 / 1 / 8 rows, warp shuffles, trigger at start
//   4-6      bands of 4 / 2 / 8, column maxima through shared memory
//   7, 8     bands of 4 / 1, loads and stores only (a floor, not SPPF)
//   9        8 x 8 patches, rows then columns (the first form), at start
//   10, 11   8 channels a thread, bands of 4 / 2
//   12       variant 0 with the trigger before the stores
//   13       variant 9 with the trigger before the stores
//   14       variant 1 with the trigger before the stores (the kept form)
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int R = 6, LANES = 32, OUT_COLS = 20, WARPS_ROW = 2, TW = 40, WIN_W = 52;
constexpr uint32_t NEG = 0x80808080u;
__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
  return make_uint4(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y), __vmaxs4(a.z, b.z), __vmaxs4(a.w, b.w));
}
__device__ __forceinline__ uint4 from(uint4 v, int d) {
  if (d > 0) return make_uint4(__shfl_down_sync(~0u, v.x, d), __shfl_down_sync(~0u, v.y, d), __shfl_down_sync(~0u, v.z, d), __shfl_down_sync(~0u, v.w, d));
  return make_uint4(__shfl_up_sync(~0u, v.x, -d), __shfl_up_sync(~0u, v.y, -d), __shfl_up_sync(~0u, v.z, -d), __shfl_up_sync(~0u, v.w, -d));
}
__device__ __forceinline__ uint4 widen(uint4 m, int d) { return vmax(m, vmax(from(m, -d), from(m, d))); }

template <int BAND, int MODE, int TRIG = 0>  // MODE 0 shuffles, 1 smem horizontal, 2 copy only
__global__ void var_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, int H, int W, int C, int tiles_w) {
  constexpr int WIN_H = BAND + 2 * R;
  constexpr int THREADS = BAND * WARPS_ROW * LANES;
  constexpr int LOADS = (WIN_H * WIN_W + THREADS - 1) / THREADS;
  if (TRIG == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ uint4 win[WIN_H][WIN_W];
  __shared__ uint4 col[MODE == 1 ? 3 : 1][MODE == 1 ? BAND : 1][WIN_W];
  const int b = blockIdx.z, c0 = 16 * blockIdx.y;
  const int h0 = blockIdx.x / tiles_w * BAND, w0 = blockIdx.x % tiles_w * TW;
  const int8_t* xb = x + (size_t)b * H * W * C + c0;
  const int tid = threadIdx.x;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  uint4 v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    const int h = h0 - R + i / WIN_W, w = w0 - R + i % WIN_W;
    v[k] = i < WIN_H * WIN_W && h >= 0 && h < H && w >= 0 && w < W
               ? *reinterpret_cast<const uint4*>(xb + ((size_t)h * W + w) * C) : make_uint4(NEG, NEG, NEG, NEG);
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    if (i < WIN_H * WIN_W) win[i / WIN_W][i % WIN_W] = v[k];
  }
  __syncthreads();
  const int lane = tid % LANES, r = tid / (WARPS_ROW * LANES);
  const int j = tid / LANES % WARPS_ROW * OUT_COLS + lane;
  if (MODE == 2) {
    const int h = h0 + r, w = w0 + j - R;
    if (lane < R || lane >= LANES - R || h >= H || w >= W) return;
    int8_t* o = out + (((size_t)b * H + h) * W + w) * 4 * C + c0;
    const uint4 c = win[r + R][j];
    *reinterpret_cast<uint4*>(o) = c; *reinterpret_cast<uint4*>(o + C) = c;
    *reinterpret_cast<uint4*>(o + 2 * C) = c; *reinterpret_cast<uint4*>(o + 3 * C) = c;
    return;
  }
  if (MODE == 0) {
    const uint4 centre = win[r + R][j];
    uint4 c2 = centre;
#pragma unroll
    for (int d = 1; d <= 2; ++d) c2 = vmax(c2, vmax(win[r + R - d][j], win[r + R + d][j]));
    uint4 c4 = c2;
#pragma unroll
    for (int d = 3; d <= 4; ++d) c4 = vmax(c4, vmax(win[r + R - d][j], win[r + R + d][j]));
    uint4 c6 = c4;
#pragma unroll
    for (int d = 5; d <= 6; ++d) c6 = vmax(c6, vmax(win[r + R - d][j], win[r + R + d][j]));
    const uint4 p2 = widen(widen(c2, 1), 1);
    const uint4 q4 = widen(widen(c4, 1), 1);
    const uint4 p4 = widen(q4, 2);
    const uint4 q6 = widen(widen(c6, 1), 1);
    const uint4 p6 = vmax(widen(q6, 2), vmax(from(q6, -4), from(q6, 4)));
    if (TRIG == 1) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int h = h0 + r, w = w0 + j - R;
    if (lane < R || lane >= LANES - R || h >= H || w >= W) return;
    int8_t* o = out + (((size_t)b * H + h) * W + w) * 4 * C + c0;
    *reinterpret_cast<uint4*>(o) = centre; *reinterpret_cast<uint4*>(o + C) = p2;
    *reinterpret_cast<uint4*>(o + 2 * C) = p4; *reinterpret_cast<uint4*>(o + 3 * C) = p6;
    return;
  }
  // MODE 1: column maxima to shared memory, then row maxima from it
  for (int i = tid; i < BAND * WIN_W; i += THREADS) {
    const int rr = i / WIN_W, jj = i % WIN_W;
    uint4 c2 = win[rr + R][jj];
#pragma unroll
    for (int d = 1; d <= 2; ++d) c2 = vmax(c2, vmax(win[rr + R - d][jj], win[rr + R + d][jj]));
    uint4 c4 = c2;
#pragma unroll
    for (int d = 3; d <= 4; ++d) c4 = vmax(c4, vmax(win[rr + R - d][jj], win[rr + R + d][jj]));
    uint4 c6 = c4;
#pragma unroll
    for (int d = 5; d <= 6; ++d) c6 = vmax(c6, vmax(win[rr + R - d][jj], win[rr + R + d][jj]));
    col[0][rr][jj] = c2; col[1][rr][jj] = c4; col[2][rr][jj] = c6;
  }
  __syncthreads();
  for (int i = tid; i < BAND * TW; i += THREADS) {
    const int rr = i / TW, jj = i % TW + R;
    const int h = h0 + rr, w = w0 + jj - R;
    if (h >= H || w >= W) continue;
    uint4 p2 = col[0][rr][jj], p4 = col[1][rr][jj], p6 = col[2][rr][jj];
#pragma unroll
    for (int d = 1; d <= 2; ++d) p2 = vmax(p2, vmax(col[0][rr][jj - d], col[0][rr][jj + d]));
#pragma unroll
    for (int d = 1; d <= 4; ++d) p4 = vmax(p4, vmax(col[1][rr][jj - d], col[1][rr][jj + d]));
#pragma unroll
    for (int d = 1; d <= 6; ++d) p6 = vmax(p6, vmax(col[2][rr][jj - d], col[2][rr][jj + d]));
    int8_t* o = out + (((size_t)b * H + h) * W + w) * 4 * C + c0;
    *reinterpret_cast<uint4*>(o) = win[rr + R][jj]; *reinterpret_cast<uint4*>(o + C) = p2;
    *reinterpret_cast<uint4*>(o + 2 * C) = p4; *reinterpret_cast<uint4*>(o + 3 * C) = p6;
  }
}

template <int BAND, int MODE, int TRIG = 0>
int go(const void* x, void* out, int B, int H, int W, int C, int pdl, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_w * ((H + BAND - 1) / BAND), (C + 15) / 16, B);
  cfg.blockDim = dim3(BAND * 64, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr; cfg.numAttrs = pdl;
  cudaError_t e = cudaLaunchKernelEx(&cfg, var_kernel<BAND, MODE, TRIG>, (const int8_t*)x, (int8_t*)out, H, W, C, tiles_w);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// the parent's layout (8 x 8 patches, rows then columns), with PDL points
constexpr int T = 8, S = T + 2 * R;
template <int TRIG>
__global__ void __launch_bounds__(128)
old_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
           int H, int W, int C, int tiles_w) {
  if (TRIG == 0) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ uint4 win[S][S];
  __shared__ uint4 rows[3][S][T];
  const int b = blockIdx.z, c0 = 16 * blockIdx.y;
  const int h0 = blockIdx.x / tiles_w * T, w0 = blockIdx.x % tiles_w * T;
  const int8_t* xb = x + (long long)b * H * W * C + c0;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  for (int i = threadIdx.x; i < S * S; i += 128) {
    const int h = h0 - R + i / S, w = w0 - R + i % S;
    win[i / S][i % S] = h >= 0 && h < H && w >= 0 && w < W
            ? *reinterpret_cast<const uint4*>(xb + ((long long)h * W + w) * C)
            : make_uint4(NEG, NEG, NEG, NEG);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * T; i += 128) {
    const int r = i / T, j = i % T + R;
    uint4 m = win[r][j];
#pragma unroll
    for (int d = 1; d <= R; ++d) {
      m = vmax(m, vmax(win[r][j - d], win[r][j + d]));
      if (d % 2 == 0) rows[d / 2 - 1][r][i % T] = m;
    }
  }
  __syncthreads();
  if (TRIG == 1) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int i = threadIdx.x; i < T * T; i += 128) {
    const int r = i / T + R, j = i % T;
    const int h = h0 + i / T, w = w0 + j;
    if (h >= H || w >= W) continue;
    int8_t* o = out + (((long long)b * H + h) * W + w) * 4 * C + c0;
    *reinterpret_cast<uint4*>(o) = win[r][j + R];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int rad = 2 * (k + 1);
      uint4 m = rows[k][r][j];
#pragma unroll
      for (int d = 1; d <= rad; ++d)
        m = vmax(m, vmax(rows[k][r - d][j], rows[k][r + d][j]));
      *reinterpret_cast<uint4*>(o + (k + 1) * C) = m;
    }
  }
}

template <int TRIG>
int go_old(const void* x, void* out, int B, int H, int W, int C, int pdl, void* stream) {
  const int tiles_w = (W + T - 1) / T;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_w * ((H + T - 1) / T), (C + 15) / 16, B);
  cfg.blockDim = dim3(128, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr; cfg.numAttrs = pdl;
  cudaError_t e = cudaLaunchKernelEx(&cfg, old_kernel<TRIG>, (const int8_t*)x, (int8_t*)out, H, W, C, tiles_w);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// 8 channels a thread (uint2), shuffle layout
__device__ __forceinline__ uint2 vmax2(uint2 a, uint2 b) { return make_uint2(__vmaxs4(a.x, b.x), __vmaxs4(a.y, b.y)); }
__device__ __forceinline__ uint2 from2(uint2 v, int d) {
  if (d > 0) return make_uint2(__shfl_down_sync(~0u, v.x, d), __shfl_down_sync(~0u, v.y, d));
  return make_uint2(__shfl_up_sync(~0u, v.x, -d), __shfl_up_sync(~0u, v.y, -d));
}
__device__ __forceinline__ uint2 widen2(uint2 m, int d) { return vmax2(m, vmax2(from2(m, -d), from2(m, d))); }
template <int BAND>
__global__ void var8_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out, int H, int W, int C, int tiles_w) {
  constexpr int WIN_H = BAND + 2 * R;
  constexpr int THREADS = BAND * WARPS_ROW * LANES;
  constexpr int LOADS = (WIN_H * WIN_W + THREADS - 1) / THREADS;
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  __shared__ uint2 win[WIN_H][WIN_W];
  const int b = blockIdx.z, c0 = 8 * blockIdx.y;
  const int h0 = blockIdx.x / tiles_w * BAND, w0 = blockIdx.x % tiles_w * TW;
  const int8_t* xb = x + (size_t)b * H * W * C + c0;
  const int tid = threadIdx.x;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  uint2 v[LOADS];
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    const int h = h0 - R + i / WIN_W, w = w0 - R + i % WIN_W;
    v[k] = i < WIN_H * WIN_W && h >= 0 && h < H && w >= 0 && w < W
               ? *reinterpret_cast<const uint2*>(xb + ((size_t)h * W + w) * C) : make_uint2(NEG, NEG);
  }
#pragma unroll
  for (int k = 0; k < LOADS; ++k) {
    const int i = tid + k * THREADS;
    if (i < WIN_H * WIN_W) win[i / WIN_W][i % WIN_W] = v[k];
  }
  __syncthreads();
  const int lane = tid % LANES, r = tid / (WARPS_ROW * LANES);
  const int j = tid / LANES % WARPS_ROW * OUT_COLS + lane;
  const uint2 centre = win[r + R][j];
  uint2 c2 = centre;
#pragma unroll
  for (int d = 1; d <= 2; ++d) c2 = vmax2(c2, vmax2(win[r + R - d][j], win[r + R + d][j]));
  uint2 c4 = c2;
#pragma unroll
  for (int d = 3; d <= 4; ++d) c4 = vmax2(c4, vmax2(win[r + R - d][j], win[r + R + d][j]));
  uint2 c6 = c4;
#pragma unroll
  for (int d = 5; d <= 6; ++d) c6 = vmax2(c6, vmax2(win[r + R - d][j], win[r + R + d][j]));
  const uint2 p2 = widen2(widen2(c2, 1), 1);
  const uint2 q4 = widen2(widen2(c4, 1), 1);
  const uint2 p4 = widen2(q4, 2);
  const uint2 q6 = widen2(widen2(c6, 1), 1);
  const uint2 p6 = vmax2(widen2(q6, 2), vmax2(from2(q6, -4), from2(q6, 4)));
  const int h = h0 + r, w = w0 + j - R;
  if (lane < R || lane >= LANES - R || h >= H || w >= W) return;
  int8_t* o = out + (((size_t)b * H + h) * W + w) * 4 * C + c0;
  *reinterpret_cast<uint2*>(o) = centre; *reinterpret_cast<uint2*>(o + C) = p2;
  *reinterpret_cast<uint2*>(o + 2 * C) = p4; *reinterpret_cast<uint2*>(o + 3 * C) = p6;
}
template <int BAND>
int go8(const void* x, void* out, int B, int H, int W, int C, int pdl, void* stream) {
  const int tiles_w = (W + TW - 1) / TW;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles_w * ((H + BAND - 1) / BAND), (C + 7) / 8, B);
  cfg.blockDim = dim3(BAND * 64, 1, 1);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr; cfg.numAttrs = pdl;
  cudaError_t e = cudaLaunchKernelEx(&cfg, var8_kernel<BAND>, (const int8_t*)x, (int8_t*)out, H, W, C, tiles_w);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}
}  // namespace

extern "C" int sppf_var(int variant, const void* x, void* out, int B, int H, int W, int C, int pdl, void* stream) {
  switch (variant) {
    case 0: return go<4, 0>(x, out, B, H, W, C, pdl, stream);
    case 1: return go<2, 0>(x, out, B, H, W, C, pdl, stream);
    case 2: return go<1, 0>(x, out, B, H, W, C, pdl, stream);
    case 3: return go<8, 0>(x, out, B, H, W, C, pdl, stream);
    case 4: return go<4, 1>(x, out, B, H, W, C, pdl, stream);
    case 5: return go<2, 1>(x, out, B, H, W, C, pdl, stream);
    case 6: return go<8, 1>(x, out, B, H, W, C, pdl, stream);
    case 7: return go<4, 2>(x, out, B, H, W, C, pdl, stream);
    case 8: return go<1, 2>(x, out, B, H, W, C, pdl, stream);
    case 9: return go_old<0>(x, out, B, H, W, C, pdl, stream);
    case 10: return go8<4>(x, out, B, H, W, C, pdl, stream);
    case 11: return go8<2>(x, out, B, H, W, C, pdl, stream);
    case 12: return go<4, 0, 1>(x, out, B, H, W, C, pdl, stream);
    case 13: return go_old<1>(x, out, B, H, W, C, pdl, stream);
    case 14: return go<2, 0, 1>(x, out, B, H, W, C, pdl, stream);
  }
  return -1;
}
