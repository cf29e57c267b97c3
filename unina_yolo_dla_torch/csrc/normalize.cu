// uint8 frame -> ImageNet-normalised float32 or bfloat16, one pass.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/preprocess_kernel.py
//   normalize_pallas / _normalize_kernel (pallas_call at :66), generalised
//   to the merged (S/2, S/4, 24) serving layout whose mean/std tile 8x
//   (runtime/pipeline.py). The uint8 -> f32 widen, which the TPU version
//   leaves to XLA, and the cast to the model's compute type are fused here.
//
// Bound on the H100: bytes. 1 B read and 4 B (f32) or 2 B (bf16) written
//   per element, no reuse; at the serving shape 1.23 MB in, 4.92 or 2.46 MB
//   out.
// Design, merged path (every input channel kept in place, constants of
//   period 3: the served case): the frame is a flat run of bytes whose
//   channel is its offset mod 3. A warp takes 384 contiguous bytes a step
//   (a multiple of 3): every lane makes three 4-byte loads, each 128 bytes
//   apart, so each load and each 16-byte (f32) or 8-byte (bf16) store of the
//   warp covers one contiguous run. Byte k of lane l's load j has channel
//   (2 j + l + k) mod 3: after one rotation of the three channels by
//   l mod 3 per thread the pattern is fixed at compile time. No index is
//   divided and no constant is read at a per-lane index. Each block first
//   fills a 3 x 256 table with (v / 255 - mean) / std in IEEE f32, the
//   reference formula (its warps' first loads already in flight), and
//   every element is a shared-memory lookup: the divisions leave the loop
//   and the bits stay those of the plain version.
//   (-DUNINA_NORMALIZE_DIVIDE computes the two divisions per element
//   instead: the variant tools/torch_prepost_probe.py times beside it.)
//   Whole steps are spread over the grid's warps; the bytes past the last
//   whole step go element by element in the same launch.
// Generic path (3- or 4-channel frames, optional B/R swap, alpha dropped):
//   one thread per pixel, the channel map a template argument; a 4-channel
//   pixel is one 4-byte load. Any other map runs one thread per pixel with
//   the map and the constants passed by value (read at warp-uniform
//   indices).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CH 32

namespace {

constexpr int MERGED_THREADS = 384;  // a multiple of 32 and of 3
constexpr int LOADS = 3;             // 4-byte loads per lane and step
constexpr int UNIT = 128 * LOADS;    // bytes per warp and step, 0 mod 3
constexpr int PIXEL_THREADS = 256;

struct Const3 {
  float mean[3];
  float std[3];
};

struct NormParams {
  float mean[MAX_CH];
  float std[MAX_CH];
  int src[MAX_CH];
};

__device__ __forceinline__ float norm1(float x, float m, float s) {
  return (x / 255.0f - m) / s;
}

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void put4(float* p, float a, float b, float c,
                                     float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void put4(__nv_bfloat16* p, float a, float b,
                                     float c, float d) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a, b);
  __nv_bfloat162 hi = __floats2bfloat162_rn(c, d);
  *reinterpret_cast<uint2*>(p) =
      make_uint2(*reinterpret_cast<uint32_t*>(&lo),
                 *reinterpret_cast<uint32_t*>(&hi));
}

// One channel as a thread sees it: its row of the table, or its constants.
struct Chan {
  const float* lut;
  float m, s;
  __device__ __forceinline__ float at(uint32_t v) const {
#ifdef UNINA_NORMALIZE_DIVIDE
    return norm1((float)v, m, s);
#else
    return lut[v];
#endif
  }
};

// A lane's 4-byte loads of warp step u.
__device__ __forceinline__ void fetch(uint32_t (&x)[LOADS], const uint8_t* in,
                                      long long u, int lane) {
#pragma unroll
  for (int j = 0; j < LOADS; ++j)
    x[j] = __ldg(reinterpret_cast<const uint32_t*>(in + u * UNIT + 4 * lane +
                                                   128 * j));
}

template <typename OutT>
__global__ void __launch_bounds__(MERGED_THREADS)
normalize_merged_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                        long long n, Const3 k) {
  __shared__ float lut[3][256];
  const int lane = threadIdx.x & 31;
  const long long units = n / UNIT;
  const long long warps = (long long)gridDim.x * (MERGED_THREADS / 32);
  long long u = (long long)blockIdx.x * (MERGED_THREADS / 32) +
                (threadIdx.x >> 5);
  // the warp's first step is asked for before the table is filled
  uint32_t x[LOADS];
  if (u < units) fetch(x, in, u, lane);
  if (threadIdx.x < 256) {
    const float q = (float)threadIdx.x / 255.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      lut[c][threadIdx.x] = (q - k.mean[c]) / k.std[c];
  }
  __syncthreads();
  Chan ch[3];  // ch[r]: channel (lane + r) mod 3
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    int c = (lane + r) % 3;
    ch[r].lut = lut[c];
    ch[r].m = k.mean[c];
    ch[r].s = k.std[c];
  }
  while (u < units) {
    const long long base = u * UNIT + 4 * lane;
#pragma unroll
    for (int j = 0; j < LOADS; ++j)
      put4(out + base + 128 * j, ch[(2 * j) % 3].at(x[j] & 255u),
           ch[(2 * j + 1) % 3].at((x[j] >> 8) & 255u),
           ch[(2 * j + 2) % 3].at((x[j] >> 16) & 255u),
           ch[(2 * j + 3) % 3].at(x[j] >> 24));
    u += warps;
    if (u < units) fetch(x, in, u, lane);
  }
  // the bytes past the last whole step (it ends on a multiple of 3)
  const long long done = units * UNIT;
  long long e = done + (long long)blockIdx.x * MERGED_THREADS + threadIdx.x;
  for (; e < n; e += (long long)gridDim.x * MERGED_THREADS)
    put(out + e, lut[(int)((e - done) % 3)][in[e]]);
}

template <int CIN, bool SWAP, typename OutT>
__global__ void __launch_bounds__(PIXEL_THREADS)
normalize_pixel_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                       long long n_pix, Const3 k) {
  long long p = (long long)blockIdx.x * PIXEL_THREADS + threadIdx.x;
  if (p >= n_pix) return;
  uint32_t c0, c1, c2;
  if (CIN == 4) {
    uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(in) + p);
    c0 = x & 255u;
    c1 = (x >> 8) & 255u;
    c2 = (x >> 16) & 255u;
  } else {
    c0 = in[3 * p];
    c1 = in[3 * p + 1];
    c2 = in[3 * p + 2];
  }
  put(out + 3 * p, norm1((float)(SWAP ? c2 : c0), k.mean[0], k.std[0]));
  put(out + 3 * p + 1, norm1((float)c1, k.mean[1], k.std[1]));
  put(out + 3 * p + 2, norm1((float)(SWAP ? c0 : c2), k.mean[2], k.std[2]));
}

template <typename OutT>
__global__ void __launch_bounds__(PIXEL_THREADS)
normalize_mapped_kernel(const uint8_t* __restrict__ in, OutT* __restrict__ out,
                        long long n_pix, int c_in, int c_out, NormParams p) {
  long long pix = (long long)blockIdx.x * PIXEL_THREADS + threadIdx.x;
  if (pix >= n_pix) return;
  for (int c = 0; c < c_out; ++c)
    put(out + pix * c_out + c,
        norm1((float)in[pix * c_in + p.src[c]], p.mean[c], p.std[c]));
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <typename OutT>
void launch(const uint8_t* in, OutT* out, long long n_pix, int c_in, int c_out,
            const float* mean, const float* stdv, const int* src,
            cudaStream_t s) {
  bool identity = c_in == c_out, period3 = c_out % 3 == 0;
  for (int c = 0; c < c_out; ++c) {
    identity = identity && src[c] == c;
    period3 = period3 && mean[c] == mean[c % 3] && stdv[c] == stdv[c % 3];
  }
  Const3 k = {{0.f, 0.f, 0.f}, {1.f, 1.f, 1.f}};
  for (int c = 0; c < 3 && c < c_out; ++c) {
    k.mean[c] = mean[c];
    k.std[c] = stdv[c];
  }
  const bool in4 = reinterpret_cast<uintptr_t>(in) % 4 == 0;
  const bool out4 = reinterpret_cast<uintptr_t>(out) % (4 * sizeof(OutT)) == 0;
  const unsigned pixel_blocks =
      (unsigned)((n_pix + PIXEL_THREADS - 1) / PIXEL_THREADS);
  if (identity && period3 && in4 && out4) {
    long long units = n_pix * c_out / UNIT;
    long long want = (units + MERGED_THREADS / 32 - 1) / (MERGED_THREADS / 32);
    long long cap = 4LL * sm_count();
    unsigned blocks = (unsigned)(want < 1 ? 1 : want > cap ? cap : want);
    normalize_merged_kernel<OutT><<<blocks, MERGED_THREADS, 0, s>>>(
        in, out, n_pix * c_out, k);
  } else if (c_out == 3 && src[1] == 1 && (c_in == 3 || (c_in == 4 && in4)) &&
             ((src[0] == 0 && src[2] == 2) || (src[0] == 2 && src[2] == 0))) {
    const bool swap = src[0] == 2;
    if (c_in == 4 && swap)
      normalize_pixel_kernel<4, true, OutT>
          <<<pixel_blocks, PIXEL_THREADS, 0, s>>>(in, out, n_pix, k);
    else if (c_in == 4)
      normalize_pixel_kernel<4, false, OutT>
          <<<pixel_blocks, PIXEL_THREADS, 0, s>>>(in, out, n_pix, k);
    else if (swap)
      normalize_pixel_kernel<3, true, OutT>
          <<<pixel_blocks, PIXEL_THREADS, 0, s>>>(in, out, n_pix, k);
    else
      normalize_pixel_kernel<3, false, OutT>
          <<<pixel_blocks, PIXEL_THREADS, 0, s>>>(in, out, n_pix, k);
  } else {
    NormParams p;
    for (int c = 0; c < c_out; ++c) {
      p.mean[c] = mean[c];
      p.std[c] = stdv[c];
      p.src[c] = src[c];
    }
    normalize_mapped_kernel<OutT><<<pixel_blocks, PIXEL_THREADS, 0, s>>>(
        in, out, n_pix, c_in, c_out, p);
  }
}

}  // namespace

extern "C" int unina_normalize(const void* in, void* out, long long n_pix,
                               int c_in, int c_out, const float* mean,
                               const float* stdv, const int* src, int out_bf16,
                               void* stream) {
  if (c_out > MAX_CH || c_out <= 0 || n_pix <= 0)
    return (int)cudaErrorInvalidValue;
  for (int c = 0; c < c_out; ++c)
    if (src[c] < 0 || src[c] >= c_in) return (int)cudaErrorInvalidValue;
  if (out_bf16)
    launch((const uint8_t*)in, (__nv_bfloat16*)out, n_pix, c_in, c_out, mean,
           stdv, src, (cudaStream_t)stream);
  else
    launch((const uint8_t*)in, (float*)out, n_pix, c_in, c_out, mean, stdv,
           src, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
