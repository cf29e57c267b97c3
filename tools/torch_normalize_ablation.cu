// The first normalize kernel of the port (one thread per output element)
// with each of its three costs switchable, for tools/torch_prepost_probe.py:
//   IDX32    the 64-bit index division and remainder become 32-bit ones;
//   SMEMC    the per-lane reads of the by-value parameter struct (the
//            constant bank, serialised when a warp's lanes ask for different
//            channels) become shared-memory reads;
//   NODIV    the two IEEE divisions become multiplications by reciprocals
//            (not bit-equal to the reference: a cost probe only).
// Variant 0 is that kernel as it was. Not part of the port's library.
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_CH 32

struct NormParams {
  float mean[MAX_CH];
  float std[MAX_CH];
  int src[MAX_CH];
};

template <bool IDX32, bool SMEMC, bool NODIV>
__global__ void ablate_kernel(const uint8_t* __restrict__ in,
                              float* __restrict__ out, long long n_out,
                              int c_in, int c_out, NormParams p) {
  __shared__ NormParams sp;
  if (SMEMC) {
    if (threadIdx.x < MAX_CH) {
      sp.mean[threadIdx.x] = p.mean[threadIdx.x];
      sp.std[threadIdx.x] = p.std[threadIdx.x];
      sp.src[threadIdx.x] = p.src[threadIdx.x];
    }
    __syncthreads();
  }
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  long long pix;
  int c;
  if (IDX32) {
    unsigned ii = (unsigned)i, pp = ii / (unsigned)c_out;
    pix = pp;
    c = (int)(ii - pp * (unsigned)c_out);
  } else {
    pix = i / c_out;
    c = (int)(i - pix * c_out);
  }
  int src = SMEMC ? sp.src[c] : p.src[c];
  float m = SMEMC ? sp.mean[c] : p.mean[c];
  float s = SMEMC ? sp.std[c] : p.std[c];
  float x = (float)in[pix * c_in + src];
  out[i] = NODIV ? (x * (1.0f / 255.0f) - m) * __frcp_rn(s)
                 : (x / 255.0f - m) / s;
}

extern "C" int ablate_normalize(int variant, const void* in, void* out,
                                long long n_pix, int c_in, int c_out,
                                const float* mean, const float* stdv,
                                const int* src, void* stream) {
  if (c_out > MAX_CH || c_out <= 0) return (int)cudaErrorInvalidValue;
  NormParams p = {};
  for (int c = 0; c < c_out; ++c) {
    p.mean[c] = mean[c];
    p.std[c] = stdv[c];
    p.src[c] = src[c];
  }
  long long n_out = n_pix * c_out;
  int threads = 256;
  unsigned blocks = (unsigned)((n_out + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* i8 = (const uint8_t*)in;
  float* o = (float*)out;
#define RUN(A, B, C) \
  ablate_kernel<A, B, C><<<blocks, threads, 0, s>>>(i8, o, n_out, c_in, c_out, p)
  switch (variant) {
    case 0: RUN(false, false, false); break;
    case 1: RUN(true, false, false); break;
    case 2: RUN(false, true, false); break;
    case 3: RUN(false, false, true); break;
    case 4: RUN(true, true, false); break;
    case 5: RUN(true, true, true); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RUN
  return (int)cudaGetLastError();
}
