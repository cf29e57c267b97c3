// The int8 convolution of the int8 engines, with its epilogue fused: one
// launch a layer.
//
// Replaces: no pallas_call. On the TPU each int8 layer is one XLA
//   convolution, int8 x int8 -> int32, whose dequant, bias, ReLU and
//   requant XLA fuses into the same pass, so only the requantised int8
//   reaches memory (unina_yolo_dla_tpu/quant/fake_quant.py:235-265, the
//   int8_path branch of QuantConv; ConvBlock's out_q and Bottleneck's
//   add_q in unina_yolo_dla_tpu/models/blocks.py). PyTorch has no int8
//   convolution on CUDA, so the port carries this kernel.
//
//   acc[p, n] = sum_{kh, kw, c} x[b, ho*S + kh - PAD, wo*S + kw - PAD, c]
//                               * w[n, (kh*KS + kw)*C + c]     (zero outside)
//   y         = fmaf((float)acc, comb[n], bias[n])   comb = w_scale * x_scale
//   F32       out[p, n] = y                                    (n < cout)
//   Q         q1 = clamp(rint(max(y, 0) / s_out), -127, 127)   (ReLU + out_q)
//   QRES      t  = fmaf(q1, s_out, (float)res[p, n] * s_res)
//             out[p, n] = clamp(rint(t / s_add), -127, 127)    (+ add_q)
//
//   The sum is exact in int32 (|acc| <= 127^2 * K < 2^31 for K <= 2^17),
//   so any order of summation gives the same accumulators. The epilogue is
//   single-precision IEEE with one rounding per step: fmaf, the correctly
//   rounded quotient (`requant`: a multiply by an f32 reciprocal would move
//   int8 steps) and rint (half to even), compiled with --fmad=false.
//
// Bound on the H100: the shipped frame's 46 layers do 23.4 G int8
//   operations (11.8 us at 1,979 TOP/s) and must move 52.5 MB (15.7 us at
//   3.35 TB/s: each input, weight and output once), so the frame's int8
//   layers are bound by bytes; each layer is small (1,600-6,400 output
//   pixels, 25-400 tiles), so in practice a layer is bound by latency:
//   few tiles, short K loops.
// Design: an implicit GEMM, no im2col in memory. M = output pixels (B*Ho*Wo,
//   any batch and size, ragged edges masked), N = output channels (a
//   multiple of 8), K = KS*KS*C walked as (tap, channel chunk of KC bytes).
//   - A block computes a 64-pixel x 64-channel tile with four warps, each
//     32 x 32 by mma.sync m16n8k32 (s8 x s8 -> s32).
//   - Each K step's A rows are gathered from the NHWC input by cp.async in
//     16-byte pieces, zero-filled (src-size 0) at the padding, past the
//     image and past C; B rows are the weights' own (N, K) rows, K
//     contiguous, as QuantConv holds them. Three stages in flight. Rows
//     are padded by 16 bytes in shared memory so the 32-bit fragment reads
//     of a warp hit 32 different banks.
//   - KC = 64 where C is a multiple of 64, else 32 (C a multiple of 16;
//     the unfused engine's 160 x 160 layers have C = 32).
//   - The epilogue runs on the accumulators in registers; the residual is
//     read and the int8 (or f32) result written straight to memory.
//   A simple kernel that is right: wgmma, TMA and persistent tiles are
//   later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma90;

constexpr int BM = 64;        // output pixels a block
constexpr int BN = 64;        // output channels a block
constexpr int THREADS = 128;  // four warps, 2 x 2, each 32 x 32
constexpr int STAGES = 3;

enum Mode { F32 = 0, Q = 1, QRES = 2 };

template <int KC>
struct Tile {
  static constexpr int ROW = KC + 16;  // shared bytes a row
  static constexpr int CHUNKS = KC / 16;
  static constexpr int LOADS = BM * CHUNKS / THREADS;  // per operand
  static constexpr int A_BYTES = BM * ROW;
  static constexpr int STAGE_BYTES = A_BYTES + BN * ROW;
  static_assert(BM == BN, "one load plan for A and B");
  static_assert(LOADS >= 1 && BM * CHUNKS % THREADS == 0, "load plan");
};

// clamp(rint(v / s), -127, 127) with v / s the correctly rounded f32
// quotient, from r = 1 / s rounded to double: the quotient of two f32
// values is never a midpoint of f32 and lies at least 2^-49 (relative)
// from one, and v * r is within 2^-52 of it, so rounding v * r once to
// f32 gives the quotient. (The library's f32 division, __fdiv_rn, cost
// 4-6 us a layer on an H100; a multiply by an f32 reciprocal moves int8
// steps.)
__device__ __forceinline__ float requant(float v, double r) {
  const float q = __double2float_rn(__dmul_rn((double)v, r));
  return fminf(fmaxf(rintf(q), -127.f), 127.f);
}

}  // namespace

template <int KS, int S, int KC, int MODE>
__global__ void __launch_bounds__(THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const float* __restrict__ comb,
                 const float* __restrict__ bias,
                 const int8_t* __restrict__ res, void* __restrict__ out,
                 int B, int H, int W, int C, int N, int cout, int Ho, int Wo,
                 float s_out, float s_res, float s_add) {
  using T = Tile<KC>;
  constexpr int PAD = KS / 2;
  __shared__ __align__(16) uint8_t smem[STAGES * T::STAGE_BYTES];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;
  const int P = B * Ho * Wo;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int K = KS * KS * C;
  const int cch = (C + KC - 1) / KC;   // channel chunks a tap
  const int steps = KS * KS * cch;
  const double r_out = __drcp_rn((double)s_out);
  const double r_add = __drcp_rn((double)s_add);

  // this thread's rows of A and B (the same row and chunk every step)
  int a_img[T::LOADS], a_h[T::LOADS], a_w[T::LOADS];
  bool a_ok[T::LOADS], b_ok[T::LOADS];
  const int8_t* b_src[T::LOADS];
  uint32_t a_dst[T::LOADS], b_dst[T::LOADS];
  const int ch = (tid % T::CHUNKS) * 16;
  const uint32_t base = smem_u32(smem);
#pragma unroll
  for (int i = 0; i < T::LOADS; ++i) {
    const int row = (tid + i * THREADS) / T::CHUNKS;
    const int p = m0 + row;
    a_ok[i] = p < P;
    const int pp = a_ok[i] ? p : 0;
    const int b = pp / (Ho * Wo), r = pp - b * Ho * Wo;
    const int ho = r / Wo, wo = r - ho * Wo;
    a_img[i] = b;
    a_h[i] = ho * S - PAD;
    a_w[i] = wo * S - PAD;
    const int n = n0 + row;
    b_ok[i] = n < N;
    b_src[i] = w + (size_t)(b_ok[i] ? n : 0) * K;
    a_dst[i] = base + row * T::ROW + ch;
    b_dst[i] = base + T::A_BYTES + row * T::ROW + ch;
  }

  auto load = [&](int step, int slot) {
    const int tap = step / cch;
    const int c = (step - tap * cch) * KC + ch;
    const int kh = tap / KS, kw = tap - kh * KS;
    const bool c_ok = c < C;
    const uint32_t off = slot * T::STAGE_BYTES;
#pragma unroll
    for (int i = 0; i < T::LOADS; ++i) {
      const int hi = a_h[i] + kh, wi = a_w[i] + kw;
      const bool ok = a_ok[i] && c_ok && hi >= 0 && hi < H && wi >= 0 &&
                      wi < W;
      const int8_t* src =
          ok ? x + (((size_t)a_img[i] * H + hi) * W + wi) * C + c : x;
      cp_async16(a_dst[i] + off, src, ok ? 16 : 0);
      const bool okb = b_ok[i] && c_ok;
      cp_async16(b_dst[i] + off, okb ? b_src[i] + tap * C + c : w,
                 okb ? 16 : 0);
    }
  };

  // this thread's output channels' comb and bias, loaded before the K
  // loop so the loads are in flight under it
  float cn[4][2], bn[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = n0 + wn * 32 + ni * 8 + 2 * t + j;
      cn[ni][j] = n < cout ? comb[n] : 0.f;
      bn[ni][j] = n < cout ? bias[n] : 0.f;
    }

  int acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
  // the warp's 8-wide column groups that hold output channels (N % 8 == 0)
  const int n_groups = min(4, max(0, (N - n0 - wn * 32) / 8));

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    // the slot refilled here was read in step s - 1, which every warp
    // has finished: the barrier above
    const int nxt = s + STAGES - 1;
    if (nxt < steps) load(nxt, nxt % STAGES);
    cp_async_commit();
    const uint8_t* As = smem + (s % STAGES) * T::STAGE_BYTES;
    const uint8_t* Bs = As + T::A_BYTES;
#pragma unroll
    for (int kk = 0; kk < KC; kk += 32) {
      uint32_t a[2][4], bf[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* r0 = As + (wm * 32 + mi * 16 + g) * T::ROW + kk + t * 4;
        const uint8_t* r1 = r0 + 8 * T::ROW;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r1);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r1 + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* r = Bs + (wn * 32 + ni * 8 + g) * T::ROW + kk + t * 4;
        bf[ni][0] = *reinterpret_cast<const uint32_t*>(r);
        bf[ni][1] = *reinterpret_cast<const uint32_t*>(r + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (ni < n_groups) {
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
            mma_m16n8k32_s8(acc[mi][ni], a[mi], bf[ni]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue, from the accumulators: thread holds rows g, g + 8 of each
  // m16 tile and channels 2t, 2t + 1 of each n8 group; where cout is even
  // the two channels leave as one store (and the residual's come in as
  // one load), all the residual loads issued before any arithmetic
  const bool pairs = (cout & 1) == 0;
  int8_t rv[2][2][4][2];
  if (MODE == QRES) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const int p = m0 + wm * 32 + mi * 16 + g + 8 * h;
          const int n = n0 + wn * 32 + ni * 8 + 2 * t;
          const size_t o = (size_t)p * cout + n;
          rv[mi][h][ni][0] = rv[mi][h][ni][1] = 0;
          if (p >= P || n >= cout) continue;
          if (pairs) {
            const char2 r2 = *reinterpret_cast<const char2*>(res + o);
            rv[mi][h][ni][0] = r2.x;
            rv[mi][h][ni][1] = r2.y;
          } else {
            rv[mi][h][ni][0] = res[o];
            if (n + 1 < cout) rv[mi][h][ni][1] = res[o + 1];
          }
        }
  }
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = m0 + wm * 32 + mi * 16 + g + 8 * h;
      if (p >= P) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + wn * 32 + ni * 8 + 2 * t;
        if (n >= cout) continue;
        const size_t o = (size_t)p * cout + n;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float y = __fmaf_rn(__int2float_rn(acc[mi][ni][2 * h + j]),
                                    cn[ni][j], bn[ni][j]);
          if (MODE == F32) {
            v[j] = y;
          } else {
            v[j] = requant(fmaxf(y, 0.f), r_out);
            if (MODE == QRES) {
              const float r = __fmul_rn((float)rv[mi][h][ni][j], s_res);
              v[j] = requant(__fmaf_rn(v[j], s_out, r), r_add);
            }
          }
        }
        if (MODE == F32) {
          float* dst = static_cast<float*>(out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
          } else {
            dst[0] = v[0];
            if (n + 1 < cout) dst[1] = v[1];
          }
        } else {
          int8_t* dst = static_cast<int8_t*>(out) + o;
          if (pairs) {
            *reinterpret_cast<char2*>(dst) =
                make_char2((signed char)(int)v[0], (signed char)(int)v[1]);
          } else {
            dst[0] = (int8_t)(int)v[0];
            if (n + 1 < cout) dst[1] = (int8_t)(int)v[1];
          }
        }
      }
    }
}

namespace {

template <int KS, int S, int KC>
cudaError_t launch_kc(int mode, const int8_t* x, const int8_t* w,
                      const float* comb, const float* bias, const int8_t* res,
                      void* out, int B, int H, int W, int C, int N, int cout,
                      float s_out, float s_res, float s_add,
                      cudaStream_t stream) {
  constexpr int PAD = KS / 2;
  const int Ho = (H + 2 * PAD - KS) / S + 1, Wo = (W + 2 * PAD - KS) / S + 1;
  const long long P = (long long)B * Ho * Wo;
  dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  switch (mode) {
    case F32:
      int8_conv_kernel<KS, S, KC, F32><<<grid, THREADS, 0, stream>>>(
          x, w, comb, bias, res, out, B, H, W, C, N, cout, Ho, Wo, s_out,
          s_res, s_add);
      break;
    case Q:
      int8_conv_kernel<KS, S, KC, Q><<<grid, THREADS, 0, stream>>>(
          x, w, comb, bias, res, out, B, H, W, C, N, cout, Ho, Wo, s_out,
          s_res, s_add);
      break;
    default:
      int8_conv_kernel<KS, S, KC, QRES><<<grid, THREADS, 0, stream>>>(
          x, w, comb, bias, res, out, B, H, W, C, N, cout, Ho, Wo, s_out,
          s_res, s_add);
  }
  return cudaGetLastError();
}

template <int KS, int S>
cudaError_t launch_geom(int kc, int mode, const int8_t* x, const int8_t* w,
                        const float* comb, const float* bias,
                        const int8_t* res, void* out, int B, int H, int W,
                        int C, int N, int cout, float s_out, float s_res,
                        float s_add, cudaStream_t stream) {
  if (kc == 64)
    return launch_kc<KS, S, 64>(mode, x, w, comb, bias, res, out, B, H, W, C,
                                N, cout, s_out, s_res, s_add, stream);
  return launch_kc<KS, S, 32>(mode, x, w, comb, bias, res, out, B, H, W, C,
                              N, cout, s_out, s_res, s_add, stream);
}

}  // namespace

// x (B, H, W, C) int8 NHWC; w (N, KS*KS*C) int8; comb, bias (N,) f32;
// res (B, Ho, Wo, cout) int8 for mode 2, else unused; out (B, Ho, Wo, cout)
// f32 (mode 0) or int8 (modes 1, 2). Geometries: KS 1 stride 1, KS 3
// stride 1 or 2, padding KS / 2. C a multiple of 16, N of 8, cout <= N.
extern "C" int unina_int8_conv(const void* x, const void* w, const float* comb,
                               const float* bias, const void* res, void* out,
                               int B, int H, int W, int C, int N, int cout,
                               int ks, int stride, int mode, float s_out,
                               float s_res, float s_add, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || N <= 0 || N % 8 ||
      cout <= 0 || cout > N || mode < F32 || mode > QRES ||
      (mode == QRES && res == nullptr))
    return (int)cudaErrorInvalidValue;
  const int kc = C % 64 == 0 ? 64 : 32;
  auto xs = static_cast<const int8_t*>(x);
  auto ws = static_cast<const int8_t*>(w);
  auto rs = static_cast<const int8_t*>(res);
  auto st = (cudaStream_t)stream;
  if (ks == 1 && stride == 1)
    return (int)launch_geom<1, 1>(kc, mode, xs, ws, comb, bias, rs, out, B, H,
                                  W, C, N, cout, s_out, s_res, s_add, st);
  if (ks == 3 && stride == 1)
    return (int)launch_geom<3, 1>(kc, mode, xs, ws, comb, bias, rs, out, B, H,
                                  W, C, N, cout, s_out, s_res, s_add, st);
  if (ks == 3 && stride == 2)
    return (int)launch_geom<3, 2>(kc, mode, xs, ws, comb, bias, rs, out, B, H,
                                  W, C, N, cout, s_out, s_res, s_add, st);
  return (int)cudaErrorInvalidValue;
}
