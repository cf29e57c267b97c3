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
//   so any order of summation, and any split of K, gives the same
//   accumulators. The epilogue is single-precision IEEE with one rounding
//   per step: fmaf, the correctly rounded quotient (`requant` in
//   quant_sm90.cuh: a multiply by an f32 reciprocal would move int8
//   steps) and rint (half to even), compiled with --fmad=false.
//
// Bound on the H100: the shipped frame's 46 layers do 23.4 G int8
//   operations (11.8 us at 1,979 TOP/s) and must move 52.5 MB (15.7 us at
//   3.35 TB/s: each input, weight and output once). Each layer is small
//   (1,600-6,400 output pixels), so a layer is bound by latency: how many
//   SMs its tiles reach, and how long each tile's K loop takes.
// Design: an implicit GEMM, no im2col in memory. M = output pixels, N =
//   output channels, K = KS*KS*C walked as (tap, channel chunk of KC
//   bytes); the plan (tile width BN, KC, ring depth) is chosen by
//   ops/cuda/int8_conv_kernel.py `plan` and passed in.
//   - A tile is an 8 x 8 patch of output pixels of one image by BN output
//     channels (8, 32 or 64: wider tiles, 128 and 256, gathered A once for
//     more channels but were slower at every shipped shape). Each K step's
//     A is ONE tensor copy (TMA) of the NHWC input at (tap offset, channel
//     chunk): the box is the patch shifted by (kh - PAD, kw - PAD), read
//     at element stride S (a 16 x 16 box at stride 2 lands the 8 x 8
//     pixels of a stride-2 tap), and TMA writes the zeros of the padding,
//     past the image and past C. B is one tensor copy of the (N, KS*KS, C)
//     weights at (tap, chunk, n0), zeros past C and N. Both land K-major
//     with a KC-byte swizzle.
//   - One producer warp keeps a ring of 4-8 stages in flight on mbarriers;
//     two consumer warpgroups take alternate K steps (the in-block split)
//     with s8 wgmma m64nBNk32 straight from shared memory, one step's
//     products in flight while the next is issued;
//     a step's slot is freed when the warpgroup's next step is issued. A
//     ring that wraps has an even depth, so a slot comes back to the
//     warpgroup that used it, which has seen its previous phase (a parity
//     wait cannot tell phase m + 2 from m).
//   - The K split is the two warpgroups'. Splits across blocks were built
//     and measured slower on every shipped shape (tools/torch_int8_plans.py;
//     PERF.md), and went: across the blocks of a cluster (partial tiles
//     added through distributed shared memory by bulk copies), and through
//     L2 (each block's partial tile to a workspace, a ticket a tile, the
//     last block adding the others': the store, fence, ticket and reload
//     cost more than the K steps they saved). So did A as one copy of each
//     channel chunk's input window (10 x 10 pixels for 3x3, the taps'
//     descriptors starting inside it; right, but a second ring beside the
//     weights' cost more than the 5.8x fewer A bytes saved).
//   - Launched with programmatic dependent launch: the next layer's blocks
//     start (barriers, tensor-map prefetch) while this one finishes, and
//     wait for it at griddepcontrol.wait before reading anything.
//   - The epilogue runs from the wgmma accumulators: the two warpgroups
//     add each other's halves through shared memory, each finishes half of
//     the columns (comb and bias by bulk copies, the QRES residual by the
//     producer warp's cp.async, all landing on one mbarrier while the
//     products run), the result goes to a shared tile and leaves in
//     coalesced 16-byte stores.
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sm90.cuh"
#include "quant_sm90.cuh"

namespace {

using namespace mma90;

constexpr int TH = 8, TW = 8;   // the output patch of a tile
constexpr int BM = TH * TW;     // its pixels: one m64 product's rows
constexpr int CONSUMERS = 2;    // warpgroups taking alternate K steps
constexpr int THREADS = 128 * CONSUMERS + 32;  // and one producer warp
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;
constexpr int CONSUMER_BAR = 1;  // named barrier of the consumer threads

enum Mode { F32 = 0, Q = 1, QRES = 2 };

struct Geometry {
  int B, H, W, C, N, cout, Ho, Wo, ks, stride, pad;
  int tiles_w, tiles_img;  // patches across Wo; patches an image
  int cch, steps;          // channel chunks a tap; K steps in all
  int mode;
  float s_out, s_res, s_add;
};

// The dynamic shared memory of a plan, in bytes from a 1024-aligned base
// (ops/cuda/int8_conv_kernel.py `smem_bytes` mirrors it). The ring; after
// the K loop the same bytes hold the warpgroups' exchange tile and then
// the output tile; beside them comb and bias, the residual tile and the
// mbarriers.
struct Layout {
  int stage, region, comb, res, rpitch, opitch, bars, total;
};
__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ inline Layout layout(int bn, int kc, int stages) {
  Layout l;
  l.stage = round_up((BM + bn) * kc, 1024);
  l.rpitch = round_up(bn, 16) + 16;
  l.opitch = 4 * bn + 16;  // the output tile's (f32 at most); exchange
  const int ring = stages * l.stage;  // tile: BM * bn * 4 bytes
  l.region = round_up(ring > BM * l.opitch ? ring : BM * l.opitch, 1024);
  l.comb = l.region;
  l.res = l.comb + 8 * bn;
  l.bars = l.res + BM * l.rpitch;
  l.total = 1024 + l.bars + 8 * (2 * MAX_STAGES + 1);
  return l;
}

// the last launch: grid x, grid y, threads, dynamic shared memory
struct LaunchShape {
  int grid_x, grid_y, threads, smem;
};
LaunchShape last_launch{};

// one k32 step of the tile: d += A (64 x 32) @ B (32 x BN)
template <int BN>
__device__ __forceinline__ void mma_k32(int (&d)[BN / 2], uint64_t da,
                                        uint64_t db) {
  if constexpr (BN == 8) {
    wgmma_m64n8k32_s8(d, da, db);
  } else if constexpr (BN == 32) {
    wgmma_m64n32k32_s8(d, da, db);
  } else {
    static_assert(BN == 64, "tile widths 8, 32, 64");
    wgmma_m64n64k32_s8(d, da, db);
  }
}

}  // namespace

template <int BN, int KC>
__global__ void __launch_bounds__(THREADS, 2)
int8_conv_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap wmap,
                 const float* __restrict__ comb,
                 const float* __restrict__ bias,
                 const int8_t* __restrict__ res, void* __restrict__ out,
                 const Geometry g, int stages) {
  constexpr int G = BN / 8;        // n8 column groups
  constexpr int G0 = (G + 1) / 2;  // groups warpgroup 0 finishes
  constexpr int A_BYTES = BM * KC;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sm = smem_raw + (base - raw);
  const Layout L = layout(BN, KC, stages);
  const uint32_t full = base + L.bars;
  const uint32_t empty = full + 8 * MAX_STAGES;
  const uint32_t aux_bar = empty + 8 * MAX_STAGES;

  // the next launch may start its own prologue now (programmatic
  // dependent launch); this one reads nothing the previous launch writes
  // before griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int tid = threadIdx.x, wg = tid >> 7;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.x / g.tiles_img;
  const int pt = blockIdx.x - b * g.tiles_img;
  const int ho0 = pt / g.tiles_w * TH, wo0 = pt % g.tiles_w * TW;
  // the residual in 16-byte pieces, each producer lane's landing on the
  // epilogue's mbarrier (else read byte by byte before it)
  const int nres = min(BN, g.cout - n0);
  const bool res16 = g.mode == QRES && nres > 0 && g.cout % 16 == 0 &&
                     n0 % 16 == 0 && nres % 16 == 0;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full + 8 * i, 1);
      mbar_init(empty + 8 * i, 1);
    }
    mbar_init(aux_bar, res16 ? 33 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // ---- the producer warp ----
    const int lane = tid & 31;
    auto issue = [&](int i) {
      const int slot = i % stages;
      const int tap = i / g.cch;
      const int c0 = (i - tap * g.cch) * KC;
      const int kh = tap / g.ks, kw = tap - kh * g.ks;
      const uint32_t st = base + slot * L.stage, bar = full + 8 * slot;
      mbar_expect(bar, (BM + BN) * KC);
      tensor_copy(st, &xmap, c0, wo0 * g.stride + kw - g.pad,
                  ho0 * g.stride + kh - g.pad, b, bar);
      tensor_copy(st + A_BYTES, &wmap, c0, tap, n0, 0, bar);
    };
    const int first = min(g.steps, stages);
    if (lane == 0) {
      prefetch_tensor_map(&xmap);
      prefetch_tensor_map(&wmap);
    }
    // everything global is read after the previous launch has finished
    // (with programmatic dependent launch this is where the prologue
    // stops overlapping it; otherwise it returns at once)
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    if (lane == 0)
      for (int i = 0; i < first; ++i) issue(i);
    __syncwarp();
    // the epilogue's residual tile, comb and bias, while the ring fills
    if (res16) {
      const int chunks = nres / 16;
      for (int e = lane; e < BM * chunks; e += 32) {
        const int r = e / chunks, ch = e - r * chunks;
        const int ho = ho0 + r / TW, wo = wo0 + r % TW;
        const bool ok = ho < g.Ho && wo < g.Wo;
        const int8_t* src =
            ok ? res + ((size_t)(b * g.Ho + ho) * g.Wo + wo) * g.cout + n0 +
                     ch * 16
               : res;
        cp_async16(base + L.res + r * L.rpitch + ch * 16, src, ok ? 16 : 0);
      }
      cp_async_mbar_arrive(aux_bar);
    } else if (g.mode == QRES && nres > 0) {
      for (int e = lane; e < BM * nres; e += 32) {
        const int r = e / nres, c = e - r * nres;
        const int ho = ho0 + r / TW, wo = wo0 + r % TW;
        sm[L.res + r * L.rpitch + c] =
            ho < g.Ho && wo < g.Wo
                ? (uint8_t)res[((size_t)(b * g.Ho + ho) * g.Wo + wo) *
                                   g.cout + n0 + c]
                : 0;
      }
    }
    __syncwarp();
    if (lane == 0) {
      const int nb = min(BN, g.N - n0) * 4;
      mbar_expect(aux_bar, 2 * nb);
      bulk_copy(base + L.comb, comb + n0, nb, aux_bar);
      bulk_copy(base + L.comb + 4 * BN, bias + n0, nb, aux_bar);
      for (int i = first; i < g.steps; ++i) {
        mbar_wait(empty + 8 * (i % stages), ((i / stages) - 1) & 1);
        issue(i);
      }
    }
    return;
  }

  // ---- the consumer warpgroups ----
  const int t = tid & 127;
  int acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
  for (int i = wg; i < g.steps; i += CONSUMERS) {
    const int slot = i % stages;
    mbar_wait(full + 8 * slot, (i / stages) & 1);
    const uint32_t st = base + slot * L.stage;
    const uint64_t da = kmajor_desc(st, KC);
    const uint64_t db = kmajor_desc(st + A_BYTES, KC);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KC / 32; ++k)
      mma_k32<BN>(acc, da + 2 * k, db + 2 * k);
    wgmma_commit();
    // the step before this warpgroup's last is done: its slot is free
    wgmma_wait<1>();
    if (i >= CONSUMERS && t == 0)
      mbar_arrive(empty + 8 * ((i - CONSUMERS) % stages));
  }
  wgmma_wait<0>();

  // the two warpgroups' sums: each hands the other the column groups it
  // does not finish, through the ring's bytes (every product is done),
  // laid out [4 G][128 threads] so a warp's words are consecutive
  int* const xch = reinterpret_cast<int*>(sm);
  named_sync(CONSUMER_BAR, 128 * CONSUMERS);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if ((j < G0) != (wg == 0))
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(4 * j + e) * 128 + t] = acc[4 * j + e];
  named_sync(CONSUMER_BAR, 128 * CONSUMERS);
#pragma unroll
  for (int j = 0; j < G; ++j)
    if ((j < G0) == (wg == 0))
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[4 * j + e] += xch[(4 * j + e) * 128 + t];

  // ---- the epilogue, from the accumulators ----
  asm volatile("griddepcontrol.wait;\n" ::: "memory");  // before any store
  mbar_wait(aux_bar, 0);  // comb, bias and the residual are in
  named_sync(CONSUMER_BAR, 128 * CONSUMERS);  // the region is read
  const float* cs = reinterpret_cast<const float*>(sm + L.comb);
  const float* bs = cs + BN;
  const int8_t* rs = reinterpret_cast<const int8_t*>(sm + L.res);
  const int lane = t & 31, warp = t >> 5;
  const double r_out = quant_reciprocal(g.s_out);
  const double r_add = quant_reciprocal(g.s_add);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if ((j < G0) != (wg == 0)) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + (lane >> 2) + 8 * h;
      const int col = 8 * j + 2 * (lane & 3);
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float y = __fmaf_rn(__int2float_rn(acc[4 * j + 2 * h + q]),
                                  cs[col + q], bs[col + q]);
        if (g.mode == F32) {
          v[q] = y;
        } else {
          v[q] = requant(fmaxf(y, 0.f), r_out);
          if (g.mode == QRES) {
            const float r =
                __fmul_rn((float)rs[row * L.rpitch + col + q], g.s_res);
            v[q] = requant(__fmaf_rn(v[q], g.s_out, r), r_add);
          }
        }
      }
      uint8_t* dst = sm + row * L.opitch;
      if (g.mode == F32)
        *reinterpret_cast<float2*>(dst + 4 * col) = make_float2(v[0], v[1]);
      else
        *reinterpret_cast<char2*>(dst + col) =
            make_char2((signed char)(int)v[0], (signed char)(int)v[1]);
    }
  }
  named_sync(CONSUMER_BAR, 128 * CONSUMERS);

  // the tile's valid pixels and channels, in 16-byte pieces where rows
  // allow (a pixel's channels are contiguous, the patch row's pixels too)
  const int esz = g.mode == F32 ? 4 : 1;
  const int nout = min(BN, g.cout - n0);
  if (nout > 0) {
    const int rowb = nout * esz;
    if ((g.cout * esz) % 16 == 0 && (n0 * esz) % 16 == 0 && rowb % 16 == 0) {
      const int chunks = rowb / 16;
      for (int e = tid; e < BM * chunks; e += 128 * CONSUMERS) {
        const int r = e / chunks, ch = e - r * chunks;
        const int ho = ho0 + r / TW, wo = wo0 + r % TW;
        if (ho < g.Ho && wo < g.Wo)
          *reinterpret_cast<uint4*>(
              static_cast<uint8_t*>(out) +
              (((size_t)(b * g.Ho + ho) * g.Wo + wo) * g.cout + n0) * esz +
              ch * 16) =
              *reinterpret_cast<const uint4*>(sm + r * L.opitch + ch * 16);
      }
    } else {
      for (int e = tid; e < BM * nout; e += 128 * CONSUMERS) {
        const int r = e / nout, c = e - r * nout;
        const int ho = ho0 + r / TW, wo = wo0 + r % TW;
        if (ho >= g.Ho || wo >= g.Wo) continue;
        const size_t o =
            ((size_t)(b * g.Ho + ho) * g.Wo + wo) * g.cout + n0 + c;
        if (esz == 4)
          static_cast<float*>(out)[o] =
              *reinterpret_cast<const float*>(sm + r * L.opitch + 4 * c);
        else
          static_cast<int8_t*>(out)[o] = (int8_t)sm[r * L.opitch + c];
      }
    }
  }
}

namespace {

// `kernel` over `grid` blocks, with programmatic dependent launch: it may
// start while the stream's previous kernel runs, and waits for it at
// griddepcontrol.wait
template <class... Args>
int launch_pdl(void (*kernel)(Args...), dim3 grid, int smem, void* stream,
               Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BN, int KC>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap,
           const float* comb, const float* bias, const int8_t* res,
           void* out, const Geometry& g, int mt, int nt, int stages,
           void* stream) {
  static bool raised = false;
  if (!raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        int8_conv_kernel<BN, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  const int smem = layout(BN, KC, stages).total;
  last_launch = LaunchShape{mt, nt, THREADS, smem};
  return launch_pdl(int8_conv_kernel<BN, KC>, dim3(mt, nt, 1), smem, stream,
                    xmap, wmap, comb, bias, res, out, g, stages);
}

template <int KC>
int launch_kc(int bn, const CUtensorMap& xmap, const CUtensorMap& wmap,
              const float* comb, const float* bias, const int8_t* res,
              void* out, const Geometry& g, int mt, int nt, int stages,
              void* stream) {
  switch (bn) {
    case 8:
      return launch<8, KC>(xmap, wmap, comb, bias, res, out, g, mt, nt,
                           stages, stream);
    case 32:
      return launch<32, KC>(xmap, wmap, comb, bias, res, out, g, mt, nt,
                            stages, stream);
    default:
      return launch<64, KC>(xmap, wmap, comb, bias, res, out, g, mt, nt,
                            stages, stream);
  }
}

}  // namespace

// x (B, H, W, C) int8 NHWC; w (N, KS*KS*C) int8; comb, bias (N,) f32;
// res (B, Ho, Wo, cout) int8 for mode 2, else unused; out (B, Ho, Wo, cout)
// f32 (mode 0) or int8 (modes 1, 2). Geometries: KS 1 stride 1, KS 3
// stride 1 or 2, padding KS / 2. C a multiple of 16, N of 8, cout <= N;
// x, w, comb, bias, res and out 16-byte aligned. The plan: tile width bn
// (8, 32, 64), K chunk kc bytes (32, 64, 128), a ring of `stages` (4-8).
// Launched with programmatic dependent launch.
extern "C" int unina_int8_conv(const void* x, const void* w, const float* comb,
                               const float* bias, const void* res, void* out,
                               int B, int H, int W, int C, int N, int cout,
                               int ks, int stride, int mode, float s_out,
                               float s_res, float s_add, int bn, int kc,
                               int stages, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || C % 16 || N <= 0 || N % 8 ||
      cout <= 0 || cout > N || mode < F32 || mode > QRES ||
      (mode == QRES && res == nullptr) ||
      !((ks == 1 && stride == 1) || (ks == 3 && (stride == 1 || stride == 2))))
    return (int)cudaErrorInvalidValue;
  Geometry g;
  g.B = B, g.H = H, g.W = W, g.C = C, g.N = N, g.cout = cout;
  g.ks = ks, g.stride = stride, g.pad = ks / 2;
  g.Ho = (H + 2 * g.pad - ks) / stride + 1;
  g.Wo = (W + 2 * g.pad - ks) / stride + 1;
  g.tiles_w = (g.Wo + TW - 1) / TW;
  g.tiles_img = g.tiles_w * ((g.Ho + TH - 1) / TH);
  g.cch = (C + kc - 1) / kc;
  g.steps = ks * ks * g.cch;
  g.mode = mode, g.s_out = s_out, g.s_res = s_res, g.s_add = s_add;
  const long long mt = (long long)B * g.tiles_img;
  const int nt = (N + bn - 1) / bn;
  if (!(bn == 8 || bn == 32 || bn == 64) ||
      !(kc == 32 || kc == 64 || kc == 128) || stages < 4 ||
      stages > MAX_STAGES || (stages < g.steps && stages % 2) ||
      mt > 0x7FFFFFFF || nt > 65535 ||
      layout(bn, kc, stages).total > SMEM_LIMIT)
    return (int)cudaErrorInvalidValue;

  // A: the input, boxes of the tile's patch at the layer's stride
  CUtensorMap xmap, wmap;
  const uint64_t xd[4] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                          (uint64_t)B};
  const uint64_t xs[3] = {(uint64_t)C, (uint64_t)W * C, (uint64_t)H * W * C};
  const uint32_t xb[4] = {(uint32_t)kc, (uint32_t)(TW * stride),
                          (uint32_t)(TH * stride), 1};
  const uint32_t xe[4] = {1, (uint32_t)stride, (uint32_t)stride, 1};
  int err = s8_tensor_map(&xmap, x, xd, xs, xb, xe, kc);
  if (err) return err;
  // B: the weights as (N, taps, C), boxes of bn rows at one tap
  const uint64_t taps = (uint64_t)ks * ks;
  const uint64_t wd[4] = {(uint64_t)C, taps, (uint64_t)N, 1};
  const uint64_t ws[3] = {(uint64_t)C, taps * C, (uint64_t)N * taps * C};
  const uint32_t wb[4] = {(uint32_t)kc, 1, (uint32_t)bn, 1};
  const uint32_t we[4] = {1, 1, 1, 1};
  err = s8_tensor_map(&wmap, w, wd, ws, wb, we, kc);
  if (err) return err;

  auto rs = static_cast<const int8_t*>(res);
  switch (kc) {
    case 32:
      return launch_kc<32>(bn, xmap, wmap, comb, bias, rs, out, g, (int)mt,
                           nt, stages, stream);
    case 64:
      return launch_kc<64>(bn, xmap, wmap, comb, bias, rs, out, g, (int)mt,
                           nt, stages, stream);
    default:
      return launch_kc<128>(bn, xmap, wmap, comb, bias, rs, out, g, (int)mt,
                            nt, stages, stream);
  }
}

// the last launch: grid x, grid y, threads, dynamic shared memory
extern "C" int unina_int8_conv_last_launch(int* out) {
  const LaunchShape& l = last_launch;
  out[0] = l.grid_x, out[1] = l.grid_y, out[2] = l.threads, out[3] = l.smem;
  return 0;
}
