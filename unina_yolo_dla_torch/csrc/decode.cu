// Anchor-free head decode and top-K compaction of every level and every
// image of a batch, in one launch.
//
// Replaces: unina_yolo_dla_tpu/ops/pallas/decode_kernel.py
//   decode_level_pallas / _decode_kernel (pallas_call at :94), and the
//   masked top-k the TPU needs around it for want of atomics
//   (unina_yolo_dla_tpu/ops/decode.py decode_outputs, exact_topk=True).
//   Per cell: sigmoid of the class logits; score = max, class = first
//   argmax; TLBR distances x stride -> xyxy around the cell centre
//   ((x + 0.5) * stride, (y + 0.5) * stride); conformal dilation by
//   q_factor; valid = score > conf. Cells are numbered across the
//   concatenated levels (all of P2, then P3, then P4, row-major in each).
//   Per image, K slots: the valid cells by score descending, ties to the
//   lower cell index; when fewer than K are valid, the first invalid
//   cells in index order fill the rest (what a stable descending sort of
//   the scores with the invalid ones at -1 gives).
//
// Bound on the H100: bytes. 16 B read a cell (4 logits), 16 B read (4
//   distances) and 25 B written a kept slot: 0.58 MB a frame, 0.17 us at
//   3.35 TB/s, far below one launch's fixed cost. So the work that is left is made small:
//   nothing is written for an invalid cell, and no pass runs in a second
//   launch or in a library sort.
// Design: a grid of (cell tiles, B) blocks.
//   1. Decode: a thread a cell computes the score and class only. Valid
//      cells append a 64-bit key (score bits, ~cell index) to their image's
//      list in device memory: one ballot and one atomicAdd a warp. A key
//      orders as (score, -index), so descending keys are the plain
//      version's order, and the box need not be stored: it is computed
//      again, by the same code, for the K cells that are kept. Only warps
//      that wrote fence.
//   2. Each image has one 64-bit word: appended keys in the low half,
//      finished blocks in the high half. A block's ticket is one atomicAdd
//      on it, and the last block's ticket returns n as well (no further
//      read). That block selects:
//      - slots past n take the first K - n invalid cells, which all lie
//        among the first K cells: one pass over those (two cells a thread)
//        and a block-wide ballot prefix, its loads in flight beside the key
//        loads, and the score and class kept for the write;
//      - n <= K keys go into shared memory and are sorted there (a rank
//        count for n <= 256, else a bitonic sort whose steps inside a
//        warp's 64 keys need no block barrier);
//      - n > K: a radix select over the list finds the K-th key, 8 bits a
//        pass from the first byte in which scores above conf can differ,
//        ending as soon as a bucket is taken whole; the K keys at or above
//        it are gathered and sorted.
//      Each slot's cell is decoded in full and written straight into the
//      four output tensors.
//   3. The same block sets its image's word back to 0: the launch needs no
//      memset and replays inside a CUDA graph.
//   Level inputs are read through their own batch and cell strides (the
//   head's channel-slice views need no copy). The sigmoid, the
//   first-match argmax and the box arithmetic keep the plain version's
//   operation order and are compiled without multiply-add contraction, so
//   the two agree bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CLASSES = 16;
constexpr int MAX_LEVELS = 3;
constexpr int MAX_K = 1024;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RANK_SORT_MAX = 256;  // up to here a rank count, then bitonic
constexpr int TAIL = MAX_K / THREADS;  // first-K cells a thread scans

struct Level {
  const float* cls;
  const float* reg;
  long long cls_b, reg_b;  // batch strides, elements
  int cls_c, reg_c;        // cell strides, elements
  int w, offset;           // width; index of the level's first cell
  float stride;
  int vec;  // bit 0: cls as float4 (C == 4, aligned); bit 1: reg as float4
};

struct Params {
  Level lv[MAX_LEVELS];
  int levels, cells, C, K;  // K <= cells
  float conf, q;
  unsigned long long* list;   // B x cells keys
  unsigned long long* state;  // B x (finished blocks << 32 | keys appended)
  float* boxes;              // B x K x 4
  float* scores;             // B x K
  int* classes;              // B x K
  uint8_t* valid;            // B x K
};

__device__ __forceinline__ int level_of(const Params& p, int g) {
  int l = 0;
#pragma unroll
  for (int i = 1; i < MAX_LEVELS; ++i)
    if (i < p.levels && g >= p.lv[i].offset) l = i;
  return l;
}

__device__ __forceinline__ void consider(float logit, int c, float& best,
                                         int& klass) {
  float prob = 1.0f / (1.0f + expf(-logit));
  if (c == 0 || prob > best) {  // first maximum wins ties
    best = prob;
    klass = c;
  }
}

// score and class of cell i of level L in image b
__device__ __forceinline__ float score_of(const Params& p, const Level& L,
                                          int b, int i, int& klass) {
  const float* c = L.cls + b * L.cls_b + (long long)i * L.cls_c;
  float best = 0.f;
  klass = 0;
  if (L.vec & 1) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(c));
    consider(v.x, 0, best, klass);
    consider(v.y, 1, best, klass);
    consider(v.z, 2, best, klass);
    consider(v.w, 3, best, klass);
  } else {
    for (int k = 0; k < p.C; ++k) consider(__ldg(c + k), k, best, klass);
  }
  return best;
}

__device__ __forceinline__ unsigned long long key_of(float score, int g) {
  return ((unsigned long long)__float_as_uint(score) << 32) |
         (0xffffffffu - (unsigned)g);
}

__device__ __forceinline__ int cell_of(unsigned long long key) {
  return (int)(0xffffffffu - (unsigned)key);
}

// the box of cell g of image b, and its score and class, into slot s
__device__ void write_box(const Params& p, int b, int s, int g, float score,
                          int klass) {
  const Level& L = p.lv[level_of(p, g)];
  const int i = g - L.offset;
  const float* r = L.reg + b * L.reg_b + (long long)i * L.reg_c;
  float l, t, rr, bb;
  if (L.vec & 2) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(r));
    l = v.x, t = v.y, rr = v.z, bb = v.w;
  } else {
    l = __ldg(r), t = __ldg(r + 1), rr = __ldg(r + 2), bb = __ldg(r + 3);
  }
  const int y = i / L.w, x = i - y * L.w;
  const float st = L.stride;
  const float cx = ((float)x + 0.5f) * st;
  const float cy = ((float)y + 0.5f) * st;
  l = l * st, t = t * st, rr = rr * st, bb = bb * st;
  float x1 = cx - l, y1 = cy - t, x2 = cx + rr, y2 = cy + bb;
  if (p.q > 0.f) {
    const float dw = (x2 - x1) * p.q;
    const float dh = (y2 - y1) * p.q;
    x1 = x1 - dw;
    y1 = y1 - dh;
    x2 = x2 + dw;
    y2 = y2 + dh;
  }
  const size_t o = (size_t)b * p.K + s;
  reinterpret_cast<float4*>(p.boxes)[o] = make_float4(x1, y1, x2, y2);
  p.scores[o] = score;
  p.classes[o] = klass;
  p.valid[o] = score > p.conf;
}

// decode cell g of image b in full into slot s
__device__ void write_slot(const Params& p, int b, int s, int g) {
  const Level& L = p.lv[level_of(p, g)];
  int klass;
  const float score = score_of(p, L, b, g - L.offset, klass);
  write_box(p, b, s, g, score, klass);
}

// the threshold T with exactly K keys >= T among the n > K of the list
__device__ unsigned long long radix_select(const unsigned long long* list,
                                           unsigned n, unsigned K, float conf,
                                           unsigned* hist, unsigned* sel) {
  const int tid = threadIdx.x, lane = tid & 31;
  const unsigned full = 0xffffffffu;
  unsigned long long prefix = 0ull, pmask = 0ull;
  unsigned need = K;  // keys still to take among those matching prefix
  // every key's score lies in (conf, 1]: the leading bytes its bits share
  // with both ends are known
  const unsigned lo = conf > 0.f ? __float_as_uint(conf) : 0u;
  const unsigned hi = __float_as_uint(1.0f);
  int shift = 56;
  for (; shift >= 32 && (lo >> (shift - 32)) == (hi >> (shift - 32));
       shift -= 8) {
    prefix |= (unsigned long long)((hi >> (shift - 32)) & 255u) << shift;
    pmask |= 0xffull << shift;
  }
  for (; shift >= 0; shift -= 8) {
    for (int d = tid; d < 256; d += THREADS) hist[d] = 0u;
    __syncthreads();
#pragma unroll 4
    for (unsigned i = tid; i < n; i += THREADS) {
      const unsigned long long k = __ldcg(list + i);
      if ((k & pmask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l holds digits 255 - 8l down to 248 - 8l
      unsigned c[8], sum = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += (c[j] = hist[255 - 8 * lane - j]);
      unsigned incl = sum;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const unsigned up = __shfl_up_sync(full, incl, d);
        if (lane >= d) incl += up;
      }
      const unsigned hit = __ballot_sync(full, incl >= need);
      if (lane == __ffs(hit) - 1) {
        unsigned above = incl - sum;
        for (int j = 0; j < 8; ++j) {
          if (above + c[j] >= need) {
            sel[0] = 255 - 8 * lane - j;
            sel[1] = above;
            sel[2] = c[j];
            break;
          }
          above += c[j];
        }
      }
    }
    __syncthreads();
    need -= sel[1];
    prefix |= (unsigned long long)sel[0] << shift;
    pmask |= 0xffull << shift;
    const bool whole = sel[2] == need;  // the bucket is taken whole
    __syncthreads();
    if (whole) break;
  }
  return prefix;
}

// descending sort of m <= MAX_K distinct keys in shared memory, then slot
// s of image b gets the cell of the s-th key
__device__ void sort_and_write(const Params& p, int b,
                               unsigned long long* keys, int m) {
  const int tid = threadIdx.x;
  if (m <= RANK_SORT_MAX) {
    // a key's slot is the number of keys above it (keys are distinct)
    if (tid < m) {
      const unsigned long long k = keys[tid];
      int rank = 0;
      for (int j = 0; j < m; ++j) rank += keys[j] > k;
      write_slot(p, b, rank, cell_of(k));
    }
    return;
  }
  int P = 1;
  while (P < m) P <<= 1;
  for (int i = m + tid; i < P; i += THREADS) keys[i] = 0ull;  // sink last
  __syncthreads();
  // thread t holds pair t (P / 2 <= THREADS): for every j <= 32 a warp's
  // pairs stay inside its own 64 keys, so only the steps on either side of
  // one that reaches across warps need a block barrier between them
  for (int k = 2; k <= P; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (tid < (P >> 1)) {
        const int i = 2 * tid - (tid & (j - 1));  // i has bit j clear
        const unsigned long long a = keys[i], c = keys[i + j];
        const bool desc = (i & k) == 0;
        if (desc ? a < c : a > c) {
          keys[i] = c;
          keys[i + j] = a;
        }
      }
      const int next = j > 1 ? j >> 1 : k;  // the next step's j
      if (j >= 64 || next >= 64) __syncthreads(); else __syncwarp();
    }
  }
  for (int s = tid; s < m; s += THREADS) write_slot(p, b, s, cell_of(keys[s]));
}

__global__ void __launch_bounds__(THREADS)
decode_topk_kernel(const __grid_constant__ Params p) {
  __shared__ unsigned long long keys[MAX_K];
  __shared__ unsigned hist[256];
  __shared__ unsigned sel[3];
  __shared__ unsigned warp_n[TAIL * WARPS];
  __shared__ unsigned s_n;
  __shared__ bool last;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned full = 0xffffffffu, below = (1u << lane) - 1u;

  // 1. decode the block's cells; valid ones append their key
  const int g = blockIdx.x * THREADS + tid;
  bool v = false;
  float score = 0.f;
  if (g < p.cells) {
    const int l = level_of(p, g);
    int klass;
    score = score_of(p, p.lv[l], b, g - p.lv[l].offset, klass);
    v = score > p.conf;
  }
  const unsigned vw = __ballot_sync(full, v);
  unsigned long long* list = p.list + (size_t)b * p.cells;
  if (vw) {
    unsigned base = 0u;
    if (lane == 0)
      base = (unsigned)atomicAdd(&p.state[b],
                                 (unsigned long long)__popc(vw));
    base = __shfl_sync(full, base, 0);
    if (v) list[base + __popc(vw & below)] = key_of(score, g);
    __threadfence();  // the keys and the count before the ticket
  }
  __syncthreads();
  if (tid == 0) {
    const unsigned long long old = atomicAdd(&p.state[b], 1ull << 32);
    last = (unsigned)(old >> 32) == gridDim.x - 1;
    s_n = (unsigned)old;  // the last ticket sees every block's count
    if (last) __threadfence();
  }
  __syncthreads();
  if (!last) return;

  // 2. the image's last block: select and write the K slots
  const unsigned n = s_n, K = (unsigned)p.K;
  const int m = (int)min(n, K);
  const int need = (int)K - m;  // invalid cells to fill the tail with
  if (n <= K)
    for (unsigned i = tid; i < n; i += THREADS) keys[i] = __ldcg(list + i);
  // the tail: the first K - m invalid cells, all among the first K cells
  float tail_score[TAIL];
  int tail_class[TAIL];
  unsigned tail_w[TAIL];
  if (need > 0) {
#pragma unroll
    for (int r = 0; r < TAIL; ++r) {
      const int c = r * THREADS + tid;
      bool inv = false;
      tail_score[r] = 0.f, tail_class[r] = 0;
      if (c < (int)K) {
        const int l = level_of(p, c);
        tail_score[r] = score_of(p, p.lv[l], b, c - p.lv[l].offset,
                                 tail_class[r]);
        inv = !(tail_score[r] > p.conf);
      }
      tail_w[r] = __ballot_sync(full, inv);
      if (lane == 0) warp_n[r * WARPS + warp] = __popc(tail_w[r]);
    }
  }
  __syncthreads();
  if (need > 0) {
#pragma unroll
    for (int r = 0; r < TAIL; ++r) {
      int rank = __popc(tail_w[r] & below);
      for (int w = 0; w < r * WARPS + warp; ++w) rank += warp_n[w];
      if ((tail_w[r] >> lane) & 1u && rank < need)
        write_box(p, b, m + rank, r * THREADS + tid, tail_score[r],
                  tail_class[r]);
    }
  }
  if (n > K) {
    const unsigned long long T = radix_select(list, n, K, p.conf, hist, sel);
    if (tid == 0) sel[0] = 0u;
    __syncthreads();
#pragma unroll 4
    for (unsigned i = tid; i < n; i += THREADS) {
      const unsigned long long k = __ldcg(list + i);
      if (k >= T) keys[atomicAdd(&sel[0], 1u)] = k;
    }
    __syncthreads();
  }
  sort_and_write(p, b, keys, m);

  // 3. ready for the next launch
  if (tid == 0) p.state[b] = 0ull;
}

}  // namespace

// meta: per level [cls, reg, cls batch stride, cls cell stride, reg batch
// stride, reg cell stride, H, W] (pointers as integers, strides in
// elements); level_stride: the levels' strides in pixels.
extern "C" int unina_decode_topk(const long long* meta,
                                 const float* level_stride, int levels,
                                 int B, int C, int K, float conf, float q,
                                 void* list, void* state, void* boxes,
                                 void* scores, void* classes,
                                 void* valid, void* stream) {
  if (levels <= 0 || levels > MAX_LEVELS || C <= 0 || C > MAX_CLASSES ||
      K <= 0 || K > MAX_K || B <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  int cells = 0;
  for (int l = 0; l < levels; ++l) {
    const long long* m = meta + 8 * l;
    Level& L = p.lv[l];
    L.cls = reinterpret_cast<const float*>(m[0]);
    L.reg = reinterpret_cast<const float*>(m[1]);
    L.cls_b = m[2], L.cls_c = (int)m[3];
    L.reg_b = m[4], L.reg_c = (int)m[5];
    L.w = (int)m[7];
    L.offset = cells;
    L.stride = level_stride[l];
    const bool cls4 = C == 4 && m[0] % 16 == 0 && m[2] % 4 == 0 &&
                      m[3] % 4 == 0;
    const bool reg4 = m[1] % 16 == 0 && m[4] % 4 == 0 && m[5] % 4 == 0;
    L.vec = (cls4 ? 1 : 0) | (reg4 ? 2 : 0);
    cells += (int)(m[6] * m[7]);
  }
  if (K > cells) return (int)cudaErrorInvalidValue;
  p.levels = levels, p.cells = cells, p.C = C, p.K = K;
  p.conf = conf, p.q = q;
  p.list = (unsigned long long*)list;
  p.state = (unsigned long long*)state;
  p.boxes = (float*)boxes;
  p.scores = (float*)scores;
  p.classes = (int*)classes;
  p.valid = (uint8_t*)valid;
  const dim3 grid((cells + THREADS - 1) / THREADS, B);
  decode_topk_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
