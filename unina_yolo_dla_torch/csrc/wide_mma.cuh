// Shared device code of the wide C3k2 and head kernels (sm_90a): `wgmma`
// products over NHWC windows in shared memory, the weights streamed by
// bulk copies (TMA) through rings of shared-memory slots, and at the
// widest widths every product's output columns split over the blocks of a
// thread-block cluster. Included by c3k2.cu and head.cu; not compiled on
// its own.
//
// What bounds them on the H100: weights of 0.3-18.9 MB a launch against
// 0.5-4.9 MB of activations and 1-30 GFLOP, so the tensor cores (1-31 us)
// once every weight is read from L2 once per cluster and every A fragment
// once per warpgroup; in practice the latency of each block's chain of
// stages (window copies, chunk steps, epilogues, barriers) on one block an
// SM. Measured times: PERF.md.
//
//   Windows  every activation window is a stack of 64-channel planes, each
//     plane `pixels x 128 bytes` with the 16-byte chunks of pixel p at
//     chunk ^ (p & 7) (mma_sm90.cuh `pix_chunk`). A channel count that is
//     no multiple of 64 leaves the rest of its last plane zero.
//   A (activations)  `ldmatrix` rows of window pixels (mma_sm90.cuh
//     `load_a64`): every lane names its own pixel, so a 3x3 tap is a shift
//     of that pixel and the halo needs no copy. `ldmatrix` reads only this
//     block's shared memory, so a plane kept by a peer is first copied in
//     (`gather`).
//   B (weights)  per 64-deep K chunk one swizzled [NS n][64 k] tile of this
//     block's NS output columns (ops/cuda/mma_pack.py `_wide_stream`); a
//     block's chunks lie in the order it consumes them, stage after stage
//     (or, where a stream is packed for fewer, wider blocks or in the
//     other order of a 3x3's taps and planes, at a stride and offset or
//     walked: `Stream`). Each
//     warpgroup keeps its own ring of the columns it multiplies: `Feeder`
//     copies its part of chunk g + DIST by one bulk copy into slot g % RING
//     while chunk g multiplies, completing on the slot's mbarrier, so the
//     two warpgroups meet only between stages.
//   Products  a stage is a set of items, an item one m64 row tile times NI
//     of the block's columns (wgmma m64nNIk16, NI 16 to 64), item i of a
//     stage belongs to warpgroup i % 2: all columns of alternate m64 tiles
//     where the tiles split evenly (`stage_nh`), else half of the columns
//     of every tile. Every count is known at compile time, so no product
//     sits behind a branch; A has one set of registers, loaded after the
//     warpgroup's previous products are done (wgmma runs unserialized only
//     while nothing else defines its operands); two chunks a step, one
//     where the accumulators are wide.
//   Cluster  the blocks of a cluster (2 or 4, within the portable 8) share
//     one output tile, each computing its columns of every stage, in one
//     of two plans. Replicated: every block keeps every plane of every
//     window and stores its columns, bf16, into the windows of every block
//     of the cluster (4-byte distributed shared-memory stores, `Peers`).
//     Owned (base 64's widest stages): a block keeps only the 64-channel
//     planes it computes, its epilogues store into its own shared memory,
//     and before a stage it copies its peers' planes into window planes of
//     its own (`gather`: 16-byte ld.shared::cluster). Either way the
//     cluster meets at a barrier after every stage's epilogue, and no
//     block leaves while a peer may still read it. Each block's ring and
//     its mbarriers are its own.
//   Tile  the output tile is a compile-time parameter of each body (c3k2.cu
//     `tile_rows` / `tile_cols`: 8 x 8; head.cu `tile_rows` / `tile_w`:
//     8 x 8 or 8 x 16, the owned plan 8 x 16; the C3k2's persistent plan
//     8 x 16), one kernel function a body.
//   Persistent plan (the C3k2 at hidden 64 on large grids: base 64's 160
//     x 160 level)  a grid of one block an SM, each block walking its
//     tiles in a fixed order (tile b, b + blocks, .., `Walk`); the ring runs
//     on from tile to tile (`Feeder::passes`), so the next tile's first
//     chunks land during this tile's last stage and epilogue, and the next
//     tile's input window is copied while this tile's later stages
//     multiply. Every stage is split by columns between the warpgroups
//     (`stage_nh`'s `all`), so each chunk is copied from L2 once a block a
//     tile. The products, and so the bits, are the replicated plan's; a
//     tile's result does not depend on the block that computes it.
//   The head at 128 on base 64's 160 x 160 runs a plan of its own (head.cu
//   `large`: three warpgroups, one ring they share, A one step ahead),
//   which shares only this file's constants and launch record.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sm90.cuh"

namespace wide {

using namespace mma90;
namespace cg = cooperative_groups;

constexpr int THREADS = 256;             // two warpgroups
constexpr int KSTEP = 2;                 // chunks multiplied a step
constexpr int MAX_RING = 8;              // slots of a warpgroup's ring
constexpr int MAX_STAGES = 6;            // C3k2: A, 2 x (B, C), D
constexpr int SMEM_MAX = 232448;         // 227 KB a block
// where a plan that walks its work with one block an SM takes over from
// the replicated one: that plan's grid fills two rounds of the H100's 132
// SMs (c3k2.cu's persistent plan, head.cu's large plan)
constexpr int WALK_MIN_BLOCKS = 264;
// shared memory ahead of a wide kernel's ring: the block's `Stream`, the
// ring's mbarriers at BARS, and the slack that aligns the ring to 1024
constexpr int SMEM_HEAD = 2048;
constexpr int BARS = 512;

__host__ __device__ inline int planes(int c) { return (c + 63) >> 6; }

// A warpgroup's ring: RING slots of SLOT bytes (its columns of one 64-deep
// K chunk: [<= 64 n][64 k]); chunks copied DIST ahead of the step that
// multiplies them. Eight 4 KB slots, or six of 8 KB at 64 columns.
template <int SLOT_>
struct Ring {
  static constexpr int SLOT = SLOT_;
  static constexpr int RING = SLOT_ > 4096 ? 6 : MAX_RING;
  static constexpr int DIST = RING - KSTEP;
  static constexpr int BYTES = 2 * RING * SLOT;  // both warpgroups'
  static_assert(SLOT % 1024 == 0 && RING <= MAX_RING, "ring geometry");
};
// Column parts of a stage of `ns` block columns over `pixels` rows: one
// (each warpgroup multiplies all columns of its own m64 tiles, so every A
// fragment is loaded once) where the m64 tiles split evenly between the
// two warpgroups and a slot holds the columns (8 KB: 64); else two (each
// warpgroup all m64 tiles, half of the columns). A stage narrower than 32
// columns is one part. `all` (the persistent plan): two wherever the
// columns are 32 or more, so that no chunk is copied into both rings.
__host__ __device__ constexpr int stage_nh(int ns, int pixels,
                                           bool all = false) {
  return ns >= 32 && (all || (((pixels + 63) / 64) & 1) || ns * 128 > 8192)
             ? 2
             : 1;
}
// the columns a warpgroup multiplies in such a stage
__host__ __device__ constexpr int stage_cols(int ns, int pixels) {
  return ns / stage_nh(ns, pixels);
}
// K chunks a step: one where a warpgroup's accumulators (MINE items of NI
// columns) leave no room for two chunks' A registers
__host__ __device__ constexpr int step_chunks(int mine, int ni) {
  return mine * ni >= 192 ? 1 : KSTEP;
}
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
// the ring of a kernel whose widest warpgroup part is `cols` columns
__host__ __device__ constexpr int ring_slot(int cols) {
  return cols * 128 > 4096 ? 8192 : 4096;
}
__host__ __device__ constexpr int ring_bytes(int cols) {
  return ring_slot(cols) > 4096 ? 2 * 6 * 8192 : 2 * MAX_RING * 4096;
}

// where this thread is: its warpgroup, warp in the warpgroup, lane
struct Lane {
  int tid, wg, warp, lane, g, tq;
  __device__ Lane()
      : tid(threadIdx.x), wg(threadIdx.x >> 7), warp((threadIdx.x >> 5) & 3),
        lane(threadIdx.x & 31), g((threadIdx.x & 31) >> 2),
        tq(threadIdx.x & 3) {}
};

// this block's weight chunks, stage after stage; each warpgroup copies the
// columns it multiplies into a ring of its own. A block's chunk of stage s
// is `bytes` at `skew` inside every `stride` bytes of the stream: the
// whole stride, or (where the stream is packed for fewer, wider blocks)
// the part of a wider block's chunk that this block multiplies.
struct Stream {
  const unsigned char* src;       // the stream's range this block reads
  int nst;                        // stages
  int first[MAX_STAGES + 1];      // first chunk of stage s; [nst] = total
  int bytes[MAX_STAGES];          // bytes of one chunk of stage s
  int halves[MAX_STAGES];         // 2: each warpgroup takes its half
  int stride[MAX_STAGES];         // bytes from one chunk to the next
  int skew[MAX_STAGES];           // the chunk's offset inside its stride
  // 0: chunks stored in the order they are multiplied; else a 3x3 stage
  // stored in the other order of its (tap, plane) pairs: the `inner`
  // chunks multiplied in a row lie `jump` chunks apart, and each such run
  // starts one chunk after the last one's start (a `Feeder` with WALK)
  int inner[MAX_STAGES];
  int jump[MAX_STAGES];
  long long off[MAX_STAGES];      // byte offset of stage s's first stride

  __device__ void add(int nchunks, int chunk_bytes, int nh, int step = 0,
                      int at = 0, int run = 0, int apart = 0) {
    off[nst] = nst ? off[nst - 1] +
                         (long long)(first[nst] - first[nst - 1]) *
                             stride[nst - 1]
                   : 0;
    bytes[nst] = chunk_bytes;
    halves[nst] = nh;
    stride[nst] = step ? step : chunk_bytes;
    skew[nst] = at;
    inner[nst] = run;
    jump[nst] = apart;
    first[nst + 1] = first[nst] + nchunks;
    ++nst;
  }
  __device__ long long total_bytes() const {
    return off[nst - 1] +
           (long long)(first[nst] - first[nst - 1]) * stride[nst - 1];
  }
};

// A warpgroup's copying side of its ring: a cursor over the block's
// stream, one chunk (the warpgroup's part of it) a call, copied by one
// bulk copy into slot g % RING, which completes on that slot's mbarrier.
// The slots' barriers lie at `bars` (RING for each warpgroup). WALK: the
// stream may hold a stage in another order than it is multiplied
// (`Stream::inner`); only the bodies that read one pay for the walk.
// LOOP (the persistent plan): `passes` walks of the stream (the block's
// tiles), the cursor starting again at stage 0 after the last stage.
template <class G, bool WALK = false, bool LOOP = false>
struct Feeder {
  static constexpr int RING = G::RING, SLOT = G::SLOT;
  const Stream* st;
  const unsigned char* src;  // this warpgroup's part of the next chunk
  const unsigned char* run;  // WALK: of the first chunk of this run
  int part, step, inner, q;  // its bytes; the stride; a run, its position
  long long hop;             // WALK: bytes between a run's chunks
  int left, s, g;            // chunks left in stage s; the next chunk
  int passes;                // LOOP: walks left, this one included
  uint32_t ring, bars;       // this warpgroup's first slot and barrier
  bool lead;                 // the warpgroup's thread that copies
  int wg;

  __device__ Feeder(const Stream& stream, uint32_t ring0, uint32_t bars0,
                    const Lane& L, int walks = 1)
      : st(&stream), g(0), passes(walks), ring(ring0 + L.wg * RING * SLOT),
        bars(bars0 + L.wg * RING * 8), lead((L.tid & 127) == 0), wg(L.wg) {
    enter(0);
  }
  // the stream's table is read here, once a stage; `issue` then only
  // steps pointers (the walk needs no division)
  __device__ void enter(int stage) {
    s = stage;
    if constexpr (LOOP) {
      if (s == st->nst && --passes > 0) s = 0;  // the next tile's walk
    }
    if (s < st->nst) {
      part = st->bytes[s] / st->halves[s];
      step = st->stride[s];
      left = st->first[s + 1] - st->first[s];
      src = st->src + st->off[s] + st->skew[s] +
            (st->halves[s] == 2 ? wg * part : 0);
      if constexpr (WALK) {
        inner = st->inner[s];
        hop = (long long)st->jump[s] * step;
        q = 0;
        run = src;
      }
    }
  }
  __device__ void issue() {
    if (s < st->nst) {
      if (lead) {
        const uint32_t bar = bars + (g % RING) * 8;
        mbar_expect(bar, part);
        bulk_copy(ring + (g % RING) * SLOT, src, part, bar);
      }
      if constexpr (WALK) {
        if (inner == 0) {
          src += step;
        } else if (++q < inner) {  // the run's next chunk
          src += hop;
        } else {                   // the next run
          q = 0;
          run += step;
          src = run;
        }
      } else {
        src += step;
      }
      if (--left == 0) enter(s + 1);
    }
    ++g;
  }
  __device__ uint32_t slot(int chunk_index) const {
    return ring + (chunk_index % RING) * SLOT;
  }
  // chunk `chunk_index` has landed in its slot
  __device__ void wait(int chunk_index) const {
    mbar_wait(bars + (chunk_index % RING) * 8, (chunk_index / RING) & 1);
  }
};

static_assert(sizeof(Stream) <= BARS && BARS + 2 * MAX_RING * 8 + 1023 <=
                  SMEM_HEAD, "the stream table and the ring's barriers");

// the first slot of the rings: past the head, 1024-byte aligned
__device__ __forceinline__ uint32_t ring_base(uint32_t raw) {
  return (raw + BARS + 2 * MAX_RING * 8 + 1023u) & ~1023u;
}

// Set up the block's rings: each warpgroup's first thread initialises its
// slots' barriers. Before the block's first barrier.
template <class G>
__device__ __forceinline__ void init_rings(uint32_t raw, const Lane& L) {
  if ((L.tid & 127) == 0) {
    for (int i = 0; i < G::RING; ++i)
      mbar_init(raw + BARS + (L.wg * G::RING + i) * 8, 1);
    mbar_init_fence();
  }
}

// ---- wgmma m64nNk16, A from registers, N = 16, 32 or 64 ----
template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const uint32_t (&a)[4],
                                        uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_n<32>(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_m64n32k16(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_n<64>(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  wgmma_m64n64k16(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_n<16>(float (&d)[8],
                                            const uint32_t (&a)[4],
                                            uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// One stage's items: `mt * NH + nh` for m64 row tile mt and NI-column part
// nh of the block's columns; warpgroup w holds items w, w + 2, ..., MINE
// of them, a compile-time count: a warpgroup whose share is short computes
// the stage's last item again and drops it in the epilogue, so no product
// sits behind a branch that depends on the thread (`wgmma` behind such a
// branch is serialized by the compiler).
template <int NI, int NH, int MINE>
struct Items {
  int count;  // of the stage
  __device__ static int raw(int i, int wg) { return wg + 2 * i; }
  __device__ int item(int i, int wg) const {
    return min(raw(i, wg), count - 1);
  }
  // the A row (0..64 MT) of this lane's ldmatrix address for item i
  __device__ int arow(int i, const Lane& L) const {
    return (item(i, L.wg) / NH) * 64 + L.warp * 16 + (L.lane & 15);
  }
};

// KS chunks of the products: wait for their slots, let the ring run on,
// then A by ldmatrix and the wgmma of every item this warpgroup holds. The
// warpgroup's previous products are done first (A has one set of
// registers: wgmma runs unserialized only while nothing else defines its
// operands); the other warpgroup runs on its own ring meanwhile and fills
// the tensor cores.
template <int KS, int NI, int MINE, class G, bool W, bool LP, class AFn>
__device__ __forceinline__ void chunk_step(
    float (&acc)[MINE][NI / 2], uint32_t (&a)[KS][MINE][4][4], int g,
    int kc, Feeder<G, W, LP>& fd, const Lane& L, AFn afn) {
#pragma unroll
  for (int k = 0; k < KS; ++k) fd.wait(g + k);  // the step's chunks landed
  wgmma_wait<0>();             // the previous step is done with A, slots
  warpgroup_barrier(1 + L.wg);
#pragma unroll
  for (int k = 0; k < KS; ++k) fd.issue();  // chunks g + G::DIST ..
  uint64_t desc[KS][4];
#pragma unroll
  for (int k = 0; k < KS; ++k) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      desc[k][ks] = b_desc(fd.slot(g + k)) + (uint64_t)(ks * 32 >> 4);
#pragma unroll
    for (int i = 0; i < MINE; ++i) {
      uint32_t win;
      int pix;
      afn(i, kc + k, win, pix);
      load_a64(a[k][i], win, pix, L.lane);
    }
  }
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < KS; ++k)
#pragma unroll
    for (int i = 0; i < MINE; ++i)
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_n<NI>(acc[i], a[k][i][ks], desc[k][ks]);
  wgmma_commit();
}

// Chunks k0 .. k0 + nk - 1 of a stage's products, added to `acc`; chunk
// kc is the stream's chunk g0 + kc. `afn(i, kc, win, pix)` names this
// lane's A row of item i in chunk kc: the plane's shared address and the
// pixel. KS chunks a step (1 where a warpgroup's accumulators and A
// registers would not fit beside each other at two).
template <int KS, int NI, int NH, int MINE, class G, bool W, bool LP,
          class AFn>
__device__ __forceinline__ void gemm_more(float (&acc)[MINE][NI / 2],
                                          const Items<NI, NH, MINE>& items,
                                          int g0, int k0, int nk,
                                          Feeder<G, W, LP>& fd,
                                          const Lane& L, AFn afn) {
  static_assert(NI * 128 <= G::SLOT, "a warpgroup's columns fit its slot");
  uint32_t a[KS][MINE][4][4];
  int kc = k0;
#pragma unroll 1
  for (; kc + KS <= k0 + nk; kc += KS)
    chunk_step<KS, NI>(acc, a, g0 + kc, kc, fd, L, afn);
  if constexpr (KS > 1) {
    if (kc < k0 + nk) {
      uint32_t a1[1][MINE][4][4];
      chunk_step<1, NI>(acc, a1, g0 + kc, kc, fd, L, afn);
    }
  }
  wgmma_wait<0>();
  (void)items;
}

template <int NI, int MINE>
__device__ __forceinline__ void zero_acc(float (&acc)[MINE][NI / 2]) {
#pragma unroll
  for (int i = 0; i < MINE; ++i)
#pragma unroll
    for (int j = 0; j < NI / 2; ++j) acc[i][j] = 0.f;
}

// A stage's products over `nk` chunks, the first the stream's chunk g0,
// KS chunks a step.
template <int KS = KSTEP, int NI, int NH, int MINE, class G, bool W,
          bool LP, class AFn>
__device__ __forceinline__ void gemm(float (&acc)[MINE][NI / 2],
                                     const Items<NI, NH, MINE>& items,
                                     int g0, int nk, Feeder<G, W, LP>& fd,
                                     const Lane& L, AFn afn) {
  zero_acc<NI>(acc);
  gemm_more<KS>(acc, items, g0, 0, nk, fd, L, afn);
}

// One output row of an epilogue: whether it is stored, whether its pixel
// lies inside the image, where it goes (`off`) and its swizzle (`x`).
struct Row {
  uint32_t off;
  int x;
  bool keep, inside;
};

// byte offset of channel c (even) inside the row of a pixel whose
// swizzle is x, in a window of `pix` pixels (planes of 64 channels)
__device__ __forceinline__ uint32_t col_off(int c, int pix, int x) {
  return (uint32_t)((c >> 6) * pix * PIX_BYTES) +
         ((((c & 63) >> 3) ^ x) << 4) + (c & 7) * 2;
}

// The epilogue's walk over this thread's accumulators (its real items):
// `row(m)` describes row m of the stage's rows once, then f(row, column c
// of the block's columns, the two bf16 of ReLU(acc + bias) at columns c
// and c + 1) for each of the row's columns. `bias(c)` points at the bias
// of block column c; this thread's columns are the same in every item it
// holds, so their biases are loaded once, ahead of the stores.
template <int NI, int NH, int MINE, class B, class R, class F>
__device__ __forceinline__ void each_pair(const float (&acc)[MINE][NI / 2],
                                          const Items<NI, NH, MINE>& items,
                                          const Lane& L, B bias, R row,
                                          F f) {
  const int c0 = (NH == 2 ? L.wg : 0) * NI + 2 * L.tq;
  float2 bv[NI / 8];
#pragma unroll
  for (int j = 0; j < NI / 8; ++j) {
    const float* p = bias(c0 + 8 * j);
    bv[j] = make_float2(__ldg(p), __ldg(p + 1));
  }
#pragma unroll
  for (int i = 0; i < MINE; ++i) {
    const int it = Items<NI, NH, MINE>::raw(i, L.wg);
    if (it < items.count) {
      const int mt = it / NH;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const Row r = row(mt * 64 + L.warp * 16 + L.g + 8 * half);
        if (!r.keep) continue;
#pragma unroll
        for (int j = 0; j < NI / 8; ++j)
          f(r, c0 + 8 * j,
            pack_bf16(
                fmaxf(__fadd_rn(acc[i][4 * j + 2 * half], bv[j].x), 0.f),
                fmaxf(__fadd_rn(acc[i][4 * j + 2 * half + 1], bv[j].y),
                      0.f)));
      }
    }
  }
}

// items of a stage of `pixels` rows and NH column parts, and this
// warpgroup's share of them
template <int NH>
__host__ __device__ constexpr int stage_items(int pixels) {
  return (pixels + 63) / 64 * NH;
}
__host__ __device__ constexpr int share(int items) { return (items + 1) / 2; }

template <int S>
struct Peers {
  uint32_t base[S];  // shared::cluster address of each block's smem_raw
  __device__ explicit Peers(unsigned char* smem_raw) {
    const uint32_t raw = smem_u32(smem_raw);
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if constexpr (S == 1)
        base[r] = raw;
      else
        asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                     : "=r"(base[r])
                     : "r"(raw), "r"(r));
    }
  }
  __device__ void put(uint32_t off, uint32_t v) const {
#pragma unroll
    for (int r = 0; r < S; ++r) {
      if constexpr (S == 1)
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(base[r] + off),
                     "r"(v)
                     : "memory");
      else
        asm volatile("st.shared::cluster.u32 [%0], %1;\n" ::"r"(
                         base[r] + off),
                     "r"(v)
                     : "memory");
    }
  }
};

// ---- planes owned: a block reads its peers' planes ----
__device__ __forceinline__ float ld_cluster_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v)
               : "r"(addr)
               : "memory");
  return v;
}
// One block-wide copy of a run of peer shared memory into this block's:
// `bytes` (a multiple of 16) from `src` (a shared::cluster address) to
// `dst`, 16 bytes a thread and UNROLL loads in flight before their stores.
// The caller meets its block at a barrier before the copy is read.
__device__ __forceinline__ void gather(uint32_t dst, uint32_t src, int bytes,
                                       int tid) {
  constexpr int UNROLL = 4, STEP = THREADS * 16;
  int i = tid * 16;
  for (; i + (UNROLL - 1) * STEP < bytes; i += UNROLL * STEP) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(v[u].x), "=r"(v[u].y), "=r"(v[u].z), "=r"(v[u].w)
                   : "r"(src + i + u * STEP)
                   : "memory");
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                       dst + i + u * STEP),
                   "r"(v[u].x), "r"(v[u].y), "r"(v[u].z), "r"(v[u].w)
                   : "memory");
  }
  for (; i < bytes; i += STEP) {
    uint4 v;
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(src + i)
                 : "memory");
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst + i),
                 "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                 : "memory");
  }
}

// every block's stores are visible to every block of the cluster
template <int S>
__device__ __forceinline__ void cluster_sync() {
  if constexpr (S == 1)
    __syncthreads();
  else
    cg::this_cluster().sync();
}

template <int S>
__device__ __forceinline__ int cluster_rank() {
  if constexpr (S == 1)
    return 0;
  else
    return (int)cg::this_cluster().block_rank();
}

// zero `bytes` (a multiple of 16) of shared memory from `p`
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes,
                                          int tid) {
  for (int i = tid * 16; i < bytes; i += THREADS * 16)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0u, 0u, 0u, 0u);
}

// The persistent plan's walk over `tiles` tiles (`rows` tile rows and
// `cols` tile columns an image): block c of the grid takes tiles c,
// c + blocks, c + 2 blocks, .., `count` of them.
struct Walk {
  int first, blocks, count, cols, rows;
  __device__ Walk(int tiles, int tile_cols, int tile_rows)
      : first(blockIdx.x), blocks(gridDim.x),
        count((tiles - (int)blockIdx.x + (int)gridDim.x - 1) /
              (int)gridDim.x),
        cols(tile_cols), rows(tile_rows) {}
  // the image, tile row and tile column of this block's k-th tile
  __device__ void tile(int k, int& b, int& ty, int& tx) const {
    const int t = first + k * blocks;
    b = t / (cols * rows);
    const int rem = t - b * cols * rows;
    ty = rem / cols;
    tx = rem - ty * cols;
  }
};

// The shape of a launch as it was made: grid, cluster along x, threads a
// block, dynamic shared memory. Each source file keeps its last one for
// the host to read (`unina_*_last_launch`).
struct LaunchShape {
  int grid_x, grid_y, cluster, threads, smem;
};

// Launch a wide kernel: `blocks` x `grid_y` blocks of THREADS, in
// clusters of S along x (S = 1: no cluster), recorded in `shape`. The
// caller has raised the kernel's dynamic shared memory limit.
template <class... Args>
int launch_cluster(LaunchShape& shape, void (*kernel)(Args...), int S,
                   int blocks, int grid_y, int smem, void* stream,
                   Args... args) {
  shape = LaunchShape{blocks, grid_y, S, THREADS, smem};
  return launch_ex(kernel, dim3(blocks, grid_y, 1), S, THREADS, smem, stream,
                   args...);
}

}  // namespace wide
