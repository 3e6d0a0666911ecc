// Whole-model decode step in one kernel (sm_90a), the kernel template: every
// layer of one decode position, then the final norm, the lm-head GEMV and the
// greedy argmax.
//
// Replaces mnn_tpu/kernels/decode_model.py::_kernel. Contract (operands,
// packed layouts, rounding points) as kernels/decode_model.py describes it.
//
// What bounds it. One decode token reads every weight byte once and does two
// operations a weight, so the floor is bytes: 0.08 ms for qwen2-0.5b on the
// H100. At that size a layer is 7.9 MB, 2.4 us of the card's memory rate, so
// what a layer costs is the chain of dependent steps between its phases:
//
//   per layer  qkv GEMV | attention per (batch row, KV head) | wo GEMV +
//              residual | gate/up GEMV + SwiGLU | down GEMV + residual
//   head       final norm + lm-head GEMV + per-tile argmax | argmax merge
//
// The design keeps weight bytes off that chain and waits only where a step
// needs what another block made:
//
//  * A static schedule. kernels/decode_model.py's `schedule()` gives every
//    block its ordered list of items for the whole step, from the shapes and
//    the grid only (never the lengths, which stay on the device): a GEMV item
//    is (phase, layer, 128-column tile, range of units), a unit being 64
//    packed rows of the tile with their scale and bias rows; an attention
//    item is (layer, batch row, KV head, split); a barrier item stands in
//    every list where a whole residual row is needed (before each RMS norm
//    and before the argmax merge). The list comes in as an int32 table
//    (DM_REC ints an item); its header repeats the shapes it was built for.
//  * Weights ahead of the barriers. A ninth warp per block is a producer: it
//    walks the block's list and copies each unit's packed rows, scales and
//    biases into a ring of shared-memory slots by cp.async (16 bytes a lane
//    where rows and pointers allow, else 4), each slot completing an
//    mbarrier. It is bounded only by free slots, so it runs ahead across
//    phase and layer boundaries; no weight byte depends on the step. The
//    eight consumer warps wait on a slot's mbarrier and free it after use.
//    (cp.async rather than a TMA tensor map: a tile row is 128 bytes strided
//    by N, and the copies need no host-side descriptor or driver entry.)
//  * Waits on what is needed. qkv -> attention, attention -> wo and gate/up
//    -> down are arrival counters in device memory: the block that completes
//    a tile (or a KV head's attention) adds one with a release add after its
//    barrier (no fence in every thread); a consumer's thread 0 spins with
//    ld.acquire.gpu and a __nanosleep back-off until every counter it names
//    reaches its layer's count. The counters rise through the layers and
//    are zeroed in the prologue, ahead of the first grid-wide wait; the
//    grid-wide waits use one word whose top bit flips at every wait (as
//    cooperative groups' grid sync does), so no launch needs a reset from
//    the host and a replayed launch stays valid. Every block walks its list
//    in order and waits only on items of earlier phases, and all blocks are
//    co-resident (a cooperative launch), so the waits cannot deadlock.
//  * Places on distinct SMs. A block takes its place in the schedule when
//    it starts: the first block on an SM the next place from 0 up, a second
//    one from the top down. A phase of at most one item an SM goes to places
//    below the SM count, so its items do not share an SM's issue slots.
//  * K ranges. In a phase with fewer tiles than blocks a tile is cut into
//    the even ranges that give the busiest block the least work (a 7-unit
//    tile alone takes longer than its ranges and their merge); a phase with
//    a tile for every block deals whole tiles a round at a time and cuts
//    the tiles left over into ranges, one a block, so that no block takes a
//    tile more than another. Ranges meet in device memory: the last block to
//    arrive adds them in range order, so the result does not depend on
//    timing.
//  * Records ahead. The consumers copy the next item's record into shared
//    memory (cp.async) while they work on the current one, so an item starts
//    without a trip to memory; the table's records start 64-byte aligned.
//
// Inside a GEMV item the x range is staged in shared memory (normalized and
// rounded to bf16 on the way). At 1 or 2 batch rows (and W8) warp w takes
// packed rows [8w, 8w + 8) of each unit on the FMA units: a lane reads its 4
// output columns of a row as one 32-bit word and sums x * q over the 16 (W4)
// or 8 (W8) K values of its rows. At 4 or 8 batch rows W4 runs on the
// tensor cores (`mma.m16n8k16`, the batch rows as A's rows, the nibbles
// made bf16 in registers). Either way `part * scale + rowsum(x) * bias` per
// quant block goes to f32, and warps are summed in shared memory in a fixed
// order. The attention item is latency, not
// bytes: a (batch row, KV head) gets one block per 64 cached positions (up
// to the length read from device memory); its cached rows are prefetched to
// L2 before it waits on qkv, each warp takes 8 positions with four lanes to
// a column (attn_common.cuh), and the blocks' softmax states are merged by
// the last to arrive, in a fixed order. Activations live in small scratch
// buffers that stay in L2 and are read with __ldcg (L1 is not coherent
// across SMs).
//
// Gemma's flags (DM_SANDWICH ...): the score softcap and each layer's window
// and rope phases (gemma2 slides on even layers; gemma3 on all but every
// swa_p-th, with its local phases cos_l / sin_l) are the attention item's;
// GeGLU-tanh is the gate/up epilogue's. Sandwich norms need a whole row
// normed before it is added, so the residual is not updated in place: the
// wo and down items store their bf16 outputs (o, d) and each tile's sums of
// squares, and where a whole row is needed next (the x stage of gate/up, of
// the next layer's qkv, of the head) the block folds it in itself: x1 =
// bf16(x + bf16(rms(o) post_norm)), its sums of squares over the whole row,
// then rms(x1) pre_ffn_norm over the item's K range. The epilogues of wo and
// down write the folded residual of their own columns (x of the layer into
// x_out, x1 into xmid), and after the last layer fold items write the x
// that leaves. No grid-wide wait is added inside a layer.
//
// The kernel is a template on BM, the batch rows it holds in registers
// (1, 2, 4 or 8). Each instantiation is compiled in a source of its own,
// decode_model_b<BM>.cu, so that the build compiles them side by side;
// decode_model.cu holds the C entry.
#pragma once

#include "attn_common.cuh"

namespace mnn {

constexpr int DM_CONSUMERS = 256, DM_WARPS = 8, DM_THREADS = DM_CONSUMERS + 32;
constexpr int DM_TILE = 128, DM_MAXB = 8, DM_ATT_SPLIT = 16;
constexpr int DM_UNIT_ROWS = 64;                    // packed rows a unit
constexpr int DM_PACKED_BYTES = DM_UNIT_ROWS * DM_TILE;
// A ring slot: a unit's packed rows, then the scale and bias rows of the
// quant blocks it touches, in pairs (block sr's scale row at DM_PACKED_BYTES +
// 2 sr * 256, its bias row 256 bytes on). A W4/W8 unit touches at most 4
// blocks (10240 bytes a slot); a W2 unit at blocks of 32 (8 packed rows)
// touches 8 and a W3 one (12 rows) 6, so W2/W3 launches take 8 (12288).
__host__ __device__ constexpr int dm_scale_rows(int bits) { return bits < 4 ? 8 : 4; }
__host__ __device__ constexpr int dm_slot_bytes(int bits) {
  return DM_PACKED_BYTES + 2 * dm_scale_rows(bits) * DM_TILE * 2;
}
constexpr int DM_PAIR = 2 * DM_TILE * 2;            // a quant block's scale and bias rows
constexpr int DM_RING_MAX = 12;
// K values an item's x stage holds: as many as fit beside what an attention
// item needs (1 and 2 batch rows), else 1024
template <int BM>
__host__ __device__ constexpr int dm_xs_k() { return BM == 1 ? 4096 : BM == 2 ? 2048 : 1024; }
constexpr int DM_REC = 16, DM_HDR = 32;             // int32 a schedule record, the header
// ints of the table before its records: the header and the blocks' starts
// (grid + 1), rounded up to a record, so that records are 64-byte aligned
__host__ __device__ constexpr int dm_recs_at(int grid) {
  return DM_HDR + (grid + 1 + DM_REC - 1) / DM_REC * DM_REC;
}
constexpr int DM_TAIL = 16 + 2 * DM_REC * 4;        // the stamps' count, the place, two records
constexpr int DM_MAGIC = 0x444D3131;
constexpr int DM_BLOCK_SMEM_2 = 115712, DM_BLOCK_SMEM_1 = 232448;   // 2 or 1 blocks an SM
constexpr int DM_SPIN_MAX = 1 << 25;                // a wait that long means a broken table
constexpr int DM_SUSPEND_NS = 100000;               // an mbarrier wait's suspend hint
constexpr int DM_SM_IDS = 256;                      // SM ids the place claims count
constexpr int DM_FIRST_COUNTER = 1 + 2 + DM_SM_IDS;  // after the wait's word and the claims
// EPI_SAND: a sandwich-normed sublayer's output, stored apart with its sums of squares
enum { EPI_QKV = 0, EPI_RES = 1, EPI_ACT = 2, EPI_HEAD = 3, EPI_SAND = 4 };
// phase kinds (schedule records and the MNN_DM_CLOCKS log)
enum { KD_PRO, KD_QKV, KD_ATT, KD_WO, KD_GU, KD_DN, KD_HEAD, KD_ARGMAX, KD_BAR, KD_FOLD };
// the config's flags (kernels/decode_model.py's model_flags)
enum { DM_SANDWICH = 1, DM_GELU = 2, DM_SOFTCAP = 4, DM_SWA_ALT = 8, DM_SWA_P = 16 };
// fields of a schedule record
enum { R_KIND, R_LAYER, R_TILE, R_U0, R_U1, R_PIECE, R_NPIECES, R_WAIT, R_NWAIT, R_TARGET,
       R_RELEASE, R_MERGE, R_MERGE_LAST, R_PART };
// fields of the header
enum { H_MAGIC, H_GRID, H_SLOTS, H_COUNTERS, H_PART, H_ITEMS, H_NS, H_B, H_L, H_H, H_NQ, H_I,
       H_V, H_BITS, H_HEAD_BITS, H_D, H_FLAGS, H_SWA_P };

struct DmParams {
  const float* x;
  const int* lengths;
  const float *cos, *sin;
  const uint8_t *wqkv_p, *wo_p, *wgu_p, *wdn_p, *head_p;
  const bf16 *wqkv_s, *wqkv_b, *wo_s, *wo_b, *wgu_s, *wgu_b, *wdn_s, *wdn_b, *head_s, *head_b;
  const float *qkv_bias, *in_norm, *post_norm, *q_norm, *k_norm, *final_norm;
  const float *pre_ffn, *post_ffn;   // sandwich norms, or null
  const float *cos_l, *sin_l;        // gemma3's local rope phases, or null
  uint8_t *k_cache, *v_cache;
  float *k_scale, *v_scale;
  float *x_out, *k_rows, *v_rows, *k_sc, *v_sc, *logits;
  int* token;
  const int* sched;          // the schedule table
  // scratch
  float *qkv, *att, *act, *part, *ssq, *best_val, *att_part;
  float *obuf, *dbuf, *xmid, *ssq_o, *ssq_d;   // the sandwich rows and their sums of squares
  int* best_idx;
  unsigned* counters;        // [0] the grid-wide wait's word, the blocks' place
                             // claims, then the arrival counters
  long long* clocks;         // the MNN_DM_CLOCKS log, or null
  int B, L, H, NH, Hkv, D, I, S, V, NQ, DQ;
  int bits, bs_h, bs_i, head_bits, bs_head, kv_bits, window, sink, write_cache;
  int att_split, slots, slot_bytes, work_bytes, n_counters, flags, swa_p;
  float sm_scale, eps, softcap;
};

// ---------------------------------------------------------------------------
// The MNN_DM_CLOCKS log. Built with -DMNN_DM_CLOCKS, thread 0 of every block
// logs clock64() at the kernel's steps into p.clocks, a row of DM_EV_MAX
// int64 a block: entry 0 the count, then one event each, tag << 56 | kind <<
// 52 | layer << 40 | the clock's low 40 bits (EV_START carries the SM's id
// as its layer). The served build carries none of it.
enum { EV_START, EV_BAR_IN, EV_BAR_OUT, EV_ITEM, EV_WEIGHTS, EV_X, EV_PUBLISHED, EV_MERGED,
       EV_DONE, EV_ROWS, EV_PREP, EV_CACHED, EV_WAITED };
#ifdef MNN_DM_CLOCKS
constexpr int DM_EV_MAX = 2048;
// the log's count: the last 16 bytes of the dynamic shared memory, which
// every build reserves, so that the stamps change no occupancy
__device__ __forceinline__ int& dm_ev_count(const DmParams& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  return *reinterpret_cast<int*>(smem + p.slots * (p.slot_bytes + 16) + p.work_bytes);
}
__device__ __forceinline__ void dm_ev(const DmParams& p, int tag, int kind, int layer) {
  if (threadIdx.x == 0 && p.clocks) {
    long long* row = p.clocks + (long)blockIdx.x * DM_EV_MAX;
    int& n = dm_ev_count(p);
    if (n < DM_EV_MAX - 1)
      row[++n] = ((long long)tag << 56) | ((long long)kind << 52) |
                 ((long long)(layer & 0xFFF) << 40) | (clock64() & 0xFFFFFFFFFFLL);
    row[0] = n;
  }
}
#define DM_EV(tag, kind, layer) dm_ev(p, tag, kind, layer)
#else
#define DM_EV(tag, kind, layer) \
  do {                          \
  } while (0)
#endif

// ---------------------------------------------------------------------------
// shared memory: the ring of weight slots, then the work area (a GEMV item's
// reduction and x stage, or an attention item's AttnSmem), then the slots'
// mbarriers

template <int BM>
struct GemvSmem {
  float red[DM_WARPS][BM][DM_TILE];
  float fin[BM][DM_TILE];
  float xs[BM][dm_xs_k<BM>()];
  float rinv[DM_MAXB];
  int flag[4];
};

__host__ __device__ constexpr int dm_round128(int n) { return (n + 127) / 128 * 128; }

// bytes of the work area: the largest of what an item keeps in shared memory
template <int BM>
__host__ __device__ inline int dm_work_bytes(int D) {
  int w = (int)sizeof(GemvSmem<BM>);
  const int a = D == 64    ? (int)sizeof(AttnSmem<64>)
                : D == 128 ? (int)sizeof(AttnSmem<128>)
                           : (int)sizeof(AttnSmem<256>);
  if (a > w) w = a;
  if (2 * DM_CONSUMERS * 4 > w) w = 2 * DM_CONSUMERS * 4;   // the argmax merge
  return dm_round128(w);
}

// ring slots: as many as fit beside the work area (1 block an SM at BM = 8,
// else 2), for the layers' weight bits
template <int BM>
__host__ __device__ inline int dm_ring_slots(int D, int bits) {
  const int budget = BM == 8 ? DM_BLOCK_SMEM_1 : DM_BLOCK_SMEM_2;
  const int s =
      (budget - dm_work_bytes<BM>(D) - 16 * DM_RING_MAX - DM_TAIL) / dm_slot_bytes(bits);
  return s < DM_RING_MAX ? s : DM_RING_MAX;
}

// the ring, the work area, the slots' mbarriers and the tail (the
// MNN_DM_CLOCKS log's count, the block's place, two schedule records)
template <int BM>
__host__ __device__ inline int dm_smem_bytes(int D, int slots, int bits) {
  return slots * dm_slot_bytes(bits) + dm_work_bytes<BM>(D) + 16 * slots + DM_TAIL;
}

// The block's shared memory by part. Each function takes it from the
// `extern __shared__` array itself, so that the compiler knows the state
// space and reads it with shared-memory loads.
struct DmShared {
  unsigned char *ring, *work;
  uint64_t *full, *empty;   // the slots' mbarriers
  int* tail;                // [0] the MNN_DM_CLOCKS log's count, [1] the block's place
  int* recs;                // the consumers' current and next schedule records
};

__device__ __forceinline__ DmShared dm_shared(const DmParams& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  DmShared s;
  s.ring = smem;
  s.work = smem + p.slots * p.slot_bytes;
  s.full = reinterpret_cast<uint64_t*>(s.work + p.work_bytes);
  s.empty = s.full + p.slots;
  s.tail = reinterpret_cast<int*>(s.empty + p.slots);
  s.recs = s.tail + 4;
  return s;
}

// ---------------------------------------------------------------------------
// synchronization

__device__ __forceinline__ unsigned dm_smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the eight consumer warps only (the producer warp runs its own course)
__device__ __forceinline__ void csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(DM_CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(a) : "memory");
  return v;
}

// Thread 0 waits until every one of `n` counters from `c` reaches `target`,
// then the consumers go on together (at once where there is none to wait
// on). A wait that never ends traps.
__device__ __forceinline__ void wait_counters(const unsigned* c, int n, unsigned target) {
  if (n == 0) return;
  if (threadIdx.x == 0)
    for (int i = 0; i < n; ++i) {
      int spins = 0;
      while ((int)(ld_acquire(c + i) - target) < 0) {
        __nanosleep(32);
        if (++spins > DM_SPIN_MAX) __trap();
      }
    }
  csync();
}

// Thread 0 adds one to `c` with release semantics after the consumers'
// barrier, so every consumer thread's earlier stores are visible device-wide
// first (one release add in place of a fence in every thread, then a plain
// add: a trip less).
__device__ __forceinline__ void release_counter(unsigned* c) {
  csync();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(c) : "memory");
}

// A merge's arrival, by thread 0 after the consumers' barrier: releases the
// block's stores and, to the last to arrive, acquires the others' (the
// consumers' next barrier passes that on to every thread).
__device__ __forceinline__ unsigned atom_acq_rel(unsigned* c) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(c) : "memory");
  return old;
}

// The grid-wide wait: block 0 adds 2^31 - (grid - 1), the others 1, so the
// word's top bit flips when the last block arrives and its low bits are as
// before (cooperative groups' grid sync, on the consumer warps only); the
// add releases and the spin's load acquires, so no fence is needed.
__device__ __forceinline__ void grid_wait(unsigned* word) {
  csync();
  if (threadIdx.x == 0) {
    const unsigned add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old;
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;\n"
                 : "=r"(old)
                 : "l"(word), "r"(add)
                 : "memory");
    int spins = 0;
    while (((old ^ ld_acquire(word)) & 0x80000000u) == 0) {
      __nanosleep(32);
      if (++spins > DM_SPIN_MAX) __trap();
    }
  }
  csync();
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(dm_smem_u32(bar)), "r"(count)
               : "memory");
}

// A test first (a slot that is full, as a consumer mostly finds it, costs
// no suspend); then suspended, not spinning, until the phase completes (or
// the hint's time passes): a waiting producer or consumer warp takes no
// issue slots from the warps that compute.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = dm_smem_u32(bar);
  unsigned done;
  int spins = 0;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  if (done) return;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity), "n"(DM_SUSPEND_NS)
        : "memory");
    if (!done && ++spins > DM_SPIN_MAX) __trap();
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(dm_smem_u32(bar)) : "memory");
}

// the slot's mbarrier completes once this lane's earlier cp.async have landed
__device__ __forceinline__ void mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(dm_smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void dm_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dm_smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void dm_cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dm_smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void dm_mma(float (&d)[4], uint32_t a0, uint32_t a2, uint32_t b0,
                                       uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// two f32 (bf16 values) as one word of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t dm_pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// nibbles (bits 0-3 of bytes 0 and 2 of v) as two bf16: 0x43 0x0q is 128 + q,
// less 128 exactly
__device__ __forceinline__ uint32_t dm_nibbles_bf16(uint32_t v) {
  uint32_t w = (v & 0x000F000Fu) | 0x43004300u;
  __nv_bfloat162 b = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&w),
                             __floats2bfloat162_rn(128.f, 128.f));
  return *reinterpret_cast<uint32_t*>(&b);
}

// A quant block's products D (row gq, columns col8 + e of a slot's tile:
// n-tile e % 4, its column pair e / 4) times the block's scales, plus the
// block's rowsum(x) times its biases, into acc.
__device__ __forceinline__ void dm_flush(float (&acc)[8], const float (&d)[4][4], float rsb,
                                         const unsigned char* sl, int srow, int col8) {
  const unsigned char* pair = sl + DM_PACKED_BYTES + srow * DM_PAIR + col8 * 2;
  const uint4 sv = *reinterpret_cast<const uint4*>(pair);
  const uint4 mv = *reinterpret_cast<const uint4*>(pair + DM_TILE * 2);
  const bf16* s8 = reinterpret_cast<const bf16*>(&sv);
  const bf16* m8 = reinterpret_cast<const bf16*>(&mv);
#pragma unroll
  for (int e = 0; e < 8; ++e)
    acc[e] = __fadd_rn(__fadd_rn(acc[e], __fmul_rn(d[e & 3][e >> 2], bf2f(s8[e]))),
                       __fmul_rn(rsb, bf2f(m8[e])));
}

// A slot of the ring: its index and the parity of its current use.
struct RingPos {
  int slot;
  unsigned parity;
  __device__ __forceinline__ void advance(int slots, int n) {
    slot += n;
    while (slot >= slots) {
      slot -= slots;
      parity ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// the GEMVs

struct Gemv {               // one quantized projection of the step
  const float* in;          // [B, K] f32
  const float* norm_w;      // RMS-norm weight [K]; null: the input as it is
  const uint8_t* packed;    // this layer's [K * bits / 8, N]
  const bf16 *scale, *bias;  // [K / bs, N]
  int K, N, bs, bits, epi;
  const float* out_bias;    // EPI_QKV, or null
  float* out;               // QKV: [B, N]; RES: the residual stream [B, N],
                            // updated in place; ACT: [B, N / 2]; HEAD: logits;
                            // SAND: the output rows [B, N]
  int fold;                 // the x stage's input: -1 `in` as it is, else a fold (fold_src)
  int res_fold;             // SAND: the fold its epilogue writes for its columns, or -1
  float* res_dst;           //   into this residual stream [B, N]
  float* ssq_out;           // SAND: the tiles' sums of squares of `out`
  __device__ __forceinline__ int kp() const { return K * bits / 8; }   // packed rows
  __device__ __forceinline__ int rows_per_block() const { return bs * bits / 8; }
  // the K value of packed row r (W4: its low nibble's; the high one's is
  // bs / 2 further; W2/W3: the first of its quant block, whose K values its
  // rows spread over), and one past the last K value of packed rows [.., r1)
  __device__ __forceinline__ int k_lo(int r) const {
    if (bits == 8) return r;
    if (bits < 4) return r / rows_per_block() * bs;
    const int half = bs / 2, kb = r / half;
    return kb * bs + r - kb * half;
  }
  __device__ __forceinline__ int k_end(int r1) const {
    if (bits < 4) return ((r1 - 1) / rows_per_block() + 1) * bs;
    return bits == 8 ? r1 : k_lo(r1 - 1) + bs / 2 + 1;
  }
};

// The folds of a sandwich-normed residual: fold 2l is x1 of layer l, x +
// bf16(rms(o) post_norm); fold 2l + 1 is the x that enters layer l + 1, x1
// + bf16(rms(d) post_ffn_norm). Each reads (base, y, w, per-tile sums of
// squares of y).
struct FoldSrc {
  const float *base, *y, *w, *ssq;
};

__device__ __forceinline__ FoldSrc fold_src(const DmParams& p, int fold) {
  const long l = fold >> 1, H = p.H;
  if ((fold & 1) == 0) return FoldSrc{p.x_out, p.obuf, p.post_norm + l * H, p.ssq_o};
  return FoldSrc{p.xmid, p.dbuf, p.post_ffn + l * H, p.ssq_d};
}

// Row i (column col) of a fold, given its rows' 1 / rms(y): bf16(base +
// bf16(y * rinv * w)), the JAX kernel's rounding points.
__device__ __forceinline__ float fold_at(const FoldSrc& f, long i, int col, float rinv) {
  const float n = round_bf16(__fmul_rn(__fmul_rn(__ldcg(&f.y[i]), rinv), __ldg(&f.w[col])));
  return round_bf16(__fadd_rn(__ldcg(&f.base[i]), n));
}

// 1 / rms of batch rows [0, B) from their per-tile sums of squares over K
// values (tile t, row b at ssq[t * DM_MAXB + b]): warp b, into dst[b].
__device__ __forceinline__ void rows_rinv(const DmParams& p, const float* ssq, int K,
                                          float* dst) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (warp < p.B) {
    float s = 0.f;
    for (int t = lane; t < (K + DM_TILE - 1) / DM_TILE; t += 32)
      s += __ldcg(&ssq[t * DM_MAXB + warp]);
    s = warp_sum(s);
    if (lane == 0) dst[warp] = rsqrtf(s / (float)K + p.eps);
  }
}

__device__ __forceinline__ Gemv gemv_of(const DmParams& p, int kind, int l) {
  const long H = p.H, NQ = p.NQ, I2 = 2L * p.I;
  const long kh = H * p.bits / 8, nbh = H / p.bs_h;
  const bool sw = p.flags & DM_SANDWICH;
  switch (kind) {
    case KD_QKV:
      return Gemv{p.x_out, p.in_norm + l * H, p.wqkv_p + l * kh * NQ, p.wqkv_s + l * nbh * NQ,
                  p.wqkv_b + l * nbh * NQ, p.H, p.NQ, p.bs_h, p.bits, EPI_QKV,
                  p.qkv_bias ? p.qkv_bias + l * NQ : nullptr, p.qkv,
                  sw && l > 0 ? 2 * (l - 1) + 1 : -1, -1, nullptr, nullptr};
    case KD_WO: {
      const long kq = (long)p.DQ * p.bits / 8, nbq = p.DQ / p.bs_h;
      return Gemv{p.att, nullptr, p.wo_p + l * kq * H, p.wo_s + l * nbq * H, p.wo_b + l * nbq * H,
                  p.DQ, p.H, p.bs_h, p.bits, sw ? EPI_SAND : EPI_RES, nullptr,
                  sw ? p.obuf : p.x_out, -1, sw && l > 0 ? 2 * (l - 1) + 1 : -1, p.x_out,
                  p.ssq_o};
    }
    case KD_GU:
      return Gemv{p.x_out, (sw ? p.pre_ffn : p.post_norm) + l * H, p.wgu_p + l * kh * I2,
                  p.wgu_s + l * nbh * I2, p.wgu_b + l * nbh * I2, p.H, (int)I2, p.bs_h, p.bits,
                  EPI_ACT, nullptr, p.act, sw ? 2 * l : -1, -1, nullptr, nullptr};
    case KD_DN: {
      const long ki = (long)p.I * p.bits / 8, nbi = p.I / p.bs_i;
      return Gemv{p.act, nullptr, p.wdn_p + l * ki * H, p.wdn_s + l * nbi * H,
                  p.wdn_b + l * nbi * H, p.I, p.H, p.bs_i, p.bits, sw ? EPI_SAND : EPI_RES,
                  nullptr, sw ? p.dbuf : p.x_out, -1, sw ? 2 * l : -1, p.xmid, p.ssq_d};
    }
    default:   // KD_HEAD
      return Gemv{p.x_out, p.final_norm, p.head_p, p.head_s, p.head_b, p.H, p.V, p.bs_head,
                  p.head_bits, EPI_HEAD, nullptr, p.logits, sw ? 2 * (p.L - 1) + 1 : -1, -1,
                  nullptr, nullptr};
  }
}

__device__ __forceinline__ bool is_gemv(int kind) {
  return kind == KD_QKV || kind == KD_WO || kind == KD_GU || kind == KD_DN || kind == KD_HEAD;
}

// The producer warp: every unit of the block's GEMV items, in list order,
// into the ring.
static __device__ __noinline__ void produce(const DmParams& p, const int* rec, int n_items) {
  const DmShared sh = dm_shared(p);
  unsigned char* ring = sh.ring;
  uint64_t *full = sh.full, *empty = sh.empty;
  const int lane = threadIdx.x & 31;
  RingPos pos{0, 0u};
  for (int it = 0; it < n_items; ++it) {
    const int* r = rec + it * DM_REC;
    const int kind = __ldg(r + R_KIND);
    if (!is_gemv(kind)) continue;
    const Gemv g = gemv_of(p, kind, __ldg(r + R_LAYER));
    const int c0 = __ldg(r + R_TILE) * DM_TILE, u1 = __ldg(r + R_U1);
    const int w = min(DM_TILE, g.N - c0);          // bytes of a packed row in this tile
    const int kp = g.kp(), rpb = g.rows_per_block();
    const bool v16 = (((uintptr_t)g.packed | (unsigned)g.N) & 15) == 0;
    const bool s16 = (((uintptr_t)g.scale | (uintptr_t)g.bias | (unsigned)(2 * g.N)) & 15) == 0;
    // a whole 128-column tile of aligned rows (every tile serving gives it):
    // lane l copies 16-byte chunk l % 8 of rows l / 8, + 4, + 8, ..., and
    // chunk l % 16 of the scale (l < 16) or bias row of each quant block
    const bool whole = v16 && s16 && w == DM_TILE;
    const int fr = lane >> 3, fc = (lane & 7) * 16, which = lane >> 4, sc = (lane & 15) * 16;
    const unsigned char* planes =
        reinterpret_cast<const unsigned char*>((which ? g.bias : g.scale) + c0) + sc;
    for (int u = __ldg(r + R_U0); u < u1; ++u) {
      mbar_wait(empty + pos.slot, pos.parity ^ 1u);
      unsigned char* dst = ring + (long)pos.slot * p.slot_bytes;
      const int r0 = u * DM_UNIT_ROWS, rows = min(DM_UNIT_ROWS, kp - r0);
      const uint8_t* src = g.packed + (long)r0 * g.N + c0;
      const int kb0 = r0 / rpb, nsr = (r0 + rows - 1) / rpb - kb0 + 1;
      if (whole) {
        const uint8_t* s = src + (long)fr * g.N + fc;
        unsigned char* d = dst + fr * DM_TILE + fc;
        for (int row = fr; row < rows; row += 4, s += 4L * g.N, d += 4 * DM_TILE) dm_cp16(d, s);
        const unsigned char* from = planes + (long)kb0 * 2 * g.N;
        unsigned char* to = dst + DM_PACKED_BYTES + which * DM_TILE * 2 + sc;
        for (int sr = 0; sr < nsr; ++sr) dm_cp16(to + sr * DM_PAIR, from + (long)sr * 2 * g.N);
        mbar_arrive_copies(full + pos.slot);
        pos.advance(p.slots, 1);
        continue;
      }
      if (v16) {
        const int per = w / 16;
        for (int i = lane; i < rows * per; i += 32) {
          const int row = i / per, c = i - row * per;
          dm_cp16(dst + row * DM_TILE + c * 16, src + (long)row * g.N + c * 16);
        }
      } else {
        const int per = w / 4;
        for (int i = lane; i < rows * per; i += 32) {
          const int row = i / per, c = i - row * per;
          dm_cp4(dst + row * DM_TILE + c * 4, src + (long)row * g.N + c * 4);
        }
      }
      // the scale rows, then the bias rows, of the quant blocks the unit touches
      const int per = s16 ? 2 * w / 16 : 2 * w / 4;
      for (int i = lane; i < 2 * nsr * per; i += 32) {
        const int which = i / (nsr * per), rem = i - which * nsr * per;
        const int sr = rem / per, c = rem - sr * per;
        const unsigned char* from = reinterpret_cast<const unsigned char*>(
            (which ? g.bias : g.scale) + (long)(kb0 + sr) * g.N + c0);
        unsigned char* to = dst + DM_PACKED_BYTES + sr * DM_PAIR + which * DM_TILE * 2;
        if (s16)
          dm_cp16(to + c * 16, from + c * 16);
        else
          dm_cp4(to + c * 4, from + c * 4);
      }
      mbar_arrive_copies(full + pos.slot);
      pos.advance(p.slots, 1);
    }
  }
}

// An item's x[b, k0 : k0 + nk) into the stage, normalized and rounded to
// bf16, KR values a thread: the norm's weights go out before the item's
// wait (they do not depend on the step); then the rows and (warp b) row b's
// sums of squares, which the norm needs, load together.
template <int BM, int KR>
__device__ __forceinline__ void stage_x(const DmParams& p, const Gemv& g, GemvSmem<BM>& sm,
                                        const int* r, int k0, int nk) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, B = p.B, K = g.K;
  float nw[KR];
  if (g.norm_w) {
#pragma unroll
    for (int j = 0; j < KR; ++j) nw[j] = __ldg(g.norm_w + k0 + min(tid + j * DM_CONSUMERS, nk - 1));
  }
  wait_counters(p.counters + r[R_WAIT], r[R_NWAIT], r[R_TARGET]);
  DM_EV(EV_WAITED, r[R_KIND], r[R_LAYER]);
  if (g.fold >= 0) {
    // A sandwich-normed residual, folded here over the whole row: the rms
    // of its y, then the folded row's sums of squares (a block-wide sum;
    // the reduction area is free until the products), then the stage. The
    // input is always normed (in_norm, pre_ffn_norm or the final norm).
    const FoldSrc f = fold_src(p, g.fold);
    float* tmp = &sm.red[0][0][0];   // [DM_MAXB] 1 / rms(y), then [warp][DM_MAXB] sums
    rows_rinv(p, f.ssq, K, tmp);
    csync();
    float sq[BM];
#pragma unroll
    for (int b = 0; b < BM; ++b) sq[b] = 0.f;
    for (int k = tid; k < K; k += DM_CONSUMERS)
#pragma unroll
      for (int b = 0; b < BM; ++b)
        if (b < B) {
          const float v = fold_at(f, (long)b * K + k, k, tmp[b]);
          sq[b] += v * v;
        }
#pragma unroll
    for (int b = 0; b < BM; ++b) {
      const float s = warp_sum(sq[b]);
      if (lane == 0) tmp[DM_MAXB + warp * DM_MAXB + b] = s;
    }
    csync();
    if (warp < B && lane == 0) {
      float s = 0.f;
      for (int w = 0; w < DM_WARPS; ++w) s += tmp[DM_MAXB + w * DM_MAXB + warp];
      sm.rinv[warp] = rsqrtf(s / (float)K + p.eps);
    }
    csync();
#pragma unroll
    for (int j = 0; j < KR; ++j) {
      const int k = tid + j * DM_CONSUMERS;
      if (k < nk)
#pragma unroll
        for (int b = 0; b < BM; ++b) {
          const float v = b < B ? fold_at(f, (long)b * K + k0 + k, k0 + k, tmp[b]) : 0.f;
          sm.xs[b][k] = round_bf16(__fmul_rn(__fmul_rn(v, sm.rinv[b]), nw[j]));
        }
    }
    return;
  }
  float sq[4] = {0.f, 0.f, 0.f, 0.f};
  const int ht = (K + DM_TILE - 1) / DM_TILE;
  if (g.norm_w && warp < B)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (lane + 32 * j < ht) sq[j] = __ldcg(&p.ssq[(lane + 32 * j) * DM_MAXB + warp]);
  float xv[KR][BM];
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = tid + j * DM_CONSUMERS;
#pragma unroll
    for (int b = 0; b < BM; ++b)
      xv[j][b] = b < B && k < nk ? __ldcg(&g.in[(long)b * K + k0 + k]) : 0.f;
  }
  if (g.norm_w && warp < B) {
    const float s = warp_sum(sq[0] + sq[1] + sq[2] + sq[3]);
    if (lane == 0) sm.rinv[warp] = rsqrtf(s / (float)K + p.eps);
  }
  if (g.norm_w) csync();
#pragma unroll
  for (int j = 0; j < KR; ++j) {
    const int k = tid + j * DM_CONSUMERS;
    if (k < nk)
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        float v = xv[j][b];
        if (g.norm_w) v = __fmul_rn(__fmul_rn(v, sm.rinv[b]), nw[j]);
        sm.xs[b][k] = round_bf16(v);
      }
  }
}

// One GEMV item: units [u0, u1) of one tile, then the merge of the tile's K
// ranges (when it has several) and the phase's epilogue.
template <int BITS, int BM>
__device__ __noinline__ void gemv_item(const DmParams& p, const int* r, RingPos pos) {
  const Gemv g = gemv_of(p, r[R_KIND], r[R_LAYER]);   // in registers
  const DmShared sh = dm_shared(p);
  const unsigned char* ring = sh.ring;
  uint64_t *full = sh.full, *empty = sh.empty;
  GemvSmem<BM>& sm = *reinterpret_cast<GemvSmem<BM>*>(sh.work);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, N = g.N;
  const int kind = r[R_KIND], layer = r[R_LAYER], t = r[R_TILE];
  const int u0 = r[R_U0], u1 = r[R_U1], npieces = r[R_NPIECES];
  const int kp = g.kp(), rpb = g.rows_per_block();
  DM_EV(EV_ITEM, kind, layer);

  // what does not depend on the step goes out before the wait: the norm's
  // weights over this item's K range, the tile's output bias, and (the
  // residual stream stands still since the last grid-wide wait) the
  // residual this tile updates
  const int r0 = u0 * DM_UNIT_ROWS, r1 = min(u1 * DM_UNIT_ROWS, kp);
  const int k0 = g.k_lo(r0), nk = g.k_end(r1) - k0;
  if (nk > dm_xs_k<BM>()) __trap();   // the schedule keeps an item inside the stage
  constexpr int XR = (BM * DM_TILE + DM_CONSUMERS - 1) / DM_CONSUMERS;
  float xr[XR];
#pragma unroll
  for (int i = 0; i < XR; ++i) {
    const int idx = tid + i * DM_CONSUMERS, b = idx / DM_TILE, col = t * DM_TILE + idx % DM_TILE;
    const bool ok = idx < BM * DM_TILE && b < B && col < N;
    xr[i] = 0.f;
    if (ok && g.epi == EPI_RES) xr[i] = __ldcg(&g.out[(long)b * N + col]);
    if (ok && g.epi == EPI_QKV && g.out_bias) xr[i] = __ldg(g.out_bias + col);
  }
  if (nk <= 4 * DM_CONSUMERS)   // a few values a thread: most items
    stage_x<BM, 4>(p, g, sm, r, k0, nk);
  else
    stage_x<BM, dm_xs_k<BM>() / DM_CONSUMERS>(p, g, sm, r, k0, nk);
  csync();
  DM_EV(EV_X, kind, layer);

  const int rpb_sh = (rpb & (rpb - 1)) == 0 ? __ffs(rpb) - 1 : -1;   // a shift for / rpb
  int nred = DM_WARPS;   // the warps' partial sums a column has
  if constexpr (BITS == 4 && BM >= 4) {
    // W4 at 4 or 8 batch rows on the tensor cores (at 1 or 2, the 16-row MMA
    // wastes more than the FMA path spends): warp (cg, kh) takes columns [32cg, 32cg + 32)
    // of the tile and packed rows [32kh, 32kh + 32) of each unit, as 4 k-steps
    // of `mma.m16n8k16` (bf16 x bf16 -> f32; the batch rows are A's rows, so
    // B of up to 8 costs what B = 1 does): a k-step is 8 packed rows, their
    // low nibbles then their high ones (K values klo.., khi.. of one quant
    // block), 4 n-tiles of 8 columns. Lane (gq, tq) gives B its column
    // 32cg + 4gq + j of n-tile j from one 32-bit word a row, and holds D's row
    // gq (the batch row) at 8 columns [32cg + 8tq, + 8). A quant block's D,
    // times its scales, plus rowsum(x) times its biases, goes to f32 `acc`.
    nred = 2;
    const int cg = warp & 3, kh = warp >> 2, gq = lane >> 2, tq = lane & 3;
    const int col8 = 32 * cg + 8 * tq;
    float acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
    for (int u = u0; u < u1; ++u) {
      if (lane == 0) mbar_wait(full + pos.slot, pos.parity);   // one waiter a warp
      __syncwarp();
      if (u == u0) DM_EV(EV_WEIGHTS, kind, layer);
      const unsigned char* sl = ring + (long)pos.slot * p.slot_bytes;
      const int kb_u = rpb_sh >= 0 ? (u * DM_UNIT_ROWS) >> rpb_sh : u * DM_UNIT_ROWS / rpb;
      float d[4][4], rsb = 0.f;
      int srow = -1;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int lr = 32 * kh + 8 * ks, pr = u * DM_UNIT_ROWS + lr;
        if (pr >= kp) break;   // the same for the whole warp
        const int kb = rpb_sh >= 0 ? pr >> rpb_sh : pr / rpb;
        if (kb - kb_u != srow) {
          if (srow >= 0) dm_flush(acc, d, rsb, sl, srow, col8);
          srow = kb - kb_u;
          rsb = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) d[j][e] = 0.f;
        }
        const int klo = kb * g.bs + pr - kb * rpb - k0 + 2 * tq, khi = klo + g.bs / 2;
        uint32_t a0 = 0u, a2 = 0u;
        float xsum = 0.f;
        if (gq < B) {
          const float2 xa = *reinterpret_cast<const float2*>(&sm.xs[gq][klo]);
          const float2 xb = *reinterpret_cast<const float2*>(&sm.xs[gq][khi]);
          a0 = dm_pack_bf16(xa.x, xa.y);
          a2 = dm_pack_bf16(xb.x, xb.y);
          xsum = (xa.x + xa.y) + (xb.x + xb.y);
        }
        xsum += __shfl_xor_sync(0xffffffffu, xsum, 1);   // the k-step's 16 values of row gq
        xsum += __shfl_xor_sync(0xffffffffu, xsum, 2);
        rsb += xsum;
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(
            sl + (lr + 2 * tq) * DM_TILE + 32 * cg + 4 * gq);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(
            sl + (lr + 2 * tq + 1) * DM_TILE + 32 * cg + 4 * gq);
        const uint32_t w0h = w0 >> 4, w1h = w1 >> 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t sel = j | (j << 4) | ((j + 4) << 8) | ((j + 4) << 12);
          dm_mma(d[j], a0, a2, dm_nibbles_bf16(__byte_perm(w0, w1, sel)),
                 dm_nibbles_bf16(__byte_perm(w0h, w1h, sel)));
        }
      }
      if (srow >= 0) dm_flush(acc, d, rsb, sl, srow, col8);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos.slot);
      pos.advance(p.slots, 1);
    }
    if (gq < BM)
#pragma unroll
      for (int e = 0; e < 8; ++e) sm.red[kh][gq][col8 + e] = acc[e];
  } else if constexpr (BITS < 4) {
    // W2/W3 on the FMA units: warp w takes packed rows [8w, 8w + 8) of each
    // unit as two groups of 4, each inside one quant block and one plane (a
    // W2 block is bs/4 rows; a W3 block bs/4 rows of its 2-bit plane, then
    // bs/8 of its 1-bit plane; bs % 32 == 0 makes all of them multiples of
    // 4). A 2-bit row j holds K values j + m bs/4 (bit pair 2m) and counts
    // them into the row sum; a 1-bit row j holds K values j + m bs/8 (bit m),
    // weighted 4, and adds nothing to the row sum: the 2-bit plane covers
    // every K value of the block once, and q = lo + 4 hi is linear in the
    // partial product, so the planes are summed apart.
    const int c0 = t * DM_TILE + lane * 4;
    const int q4 = g.bs >> 2, e8 = g.bs >> 3;
    float acc[BM][4];
#pragma unroll
    for (int b = 0; b < BM; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
    for (int u = u0; u < u1; ++u) {
      if (lane == 0) mbar_wait(full + pos.slot, pos.parity);   // one waiter a warp
      __syncwarp();
      if (u == u0) DM_EV(EV_WEIGHTS, kind, layer);
      const unsigned char* sl = ring + (long)pos.slot * p.slot_bytes;
      const int kb_u = u * DM_UNIT_ROWS / rpb;
#pragma unroll
      for (int hg = 0; hg < 2; ++hg) {
        const int lr = warp * 8 + 4 * hg, pr = u * DM_UNIT_ROWS + lr;
        if (pr >= kp) break;                         // the same for the whole warp
        const int kb = pr / rpb, ri = pr - kb * rpb, srow = kb - kb_u;
        const bool hi = BITS == 3 && ri >= q4;       // a row of the 1-bit plane
        const int kx = kb * g.bs - k0;               // the block's first K value in the stage
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(sl + (lr + i) * DM_TILE + lane * 4);
        const unsigned char* pair = sl + DM_PACKED_BYTES + srow * DM_PAIR + lane * 8;
        const uint2 sv = *reinterpret_cast<const uint2*>(pair);
        const uint2 bv = *reinterpret_cast<const uint2*>(pair + DM_TILE * 2);
        float part[BM][4], rs[BM];
#pragma unroll
        for (int b = 0; b < BM; ++b) {
          rs[b] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) part[b][j] = 0.f;
        }
        if (!hi) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 4; ++m) {
              const uint32_t v = (w[i] >> (2 * m)) & 0x03030303u;
              float q[4];   // the bytes as f32: 0x4B0000qq is 2^23 + qq
#pragma unroll
              for (int j = 0; j < 4; ++j)
                q[j] = __uint_as_float(__byte_perm(v, 0x4B00u, 0x5440 + j)) - 8388608.f;
#pragma unroll
              for (int b = 0; b < BM; ++b) {
                const float xa = sm.xs[b][kx + ri + i + m * q4];
                rs[b] += xa;
#pragma unroll
                for (int j = 0; j < 4; ++j) part[b][j] = fmaf(xa, q[j], part[b][j]);
              }
            }
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int m = 0; m < 8; ++m) {
              const uint32_t v = (w[i] >> m) & 0x01010101u;
              float q[4];
#pragma unroll
              for (int j = 0; j < 4; ++j)
                q[j] = __uint_as_float(__byte_perm(v, 0x4B00u, 0x5440 + j)) - 8388608.f;
#pragma unroll
              for (int b = 0; b < BM; ++b) {
                const float xa = 4.f * sm.xs[b][kx + ri - q4 + i + m * e8];
#pragma unroll
                for (int j = 0; j < 4; ++j) part[b][j] = fmaf(xa, q[j], part[b][j]);
              }
            }
        }
        if (c0 < N) {
          const bf16* s2 = reinterpret_cast<const bf16*>(&sv);
          const bf16* m2 = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float s = bf2f(s2[j]), m = bf2f(m2[j]);
#pragma unroll
            for (int b = 0; b < BM; ++b)
              acc[b][j] = __fadd_rn(__fadd_rn(acc[b][j], __fmul_rn(part[b][j], s)),
                                    __fmul_rn(rs[b], m));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos.slot);
      pos.advance(p.slots, 1);
    }
#pragma unroll
    for (int b = 0; b < BM; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.red[warp][b][lane * 4 + j] = acc[b][j];
  } else {
    // On the FMA units: warp w takes packed rows [8w, 8w + 8) of each unit
    // (W4: 16 K values, the rows' low nibbles and their high ones; W8: 8), a
    // lane its 4 adjacent columns as one 32-bit word a row, x by broadcast
    // from the stage
    const int c0 = t * DM_TILE + lane * 4;
    float acc[BM][4];
#pragma unroll
    for (int b = 0; b < BM; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
    for (int u = u0; u < u1; ++u) {
      if (lane == 0) mbar_wait(full + pos.slot, pos.parity);   // one waiter a warp
      __syncwarp();
      if (u == u0) DM_EV(EV_WEIGHTS, kind, layer);
      const unsigned char* sl = ring + (long)pos.slot * p.slot_bytes;
      const int pr = u * DM_UNIT_ROWS + warp * 8;    // this warp's first packed row
      if (pr < kp) {                                 // the same for the whole warp
        // the quant block of these rows and its row in the slot
        const int kb = rpb_sh >= 0 ? pr >> rpb_sh : pr / rpb;
        const int srow = kb - (rpb_sh >= 0 ? (u * DM_UNIT_ROWS) >> rpb_sh : u * DM_UNIT_ROWS / rpb);
        // the K value of the first row (W4: of its low nibble; the high one's
        // is bs / 2 on)
        const int klo = (BITS == 4 ? kb * g.bs + pr - kb * rpb : pr) - k0, khi = klo + g.bs / 2;
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(sl + (warp * 8 + i) * DM_TILE + lane * 4);
        const unsigned char* pair = sl + DM_PACKED_BYTES + srow * DM_PAIR + lane * 8;
        const uint2 sv = *reinterpret_cast<const uint2*>(pair);
        const uint2 bv = *reinterpret_cast<const uint2*>(pair + DM_TILE * 2);
        float part[BM][4], rs[BM];
#pragma unroll
        for (int b = 0; b < BM; ++b) {
          rs[b] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) part[b][j] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          // bytes (W4: nibbles) as f32 by the exponent trick: 0x4B0000qq is 2^23 + qq
          if constexpr (BITS == 4) {
            const uint32_t lo4 = w[i] & 0x0F0F0F0Fu, hi4 = (w[i] >> 4) & 0x0F0F0F0Fu;
            float lo[4], hi[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              lo[j] = __uint_as_float(__byte_perm(lo4, 0x4B00u, 0x5440 + j)) - 8388608.f;
              hi[j] = __uint_as_float(__byte_perm(hi4, 0x4B00u, 0x5440 + j)) - 8388608.f;
            }
#pragma unroll
            for (int b = 0; b < BM; ++b) {
              const float xa = sm.xs[b][klo + i], xb = sm.xs[b][khi + i];
              rs[b] += xa + xb;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                part[b][j] = fmaf(xb, hi[j], fmaf(xa, lo[j], part[b][j]));
            }
          } else {
            float q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j)
              q[j] = __uint_as_float(__byte_perm(w[i], 0x4B00u, 0x5440 + j)) - 8388608.f;
#pragma unroll
            for (int b = 0; b < BM; ++b) {
              const float xa = sm.xs[b][klo + i];
              rs[b] += xa;
#pragma unroll
              for (int j = 0; j < 4; ++j) part[b][j] = fmaf(xa, q[j], part[b][j]);
            }
          }
        }
        if (c0 < N) {
          const bf16* s2 = reinterpret_cast<const bf16*>(&sv);
          const bf16* m2 = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float s = bf2f(s2[j]), m = bf2f(m2[j]);
#pragma unroll
            for (int b = 0; b < BM; ++b)
              acc[b][j] = __fadd_rn(__fadd_rn(acc[b][j], __fmul_rn(part[b][j], s)),
                                    __fmul_rn(rs[b], m));
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + pos.slot);
      pos.advance(p.slots, 1);
    }
#pragma unroll
    for (int b = 0; b < BM; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) sm.red[warp][b][lane * 4 + j] = acc[b][j];
  }
  csync();
  for (int idx = tid; idx < BM * DM_TILE; idx += DM_CONSUMERS) {
    const int b = idx / DM_TILE, c = idx - b * DM_TILE;
    float v = 0.f;
    for (int w = 0; w < nred; ++w) v += sm.red[w][b][c];
    sm.fin[b][c] = v;
  }

  if (npieces > 1) {
    // the tile's K ranges meet in device memory; the last block to arrive
    // adds them in the order of the ranges
    float* part = p.part + r[R_PART];
    const int piece = r[R_PIECE];
    for (int idx = tid; idx < BM * DM_TILE; idx += DM_CONSUMERS) {
      const int b = idx / DM_TILE, c = idx - b * DM_TILE, col = t * DM_TILE + c;
      if (b < B && col < N) __stcg(&part[((long)piece * B + b) * N + col], sm.fin[b][c]);
    }
    csync();
    if (tid == 0)   // npieces arrivals a layer: the counter rises through the layers
      sm.flag[0] = atom_acq_rel(p.counters + r[R_MERGE]) == (unsigned)r[R_MERGE_LAST];
    csync();
    DM_EV(EV_PUBLISHED, kind, layer);
    if (!sm.flag[0]) {
      csync();   // the work area is reused by the next item
      return;
    }
    for (int idx = tid; idx < BM * DM_TILE; idx += DM_CONSUMERS) {
      const int b = idx / DM_TILE, c = idx - b * DM_TILE, col = t * DM_TILE + c;
      sm.fin[b][c] =
          b < B && col < N ? sum_ldcg(part + (long)b * N + col, (long)B * N, npieces) : 0.f;
    }
    DM_EV(EV_MERGED, kind, layer);
  }
  csync();

  if (g.epi == EPI_QKV) {
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const int idx = tid + i * DM_CONSUMERS, b = idx / DM_TILE, c = idx % DM_TILE;
      const int col = t * DM_TILE + c;
      if (idx >= BM * DM_TILE || b >= B || col >= N) continue;
      float v = sm.fin[b][c];
      if (g.out_bias) v = __fadd_rn(v, xr[i]);
      __stcg(&g.out[(long)b * N + col], round_bf16(v));
    }
  } else if (g.epi == EPI_RES) {
    // x <- bf16(x + bf16(y)), and the tile's sum of squares of the new x
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const int idx = tid + i * DM_CONSUMERS, b = idx / DM_TILE, c = idx % DM_TILE;
      const int col = t * DM_TILE + c;
      if (idx >= BM * DM_TILE) continue;
      float nx = 0.f;
      if (b < B && col < N) {
        nx = round_bf16(__fadd_rn(xr[i], round_bf16(sm.fin[b][c])));
        __stcg(&g.out[(long)b * N + col], nx);
      }
      sm.fin[b][c] = nx;
    }
    csync();
    for (int b = warp; b < B; b += DM_WARPS) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = sm.fin[b][lane * 4 + j];
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) __stcg(&p.ssq[t * DM_MAXB + b], s);
    }
  } else if (g.epi == EPI_SAND) {
    // out <- bf16(y), the tile's sums of squares of it; then the folded
    // residual of these columns (res_fold), which nothing reads before the
    // next grid-wide wait
#pragma unroll
    for (int i = 0; i < XR; ++i) {
      const int idx = tid + i * DM_CONSUMERS, b = idx / DM_TILE, c = idx % DM_TILE;
      const int col = t * DM_TILE + c;
      if (idx >= BM * DM_TILE) continue;
      float v = 0.f;
      if (b < B && col < N) {
        v = round_bf16(sm.fin[b][c]);
        __stcg(&g.out[(long)b * N + col], v);
      }
      sm.fin[b][c] = v;
    }
    csync();
    for (int b = warp; b < B; b += DM_WARPS) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = sm.fin[b][lane * 4 + j];
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) __stcg(&g.ssq_out[t * DM_MAXB + b], s);
    }
    if (g.res_fold >= 0) {
      const FoldSrc f = fold_src(p, g.res_fold);
      rows_rinv(p, f.ssq, N, sm.rinv);
      csync();
      for (int idx = tid; idx < B * DM_TILE; idx += DM_CONSUMERS) {
        const int b = idx / DM_TILE, col = t * DM_TILE + idx % DM_TILE;
        if (col < N) __stcg(&g.res_dst[(long)b * N + col], fold_at(f, (long)b * N + col, col,
                                                                   sm.rinv[b]));
      }
    }
  } else if (g.epi == EPI_ACT) {
    // the tile holds 64 gate columns, then their 64 up columns; silu, or
    // (DM_GELU) gelu's tanh form as jax.nn.gelu(approximate=True) writes it
    const bool gelu = p.flags & DM_GELU;
    for (int idx = tid; idx < BM * (DM_TILE / 2); idx += DM_CONSUMERS) {
      const int b = idx / (DM_TILE / 2), c = idx - b * (DM_TILE / 2);
      if (b >= B) continue;
      const float gate = round_bf16(sm.fin[b][c]);
      const float up = round_bf16(sm.fin[b][c + DM_TILE / 2]);
      const float si =
          gelu ? round_bf16(gate * (0.5f * (1.f + tanhf(0.7978845608028654f *
                                                         (gate + 0.044715f * (gate * gate * gate))))))
               : round_bf16(__fmul_rn(gate, 1.f / (1.f + expf(-gate))));
      __stcg(&g.out[(long)b * (N / 2) + t * (DM_TILE / 2) + c], round_bf16(__fmul_rn(si, up)));
    }
  } else {   // EPI_HEAD: f32 logits, and the tile's (max, lowest index)
    const int ntiles = (N + DM_TILE - 1) / DM_TILE;
    for (int idx = tid; idx < BM * DM_TILE; idx += DM_CONSUMERS) {
      const int b = idx / DM_TILE, c = idx - b * DM_TILE, col = t * DM_TILE + c;
      if (b < B && col < N) g.out[(long)b * N + col] = sm.fin[b][c];
    }
    for (int b = warp; b < B; b += DM_WARPS) {
      float bv = -INFINITY;
      int bi = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t * DM_TILE + lane * 4 + j;
        const float v = sm.fin[b][lane * 4 + j];
        if (col < N && v > bv) {
          bv = v;
          bi = col;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        __stcg(&p.best_val[b * ntiles + t], bv);
        __stcg(&p.best_idx[b * ntiles + t], bi);
      }
    }
  }
  const int rel = r[R_RELEASE];
  if (rel >= 0)
    release_counter(p.counters + rel);
  else
    csync();   // the work area is reused by the next item
  DM_EV(EV_DONE, kind, layer);
}

// ---------------------------------------------------------------------------
// attention

// Rope, QK-norm, quantization of the new K/V row, the seeded softmax over
// the cached positions [0, len_old) of `layer`, for one (batch row, KV head)
// and one split of its positions: split s of ns takes the 8-column steps
// (i * ns + s) * 8 + warp, and the last of the ns blocks to arrive merges
// their softmax states with the new token's seed. ns follows the row's
// length (one block per 64 positions), read from device memory.
template <int D, int KVB>
__device__ __noinline__ void attn_item(const DmParams& p, const int* r) {
  AttnSmem<D>& sm = *reinterpret_cast<AttnSmem<D>*>(dm_shared(p).work);
  constexpr bool QUANT = KVB < 16;
  constexpr int DP = D / 32, ROWB = D * KVB / 8, DS = KVB == 4 ? D / 2 : D;
  constexpr int STATE = D + 2;   // a block's merged state per query row: acc, m, l
  constexpr int SECT = (ROWB + 31) / 32;   // 32-byte sectors of a cached row
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = p.NH / p.Hkv, B = p.B, Hkv = p.Hkv, S = p.S, NS = p.att_split;
  const int layer = r[R_LAYER], bh = r[R_TILE], split = r[R_U0];
  const int b = bh / Hkv, hi = bh - b * Hkv;
  const float* q_norm = p.q_norm ? p.q_norm + (long)layer * D : nullptr;
  const float* k_norm = p.k_norm ? p.k_norm + (long)layer * D : nullptr;
  const int len_old = p.lengths[b];
  const int limit = min(max(len_old, 0), S);
  // the layer's window and rope phases: gemma2 slides on even layers, gemma3
  // on all but every swa_p-th, with its local phases
  const bool local = p.swa_p > 0 && (layer + 1) % p.swa_p != 0;
  int win = p.window;
  if (p.flags & DM_SWA_ALT) win = layer % 2 == 0 ? p.window : 0;
  else if (p.swa_p > 0) win = local ? p.window : 0;
  const float* cosp = local ? p.cos_l : p.cos;
  const float* sinp = local ? p.sin_l : p.sin;
  const int ns = max(1, min(NS, (limit + AT_WARPS * AT_CW - 1) / (AT_WARPS * AT_CW)));
  if (split >= ns) return;   // the same for the whole block
  DM_EV(EV_ITEM, KD_ATT, layer);

  // this block's cached K and V rows go to L2 while qkv is being made
  const long base = ((long)(layer * B + b) * Hkv + hi) * S;
  for (int i = threadIdx.x; i < AT_WARPS * AT_CW * 2 * SECT; i += DM_CONSUMERS) {
    const int cl = i / (2 * SECT), rem = i - cl * 2 * SECT;
    const uint8_t* cache = rem < SECT ? p.k_cache : p.v_cache;
    const int sect = rem < SECT ? rem : rem - SECT;
    for (int c = split * AT_WARPS * AT_CW + cl; c < limit; c += ns * AT_WARPS * AT_CW)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(cache + (base + c) * ROWB + sect * 32));
  }
  if (QUANT && threadIdx.x < 2 * AT_WARPS * AT_CW / 8)   // their scales, 8 a sector
    for (int c = split * AT_WARPS * AT_CW + (threadIdx.x >> 1) * 8; c < limit;
         c += ns * AT_WARPS * AT_CW)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"((threadIdx.x & 1 ? p.v_scale : p.k_scale) +
                                                      base + c));
  float cs[DP], sn[DP];   // this lane's rope phases, on their way before the wait
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    cs[j] = __ldg(&cosp[b * D + lane * DP + j]);
    sn[j] = __ldg(&sinp[b * D + lane * DP + j]);
  }
  wait_counters(p.counters + r[R_WAIT], r[R_NWAIT], r[R_TARGET]);
  DM_EV(EV_WAITED, KD_ATT, layer);

  const int R = G + 2;
  for (int i = threadIdx.x; i < R * D; i += DM_CONSUMERS)
    sm.rows[i / D][i % D] = __ldcg(&p.qkv[(long)b * p.NQ + (long)hi * R * D + i]);
  csync();
  DM_EV(EV_ROWS, KD_ATT, layer);

  // QK-norm + rope on the G query rows and the K row, one warp per row;
  // q stays f32 afterwards
  for (int rr = warp; rr <= G; rr += AT_WARPS) {
    float x[DP];
#pragma unroll
    for (int j = 0; j < DP; ++j) x[j] = sm.rows[rr][lane * DP + j];
    const float* nw = rr < G ? q_norm : k_norm;
    if (nw) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) ss += x[j] * x[j];
      const float rinv = rsqrtf(warp_sum(ss) / D + p.eps);
#pragma unroll
      for (int j = 0; j < DP; ++j) x[j] = __fmul_rn(__fmul_rn(x[j], rinv), nw[lane * DP + j]);
    }
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int d = lane * DP + j;
      const float partner = __shfl_xor_sync(0xffffffffu, x[j], 16);   // dim d +- D/2
      const float rot = d < D / 2 ? -partner : partner;
      sm.rows[rr][d] = __fadd_rn(__fmul_rn(x[j], cs[j]), __fmul_rn(rot, sn[j]));
    }
  }
  csync();

  // the new K (warp 0) and V (warp 1) rows: as the cache stores them, and
  // as attention sees them (the dequantized round trip)
  if (warp < 2) {
    const float* src = sm.rows[G + warp];
    float x[DP], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      x[j] = src[lane * DP + j];
      amax = fmaxf(amax, fabsf(x[j]));
    }
    amax = warp_max(amax);
    constexpr float QMAX = KVB == 4 ? 7.f : 127.f;
    const float sc = amax == 0.f ? 1.f : amax / QMAX;
    float* att_dst = warp == 0 ? sm.katt : sm.vatt;
    float* row_dst = warp == 0 ? sm.krow : sm.vrow;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int d = lane * DP + j;
      float qv, av;
      if (QUANT) {
        qv = fminf(fmaxf(rintf(x[j] / sc), -QMAX - 1.f), QMAX);
        av = qv * sc;
      } else {
        qv = av = round_bf16(x[j]);
      }
      att_dst[d] = av;
      if (KVB == 4) {
        // byte d = (q[d] + 8) | (q[d + D/2] + 8) << 4, wrapped to signed
        const float qh = __shfl_down_sync(0xffffffffu, qv, 16);
        if (lane < 16) {
          const int byte = ((int)qv + 8) | (((int)qh + 8) << 4);
          row_dst[d] = (float)(byte > 127 ? byte - 256 : byte);
        }
      } else {
        row_dst[d] = qv;
      }
    }
    if (lane == 0) sm.new_sc[warp] = sc;
  }
  csync();

  // the new token's score: always visible
  for (int gq = warp; gq < G; gq += AT_WARPS) {
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) dot += sm.rows[gq][lane * DP + j] * sm.katt[lane * DP + j];
    float s = warp_sum(dot) * p.sm_scale;
    if (p.softcap > 0.f) s = tanhf(s / p.softcap) * p.softcap;
    if (lane == 0) sm.seed[gq] = s;
  }
  DM_EV(EV_PREP, KD_ATT, layer);

  constexpr int GM = at_gmax<D>();
  float m[GM], l[GM], acc[GM][DP];
  attend_cached<D, KVB, false>(
      sm.rows, G, p.k_cache + base * ROWB, p.v_cache + base * ROWB,
      QUANT ? p.k_scale + base : nullptr, QUANT ? p.v_scale + base : nullptr,
      (split * AT_WARPS + warp) * AT_CW, ns * AT_WARPS * AT_CW, limit, len_old - win, win > 0,
      p.sink, p.sm_scale, p.softcap, sm.pv[warp], lane, m, l, acc);
  park_state<D, KVB>(sm, G, warp, lane, m, l, acc);
  csync();
  DM_EV(EV_CACHED, KD_ATT, layer);

  bool last = true;
  float* mine = p.att_part + ((long)bh * NS + split) * AT_GMAX * STATE;
  if (ns > 1) {
    // this block's warps merged into one state per query row, published;
    // the last block of the (row, head) to arrive merges them all
    for (int i = threadIdx.x; i < G * D; i += DM_CONSUMERS) {
      const int gq = i / D, d = i - gq * D;
      float mx = NEG_INF;
      for (int w = 0; w < AT_WARPS; ++w) mx = fmaxf(mx, sm.m[w][gq]);
      float Lsum = 0.f, A = 0.f;
      for (int w = 0; w < AT_WARPS; ++w) {
        const float e = expf(sm.m[w][gq] - mx);
        Lsum += sm.l[w][gq] * e;
        A += sm.acc[w][gq][d] * e;
      }
      __stcg(&mine[gq * STATE + d], A);
      if (d == 0) {
        __stcg(&mine[gq * STATE + D], mx);
        __stcg(&mine[gq * STATE + D + 1], Lsum);
      }
    }
    csync();
    if (threadIdx.x == 0)
      sm.flag = atom_acq_rel(p.counters + r[R_MERGE]) == (unsigned)((layer + 1) * ns - 1);
    csync();
    last = sm.flag != 0;
    DM_EV(EV_PUBLISHED, KD_ATT, layer);
  }
  if (last) {
    const float* all = p.att_part + (long)bh * NS * AT_GMAX * STATE;
    for (int i = threadIdx.x; i < G * D; i += DM_CONSUMERS) {
      const int gq = i / D, d = i - gq * D;
      float mx = sm.seed[gq];
      float Lsum, A;
      if (ns > 1) {
        float mk[DM_ATT_SPLIT], lk[DM_ATT_SPLIT], ak[DM_ATT_SPLIT];   // all loads go out first
#pragma unroll
        for (int k = 0; k < DM_ATT_SPLIT; ++k) {
          const float* st = all + (k * AT_GMAX + gq) * STATE;
          mk[k] = k < ns ? __ldcg(&st[D]) : NEG_INF;
          lk[k] = k < ns ? __ldcg(&st[D + 1]) : 0.f;
          ak[k] = k < ns ? __ldcg(&st[d]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < DM_ATT_SPLIT; ++k) mx = fmaxf(mx, mk[k]);
        const float e0 = expf(sm.seed[gq] - mx);
        Lsum = e0;
        A = sm.vatt[d] * e0;
#pragma unroll
        for (int k = 0; k < DM_ATT_SPLIT; ++k) {
          const float e = expf(mk[k] - mx);
          Lsum += lk[k] * e;
          A += ak[k] * e;
        }
      } else {
        for (int w = 0; w < AT_WARPS; ++w) mx = fmaxf(mx, sm.m[w][gq]);
        const float e0 = expf(sm.seed[gq] - mx);
        Lsum = e0;
        A = sm.vatt[d] * e0;
        for (int w = 0; w < AT_WARPS; ++w) {
          const float e = expf(sm.m[w][gq] - mx);
          Lsum += sm.l[w][gq] * e;
          A += sm.acc[w][gq][d] * e;
        }
      }
      if (Lsum == 0.f) Lsum = 1.f;
      __stcg(&p.att[(long)b * p.DQ + ((long)hi * G + gq) * D + d], A / Lsum);
    }
    // the stored rows go out, and into the cache at the clamped length:
    // every block of this (row, head) has read its columns by now
    const long orow = ((long)layer * B * Hkv + bh) * DS;
    const int pos = min(max(len_old, 0), S - 1);
    for (int i = threadIdx.x; i < DS; i += DM_CONSUMERS) {
      p.k_rows[orow + i] = sm.krow[i];
      p.v_rows[orow + i] = sm.vrow[i];
      if (p.write_cache) {
        const long at = (base + pos) * DS + i;
        if (KVB == 16) {
          reinterpret_cast<bf16*>(p.k_cache)[at] = __float2bfloat16_rn(sm.krow[i]);
          reinterpret_cast<bf16*>(p.v_cache)[at] = __float2bfloat16_rn(sm.vrow[i]);
        } else {
          reinterpret_cast<int8_t*>(p.k_cache)[at] = (int8_t)(int)sm.krow[i];
          reinterpret_cast<int8_t*>(p.v_cache)[at] = (int8_t)(int)sm.vrow[i];
        }
      }
    }
    if (QUANT && threadIdx.x == 0) {
      p.k_sc[(long)layer * B * Hkv + bh] = sm.new_sc[0];
      p.v_sc[(long)layer * B * Hkv + bh] = sm.new_sc[1];
      if (p.write_cache) {
        p.k_scale[base + pos] = sm.new_sc[0];
        p.v_scale[base + pos] = sm.new_sc[1];
      }
    }
    release_counter(p.counters + r[R_RELEASE]);
  } else {
    csync();   // shared memory is reused by the next item
  }
  DM_EV(EV_DONE, KD_ATT, layer);
}

__device__ __forceinline__ void run_attn(const DmParams& p, const int* r) {
#define MNN_DM_ATT(DD, KK) \
  if (p.D == DD && p.kv_bits == KK) return attn_item<DD, KK>(p, r);
  MNN_DM_ATT(64, 16)
  MNN_DM_ATT(64, 8)
  MNN_DM_ATT(64, 4)
  MNN_DM_ATT(128, 16)
  MNN_DM_ATT(128, 8)
  MNN_DM_ATT(128, 4)
  MNN_DM_ATT(256, 16)   // gemma: an int8 or bf16 cache (int4 takes the eager path)
  MNN_DM_ATT(256, 8)
#undef MNN_DM_ATT
}

// After the last layer of a sandwich-normed config: tile t of the residual
// stream that leaves, x1 + bf16(rms(d) post_ffn_norm), into x_out.
static __device__ __noinline__ void fold_item(const DmParams& p, int t) {
  float* rinv = reinterpret_cast<float*>(dm_shared(p).work);   // [DM_MAXB]
  const FoldSrc f = fold_src(p, 2 * (p.L - 1) + 1);
  rows_rinv(p, f.ssq, p.H, rinv);
  csync();
  for (int idx = threadIdx.x; idx < p.B * DM_TILE; idx += DM_CONSUMERS) {
    const int b = idx / DM_TILE, col = t * DM_TILE + idx % DM_TILE;
    if (col < p.H) p.x_out[(long)b * p.H + col] = fold_at(f, (long)b * p.H + col, col, rinv[b]);
  }
  csync();   // the work area is reused by the next item
}

// merge the head tiles' (max, lowest index) of batch row b into its token
static __device__ __noinline__ void argmax_item(const DmParams& p, int b) {
  float* bv_s = reinterpret_cast<float*>(dm_shared(p).work);   // [DM_CONSUMERS]
  int* bi_s = reinterpret_cast<int*>(bv_s + DM_CONSUMERS);
  const int tid = threadIdx.x, ntiles = (p.V + DM_TILE - 1) / DM_TILE;
  float bv = -INFINITY;
  int bi = 0x7fffffff;
  for (int t = tid; t < ntiles; t += DM_CONSUMERS) {
    const float v = __ldcg(&p.best_val[b * ntiles + t]);
    const int i = __ldcg(&p.best_idx[b * ntiles + t]);
    if (v > bv || (v == bv && i < bi)) {
      bv = v;
      bi = i;
    }
  }
  bv_s[tid] = bv;
  bi_s[tid] = bi;
  csync();
  for (int o = DM_CONSUMERS / 2; o > 0; o >>= 1) {
    if (tid < o) {
      const float ov = bv_s[tid + o];
      const int oi = bi_s[tid + o];
      if (ov > bv_s[tid] || (ov == bv_s[tid] && oi < bi_s[tid])) {
        bv_s[tid] = ov;
        bi_s[tid] = oi;
      }
    }
    csync();
  }
  if (tid == 0) p.token[b] = bi_s[0];
  csync();
}

template <int BM>
__device__ __forceinline__ void run_gemv(const DmParams& p, const int* r, RingPos pos) {
  const int kind = r[R_KIND], bits = kind == KD_HEAD ? p.head_bits : p.bits;
  if (bits == 4)
    gemv_item<4, BM>(p, r, pos);
  else if (bits == 8)
    gemv_item<8, BM>(p, r, pos);
  else if (bits == 3)
    gemv_item<3, BM>(p, r, pos);
  else
    gemv_item<2, BM>(p, r, pos);
}

template <int BM>
__global__ void __launch_bounds__(DM_THREADS, BM == 8 ? 1 : 2)
decode_model_kernel(const __grid_constant__ DmParams p) {
  const DmShared sh = dm_shared(p);
  uint64_t *full = sh.full, *empty = sh.empty;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, H = p.H;
  // The block's place in the schedule: the first block to start on an SM
  // takes the next place from 0 up, a second one the next from the grid's
  // end down. So places [0, SMs) stand on distinct SMs, which is where the
  // schedule puts a phase's items first. `claims` (after the grid-wide
  // wait's word, before the arrival counters, at the same place for every
  // table) is zeroed by block 0 after the first grid-wide wait.
  unsigned* claims = p.counters + 1;   // rank 0, rank 1, then one an SM
  int* tail = sh.tail;
  if (tid == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;\n" : "=r"(smid));
    const unsigned rank = atomicAdd(claims + 2 + smid % DM_SM_IDS, 1u);
    tail[1] = rank == 0 ? (int)atomicAdd(claims, 1u)
                        : (int)gridDim.x - 1 - (int)atomicAdd(claims + 1, 1u);
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(full + s, 32);         // the producer's lanes
      mbar_init(empty + s, DM_WARPS);  // the consumer warps
    }
#ifdef MNN_DM_CLOCKS
    dm_ev_count(p) = 0;
#endif
  }
  __syncthreads();
  const int place = tail[1];
  const int* starts = p.sched + DM_HDR;
  const int first = __ldg(starts + place), n_items = __ldg(starts + place + 1) - first;
  const int* rec = p.sched + dm_recs_at(gridDim.x) + (long)first * DM_REC;
  if (warp == DM_WARPS) {
    produce(p, rec, n_items);
    return;
  }
#ifdef MNN_DM_CLOCKS
  unsigned smid;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(smid));
  DM_EV(EV_START, KD_PRO, (int)smid);
  DM_EV(EV_START, KD_PRO, place);
#endif

  // prologue: the arrival counters to zero (nothing reads them before the
  // first grid-wide wait); the residual stream starts as x; its sums of
  // squares per tile
  for (int i = DM_FIRST_COUNTER + blockIdx.x * DM_CONSUMERS + tid; i < p.n_counters;
       i += gridDim.x * DM_CONSUMERS)
    p.counters[i] = 0u;
  for (int t = blockIdx.x; t < (H + DM_TILE - 1) / DM_TILE; t += gridDim.x)
    for (int b = warp; b < B; b += DM_WARPS) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = t * DM_TILE + lane * 4 + j;
        if (col < H) {
          const float v = p.x[(long)b * H + col];
          __stcg(&p.x_out[(long)b * H + col], v);
          s += v * v;
        }
      }
      s = warp_sum(s);
      if (lane == 0) __stcg(&p.ssq[t * DM_MAXB + b], s);
    }

  // The records come into shared memory one item ahead (threads 0 to 3, 16
  // bytes each, by cp.async), so that an item starts without a trip to
  // memory for its own.
  RingPos pos{0, 0u};
  if (tid < 4 && n_items > 0) dm_cp16(sh.recs + 4 * tid, rec + 4 * tid);
  for (int it = 0; it < n_items; ++it) {
    if (tid < 4) asm volatile("cp.async.wait_all;\n" ::: "memory");
    csync();
    const int* r = sh.recs + (it & 1) * DM_REC;
    if (tid < 4 && it + 1 < n_items)
      dm_cp16(sh.recs + ((it + 1) & 1) * DM_REC + 4 * tid, rec + (it + 1) * DM_REC + 4 * tid);
    const int kind = r[R_KIND];
    if (kind == KD_BAR) {
      DM_EV(EV_BAR_IN, r[R_TILE], r[R_LAYER]);
      grid_wait(p.counters);
      DM_EV(EV_BAR_OUT, r[R_TILE], r[R_LAYER]);
      if (r[R_TILE] == KD_PRO && blockIdx.x == 0)   // every block has its place
        for (int i = tid; i < 2 + DM_SM_IDS; i += DM_CONSUMERS) claims[i] = 0u;
    } else if (kind == KD_ATT) {
      run_attn(p, r);
    } else if (kind == KD_ARGMAX) {
      argmax_item(p, r[R_TILE]);
      DM_EV(EV_DONE, KD_ARGMAX, p.L);
    } else if (kind == KD_FOLD) {
      fold_item(p, r[R_TILE]);
      DM_EV(EV_DONE, KD_FOLD, p.L);
    } else {
      run_gemv<BM>(p, r, pos);
      pos.advance(p.slots, r[R_U1] - r[R_U0]);
    }
  }
}

// The host side of an instantiation. In an anonymous namespace: a template's
// static locals are otherwise one object in the whole process (GNU unique
// symbols), shared with another build of this source that a profiler loads.
namespace {

// The ring and the grid for BM batch rows at head dim D: {blocks an SM that
// the occupancy calculator allows at this shared memory, shared bytes a
// block, ring slots, SMs, registers a thread, most threads a block, static
// shared bytes, local bytes a thread}.
template <int BM>
int limits(int D, int bits, int* out) {
  static int sms = 0;
  static size_t granted = 0;
  const int slots = dm_ring_slots<BM>(D, bits), smem = dm_smem_bytes<BM>(D, slots, bits);
  auto kern = decode_model_kernel<BM>;
  int dev = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !sms)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(kern, (size_t)smem, granted);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, DM_THREADS, smem);
  cudaFuncAttributes fa{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, (const void*)kern);
  if (e != cudaSuccess) return (int)e;
  out[0] = per_sm;
  out[1] = smem;
  out[2] = slots;
  out[3] = sms;
  out[4] = fa.numRegs;
  out[5] = fa.maxThreadsPerBlock;
  out[6] = (int)fa.sharedSizeBytes;
  out[7] = (int)fa.localSizeBytes;
  return 0;
}

template <int BM>
int launch(DmParams& p, float* ws, long ws_floats, int n_counters, const int* hdr,
           cudaStream_t st) {
  int lim[8];
  const int e0 = limits<BM>(p.D, p.bits, lim);
  if (e0) return e0;
  const int grid = hdr[H_GRID];
  // the table must be built for this ring, and every block co-resident
  if (hdr[H_SLOTS] != lim[2] || grid < 1 || grid > lim[0] * lim[3] ||
      hdr[H_COUNTERS] > n_counters)
    return (int)cudaErrorInvalidValue;
  p.slots = lim[2];
  p.slot_bytes = dm_slot_bytes(p.bits);
  p.work_bytes = dm_work_bytes<BM>(p.D);
  p.n_counters = hdr[H_COUNTERS];
  p.att_split = hdr[H_NS];

  // carve the scratch
  const long B = p.B, vt = p.head_p ? (p.V + DM_TILE - 1) / DM_TILE : 0;
  const long ht = (p.H + DM_TILE - 1) / DM_TILE;
  long off = 0;
  auto take = [&](long n) {
    float* at = ws + off;
    off += (n + 3) / 4 * 4;
    return at;
  };
  p.qkv = take(B * p.NQ);
  p.att = take(B * p.DQ);
  p.act = take(B * p.I);
  p.ssq = take(ht * DM_MAXB);
  p.best_val = take(B * vt);
  p.best_idx = reinterpret_cast<int*>(take(B * vt));
  p.att_part = take(B * p.Hkv * p.att_split * AT_GMAX * (p.D + 2));
  p.part = take(hdr[H_PART]);
  p.obuf = take(B * p.H);
  p.dbuf = take(B * p.H);
  p.xmid = take(B * p.H);
  p.ssq_o = take(ht * DM_MAXB);
  p.ssq_d = take(ht * DM_MAXB);
  if (off > ws_floats) return (int)cudaErrorInvalidValue;

  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)decode_model_kernel<BM>, dim3(grid),
                                              dim3(DM_THREADS), args, (size_t)lim[1], st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One instantiation per source file: decode_model_b<BM>.cu defines these.
#define MNN_DM_DECLARE(BM)                                                                 \
  int launch_b##BM(DmParams& p, float* ws, long ws_floats, int n_counters, const int* hdr, \
                   cudaStream_t st);                                                       \
  int limits_b##BM(int D, int bits, int* out);
MNN_DM_DECLARE(1)
MNN_DM_DECLARE(2)
MNN_DM_DECLARE(4)
MNN_DM_DECLARE(8)
#undef MNN_DM_DECLARE

}  // namespace mnn
