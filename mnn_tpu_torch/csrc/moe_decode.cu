// Routed mixture-of-experts MLP of one decode step (sm_90a): every (token,
// expert) pair of the layer and the shared expert in one launch.
//
// Replaces mnn_tpu/kernels/moe_decode.py::_kernel. For n <= 8 tokens,
//   y[r] = sum_k wsel[r, k] * expert_{sel[r, k]}(x[r]) + gate[r] * shared(x[r])
// where an expert is gate/up GEMV -> bf16 -> 64-block split -> SwiGLU -> down
// GEMV over W4/W8 weights in the packed per-block format. Rounding points as
// the TPU kernel: x rounded to bf16, part * s + rowsum * m per quant block in
// f32, the gate/up result and both SwiGLU products rounded to bf16, the down
// product and the combination in f32.
//
// Bound by bytes: a token reads k experts of E and the shared expert once
// (36.8 MB a layer at qwen1.5-moe-a2.7b's widths, 11 us of the H100's
// memory rate) and does two operations per weight. What held the two-launch
// version at 3.6x was not the bytes alone: a full drain between the gate/up
// and down launches, and a merge through device memory in each, on the path
// of every block. The design:
//
// * One launch, work claimed by tickets. kernels/moe_decode.py's
//   `schedule()` lists the items (gate/up: a K range of a 128-column tile of
//   a pair's or the shared expert's matrix; down: a K range of a 128-column
//   tile of y of a pair or the shared expert) as an int32 table, from the
//   shapes only: expert ids stay on the device, and a block computes its
//   weight pointers from sel[] and the flat [L * E] stacks. Persistent
//   blocks (the occupancy calculator's count: two an SM up to 4 rows) take
//   items from an atomic ticket. Every gate/up item's ticket comes before
//   every down item's, so a block that waits waits only on items that
//   running blocks have claimed, and a gate/up item waits on nothing: no
//   deadlock, and no cooperative launch, so the launch can be captured in a
//   CUDA graph.
// * Weights ahead of the waits. A producer warp claims the block's next
//   ticket when a slot of its shared-memory ring is free, and copies each
//   unit of the item (64 packed rows of the tile, 128 bytes a row, with
//   their scale and bias rows) into the ring by cp.async, 16 bytes a lane,
//   each slot completing an mbarrier: a down item's weights land while it
//   waits for its activations, and the next item's while the current one
//   computes.
// * Merges off the compute warps' path. Eight compute warps take an item's
//   units and hand their partial sums to an epilogue warp through a double
//   buffer in shared memory, then go on to the next item; the epilogue warp
//   sums them, merges K ranges, applies SwiGLU or combines y, all of it
//   trips to device memory that no compute warp waits for.
// * Waits on what is needed. A gate/up tile yields 64 activations; a down
//   item waits (thread 0, ld.acquire) on one arrival counter, that of its
//   (pair, K range) or (shared, K range), until every gate/up tile that
//   feeds its range has released it (red.release after its stores). x,
//   bf16, is copied into shared memory once a block (where n rows fit).
// * The same bits from run to run: K ranges of a gate/up tile meet in
//   device memory and the last block to arrive (a counter per tile, reset by
//   that block) adds them in range order; a tile of y waits for all its
//   pairs' and the shared expert's ranges, and its last block adds pair 0 ..
//   k-1, then the shared term. No floating-point atomics.
// * No host reset. The last block to finish (a count of finished blocks)
//   zeroes the ticket, the arrival counters and that count, so three
//   launches in a row and a replayed CUDA graph start from zero.
// * A hazard of the port: the scratch and counters are one set per device
//   and shape (kernels/moe_decode.py's `_scratch`), as flash decode's and the
//   M = 1 GEMV's workspaces are. Two calls on two streams at once would
//   corrupt each other; the port runs one stream.
//
// Inside a unit compute warp w takes packed rows [8w, 8w + 8) on the FMA
// units: a lane reads its 4 output columns of a row as one 32-bit word and
// sums x * q over the 16 (W4) or 8 (W8) K values of its rows, x by
// broadcast from shared memory.
#include "common.cuh"
#include "md_clocks.cuh"

namespace mnn {

constexpr int MD_CONSUMERS = 256, MD_WARPS = 8;             // the compute warps
constexpr int MD_PRODUCER = 8, MD_EPILOGUE = 9;             // the other two warps
constexpr int MD_THREADS = MD_CONSUMERS + 64;
constexpr int MD_TILE = 128, MD_UNIT_ROWS = 64, MD_SCALE_ROWS = 4;
constexpr int MD_RING = 4;   // ring slots a block up to 4 rows (twice that at 8)
constexpr int MD_PACKED_BYTES = MD_UNIT_ROWS * MD_TILE;     // 8192
constexpr int MD_PLANE = MD_SCALE_ROWS * MD_TILE * 2;       // a unit's scale (or bias) rows
constexpr int MD_SLOT = MD_PACKED_BYTES + 2 * MD_PLANE;
constexpr int MD_XS_PAD = 8;                 // bf16 a stage row is padded by (banks)
constexpr int MD_MAXB = 8;
constexpr int MD_HDR = 16, MD_REC = 16;      // int32 of the table's header, of a record
constexpr long long MD_WAIT_MAX = 1LL << 31;   // cycles (about a second): a broken table
constexpr int MD_SUSPEND_NS = 100000;        // an mbarrier wait's suspend hint
// A launch for BM batch rows: blocks an SM (two up to 4 rows, one at 8, so
// that one block's waits hide behind the other's work), ring slots, bf16
// values of the x stage (a down item's activations, rows x (K range + pad)),
// and of the block's copy of x (BM rows of up to 2048, where gate/up items
// read x)
__host__ __device__ constexpr int md_blocks_sm(int bm) { return bm == 8 ? 1 : 2; }
__host__ __device__ constexpr int md_slots(int bm) { return bm == 8 ? 2 * MD_RING : MD_RING; }
__host__ __device__ constexpr int md_xs(int bm) { return (bm == 8 ? 16384 : 8192) + 8 * MD_XS_PAD; }
__host__ __device__ constexpr int md_xall(int bm) { return bm * (2048 + MD_XS_PAD); }
// f32 of one buffer of the compute warps' sums: [warp][BM][TILE]
__host__ __device__ constexpr int md_red(int bm) { return MD_WARPS * bm * MD_TILE; }
constexpr int MD_COMBINE = 16;   // shares of a tile of y a combine loads at once
constexpr int MD_WSEL = 256;   // routing weights a block keeps in shared memory, at most
// shared bytes: the ring, its records and mbarriers; the x stage, the copy
// of x, the two sum buffers, their records and mbarriers, the routing
// weights and gates
__host__ __device__ constexpr int md_smem_bytes(int bm) {
  return md_slots(bm) * (MD_SLOT + 16 + MD_REC * 4) + (md_xs(bm) + md_xall(bm)) * 2 +
         2 * md_red(bm) * 4 + 2 * MD_REC * 4 + 32 + (MD_WSEL + MD_MAXB) * 4;
}
// fields of a record; the counters are indices into p.counters. A gate/up
// item releases up to four arrival counters (MR_REL..), a down item waits
// on one (MR_WAIT, MR_TARGET) and combines its tile of y from MR_BASE.
enum { MR_KIND, MR_JOB, MR_TILE, MR_U0, MR_U1, MR_PIECE, MR_NPIECES, MR_MERGE, MR_PART, MR_REL,
       MR_WAIT = MR_REL, MR_TARGET, MR_BASE };
constexpr int MD_NREL = 4;
constexpr int MR_ROWS = 15;   // the epilogue's copy of a record: the rows the sums hold
// the counters: the ticket, the finished blocks, then the arrival counters
// (p.n_ready), then the merge counters (each left at zero by its last block)
enum { MC_TICKET, MC_DONE, MC_READY };
constexpr int MD_CLK_EPI = 3072;   // the epilogue warp's rows of the -DMNN_MD_CLOCKS log

struct MdParams {
  const float* x;          // [n, H]
  const int* sel;          // [n * k] expert ids of this layer
  const float* wsel;       // [n * k] routing weights
  const float* gate;       // [n] shared-expert gate, or null (1)
  const uint8_t *gu_p, *dn_p;                    // flat expert stacks [L * E, ...]
  const bf16 *gu_s, *gu_b, *dn_s, *dn_b;
  const uint8_t *sgu_p, *sdn_p;                  // this layer's shared expert, or null
  const bf16 *sgu_s, *sgu_b, *sdn_s, *sdn_b;
  float* y;                // [n, H]
  const int* table;        // the item table of kernels/moe_decode.py's schedule()
  float *act_r, *act_s;    // scratch: [n * k, mi], [n, si]
  float *part_a, *part_b;  // scratch: K ranges of a gate/up tile, shares of a tile of y
  unsigned* counters;
  int n, k, E, layer, H, mi, si, bits;
  int bs_h, bs_mi, bs_sh, bs_sd;                 // quant blocks: gu, down, shared gu, shared down
  int n_items, n_ready, rd, sd;                  // down K ranges of a pair, of the shared expert
  int slots, xs, bm, xall;                       // the launch's ring, stage, BM; x copied (1)
};

// One matrix of the item: its packed rows, scales and biases, K, N, quant block.
struct MdGeo {
  const uint8_t* packed;
  const bf16 *scale, *bias;
  int K, N, bs;
};

__device__ __forceinline__ MdGeo md_geo(const MdParams& p, int kind, int job) {
  if (kind == MD_K_GU_S) return MdGeo{p.sgu_p, p.sgu_s, p.sgu_b, p.H, 2 * p.si, p.bs_sh};
  if (kind == MD_K_DN_S) return MdGeo{p.sdn_p, p.sdn_s, p.sdn_b, p.si, p.H, p.bs_sd};
  const long e = (long)p.layer * p.E + __ldg(p.sel + job);
  if (kind == MD_K_GU_R) {
    const long N = 2L * p.mi, kp = (long)p.H * p.bits / 8, nb = p.H / p.bs_h;
    return MdGeo{p.gu_p + e * kp * N, p.gu_s + e * nb * N, p.gu_b + e * nb * N, p.H, (int)N,
                 p.bs_h};
  }
  const long kp = (long)p.mi * p.bits / 8, nb = p.mi / p.bs_mi;
  return MdGeo{p.dn_p + e * kp * p.H, p.dn_s + e * nb * p.H, p.dn_b + e * nb * p.H, p.mi, p.H,
               p.bs_mi};
}

// The K value of packed row r (W4: its low nibble's; the high one's is bs / 2
// further), and one past the last K value of packed rows [.., r1).
__device__ __forceinline__ int md_k_lo(int r, int bits, int bs) {
  if (bits == 8) return r;
  const int half = bs / 2, kb = r / half;
  return kb * bs + r - kb * half;
}
__device__ __forceinline__ int md_k_end(int r1, int bits, int bs) {
  return bits == 8 ? r1 : md_k_lo(r1 - 1, bits, bs) + bs / 2 + 1;
}

// ---------------------------------------------------------------------------
// shared memory: the ring of weight slots, the x stage, the copy of x, the
// two sum buffers and their records, the slots' item records (written by the
// producer on an item's first unit), the slots' mbarriers, the sum buffers'
// mbarriers. A slot: the unit's packed rows, then its scale rows, then at
// MD_PLANE its bias rows.

struct MdSmem {
  unsigned char* ring;
  bf16* xs;        // [BR][nk + pad] a down item's activations (or x), bf16
  bf16* xall;      // [n][H + pad] x, bf16, where it fits
  float* red;      // [2][WARPS][BR][TILE] the compute warps' sums
  int* erec;       // [2][MD_REC] their items' records
  int* hdr;        // [slots][MD_REC]
  uint64_t *full, *empty;     // the ring's
  uint64_t *rfull, *rempty;   // the sum buffers'
  float* wsel;     // [n * k] routing weights (where they fit), then [n] gates
};

__device__ __forceinline__ MdSmem md_smem(const MdParams& p) {
  extern __shared__ __align__(128) unsigned char smem[];
  MdSmem s;
  s.ring = smem;
  s.xs = reinterpret_cast<bf16*>(smem + p.slots * MD_SLOT);
  s.xall = s.xs + p.xs;
  s.red = reinterpret_cast<float*>(s.xall + md_xall(p.bm));
  s.erec = reinterpret_cast<int*>(s.red + 2 * md_red(p.bm));
  s.hdr = s.erec + 2 * MD_REC;
  s.full = reinterpret_cast<uint64_t*>(s.hdr + p.slots * MD_REC);
  s.empty = s.full + p.slots;
  s.rfull = s.empty + p.slots;
  s.rempty = s.rfull + 2;
  s.wsel = reinterpret_cast<float*>(s.rempty + 2);
  return s;
}

__device__ __forceinline__ unsigned md_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// the eight compute warps only (the producer and epilogue warps run their
// own courses)
__device__ __forceinline__ void md_csync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(MD_CONSUMERS) : "memory");
}

__device__ __forceinline__ unsigned md_ld_acquire(const unsigned* a) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(a) : "memory");
  return v;
}

__device__ __forceinline__ unsigned md_atom_acq_rel(unsigned* c) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n" : "=r"(old) : "l"(c) : "memory");
  return old;
}

__device__ __forceinline__ void md_red_release(unsigned* c) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(c) : "memory");
}

__device__ __forceinline__ void md_mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(md_u32(bar)), "r"(count)
               : "memory");
}

// A test first (a barrier that is done, as a waiter mostly finds it, costs
// no suspend); then suspended, not spinning, until the phase completes.
__device__ __forceinline__ void md_mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = md_u32(bar);
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(a), "r"(parity)
      : "memory");
  if (done) return;
  const long long t0 = clock64();
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2, %3;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity), "n"(MD_SUSPEND_NS)
        : "memory");
    if (!done && clock64() - t0 > MD_WAIT_MAX) __trap();
  } while (!done);
}

__device__ __forceinline__ void md_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(md_u32(bar)) : "memory");
}

// the slot's mbarrier completes once this lane's earlier cp.async have landed
__device__ __forceinline__ void md_mbar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(md_u32(bar))
               : "memory");
}

// The weight stream is marked evict-first in L2, so that it does not push
// out the partial sums and activations that other blocks read back.
__device__ __forceinline__ uint64_t md_stream_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(pol));
  return pol;
}

__device__ __forceinline__ void md_cp16(void* dst, const void* src, uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(md_u32(dst)),
               "l"(src), "l"(pol)
               : "memory");
}

// A slot of a ring of `slots`: its index and the parity of its current use.
struct MdRing {
  int slot;
  unsigned parity;
  __device__ __forceinline__ void advance(int n, int slots) {
    slot += n;
    while (slot >= slots) {
      slot -= slots;
      parity ^= 1u;
    }
  }
};

// ---------------------------------------------------------------------------
// the producer warp

// Claim tickets while the ring has room; copy each unit of the item into the
// next slot, lane 0 writing the item's record into the slot's header on its
// first unit. The slot's full barrier counts each lane's copies (noinc) and
// lane 0's arrival, which releases the record. A ticket past the table ends
// the block's list with a record of kind -1.
static __device__ __noinline__ void md_produce(const MdParams& p) {
  const MdSmem sm = md_smem(p);
  const int lane = threadIdx.x & 31;
  // lane l copies 16-byte chunk l % 8 of rows l / 8, + 4, + 8, ..., and
  // chunk l % 16 of the scale (l < 16) or bias row of each quant block
  const int fr = lane >> 3, fc = (lane & 7) * 16, which = lane >> 4, sc = (lane & 15) * 16;
  const uint64_t pol = md_stream_policy();
  MdRing pos{0, 0u};
  for (;;) {
#ifdef MNN_MD_CLOCKS
    long long waited = 0;   // cycles spent on free slots
#endif
    MD_TIMED(waited, md_mbar_wait(sm.empty + pos.slot, pos.parity ^ 1u));
    unsigned t = 0;
    if (lane == 0) t = atomicAdd(p.counters + MC_TICKET, 1u);
    t = __shfl_sync(0xffffffffu, t, 0);
    int* hdr = sm.hdr + pos.slot * MD_REC;
    if (t >= (unsigned)p.n_items) {
      if (lane == 0) {
        hdr[MR_KIND] = -1;
        md_mbar_arrive(sm.full + pos.slot);
      }
      md_mbar_arrive_copies(sm.full + pos.slot);
      return;
    }
    const int* rec = p.table + MD_HDR + (long)t * MD_REC;
    const int mine = lane < MD_REC ? __ldg(rec + lane) : 0;
    const int kind = __shfl_sync(0xffffffffu, mine, MR_KIND);
    const int job = __shfl_sync(0xffffffffu, mine, MR_JOB);
    const int tile = __shfl_sync(0xffffffffu, mine, MR_TILE);
    const int u0 = __shfl_sync(0xffffffffu, mine, MR_U0);
    const int u1 = __shfl_sync(0xffffffffu, mine, MR_U1);
    const MdGeo g = md_geo(p, kind, job);
    const int c0 = tile * MD_TILE;
    const int kp = g.K * p.bits / 8, rpb = g.bs * p.bits / 8;
    const unsigned char* planes =
        reinterpret_cast<const unsigned char*>((which ? g.bias : g.scale) + c0) + sc;
    for (int u = u0; u < u1; ++u) {
      if (u > u0) MD_TIMED(waited, md_mbar_wait(sm.empty + pos.slot, pos.parity ^ 1u));
      unsigned char* dst = sm.ring + (long)pos.slot * MD_SLOT;
      const int r0 = u * MD_UNIT_ROWS, rows = min(MD_UNIT_ROWS, kp - r0);
      const uint8_t* s = g.packed + (long)(r0 + fr) * g.N + c0 + fc;
      unsigned char* d = dst + fr * MD_TILE + fc;
      for (int row = fr; row < rows; row += 4, s += 4L * g.N, d += 4 * MD_TILE) md_cp16(d, s, pol);
      // the scale rows, then the bias rows, of the quant blocks the unit touches
      const int kb0 = r0 / rpb, nsr = (r0 + rows - 1) / rpb - kb0 + 1;
      const unsigned char* from = planes + (long)kb0 * 2 * g.N;
      unsigned char* to = dst + MD_PACKED_BYTES + which * MD_PLANE + sc;
      for (int sr = 0; sr < nsr; ++sr) md_cp16(to + sr * MD_TILE * 2, from + (long)sr * 2 * g.N, pol);
      if (u == u0) {   // the record, for the compute warps to start the item from
        for (int i = 0; i < MD_REC; ++i) {
          const int v = __shfl_sync(0xffffffffu, mine, i);
          if (lane == 0) hdr[i] = v;
        }
      }
      if (lane == 0) md_mbar_arrive(sm.full + pos.slot);
      md_mbar_arrive_copies(sm.full + pos.slot);
      pos.advance(1, p.slots);
    }
#ifdef MNN_MD_CLOCKS
    if (lane == 0) md_log(MD_CLK_ROW2 + blockIdx.x, MD_EV_EMPTY_WAIT, kind, u1 - u0, waited);
#endif
  }
}

// ---------------------------------------------------------------------------
// the compute warps

struct MdItem {
  int kind, job, tile, u0, u1, wait, target;
};

// rows [0, B) of in[.., stride] over K values [k0, k0 + nk) into the stage as
// bf16, rows [B, BR) as zeros, a row every xst values; eight loads in flight
// a thread before the stores
template <int BR>
__device__ __forceinline__ void md_stage(bf16* xs, int xst, const float* in, long stride, int B,
                                         int k0, int nk, bool coherent) {
  const int total = BR * nk;
  for (int base = threadIdx.x; base < total; base += 8 * MD_CONSUMERS) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = base + i * MD_CONSUMERS, b = idx / nk;
      const float* at = in + b * stride + k0 + (idx - b * nk);
      v[i] = idx < total && b < B ? (coherent ? __ldcg(at) : __ldg(at)) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int idx = base + i * MD_CONSUMERS, b = idx / nk;
      if (idx < total) xs[b * xst + idx - b * nk] = __float2bfloat16_rn(v[i]);
    }
  }
}

__device__ __forceinline__ float md_x(const bf16* xs, int i) { return __bfloat162float(xs[i]); }

// Units [u0, u1) of the item on the FMA units: warp w takes packed rows
// [8w, 8w + 8) of each unit (W4: 16 K values, the rows' low nibbles and
// their high ones; W8: 8), a lane its 4 adjacent columns as one 32-bit word
// a row, x by broadcast from xs (row b at b * xst, K value k at k - k0).
template <int BITS, int BR>
__device__ __forceinline__ void md_units(const MdParams& p, const MdSmem& sm, const MdGeo& g,
                                         const MdItem& r, MdRing pos, const bf16* xs, int k0,
                                         int xst, float (&acc)[BR][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kp = g.K * BITS / 8, rpb = g.bs * BITS / 8;
  const int rpb_sh = (rpb & (rpb - 1)) == 0 ? __ffs(rpb) - 1 : -1;   // a shift for / rpb
#pragma unroll
  for (int b = 0; b < BR; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;
#ifdef MNN_MD_CLOCKS
  long long waited = 0;   // cycles spent on full slots
#endif
  for (int u = r.u0; u < r.u1; ++u) {
    if (lane == 0)   // one waiter a warp
      MD_TIMED(waited, md_mbar_wait(sm.full + pos.slot, pos.parity));
    __syncwarp();
    if (u == r.u0) MD_EV(blockIdx.x, MD_EV_WEIGHTS, r.kind, r.tile);
    const unsigned char* sl = sm.ring + (long)pos.slot * MD_SLOT;
    const int ub = u * MD_UNIT_ROWS, pr = ub + warp * 8;   // this warp's first packed row
    if (pr < kp) {                                         // the same for the whole warp
      const int kb = rpb_sh >= 0 ? pr >> rpb_sh : pr / rpb;
      const int srow = kb - (rpb_sh >= 0 ? ub >> rpb_sh : ub / rpb);
      const int klo = (BITS == 4 ? kb * g.bs + pr - kb * rpb : pr) - k0, khi = klo + g.bs / 2;
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(sl + (warp * 8 + i) * MD_TILE + lane * 4);
      const unsigned char* sc = sl + MD_PACKED_BYTES + srow * MD_TILE * 2 + lane * 8;
      const uint2 sv = *reinterpret_cast<const uint2*>(sc);
      const uint2 bv = *reinterpret_cast<const uint2*>(sc + MD_PLANE);
      float part[BR][4], rs[BR];
#pragma unroll
      for (int b = 0; b < BR; ++b) {
        rs[b] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) part[b][j] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if constexpr (BITS == 4) {
          // a nibble q as the f32 0x3F_0q_00_00 = 0.5 + q / 256, one byte_perm
          // each: part collects sum x (0.5 + q / 256), and sum x q is
          // 256 part - 128 rowsum, taken below
          const uint32_t lo4 = w[i] & 0x0F0F0F0Fu, hi4 = (w[i] >> 4) & 0x0F0F0F0Fu;
          float lo[4], hi[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            lo[j] = __uint_as_float(__byte_perm(lo4, 0x3F00u, 0x5044 + (j << 8)));
            hi[j] = __uint_as_float(__byte_perm(hi4, 0x3F00u, 0x5044 + (j << 8)));
          }
#pragma unroll
          for (int b = 0; b < BR; ++b) {
            const float xa = md_x(xs, b * xst + klo + i), xb = md_x(xs, b * xst + khi + i);
            rs[b] += xa + xb;
#pragma unroll
            for (int j = 0; j < 4; ++j) part[b][j] = fmaf(xb, hi[j], fmaf(xa, lo[j], part[b][j]));
          }
        } else {
          // a byte as f32 by the exponent trick: 0x4B0000qq is 2^23 + qq
          float q[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            q[j] = __uint_as_float(__byte_perm(w[i], 0x4B00u, 0x5440 + j)) - 8388608.f;
#pragma unroll
          for (int b = 0; b < BR; ++b) {
            const float xa = md_x(xs, b * xst + klo + i);
            rs[b] += xa;
#pragma unroll
            for (int j = 0; j < 4; ++j) part[b][j] = fmaf(xa, q[j], part[b][j]);
          }
        }
      }
      const bf16* s2 = reinterpret_cast<const bf16*>(&sv);
      const bf16* m2 = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s = bf2f(s2[j]), m = bf2f(m2[j]);
#pragma unroll
        for (int b = 0; b < BR; ++b) {
          const float pq = BITS == 4 ? fmaf(256.f, part[b][j], -128.f * rs[b]) : part[b][j];
          acc[b][j] = __fadd_rn(__fadd_rn(acc[b][j], __fmul_rn(pq, s)), __fmul_rn(rs[b], m));
        }
      }
    }
    __syncwarp();
    if (lane == 0) md_mbar_arrive(sm.empty + pos.slot);
    pos.advance(1, p.slots);
  }
#ifdef MNN_MD_CLOCKS
  if (threadIdx.x == 0) md_log(blockIdx.x, MD_EV_FULL_WAIT, r.kind, r.tile, waited);
#endif
}

// One item on the compute warps: its input rows (down: after its wait),
// its units, then its sums into sum buffer rb for the epilogue warp (the
// item's record with them, written by warp 0).
template <int BITS, int BR>
__device__ __noinline__ void md_compute(const MdParams& p, const int* h, MdRing pos, int rb,
                                        unsigned rpar) {
  const MdSmem sm = md_smem(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the record, read before the first unit's slot (and its header) is freed
  const int field = warp == 0 && lane < MD_REC ? h[lane] : 0;
  MdItem r;
  r.kind = h[MR_KIND];
  r.job = h[MR_JOB];
  r.tile = h[MR_TILE];
  r.u0 = h[MR_U0];
  r.u1 = h[MR_U1];
  r.wait = h[MR_WAIT];
  r.target = h[MR_TARGET];
  const bool gu = r.kind == MD_K_GU_R || r.kind == MD_K_GU_S;
  const bool shared = r.kind == MD_K_GU_S || r.kind == MD_K_DN_S;
  const int B = shared ? p.n : 1;
  const MdGeo g = md_geo(p, r.kind, r.job);
  const int kp = g.K * BITS / 8;
  const int r0 = r.u0 * MD_UNIT_ROWS, r1 = min(r.u1 * MD_UNIT_ROWS, kp);
  const int k0 = md_k_lo(r0, BITS, g.bs), nk = md_k_end(r1, BITS, g.bs) - k0;
  MD_EV(blockIdx.x, MD_EV_ITEM, r.kind, r.tile);
  // the item's rows of x (gate/up) or of the activations (down), bf16: the
  // block's copy of x where it has one, else staged into xs
  const bf16* xs = sm.xs;
  int xk0 = k0, xst = nk + MD_XS_PAD;
  if (gu && p.xall) {
    xst = p.H + MD_XS_PAD;
    xs = sm.xall + (shared ? 0 : (r.job / p.k) * xst);
    xk0 = 0;
  } else {
    const float* in;
    long stride;
    if (gu) {
      in = p.x + (shared ? 0L : (long)(r.job / p.k) * p.H);
      stride = p.H;
    } else {
      in = shared ? p.act_s : p.act_r + (long)r.job * p.mi;
      stride = shared ? p.si : p.mi;
      if (tid == 0) {   // every gate/up tile that feeds this K range has stored
        const long long t0 = clock64();
        while ((int)md_ld_acquire(p.counters + r.wait) < r.target) {
          __nanosleep(32);
          if (clock64() - t0 > MD_WAIT_MAX) __trap();
        }
      }
      MD_EV(blockIdx.x, MD_EV_WAITED, r.kind, r.tile);
    }
    if (BR * xst > p.xs) __trap();   // the schedule keeps an item inside the stage
    md_csync();   // every warp is done with the stage's last item, and the wait is over
    md_stage<BR>(sm.xs, xst, in, stride, B, k0, nk, !gu);
    md_csync();
  }
  MD_EV(blockIdx.x, MD_EV_X, r.kind, r.tile);
  float acc[BR][4];
  md_units<BITS, BR>(p, sm, g, r, pos, xs, xk0, xst, acc);
  MD_EV(blockIdx.x, MD_EV_PRODUCTS, r.kind, r.tile);
  // hand the sums to the epilogue warp
  if (lane == 0) md_mbar_wait(sm.rempty + rb, rpar ^ 1u);
  __syncwarp();
  float* red = sm.red + rb * md_red(p.bm);
#pragma unroll
  for (int b = 0; b < BR; ++b)
    *reinterpret_cast<float4*>(red + (warp * BR + b) * MD_TILE + lane * 4) =
        make_float4(acc[b][0], acc[b][1], acc[b][2], acc[b][3]);
  if (warp == 0 && lane < MD_REC) sm.erec[rb * MD_REC + lane] = lane == MR_ROWS ? BR : field;
  __syncwarp();
  if (lane == 0) md_mbar_arrive(sm.rfull + rb);
}

// ---------------------------------------------------------------------------
// the epilogue warp

// One item's epilogue from sum buffer rb: lane l holds columns [4l, 4l + 4)
// of the tile for each row. Gate/up: the K ranges merged in range order by
// the last block to arrive, SwiGLU (lanes 0-15 hold the gate columns, lanes
// 16-31 their up columns), the activations stored and the down ranges they
// feed released. Down: the share stored, and the last of the tile of y's
// shares to arrive combines them.
template <int BR>
__device__ __noinline__ void md_epilogue(const MdParams& p, int rb) {
  const MdSmem sm = md_smem(p);
  const int lane = threadIdx.x & 31;
  const int* e = sm.erec + rb * MD_REC;
  const int kind = e[MR_KIND], tile = e[MR_TILE], job = e[MR_JOB];
  const int piece = e[MR_PIECE], npieces = e[MR_NPIECES], merge = e[MR_MERGE], part = e[MR_PART];
  int rel[MD_NREL];
#pragma unroll
  for (int i = 0; i < MD_NREL; ++i) rel[i] = e[MR_REL + i];
  const int base = e[MR_BASE];
  const bool gu = kind == MD_K_GU_R || kind == MD_K_GU_S;
  const bool shared = kind == MD_K_GU_S || kind == MD_K_DN_S;
  const int B = shared ? p.n : 1;
#ifdef MNN_MD_CLOCKS
  const int erow = MD_CLK_EPI + blockIdx.x;
  if (lane == 0) md_log(erow, MD_EV_ITEM, kind + 4, tile, clock64());
#define MD_EPI_EV(tag) \
  if (lane == 0) md_log(erow, tag, kind + 4, tile, clock64())
#else
#define MD_EPI_EV(tag) \
  do {                 \
  } while (0)
#endif
  // the warps' sums, in warp order
  const float* red = sm.red + rb * md_red(p.bm);
  float f[BR][4];
#pragma unroll
  for (int b = 0; b < BR; ++b) {
    float4 v = *reinterpret_cast<const float4*>(red + b * MD_TILE + lane * 4);
#pragma unroll
    for (int w = 1; w < MD_WARPS; ++w) {
      const float4 t = *reinterpret_cast<const float4*>(red + (w * BR + b) * MD_TILE + lane * 4);
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
    }
    f[b][0] = v.x;
    f[b][1] = v.y;
    f[b][2] = v.z;
    f[b][3] = v.w;
  }
  __syncwarp();
  if (lane == 0) md_mbar_arrive(sm.rempty + rb);   // the compute warps may refill it
  // this item's rows into device memory at dst; true in the last of `total`
  // to arrive on counter c, which also sees the others' (and resets c)
  auto arrive = [&](float* dst, int c, int total) {
#pragma unroll
    for (int b = 0; b < BR; ++b)
      if (b < B)
        __stcg(reinterpret_cast<float4*>(dst + b * MD_TILE + lane * 4),
               make_float4(f[b][0], f[b][1], f[b][2], f[b][3]));
    __syncwarp();
    unsigned last = 0;
    if (lane == 0) {
      last = md_atom_acq_rel(p.counters + c) == (unsigned)(total - 1);
      if (last) p.counters[c] = 0u;
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    MD_EPI_EV(MD_EV_PUBLISHED);
    return last != 0;
  };
  if (gu) {
    if (npieces > 1) {
      const float* pp = p.part_a + part;
      if (!arrive(p.part_a + part + (long)piece * B * MD_TILE, merge, npieces)) {
        MD_EPI_EV(MD_EV_DONE);
        return;
      }
      // the K ranges in range order
#pragma unroll
      for (int b = 0; b < BR; ++b) {
        if (b >= B) break;
        float4 v = __ldcg(reinterpret_cast<const float4*>(pp + b * MD_TILE + lane * 4));
        for (int q = 1; q < npieces; ++q) {
          const float4 t = __ldcg(
              reinterpret_cast<const float4*>(pp + ((long)q * B + b) * MD_TILE + lane * 4));
          v.x += t.x;
          v.y += t.y;
          v.z += t.z;
          v.w += t.w;
        }
        f[b][0] = v.x;
        f[b][1] = v.y;
        f[b][2] = v.z;
        f[b][3] = v.w;
      }
      MD_EPI_EV(MD_EV_MERGED);
    }
    // the tile holds 64 gate columns, then their 64 up columns
    float* act = shared ? p.act_s : p.act_r + (long)job * p.mi;
    const int inter = shared ? p.si : p.mi;
#pragma unroll
    for (int b = 0; b < BR; ++b) {
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float up = round_bf16(__shfl_sync(0xffffffffu, f[b][j], (lane + 16) & 31));
        const float gt = round_bf16(f[b][j]);
        const float si = round_bf16(__fmul_rn(gt, 1.f / (1.f + expf(-gt))));
        o[j] = round_bf16(__fmul_rn(si, up));
      }
      if (lane < 16 && b < B)
        __stcg(reinterpret_cast<float4*>(act + (long)b * inter + tile * (MD_TILE / 2) + lane * 4),
               make_float4(o[0], o[1], o[2], o[3]));
    }
    __syncwarp();
    if (lane == 0)   // release the down ranges this tile feeds
      for (int i = 0; i < MD_NREL; ++i)
        if (rel[i] >= 0) md_red_release(p.counters + rel[i]);
    MD_EPI_EV(MD_EV_DONE);
    return;
  }
  // down: the share, then (the last to arrive) y = pair 0 .. k-1 in order,
  // each its ranges' sum times its weight, then the shared term; the tile's
  // shares: [pair][range] one row each, then [range][row] of the shared
  // expert, loaded MD_COMBINE at a time over (row, share) and added in that
  // order
  const int nk_pairs = p.n * p.k, nr = p.k * p.rd, nt = nr + p.sd, total = p.n * nt;
  if (!arrive(p.part_b + part, merge, nk_pairs * p.rd + p.sd)) {
    MD_EPI_EV(MD_EV_DONE);
    return;
  }
  const float* tile_part = p.part_b + base + lane * 4;
  const bool wsm = nk_pairs <= MD_WSEL;   // the weights in shared memory
  float v[4] = {0.f, 0.f, 0.f, 0.f}, term[4] = {0.f, 0.f, 0.f, 0.f};
  int lrow = 0, lq = 0;                   // the next load's row and share
  int row = 0, q = 0, qj = 0, qk = 0;     // the next add's row, share, range, pair
  for (int i0 = 0; i0 < total; i0 += MD_COMBINE) {
    float4 t[MD_COMBINE];
#pragma unroll
    for (int i = 0; i < MD_COMBINE; ++i) {
      const long at = lq < nr ? (long)lrow * nr + lq
                              : (long)nk_pairs * p.rd + (long)(lq - nr) * p.n + lrow;
      t[i] = i0 + i < total ? __ldcg(reinterpret_cast<const float4*>(tile_part + at * MD_TILE))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      if (++lq == nt) {
        lq = 0;
        ++lrow;
      }
    }
#pragma unroll
    for (int i = 0; i < MD_COMBINE; ++i) {
      if (i0 + i >= total) break;
      const float tv[4] = {t[i].x, t[i].y, t[i].z, t[i].w};
#pragma unroll
      for (int c = 0; c < 4; ++c) term[c] = qj == 0 ? tv[c] : term[c] + tv[c];
      if (qj == (q < nr ? p.rd : p.sd) - 1) {
        const int pw = row * p.k + qk;
        const float wt = q < nr ? (wsm ? sm.wsel[pw] : __ldg(p.wsel + pw))
                                : sm.wsel[MD_WSEL + row];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(v[c], __fmul_rn(term[c], wt));
        qj = 0;
        ++qk;
      } else {
        ++qj;
      }
      if (++q == nt) {   // the row is whole
        *reinterpret_cast<float4*>(p.y + (long)row * p.H + tile * MD_TILE + lane * 4) =
            make_float4(v[0], v[1], v[2], v[3]);
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = 0.f;
        q = qk = 0;
        ++row;
      }
    }
  }
  MD_EPI_EV(MD_EV_MERGED);
#undef MD_EPI_EV
}

template <int BITS, int BM>
__global__ void __launch_bounds__(MD_THREADS, md_blocks_sm(BM))
moe_decode_kernel(const __grid_constant__ MdParams p) {
  const MdSmem sm = md_smem(p);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < p.slots; ++s) {
      md_mbar_init(sm.full + s, 33);         // the producer's lanes and its record
      md_mbar_init(sm.empty + s, MD_WARPS);  // the compute warps
    }
    for (int b = 0; b < 2; ++b) {
      md_mbar_init(sm.rfull + b, MD_WARPS);  // the compute warps' sums
      md_mbar_init(sm.rempty + b, 1);        // the epilogue warp
    }
  }
  __syncthreads();
  if (warp == MD_PRODUCER) {
    md_produce(p);
    return;
  }
  if (warp == MD_EPILOGUE) {
    // items in the compute warps' order, sum buffers in turn; a record of
    // kind -1 ends the list. Then the last block to finish leaves the
    // ticket and the counters at zero.
    for (int i = 0;; ++i) {
      const int rb = i & 1;
      if (lane == 0) md_mbar_wait(sm.rfull + rb, (i >> 1) & 1);
      __syncwarp();
      if (sm.erec[rb * MD_REC + MR_KIND] < 0) break;
      if (sm.erec[rb * MD_REC + MR_ROWS] == 1)
        md_epilogue<1>(p, rb);
      else
        md_epilogue<BM>(p, rb);
    }
    if (lane == 0 && md_atom_acq_rel(p.counters + MC_DONE) == gridDim.x - 1) {
      for (int i = 0; i < p.n_ready; ++i) p.counters[MC_READY + i] = 0u;
      p.counters[MC_TICKET] = 0u;
      p.counters[MC_DONE] = 0u;
    }
    return;
  }
#ifdef MNN_MD_CLOCKS
  MD_EV(blockIdx.x, MD_EV_START, 0, md_smid());
#endif
  // the routing weights and the gates for the epilogue warp's combines; x,
  // bf16, for every gate/up item of the block
  for (int i = tid; i < p.n * p.k && i < MD_WSEL; i += MD_CONSUMERS) sm.wsel[i] = __ldg(p.wsel + i);
  if (tid < p.n) sm.wsel[MD_WSEL + tid] = p.gate ? __ldg(p.gate + tid) : 1.f;
  if (p.xall) {
    const int xst = p.H + MD_XS_PAD;
    for (int idx = tid; idx < p.n * p.H; idx += MD_CONSUMERS) {
      const int b = idx / p.H;
      sm.xall[b * xst + idx - b * p.H] = __float2bfloat16_rn(__ldg(p.x + idx));
    }
  }
  md_csync();
  MdRing pos{0, 0u};
  int i = 0;
  for (;; ++i) {
    if (lane == 0) md_mbar_wait(sm.full + pos.slot, pos.parity);
    __syncwarp();
    const int* h = sm.hdr + pos.slot * MD_REC;
    const int kind = h[MR_KIND];
    if (kind < 0) break;
    const int nu = h[MR_U1] - h[MR_U0];
    if (kind == MD_K_GU_S || kind == MD_K_DN_S)
      md_compute<BITS, BM>(p, h, pos, i & 1, (i >> 1) & 1);
    else
      md_compute<BITS, 1>(p, h, pos, i & 1, (i >> 1) & 1);
    pos.advance(nu, p.slots);
  }
  // the end of the list, for the epilogue warp
  const int rb = i & 1;
  if (lane == 0) md_mbar_wait(sm.rempty + rb, ((i >> 1) & 1) ^ 1u);
  __syncwarp();
  if (warp == 0 && lane == 0) sm.erec[rb * MD_REC + MR_KIND] = -1;
  __syncwarp();
  if (lane == 0) md_mbar_arrive(sm.rfull + rb);
  MD_EV(blockIdx.x, MD_EV_EXIT, 0, 0);
}

// The host side. In an anonymous namespace: a template's static locals are
// otherwise one object in the whole process (GNU unique symbols), shared
// with another build of this source that a profiler loads.
namespace {

// {blocks an SM the occupancy calculator allows, shared bytes a block, ring
// slots, SMs, registers a thread, most threads a block, static shared bytes,
// local bytes a thread, x stage values, values of the block's copy of x},
// asked of the runtime on the first call that succeeds (which also lifts the
// kernel's shared-memory limit) and kept, so a launch makes no runtime call
// for them. kernels/moe_decode.py sizes its items by the same numbers.
template <int BITS, int BM>
int md_limits(int* out) {
  static int lim[10] = {};
  static cudaError_t err = cudaErrorNotReady;   // not asked yet
  if (err == cudaErrorNotReady) {
    auto kern = moe_decode_kernel<BITS, BM>;
    int dev = 0;
    size_t granted = 0;
    cudaFuncAttributes fa{};
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&lim[3], cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) err = allow_smem(kern, (size_t)md_smem_bytes(BM), granted);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&lim[0], kern, MD_THREADS,
                                                          md_smem_bytes(BM));
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, (const void*)kern);
    lim[1] = md_smem_bytes(BM);
    lim[2] = md_slots(BM);
    lim[4] = fa.numRegs;
    lim[5] = fa.maxThreadsPerBlock;
    lim[6] = (int)fa.sharedSizeBytes;
    lim[7] = (int)fa.localSizeBytes;
    lim[8] = md_xs(BM);
    lim[9] = md_xall(BM);
  }
  if (err != cudaSuccess) {   // asked again on the next call
    const int e = (int)err;
    err = cudaErrorNotReady;
    return e;
  }
  for (int i = 0; i < 10; ++i) out[i] = lim[i];
  return 0;
}

template <int BITS, int BM>
int md_launch(MdParams p, cudaStream_t st) {
  int lim[10];
  const int e0 = md_limits<BITS, BM>(lim);
  if (e0) return e0;
  if (lim[0] < 1) return (int)cudaErrorInvalidConfiguration;
  p.slots = md_slots(BM);
  p.xs = md_xs(BM);
  p.bm = BM;
  p.xall = p.n * (p.H + MD_XS_PAD) <= md_xall(BM);
  const int grid = min(p.n_items, lim[0] * lim[3]);
  moe_decode_kernel<BITS, BM><<<grid, MD_THREADS, md_smem_bytes(BM), st>>>(p);
  return (int)cudaGetLastError();
}

template <int BITS>
int md_dispatch(const MdParams& p, cudaStream_t st, int* lim) {
  const int n = p.n;
  if (lim) {
    if (n == 1) return md_limits<BITS, 1>(lim);
    if (n == 2) return md_limits<BITS, 2>(lim);
    if (n <= 4) return md_limits<BITS, 4>(lim);
    return md_limits<BITS, 8>(lim);
  }
  if (n == 1) return md_launch<BITS, 1>(p, st);
  if (n == 2) return md_launch<BITS, 2>(p, st);
  if (n <= 4) return md_launch<BITS, 4>(p, st);
  return md_launch<BITS, 8>(p, st);
}

}  // namespace
}  // namespace mnn

using namespace mnn;

// y[n, H] = sum_k wsel * expert_sel(x) + gate * shared(x) for one layer.
// Pointers: x, sel, wsel, gate (or null); the flat expert stacks gu/dn
// (packed, scale, bias); this layer's shared expert sgu/sdn (or nulls with
// si = 0); y; the item table of kernels/moe_decode.py's schedule(); the f32
// scratch (act_r, act_s, part_a, part_b in turn, f_floats in all) and the
// counters (zero before the first call; every launch leaves them at zero).
MNN_API int mnn_moe_decode(const void* x, const void* sel, const void* wsel, const void* gate,
                           const void* gu_p, const void* gu_s, const void* gu_b,
                           const void* dn_p, const void* dn_s, const void* dn_b,
                           const void* sgu_p, const void* sgu_s, const void* sgu_b,
                           const void* sdn_p, const void* sdn_s, const void* sdn_b,
                           void* y, const void* table, void* fscratch, void* counters,
                           int n, int k, int E, int layer, int H, int mi, int si, int bits,
                           int bs_h, int bs_mi, int bs_sh, int bs_sd, int n_items, int n_ready,
                           int rd, int sd, int part_a_floats, int part_b_floats, int f_floats,
                           void* stream) {
  if (n < 1 || n > MD_MAXB || k < 1 || mi % 64 || si % 64 || H % MD_TILE || n_items < 1)
    return (int)cudaErrorInvalidValue;
  if (bs_h % 32 || bs_mi % 32 || (si && (bs_sh % 32 || bs_sd % 32)) || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const long long need = (long long)n * k * mi + (long long)n * si + part_a_floats + part_b_floats;
  if (need > f_floats || (si != 0) != (sd != 0) || rd < 1) return (int)cudaErrorInvalidValue;
  // 16-byte copies and loads: every matrix base and row (N is a multiple of
  // 128), the scratch and its parts, y
  const void* bases[] = {gu_p, gu_s, gu_b, dn_p, dn_s, dn_b, sgu_p, sgu_s,
                         sgu_b, sdn_p, sdn_s, sdn_b, y, fscratch};
  for (const void* b : bases)
    if (reinterpret_cast<uintptr_t>(b) & 15) return (int)cudaErrorInvalidValue;
  if ((((long long)n * k * mi) | ((long long)n * si) | part_a_floats) & 3)
    return (int)cudaErrorInvalidValue;
  MdParams p;
  p.x = static_cast<const float*>(x);
  p.sel = static_cast<const int*>(sel);
  p.wsel = static_cast<const float*>(wsel);
  p.gate = static_cast<const float*>(gate);
  p.gu_p = static_cast<const uint8_t*>(gu_p);
  p.gu_s = static_cast<const bf16*>(gu_s);
  p.gu_b = static_cast<const bf16*>(gu_b);
  p.dn_p = static_cast<const uint8_t*>(dn_p);
  p.dn_s = static_cast<const bf16*>(dn_s);
  p.dn_b = static_cast<const bf16*>(dn_b);
  p.sgu_p = static_cast<const uint8_t*>(sgu_p);
  p.sgu_s = static_cast<const bf16*>(sgu_s);
  p.sgu_b = static_cast<const bf16*>(sgu_b);
  p.sdn_p = static_cast<const uint8_t*>(sdn_p);
  p.sdn_s = static_cast<const bf16*>(sdn_s);
  p.sdn_b = static_cast<const bf16*>(sdn_b);
  p.y = static_cast<float*>(y);
  p.table = static_cast<const int*>(table);
  float* f = static_cast<float*>(fscratch);
  p.act_r = f;
  p.act_s = p.act_r + (long)n * k * mi;
  p.part_a = p.act_s + (long)n * si;
  p.part_b = p.part_a + part_a_floats;
  p.counters = static_cast<unsigned*>(counters);
  p.n = n; p.k = k; p.E = E; p.layer = layer; p.H = H; p.mi = mi; p.si = si; p.bits = bits;
  p.bs_h = bs_h; p.bs_mi = bs_mi; p.bs_sh = bs_sh; p.bs_sd = bs_sd;
  p.n_items = n_items; p.n_ready = n_ready; p.rd = rd; p.sd = sd;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bits == 4 ? md_dispatch<4>(p, st, nullptr) : md_dispatch<8>(p, st, nullptr);
}

// The launch limits for n rows at W`bits` (out[10], as md_limits gives them):
// kernels/moe_decode.py sizes its items by the blocks a launch has and its
// K ranges by the x stage and the copy of x.
MNN_API int mnn_moe_decode_limits(int n, int bits, int* out) {
  if (n < 1 || n > MD_MAXB || (bits != 4 && bits != 8)) return (int)cudaErrorInvalidValue;
  MdParams p{};
  p.n = n;
  return bits == 4 ? md_dispatch<4>(p, nullptr, out) : md_dispatch<8>(p, nullptr, out);
}

#ifdef MNN_MD_CLOCKS
MNN_API int mnn_moe_decode_clocks(long long* out, int rows) { return md_clocks_read(out, rows); }
#endif
