// Causal GQA flash attention for chunked prefill (sm_90a), on the bf16
// tensor cores.
//
// Replaces mnn_tpu/kernels/flash_attention.py::_prefill_kernel. q is bf16
// [B, H, Tq, D]; k and v are bf16 [B, Hkv, S, D], a fixed-capacity buffer
// of which the first kv_len positions are valid; query row i sits at global
// position q_offset + i. lens = (kv_len, q_offset) is read from device
// memory, so a chunk never waits for the host.
//
// What bounds it: a 512-row chunk over 300 to 640 positions is 0.1 to 0.5
// GFLOP and a few MB a layer, microseconds at the card's limits, so it is
// held by latency and by how the work is spread, not by bytes or operations.
// The design:
//  * a block of 4 warps owns (batch x head, 16 x WQ query rows), a warp 16
//    rows; WQ warps share each K/V tile, and 4 / WQ such groups split the
//    block's tiles and merge their softmax states in shared memory in a
//    fixed order (the same bits every run). The block takes the most split
//    shape whose grid the card holds in one wave (`fp_shape`): a 128-row
//    chunk over a long cache runs 16-row blocks whose 4 warps take a
//    quarter of the positions each, a 512-row chunk 32-row blocks of two
//    groups. The query tiles with the most positions start first;
//  * both products on `mma.sync.m16n8k16` (bf16 in, f32 accumulate): a
//    warp's Q A-fragments are loaded once by ldmatrix and stay in registers;
//    K B-fragments come by ldmatrix (a K row is an n-column), V's by
//    ldmatrix.trans;
//  * the online softmax stays in the accumulator layout: a lane holds two
//    rows' columns, row max over the quad by two shuffles, m and l per row in
//    registers (l summed per lane and over the quad at the end), p rounded to
//    bf16 and packed straight from the S accumulators into P.V's A fragments;
//  * K and V tiles of 64 positions (32 at D = 128 in a split block, so two
//    such blocks fit an SM) come in by 16-byte cp.async into a two-stage
//    ring per group, the next tile in flight while this one is computed;
//    shared rows are padded by 16 bytes, so ldmatrix's eight row addresses
//    fall in eight different bank groups; positions at or past kv_len are
//    zero-filled (a zero times stale shared memory can be NaN);
//  * tiles at or past kv_len, wholly past the causal edge of the block's
//    last row, or wholly before the window of its first row (and not in the
//    sink) are skipped; only tiles that cross an edge pay for the mask.
//    Every row still sees a column of a visited tile if it sees any, and
//    alpha = exp(-1e30 - m) = 0 wipes what a wholly masked first tile left.
// Numerics follow the Pallas kernel: scores scaled, then masked with -1e30;
// p = exp(s - m_new) in f32, computed as exp2((s - m_new) * log2 e) (within
// 2 ulp of f32, far below p's bf16 rounding); l sums the unrounded p; p is
// rounded to bf16 for P.V (as `p.astype(v.dtype)`); l == 0 -> 1.
#include "common.cuh"

namespace mnn {
namespace fp {

constexpr int STAGES = 2;      // K/V tiles in the copy ring
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from device to shared memory without waiting; zeros when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, row) . b (16 x 8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as one word of two bf16 (round to nearest even), `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) { return exp2f(x * LOG2E); }

// Block shapes, 4 warps each: WQ warps of 16 query rows share every K/V
// tile; WK such groups split the block's tiles between them (group g takes
// tiles g, g + WK, ...) and merge their softmax states at the end in a
// fixed order. A group's ring holds STAGES tiles of BKV positions.
__host__ __device__ constexpr int bkv_of(int D, int WK) {
  return D == 128 && WK > 1 ? 32 : 64;
}
__host__ __device__ constexpr int ring_bytes(int D, int WK) {
  return STAGES * 2 * bkv_of(D, WK) * (D + 8) * 2;
}
// Q [16 WQ][D + 8] bf16, then WK rings of STAGES x (K, V) [BKV][D + 8] bf16;
// a row is D values and 16 bytes of pad. The merge reuses the rings.
__host__ __device__ constexpr int smem_bytes(int D, int WQ, int WK) {
  return 16 * WQ * (D + 8) * 2 + WK * ring_bytes(D, WK);
}

// Wait for this group's threads only (named barrier 1 + g; 0 is __syncthreads).
template <int WQ>
__device__ __forceinline__ void group_sync(int g) {
  if (WQ == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + g), "n"(32 * WQ) : "memory");
}

}  // namespace fp

template <int D, int WQ, int WK>
__global__ void __launch_bounds__(WQ * WK * 32)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const int* __restrict__ lens, int H, int Hkv, int Tq, int S,
                     int causal, int window, int sink, float scale) {
  using namespace fp;
  constexpr int BKV = bkv_of(D, WK), NT = BKV / 8, PK = BKV / 16;
  constexpr int THREADS = WQ * WK * 32, GT = WQ * 32, BQ = 16 * WQ, LD = D + 8, CH = D / 8;
  constexpr int KS = D / 16;                       // k-steps of Q.K^T
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wq = warp % WQ, grp = warp / WQ, gtid = tid - grp * GT;
  const int gid = lane >> 2, tig = lane & 3;
  bf16* ring = q_s + BQ * LD + grp * (ring_bytes(D, WK) / 2);   // [STAGES][2][BKV][LD]
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // most positions first
  const int kv_lim = min(lens[0], S), q_offset = lens[1];
  const bf16* qb = q + ((long)bh * Tq + q0) * D;
  const bf16* kb = k + (long)(b * Hkv + kvh) * S * D;
  const bf16* vb = v + (long)(b * Hkv + kvh) * S * D;

  // The tiles this block visits: the sink's, then from the window's start
  // for the first row to the causal edge of the last.
  const int qa = q_offset + q0, qz = q_offset + min(q0 + BQ, Tq) - 1;
  const int end = causal ? min(kv_lim, qz + 1) : kv_lim;
  const int n_end = end > 0 ? (end + BKV - 1) / BKV : 0;
  int win0 = 0, n_sink = 0;
  if (window) {
    win0 = min(max(0, qa - window + 1) / BKV, n_end);
    n_sink = min((sink + BKV - 1) / BKV, win0);
  }
  const int count = n_sink + (n_end - win0);
  const int mine = count > grp ? (count - grp + WK - 1) / WK : 0;   // this group's tiles
  auto tile_of = [&](int j) {
    const int i = grp + WK * j;
    return i < n_sink ? i : win0 + (i - n_sink);
  };

  auto load_tile = [&](int j, int st) {
    const int t = tile_of(j);
    bf16* ks = ring + st * 2 * BKV * LD;
    bf16* vs = ks + BKV * LD;
#pragma unroll 4
    for (int c = gtid; c < BKV * CH; c += GT) {
      const int r = c / CH, x = (c - r * CH) * 8;
      const int col = t * BKV + r;
      const bool ok = col < kv_lim;
      const long off = ok ? (long)col * D + x : 0;
      cp16(ks + r * LD + x, kb + off, ok);
      cp16(vs + r * LD + x, vb + off, ok);
    }
  };

  for (int c = tid; c < BQ * CH; c += THREADS) {
    const int r = c / CH, x = (c - r * CH) * 8;
    const bool ok = q0 + r < Tq;
    cp16(q_s + r * LD + x, ok ? qb + (long)r * D + x : qb - (long)q0 * D, ok);
  }
  commit();
  if (mine > 0) load_tile(0, 0);
  commit();
  wait_copies<1>();
  __syncthreads();

  // this warp's 16 query rows as A fragments, k-step by k-step
  uint32_t qf[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    ldsm_x4(qf[kk], q_s + (wq * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  const int wpos = q_offset + q0 + wq * 16;        // position of the warp's row 0
  const int row_pos = wpos + gid;                  // this lane's rows: +0 and +8
  for (int j = 0; j < mine; ++j) {
    if (j + 1 < mine) load_tile(j + 1, (j + 1) & 1);
    commit();
    wait_copies<1>();
    group_sync<WQ>(grp);
    const bf16* ks = ring + (j & 1) * 2 * BKV * LD;
    const bf16* vs = ks + BKV * LD;
    const int t0 = tile_of(j) * BKV;

    // S = Q K^T: NT n-tiles of 8 positions
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bfr[4];
        ldsm_x4(bfr, ks + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                         ((lane >> 3) & 1) * 8);
        mma(s[2 * np], qf[kk], bfr[0], bfr[1]);
        mma(s[2 * np + 1], qf[kk], bfr[2], bfr[3]);
      }
    }

    // scale, then mask only where the tile crosses an edge for this warp
    const bool edge = t0 + BKV > kv_lim || (causal && t0 + BKV - 1 > wpos) ||
                      (window && t0 <= wpos + 15 - window && !(t0 + BKV <= sink));
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int col = t0 + 8 * n + 2 * tig + (e & 1);
          const int pos = row_pos + (e >> 1) * 8;
          bool ok = col < kv_lim;
          if (causal) ok = ok && col <= pos;
          if (window) ok = ok && (col > pos - window || (sink && col < sink));
          x = ok ? x : NEG_INF;
        }
        s[n][e] = x;
      }

    // online softmax for the two rows (gid, gid + 8) over the quad
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f};
    uint32_t pf[PK][4];   // P as A fragments: k-step kk covers n-tiles 2kk, 2kk + 1
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float p0 = ex2(s[n][0] - m[0]), p1 = ex2(s[n][1] - m[0]);
      const float p2 = ex2(s[n][2] - m[1]), p3 = ex2(s[n][3] - m[1]);
      ps[0] += p0 + p1;
      ps[1] += p2 + p3;
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];
#pragma unroll
    for (int d = 0; d < D / 8; ++d) {
      acc[d][0] *= alpha[0];
      acc[d][1] *= alpha[0];
      acc[d][2] *= alpha[1];
      acc[d][3] *= alpha[1];
    }

    // O += P V: V's rows are the k dimension, so ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bfr[4];
        ldsm_x4_trans(bfr, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                               dp * 16 + (lane >> 4) * 8);
        mma(acc[2 * dp], pf[kk], bfr[0], bfr[1]);
        mma(acc[2 * dp + 1], pf[kk], bfr[2], bfr[3]);
      }
    }
    group_sync<WQ>(grp);   // the next iteration's copy refills this stage
  }
  wait_copies<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if (WK > 1) {
    // Park every warp's (m, l, O) where the rings were, then the first group
    // folds the others in, group by group: the same order on every run.
    constexpr int PARK = 16 * (D + 2);            // floats a warp: m, l, O rows
    static_assert(WQ * WK * PARK * 4 <= WK * ring_bytes(D, WK), "the park overflows the rings");
    __syncthreads();
    float* park = reinterpret_cast<float*>(q_s + BQ * LD);
    float* mine_p = park + warp * PARK;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (tig == 0) {
        mine_p[gid + 8 * r] = m[r];
        mine_p[16 + gid + 8 * r] = l[r];
      }
#pragma unroll
      for (int d = 0; d < D / 8; ++d)
        *reinterpret_cast<float2*>(mine_p + 32 + (gid + 8 * r) * D + 8 * d + 2 * tig) =
            make_float2(acc[d][2 * r], acc[d][2 * r + 1]);
    }
    __syncthreads();
    if (grp) return;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = gid + 8 * r;
      float mg[WK] = {}, mt = m[r];
#pragma unroll
      for (int g = 1; g < WK; ++g) {
        mg[g] = park[(g * WQ + wq) * PARK + rr];
        mt = fmaxf(mt, mg[g]);
      }
      const float a0 = ex2(m[r] - mt);
      l[r] *= a0;
#pragma unroll
      for (int d = 0; d < D / 8; ++d) {
        acc[d][2 * r] *= a0;
        acc[d][2 * r + 1] *= a0;
      }
#pragma unroll
      for (int g = 1; g < WK; ++g) {
        const float* other = park + (g * WQ + wq) * PARK;
        const float ag = ex2(mg[g] - mt);
        l[r] += other[16 + rr] * ag;
#pragma unroll
        for (int d = 0; d < D / 8; ++d) {
          const float2 x = *reinterpret_cast<const float2*>(other + 32 + rr * D + 8 * d + 2 * tig);
          acc[d][2 * r] += x.x * ag;
          acc[d][2 * r + 1] += x.y * ag;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    if (l[r] == 0.f) l[r] = 1.f;
  const int row = q0 + wq * 16 + gid;
  bf16* ob = o + ((long)bh * Tq + row) * D + 2 * tig;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= Tq) continue;
#pragma unroll
    for (int d = 0; d < D / 8; ++d)
      *reinterpret_cast<uint32_t*>(ob + 8 * r * D + 8 * d) =
          pack_bf16(acc[d][2 * r] / l[r], acc[d][2 * r + 1] / l[r]);
  }
}

namespace {   // internal linkage: two builds of this file may share a process

// One block shape: WQ query warps of 16 rows, times WK groups that split
// the positions.
template <int D, int WQ, int WK>
struct FpKernel {
  static constexpr int THREADS = 32 * WQ * WK;
  static constexpr size_t BYTES = fp::smem_bytes(D, WQ, WK);

  // Blocks an SM holds at once, by shared memory and registers; the first
  // call lifts the kernel's shared-memory limit. 0 if either call failed
  // (the launch then reports the error).
  static int resident() {
    static int n = -1;
    if (n < 0) {
      size_t granted = 48 << 10;
      auto kern = flash_prefill_kernel<D, WQ, WK>;
      if (allow_smem(kern, BYTES, granted) != cudaSuccess ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, THREADS, BYTES) != cudaSuccess)
        n = 0;
    }
    return n;
  }

  static int launch(const void* q, const void* k, const void* v, void* o, const void* lens,
                    int B, int H, int Hkv, int Tq, int S, int causal, int window, int sink,
                    float scale, cudaStream_t st) {
    if (!resident()) {
      const cudaError_t e = cudaGetLastError();
      return (int)(e != cudaSuccess ? e : cudaErrorInvalidConfiguration);
    }
    dim3 grid(B * H, (Tq + 16 * WQ - 1) / (16 * WQ));
    flash_prefill_kernel<D, WQ, WK><<<grid, THREADS, BYTES, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), static_cast<const int*>(lens), H, Hkv, Tq, S, causal, window,
        sink, scale);
    return (int)cudaGetLastError();
  }
};

static int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// The block shape of a launch: the most split of 1 x 4, 2 x 2 whose grid of
// (batch x head, query tile) the card holds in one wave, else 4 x 1 (64 rows
// that share every tile four ways). MNN_FP_WQ and MNN_FP_WK, when defined at
// build time, fix it (for timing one block shape against another).
struct FpShape { int wq, wk; };
template <int D>
static FpShape fp_shape(int BH, int Tq) {
#ifdef MNN_FP_WQ
  return {MNN_FP_WQ, MNN_FP_WK};
#else
  auto one_wave = [&](int wq, int resident) {
    return (long)BH * ((Tq + 16 * wq - 1) / (16 * wq)) <= (long)resident * sm_count();
  };
  if (one_wave(1, FpKernel<D, 1, 4>::resident())) return {1, 4};
  if (one_wave(2, FpKernel<D, 2, 2>::resident())) return {2, 2};
  return {4, 1};
#endif
}

template <int D>
static int launch_d(const void* q, const void* k, const void* v, void* o, const void* lens,
                    int B, int H, int Hkv, int Tq, int S, int causal, int window, int sink,
                    float scale, cudaStream_t st) {
  const FpShape f = fp_shape<D>(B * H, Tq);
#define MNN_FP_LAUNCH(WQ, WK)                                                               \
  if (f.wq == WQ && f.wk == WK)                                                             \
    return FpKernel<D, WQ, WK>::launch(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window,  \
                                       sink, scale, st);
  MNN_FP_LAUNCH(4, 1)
  MNN_FP_LAUNCH(2, 2)
  MNN_FP_LAUNCH(1, 4)
#ifdef MNN_FP_WQ
  MNN_FP_LAUNCH(MNN_FP_WQ, MNN_FP_WK)
#endif
#undef MNN_FP_LAUNCH
  return (int)cudaErrorInvalidConfiguration;
}

}  // namespace

}  // namespace mnn

using namespace mnn;

MNN_API int mnn_flash_prefill(const void* q, const void* k, const void* v, void* o,
                              const void* lens, int B, int H, int Hkv, int Tq, int S, int D,
                              int causal, int window, int sink, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv || Tq <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch_d<32>(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window, sink, scale, st);
    case 64: return launch_d<64>(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window, sink, scale, st);
    case 128: return launch_d<128>(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window, sink, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tiling mnn_flash_prefill takes: out = (query rows a block, groups
// that split its K/V tiles, positions a tile, dynamic shared bytes, blocks).
// Launches nothing.
MNN_API int mnn_flash_prefill_tile(int B, int H, int Tq, int D, int* out) {
  if (B <= 0 || H <= 0 || Tq <= 0 || (D != 32 && D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
  const FpShape f = D == 32 ? fp_shape<32>(B * H, Tq)
                   : D == 64 ? fp_shape<64>(B * H, Tq) : fp_shape<128>(B * H, Tq);
  out[0] = 16 * f.wq;
  out[1] = f.wk;
  out[2] = fp::bkv_of(D, f.wk);
  out[3] = fp::smem_bytes(D, f.wq, f.wk);
  out[4] = B * H * ((Tq + 16 * f.wq - 1) / (16 * f.wq));
  return 0;
}
