// Fused single-position decode attention for one layer (sm_90a).
//
// Replaces mnn_tpu/kernels/decode_step.py::_kernel. For each (batch row, KV
// head) it takes the grouped projection rows [G + 2, D] (G query rows, then
// K, then V), applies the optional QK RMS-norm and full-width neox rope,
// quantizes the new K and V rows to int8 (absmax / 127, rint, clip to +-127),
// seeds the softmax with the new token against its quantize -> dequantize
// round trip, and attends over the cached positions [0, len_old) of layer
// `layer` of the stacked [L, B, Hkv, S, D] cache, with the K scale on score
// columns and the V scale on probability columns. It returns the attention
// rows and the quantized K/V rows and scales; the caller writes those into
// the cache at len_old.
//
// Head dims 32, 64, 128 and 256 (gemma). What bounds it: a few hundred cached
// positions of 64 to 512 bytes per KV head is microseconds of neither bytes
// nor operations, so the kernel is held
// by latency: how long the longest chain of dependent steps is, and how few
// SMs take part. The design:
//  * a thread-block cluster of P blocks per (batch row, KV head) splits the
//    visible positions (the sink's, then the window's; or all of [0,
//    len_old)) into even ranges. P comes from B, Hkv and the capacity S,
//    never from the lengths, which stay on the device: the most of 1, 2, 4,
//    8 (16 where the card can place clusters that large) whose grid fits the
//    SMs in one wave, at least one tile of S a block (`DsKernel::splits`). From 4
//    blocks on, block 0 takes no positions: its quantize and seed run beside
//    the others' tiles;
//  * a block stages its range in tiles of DS_TP positions, the K and V rows
//    and their scales, by cp.async into a two-stage ring. The first two
//    tiles are requested as soon as lengths[b] is read, before the
//    norm / rope / quantize prologue runs, and nothing in the products reads
//    device memory. A per-position copy follows the sink-then-window gather;
//  * a tile costs three steps between block barriers: scores with NJ lanes
//    a position (a 16-byte chunk of its row each, q from shared memory,
//    summed over the NJ lanes by shuffles); one max and one sum per query
//    row over the whole tile (a warp a row); P.V with a thread per (4 dims,
//    position group) holding all GP rows in registers. Warps and positions
//    past the range skip their work;
//  * the merge is spread over the cluster: each block owns a slice of the
//    outputs, and every block stores its (m, l) and each slice of its acc
//    into the slice owner's shared memory with st.async, which counts the
//    bytes on the owner's mbarrier. Each block waits on its own mbarrier,
//    merges its slice over the P states in rank order and writes it.
//    One launch a call, no global scratch, no host sync, and the same bits
//    every run.
#include <cooperative_groups.h>

#include "common.cuh"

namespace mnn {
namespace {   // internal linkage: two builds of this source may share a process

namespace cg = cooperative_groups;

constexpr int DS_THREADS = 256, DS_WARPS = DS_THREADS / 32, DS_GMAX = 8, DS_STAGES = 2;
constexpr int DS_TP = 64;   // positions a tile
#ifdef MNN_DS_PMAX
constexpr int DS_PMAX = MNN_DS_PMAX;   // most blocks a cluster (build-time cap, for timing)
#else
constexpr int DS_PMAX = 16;
#endif
static_assert(DS_TP % 32 == 0 && DS_TP <= 256, "a tile is whole warps of positions");

// Built with -DMNN_DS_CLOCKS, thread 0 of blocks 0 and 1 records clock64()
// at the kernel's steps (mnn_decode_step_clocks reads them back): slot 0 the
// start, 1 the tiles requested, 2 the projection rows in, 3 rope done, 19
// and 4 block 0's quantize and seed done, 5 + 4j to 8 + 4j tile j (j < 3)
// in, its scores, its softmax, its P.V, 20 the warps folded, 23 the state
// sent, 21 every slice in, 22 the merge done.
#ifdef MNN_DS_CLOCKS
constexpr int DS_CLOCK_SLOTS = 24;
__device__ long long ds_clocks[2][DS_CLOCK_SLOTS];
#define DS_STAMP(i)                                                              \
  do {                                                                           \
    if (blockIdx.x < 2 && threadIdx.x == 0) ds_clocks[blockIdx.x][i] = clock64(); \
  } while (0)
#else
#define DS_STAMP(i) \
  do {              \
  } while (0)
#endif

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from device to shared memory without waiting; zeros when !valid.
__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
// The merge's transport: this block's mbarrier counts the bytes that the
// blocks of the cluster store into its shared memory with st.async.
__device__ __forceinline__ unsigned cluster_addr(const void* p, int rank) {   // mapa
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ void st_async4(unsigned dst, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(dst),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async2(unsigned dst, float a, float b, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          dst),
      "f"(a), "f"(b), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bar_init(void* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_expect(void* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ bool bar_done(void* bar) {   // phase 0 complete
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar))
      : "memory");
  return ok;
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// A 16-byte chunk of a cache row as f32: 16 int8 or 8 bf16 values.
__device__ __forceinline__ void chunk_to_f(const uint4& u, float (&x)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) x[4 * i + k] = (float)(int8_t)(w[i] >> (8 * k));
}
__device__ __forceinline__ void chunk_to_f(const uint4& u, float (&x)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Four consecutive values of a V row in shared memory as f32.
__device__ __forceinline__ void four_to_f(const int8_t* p, float (&v)[4]) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (float)(int8_t)(w >> (8 * k));
}
__device__ __forceinline__ void four_to_f(const bf16* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = a.x, v[1] = a.y, v[2] = c.x, v[3] = c.y;
}

// A slot of the merge: (m, l) pairs [GMAX], then the largest slice of the
// G * D outputs that P blocks' shares give one block, in 4-value chunks.
template <int D>
__host__ __device__ constexpr int slot_floats(int P, int G) {
  return 2 * DS_GMAX + 4 * ((G * D / 4 + P - 1) / P);
}

// Shared memory of one block, in bytes from the start of the dynamic array.
// Every region starts on 16 bytes.
template <int D, typename T>
struct Layout {
  static constexpr int SZ = sizeof(T);
  static constexpr int CH = 16 / SZ;             // values in a 16-byte chunk
  static constexpr int NJ = D / CH;              // chunks in a row: lanes a position
  static constexpr int QR = NJ * (CH + 4);       // a q row, chunk by chunk, 4 floats of pad
  static constexpr int KV = DS_TP * D * SZ;      // a K or V tile
  static constexpr int STAGE = 2 * KV + 2 * DS_TP * 4;   // K, V, K scales, V scales
  static constexpr int Q = DS_STAGES * STAGE;            // roped q rows [GMAX][QR] f32
  static constexpr int ROWS = Q + DS_GMAX * QR * 4;      // projection rows [GMAX + 2][D] bf16
  static constexpr int S = ROWS + (DS_GMAX + 2) * D * 2; // scores [GMAX][TP]
  static constexpr int P = S + DS_GMAX * DS_TP * 4;      // probabilities x V scale
  static constexpr int RED = P + DS_GMAX * DS_TP * 4;    // per-warp P.V [WARPS][GMAX][D]
  static constexpr int VEC = RED + DS_WARPS * DS_GMAX * D * 4;   // m, l, seed, alpha, m, l
  static constexpr int CNT = VEC + (6 * DS_GMAX + 2 * D) * 4;    // [GMAX]; vatt, roped K [D]
  static constexpr int BYTES = CNT + 16;   // the merge's mbarrier (8 bytes)
  // then the merge region: P slots of ((m, l) [GMAX], a slice of acc) f32
  static __host__ __device__ constexpr int merge_bytes(int P, int G) {
    return P * slot_floats<D>(P, G) * 4;
  }
};

// Where dim d of a q row lies in the chunked layout (4 floats of pad after
// every chunk, so the NJ lanes of a position read distinct bank groups).
template <int D, typename T>
__device__ __forceinline__ int qidx(int d) {
  using L = Layout<D, T>;
  return (d / L::CH) * (L::CH + 4) + d % L::CH;
}

// GP is the query heads a KV head padded to 1, 2, 4 or 8 (rows G..GP-1 are
// zero queries whose results are never written), so every loop over the
// rows is unrolled without a guard.
template <int D, typename T, int GP>
__global__ void __launch_bounds__(DS_THREADS)
decode_step_kernel(const bf16* __restrict__ qkv, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const float* __restrict__ cosf_,
                   const float* __restrict__ sinf_, const float* __restrict__ q_norm,
                   const float* __restrict__ k_norm, const int* __restrict__ lengths,
                   bf16* __restrict__ att, float* __restrict__ k_row, float* __restrict__ v_row,
                   float* __restrict__ k_sc, float* __restrict__ v_sc, int B, int Hkv, int G,
                   int S, int layer, int window, int sink, float softcap, float scale,
                   float eps) {
  using L = Layout<D, T>;
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int CH = L::CH, NJ = L::NJ, QR = L::QR;
  constexpr int DP = D / 32;                     // dims a lane in the prologue
  constexpr int PP = DS_THREADS / NJ;            // positions a pass of the scores
  constexpr int NC = D / 4, NPG = DS_THREADS / NC;   // P.V: 4 dims x position groups
  static_assert(GP <= DS_GMAX && GP <= DS_WARPS, "a warp a query row in the softmax");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q);
  bf16* rows_h = reinterpret_cast<bf16*>(smem + L::ROWS);
  float* s_s = reinterpret_cast<float*>(smem + L::S);
  float* p_s = reinterpret_cast<float*>(smem + L::P);
  float* red_s = reinterpret_cast<float*>(smem + L::RED);
  float* m_s = reinterpret_cast<float*>(smem + L::VEC);
  float* l_s = m_s + DS_GMAX;
  float* seed_s = l_s + DS_GMAX;
  float* alpha_s = seed_s + DS_GMAX;
  float* ms_s = alpha_s + DS_GMAX;   // the state that leaves the block: m, l [GMAX]
  float* ls_s = ms_s + DS_GMAX;
  float* vatt_s = ls_s + DS_GMAX;
  float* kr_s = vatt_s + D;
  void* mbar = smem + L::CNT;   // counts the bytes of the merge's slots

  cg::cluster_group cluster = cg::this_cluster();
  const int P = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x / P;
  const int b = bh / Hkv;
  const int R = G + 2;
  const bool lead = rank == 0;   // block 0 takes the new K and V rows, the seed and the merge
  DS_STAMP(0);
  // Every block has started, and its mbarrier is set up, once this barrier
  // phase completes (waited for before the first store into another block).
  if (tid == 0) bar_init(mbar, 1);
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // Start every load that needs nothing: the projection rows (by cp.async),
  // this lane's rope phases and norm weights, and the length.
  for (int c = tid; c < (lead ? R : G) * D / 8; c += DS_THREADS)
    cp16(rows_h + c * 8, qkv + (long)bh * R * D + c * 8, true);
  commit();
  float cs[DP], sn[DP], qn[DP], kn[DP];
#pragma unroll
  for (int j = 0; j < DP; ++j) {
    const int d = lane * DP + j;
    cs[j] = cosf_[b * D + d];
    sn[j] = sinf_[b * D + d];
    qn[j] = q_norm ? q_norm[d] : 1.f;
    kn[j] = k_norm ? k_norm[d] : 1.f;
  }

  // The visible positions, in order: the sink's [0, n_sink), then [w0, hi).
  // This block takes [v0, v1) of that sequence; from 4 blocks a cluster on,
  // block 0 takes none, so its quantize and seed run beside the others' tiles.
  const int len_old = lengths[b];
  const int hi = min(len_old, S);
  int w0 = 0, n_sink = 0;
  if (window) {
    w0 = min(max(0, len_old - window + 1), hi);
    n_sink = min(sink, w0);
  }
  const int count = n_sink + hi - w0;
  const int share = P >= 4 ? P - 1 : P, part = P >= 4 ? rank - 1 : rank;
  const int v0 = part < 0 ? 0 : (int)((long)count * part / share);
  const int v1 = part < 0 ? 0 : (int)((long)count * (part + 1) / share);
  const int tiles = (v1 - v0 + DS_TP - 1) / DS_TP;

  const long base = ((long)(layer * B + b) * Hkv + (bh - b * Hkv)) * S;
  const T* kc = k_cache + base * D;
  const T* vc = v_cache + base * D;
  const float* ksc = QUANT ? k_scale + base : nullptr;
  const float* vsc = QUANT ? v_scale + base : nullptr;

  auto load_tile = [&](int j) {
    unsigned char* st = smem + (j & 1) * L::STAGE;
    T* kt = reinterpret_cast<T*>(st);
    T* vt = reinterpret_cast<T*>(st + L::KV);
    float* kst = reinterpret_cast<float*>(st + 2 * L::KV);
    const int vb = v0 + j * DS_TP;
#pragma unroll
    for (int c = tid; c < DS_TP * NJ; c += DS_THREADS) {
      const int r = c / NJ, x = (c - r * NJ) * CH;
      const int v = vb + r;
      const bool ok = v < v1;
      const long off = ok ? (long)(v < n_sink ? v : w0 + v - n_sink) * D + x : 0;
      cp16(kt + r * D + x, kc + off, ok);
      cp16(vt + r * D + x, vc + off, ok);
    }
    if (QUANT && tid < 2 * DS_TP) {
      const int r = tid % DS_TP, v = vb + r;
      const bool ok = v < v1;
      const long pos = ok ? (v < n_sink ? v : w0 + v - n_sink) : 0;
      cp4(kst + tid, (tid < DS_TP ? ksc : vsc) + pos, ok);
    }
  };
  // the first two tiles go out before the prologue computes anything
  if (tiles > 0) load_tile(0);
  commit();
  if (tiles > 1) load_tile(1);
  commit();
  DS_STAMP(1);
  wait_copies<2>();   // the projection rows
  __syncthreads();
  DS_STAMP(2);

  // QK-norm + rope on the G query rows (and block 0's K row), one warp per
  // row; the padded rows are zero. A block with no positions needs no q.
  if (tiles > 0 || lead) {
    for (int r = warp; r < (lead ? G + 1 : G); r += DS_WARPS) {
      float x[DP];
#pragma unroll
      for (int j = 0; j < DP; ++j) x[j] = bf2f(rows_h[r * D + lane * DP + j]);
      if (q_norm) {
        float ss = 0.f;
#pragma unroll
        for (int j = 0; j < DP; ++j) ss += x[j] * x[j];
        const float rinv = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
        for (int j = 0; j < DP; ++j)
          x[j] = __fmul_rn(__fmul_rn(x[j], rinv), r < G ? qn[j] : kn[j]);
      }
#pragma unroll
      for (int j = 0; j < DP; ++j) {
        const int d = lane * DP + j;
        const float partner = __shfl_xor_sync(0xffffffffu, x[j], 16);   // dim d +- D/2
        const float rot = d < D / 2 ? -partner : partner;
        const float y = __fadd_rn(__fmul_rn(x[j], cs[j]), __fmul_rn(rot, sn[j]));
        if (r < G)
          q_s[r * QR + qidx<D, T>(d)] = y;
        else
          kr_s[d] = y;
      }
    }
    for (int i = G * QR + tid; i < GP * QR; i += DS_THREADS) q_s[i] = 0.f;
  }
  __syncthreads();
  DS_STAMP(3);

  // Block 0: quantize the new K (warp 0) and V (warp 1) rows; warp 0 then
  // scores the new token, which every query row sees.
  if (lead && warp < 2) {
    float x[DP], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      x[j] = warp == 0 ? kr_s[lane * DP + j] : bf2f(rows_h[(G + 1) * D + lane * DP + j]);
      amax = fmaxf(amax, fabsf(x[j]));
    }
    amax = warp_max(amax);
    const float sc = amax == 0.f ? 1.f : amax / 127.f;
    float* row_dst = (warp == 0 ? k_row : v_row) + (long)bh * D;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      float qv, av;
      if (QUANT) {
        qv = fminf(fmaxf(rintf(x[j] / sc), -127.f), 127.f);
        av = qv * sc;
      } else {
        qv = av = round_bf16(x[j]);
      }
      x[j] = av;
      if (warp == 1) vatt_s[lane * DP + j] = av;
      row_dst[lane * DP + j] = qv;
    }
    if (QUANT && lane == 0) (warp == 0 ? k_sc : v_sc)[bh] = sc;
    DS_STAMP(19);
    if (warp == 0) {
      float dot[GP];
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        dot[g] = 0.f;
#pragma unroll
        for (int j = 0; j < DP; ++j) dot[g] += q_s[g * QR + qidx<D, T>(lane * DP + j)] * x[j];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)   // the GP sums side by side
#pragma unroll
        for (int g = 0; g < GP; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
#pragma unroll
      for (int g = 0; g < GP; ++g)
        if (lane == g) {
          float s = dot[g] * scale;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          seed_s[g] = s;
        }
    }
  }
  if (lead) DS_STAMP(4);

  // The block's positions, tile by tile, with one online-softmax state per row.
  float m = NEG_INF, l = 0.f;   // row `warp`'s state (warps < GP)
  float acc[GP][4];
#pragma unroll
  for (int g = 0; g < GP; ++g) acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  const int c4 = tid % NC, pg = tid / NC;
  for (int j = 0; j < tiles; ++j) {
    wait_copies<1>();
    __syncthreads();
    if (j < 3) DS_STAMP(5 + 4 * j);
    const unsigned char* st = smem + (j & 1) * L::STAGE;
    const T* kt = reinterpret_cast<const T*>(st);
    const T* vt = reinterpret_cast<const T*>(st + L::KV);
    const float* kst = reinterpret_cast<const float*>(st + 2 * L::KV);
    const float* vst = kst + DS_TP;
    const int valid = min(DS_TP, v1 - v0 - j * DS_TP);   // positions of this tile

    // scores: NJ lanes a position, one 16-byte chunk each
#pragma unroll
    for (int r0 = 0; r0 < DS_TP; r0 += PP) {
      const int r = r0 + tid / NJ, cj = tid % NJ;
      if (r0 + warp * 32 / NJ < valid) {   // a warp with no valid position rests
        float kv[CH];
        chunk_to_f(*reinterpret_cast<const uint4*>(kt + r * D + cj * CH), kv);
        const float* qc = q_s + cj * (CH + 4);
        float dot[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          dot[g] = 0.f;
#pragma unroll
          for (int e = 0; e < CH; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qc + g * QR + e);
            dot[g] += q4.x * kv[e] + q4.y * kv[e + 1] + q4.z * kv[e + 2] + q4.w * kv[e + 3];
          }
        }
#pragma unroll
        for (int o = 1; o < NJ; o <<= 1)
#pragma unroll
          for (int g = 0; g < GP; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        const float ks = QUANT ? kst[r] : 1.f;
#pragma unroll
        for (int g = 0; g < GP; ++g)
          if (cj == g % NJ) {
            float s = QUANT ? __fmul_rn(dot[g], ks) : dot[g];
            s = __fmul_rn(s, scale);
            if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
            s_s[g * DS_TP + r] = s;
          }
      }
    }
    __syncthreads();
    if (j < 3) DS_STAMP(6 + 4 * j);

    // one max and one sum per query row across the tile: a warp a row
    if (warp < GP) {
      constexpr int PL = DS_TP / 32;
      float s[PL], mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        s[i] = lane + 32 * i < valid ? s_s[warp * DS_TP + lane + 32 * i] : NEG_INF;
        mx = fmaxf(mx, s[i]);
      }
      const float m_new = fmaxf(m, warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int t = lane + 32 * i;
        const float p = t < valid ? expf(s[i] - m_new) : 0.f;
        psum += p;
        if (t < valid) p_s[warp * DS_TP + t] = QUANT ? __fmul_rn(p, vst[t]) : p;
      }
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(psum);
      m = m_new;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    __syncthreads();
    if (j < 3) DS_STAMP(7 + 4 * j);

    // P.V: 4 dims and the positions pg, pg + NPG, ... for every row
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      const float a = alpha_s[g];
      acc[g][0] *= a, acc[g][1] *= a, acc[g][2] *= a, acc[g][3] *= a;
    }
#pragma unroll
    for (int i = 0; i < DS_TP / NPG; ++i) {
      const int t = pg + NPG * i;
      if (t >= valid) break;
      float v[4];
      four_to_f(vt + t * D + 4 * c4, v);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float p = p_s[g * DS_TP + t];
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[g][k] = fmaf(p, v[k], acc[g][k]);
      }
    }
    __syncthreads();   // the stage and p_s are free again
    if (j < 3) DS_STAMP(8 + 4 * j);
    if (j + 2 < tiles) load_tile(j + 2);
    commit();
  }

  // Fold the position groups: lanes NC apart within a warp, then the warps
  // through shared memory, in a fixed order. At D = 256 (NC = 64) a position
  // group is two warps, each with half of the dims: the group is the slot.
  constexpr int NSLOT = DS_THREADS / (NC > 32 ? NC : 32);   // slots of red_s
  const int slot = NC > 32 ? pg : warp;
#pragma unroll
  for (int o = NC; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GP; ++g)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[g][k] += __shfl_xor_sync(0xffffffffu, acc[g][k], o);
  if (lane < NC)
#pragma unroll
    for (int g = 0; g < GP; ++g)
      *reinterpret_cast<float4*>(red_s + (slot * GP + g) * D + 4 * c4) =
          make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  if (warp < GP && lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  DS_STAMP(20);

  // Each block owns a slice of the G * D outputs (in 4-value chunks). Every
  // block stores its (m, l) pairs and each slice of its acc into slot `rank`
  // of the slice's owner, by st.async on the owner's mbarrier, which expects
  // P slots' bytes; block 0 first folds the new token's seed into its state.
  const int n4 = G * D / 4, SL = slot_floats<D>(P, G);
  float* mrg = reinterpret_cast<float*>(smem + L::BYTES);   // [P] slots
  const int k0 = n4 * rank / P, k1 = n4 * (rank + 1) / P;
  if (tid < G) {
    float mg = m_s[tid], lg = l_s[tid];
    if (lead) {
      const float mn = fmaxf(mg, seed_s[tid]);
      lg = lg * expf(mg - mn) + expf(seed_s[tid] - mn);
      mg = mn;
    }
    ms_s[tid] = mg;
    ls_s[tid] = lg;
  }
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid == 0) bar_expect(mbar, P * (8 * G + 16 * (k1 - k0)));
  for (int k = tid; k < n4; k += DS_THREADS) {
    const int i = 4 * k, g = i / D, d = i - g * D;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int w = 0; w < NSLOT; ++w) {
      const float4 x = *reinterpret_cast<const float4*>(red_s + (w * GP + g) * D + d);
      a[0] += x.x, a[1] += x.y, a[2] += x.z, a[3] += x.w;
    }
    if (lead) {
      const float mn = fmaxf(m_s[g], seed_s[g]);
      const float e = expf(m_s[g] - mn), e0 = expf(seed_s[g] - mn);
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = a[j] * e + vatt_s[d + j] * e0;
    }
    const int q = ((k + 1) * P - 1) / n4;   // the chunk's owner
    float* dst = mrg + rank * SL + 2 * DS_GMAX + 4 * (k - n4 * q / P);
    st_async4(cluster_addr(dst, q), make_float4(a[0], a[1], a[2], a[3]), cluster_addr(mbar, q));
  }
  __syncthreads();   // ms_s, ls_s
  if (tid < P * G) {
    const int q = tid / G, g = tid - q * G;
    st_async2(cluster_addr(mrg + rank * SL + 2 * g, q), ms_s[g], ls_s[g], cluster_addr(mbar, q));
  }
  DS_STAMP(23);
  if (tid == 0)   // a slice that never completes is a fault, not a wait
    for (long spin = 0; !bar_done(mbar); ++spin)
      if (spin == (1l << 26)) __trap();
  __syncthreads();   // every block's part of this block's slice is here
  DS_STAMP(21);

  // Merge this block's slice over the P states in rank order: a weight a
  // state and row, exp(m_r - max), then the weighted sums, four outputs a
  // thread. Ranks past P read rank P - 1's slot with a weight of 0.
  float* e_s = red_s;                      // [PMAX][GMAX] exp(m_r - max)
  float* le_s = e_s + DS_PMAX * DS_GMAX;   // [PMAX][GMAX] l_r exp(m_r - max)
  if (tid < P * G) {
    const int r = tid / G, g = tid - r * G;
    float mx = NEG_INF;
#pragma unroll
    for (int q = 0; q < DS_PMAX; ++q) mx = fmaxf(mx, mrg[min(q, P - 1) * SL + 2 * g]);
    const float2 ml = *reinterpret_cast<const float2*>(mrg + r * SL + 2 * g);
    const float e = expf(ml.x - mx);
    e_s[r * DS_GMAX + g] = e;
    le_s[r * DS_GMAX + g] = ml.y * e;
  }
  __syncthreads();
  for (int k = k0 + tid; k < k1; k += DS_THREADS) {
    const int i = 4 * k, g = i / D;
    float a[4] = {0.f, 0.f, 0.f, 0.f}, sum = 0.f;
#pragma unroll
    for (int r = 0; r < DS_PMAX; ++r) {
      const int rr = min(r, P - 1);
      const float w = r < P ? e_s[rr * DS_GMAX + g] : 0.f;
      const float4 x =
          *reinterpret_cast<const float4*>(mrg + rr * SL + 2 * DS_GMAX + 4 * (k - k0));
      a[0] += x.x * w, a[1] += x.y * w, a[2] += x.z * w, a[3] += x.w * w;
      sum += r < P ? le_s[rr * DS_GMAX + g] : 0.f;
    }
    if (sum == 0.f) sum = 1.f;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(att + (long)bh * G * D + i);
    out[0] = __floats2bfloat162_rn(a[0] / sum, a[1] / sum);
    out[1] = __floats2bfloat162_rn(a[2] / sum, a[3] / sum);
  }
  DS_STAMP(22);
}

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

template <int D, typename T, int GP>
struct DsKernel {
  // Dynamic shared bytes of a block: the fixed part and block 0's merge region.
  static int bytes(int P, int G) { return Layout<D, T>::BYTES + Layout<D, T>::merge_bytes(P, G); }

  // Lift the kernel's shared-memory limit and allow clusters past the
  // portable 8, once. 0 on success.
  static cudaError_t prepare() {
    static cudaError_t e = cudaErrorNotReady;
    if (e == cudaErrorNotReady) {
      size_t granted = 48 << 10;
      e = allow_smem(decode_step_kernel<D, T, GP>, bytes(DS_PMAX, GP), granted);
      if (e == cudaSuccess && DS_PMAX > 8)
        e = cudaFuncSetAttribute(decode_step_kernel<D, T, GP>,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    }
    return e;
  }

  static cudaLaunchConfig_t config(int blocks, int P, int G, cudaLaunchAttribute* attr,
                                   cudaStream_t st) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(DS_THREADS);
    cfg.dynamicSmemBytes = bytes(P, G);
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = P;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
  }

  // Whether the card holds `clusters` clusters of 16 blocks (of the largest
  // shared memory) at once.
  static bool fits16(long clusters) {
    static int n = -1;
    if (n < 0) {
      cudaLaunchAttribute attr[1];
      cudaLaunchConfig_t cfg = config(16, 16, GP, attr, 0);
      if (DS_PMAX < 16 || prepare() != cudaSuccess ||
          cudaOccupancyMaxActiveClusters(&n, decode_step_kernel<D, T, GP>, &cfg) != cudaSuccess)
        n = 0;
      cudaGetLastError();   // a refusal here only rules the size out
    }
    return n >= clusters;
  }

  // Blocks a cluster: the most of 1, 2, 4, 8, 16 whose grid of B * Hkv
  // clusters fits the SMs in one wave, with at least one tile of the
  // capacity S a block; 16 only where the card can place such clusters. The
  // lengths never enter: they stay on the device.
  static int splits(int B, int Hkv, int S) {
    const long bh = (long)B * Hkv;
    int P = 1;
    while (2 * P <= DS_PMAX && 2 * P <= 8 && bh * 2 * P <= sm_count() &&
           (long)S >= (long)DS_TP * 2 * P)
      P *= 2;
    if (P == 8 && DS_PMAX >= 16 && bh * 16 <= sm_count() && (long)S >= (long)DS_TP * 16 &&
        fits16(bh))
      P = 16;
    return P;
  }

  static int launch(const void* qkv, const void* kc, const void* vc, const void* ks,
                    const void* vs, const void* cs, const void* sn, const void* qn,
                    const void* kn, const void* lengths, void* att, void* krow, void* vrow,
                    void* ksc, void* vsc, int B, int Hkv, int G, int S, int layer, int window,
                    int sink, float softcap, float scale, float eps, cudaStream_t st) {
    cudaError_t e = prepare();
    if (e != cudaSuccess) return (int)e;
    const int P = splits(B, Hkv, S);
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = config(B * Hkv * P, P, G, attr, st);
    e = cudaLaunchKernelEx(
        &cfg, decode_step_kernel<D, T, GP>, static_cast<const bf16*>(qkv), static_cast<const T*>(kc),
        static_cast<const T*>(vc), static_cast<const float*>(ks),
        static_cast<const float*>(vs), static_cast<const float*>(cs),
        static_cast<const float*>(sn), static_cast<const float*>(qn),
        static_cast<const float*>(kn), static_cast<const int*>(lengths),
        static_cast<bf16*>(att), static_cast<float*>(krow), static_cast<float*>(vrow),
        static_cast<float*>(ksc), static_cast<float*>(vsc), B, Hkv, G, S, layer, window,
        sink, softcap, scale, eps);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
  }
};

// The kernel for a head dim, cache type and group: GP = G rounded up to a power of two.
template <int D, typename T, typename F>
static int with_group(int G, F&& f) {
  if (G <= 1) return f(DsKernel<D, T, 1>());
  if (G <= 2) return f(DsKernel<D, T, 2>());
  if (G <= 4) return f(DsKernel<D, T, 4>());
  return f(DsKernel<D, T, 8>());
}

template <typename F>
static int with_kernel(int D, int quantized, int G, F&& f) {
  switch (D) {
    case 32: return quantized ? with_group<32, int8_t>(G, f) : with_group<32, bf16>(G, f);
    case 64: return quantized ? with_group<64, int8_t>(G, f) : with_group<64, bf16>(G, f);
    case 128: return quantized ? with_group<128, int8_t>(G, f) : with_group<128, bf16>(G, f);
    case 256: return quantized ? with_group<256, int8_t>(G, f) : with_group<256, bf16>(G, f);
    default: return -1;
  }
}

}  // namespace
}  // namespace mnn

using namespace mnn;

MNN_API int mnn_decode_step(const void* qkv, const void* k_cache, const void* v_cache,
                            const void* k_scale, const void* v_scale, const void* cos,
                            const void* sin, const void* q_norm, const void* k_norm,
                            const void* lengths, void* att, void* k_row, void* v_row,
                            void* k_sc, void* v_sc, int B, int Hkv, int G, int D, int S,
                            int layer, int quantized, int window, int sink, float softcap,
                            float scale, float eps, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > DS_GMAX || B < 1 || Hkv < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const int e = with_kernel(D, quantized, G, [&](auto k) {
    return k.launch(qkv, k_cache, v_cache, k_scale, v_scale, cos, sin, q_norm, k_norm,
                    lengths, att, k_row, v_row, k_sc, v_sc, B, Hkv, G, S, layer, window, sink,
                    softcap, scale, eps, st);
  });
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}

// The split mnn_decode_step takes: out = (blocks a cluster, positions a
// tile, dynamic shared bytes a block, blocks). Launches nothing.
MNN_API int mnn_decode_step_split(int B, int Hkv, int G, int S, int D, int quantized,
                                  int* out) {
  if (B < 1 || Hkv < 1 || G < 1 || G > DS_GMAX || S < 1) return (int)cudaErrorInvalidValue;
  int P = 0, bytes = 0;
  if (with_kernel(D, quantized, G, [&](auto k) {
        P = k.splits(B, Hkv, S);
        bytes = k.bytes(P, G);
        return 0;
      }) < 0)
    return (int)cudaErrorInvalidValue;
  out[0] = P;
  out[1] = DS_TP;
  out[2] = bytes;
  out[3] = B * Hkv * P;
  return 0;
}

#ifdef MNN_DS_CLOCKS
// The clock64() stamps of the launches since the last call, [2 blocks]
// [DS_CLOCK_SLOTS] (0 where a slot was not reached); then zeroes them.
MNN_API int mnn_decode_step_clocks(long long* out) {
  void* dev = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(out, ds_clocks, sizeof(ds_clocks));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, ds_clocks);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, sizeof(ds_clocks));
  return (int)e;
}
#endif
