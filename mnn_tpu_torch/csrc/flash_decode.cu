// Single-position GQA decode attention over the stacked KV cache (sm_90a).
//
// Replaces mnn_tpu/kernels/flash_attention.py::_decode_kernel. One query
// position per sequence, q [B, H, D] bf16, attends over the first kv_len[b]
// positions of layer `layer` of a [L, B, Hkv, S, D] cache that already holds
// the new token. The cache is bf16, int8 or nibble-packed int4 ([.., D/2]
// bytes, unpacked as (lo - 8, hi - 8) for dims (j, j + D/2)); the K scale
// multiplies score columns, the V scale probability columns, and the
// probability times the V scale is rounded to bf16 before the P.V product,
// as the TPU kernel casts it to V's type. Masks: col < kv_len, and with a
// window col > kv_len - 1 - window or col < sink. l == 0 -> 1; bf16 out.
//
// What bounds it: at batch 1 a KV head is a few hundred positions of 32 to
// 256 bytes, microseconds of neither bytes nor operations, so latency holds
// it: the longest chain of dependent steps, and how few SMs take part. The
// design:
//  * P blocks a (batch row, KV head) take the tiles of FD_TP visible
//    positions (the sink's, then the window's; or all of [0, kv_len)) in
//    turn: block p tiles p, p + P, ... P comes from B, Hkv and the capacity
//    S, never from the lengths, which stay on the device: the most of 1, 2,
//    4, 8, 16 whose grid stays within two blocks an SM, with at least one
//    tile of S a block (`fd_splits`). The lengths only decide, on the device,
//    which blocks find a tile: where block 0 finds them all it writes the
//    output alone and the others stop at once; else every block takes part
//    in the merge, with a tile or without;
//  * a block stages its tiles, the K and V rows and their scales, by
//    cp.async into a two-stage ring; the first two are requested as soon as
//    kv_len[b] is read, and block 0's first (positions [0, FD_TP) when there
//    is no window) before it, so a short sequence costs one trip to memory;
//  * a tile costs three steps between block barriers: scores with NJ lanes a
//    position (a quarter of its row each, unpacked from shared memory,
//    q from shared memory in the same chunked order, summed over the NJ
//    lanes by shuffles); one max and one sum per query row over the whole
//    tile (a warp a row); P.V with a warp a position, each lane a few bytes
//    of the V row and all GP rows in registers, so the warps' sums meet once,
//    in shared memory. GP is the group padded to 1, 2, 4 or 8, so every loop
//    over the rows unrolls without a guard. With one row (GP = 1, the
//    mixture-of-experts heads) a tile takes two steps: the scores step also
//    takes the tile's max (a warp's max, then an integer atomic max in
//    shared memory), and each warp weights its own positions in P.V and keeps
//    its share of the sum;
//  * the partial states (m, l, acc) of the blocks that found tiles meet in a
//    workspace in device memory, and the last block of a KV head to arrive
//    (one counter a KV head, left at zero by that block) merges them in
//    block order: the same bits every run, no floating-point atomics. This
//    merge was chosen over a cluster's shared-memory merge (decode_step.cu)
//    because it needs nothing from the caller and no cluster: the workspace
//    and counters are this file's own device arrays, allocated once per
//    device when the module loads, zero at load, sized for the largest grid
//    the split rule makes, so the C entry keeps its arguments and a captured
//    CUDA graph replays with the counters at zero. Two calls on one device
//    must not run at once (on two streams): they would share the workspace.
#include <type_traits>

#include "common.cuh"

namespace mnn {
namespace {   // internal linkage: two builds of this source may share a process

constexpr int FD_THREADS = 256, FD_WARPS = FD_THREADS / 32, FD_GMAX = 8, FD_STAGES = 2;
constexpr int FD_TP = 64;   // positions a tile
#ifdef MNN_FD_PMAX
constexpr int FD_PMAX = MNN_FD_PMAX;   // most blocks a KV head (build-time cap, for timing)
#else
constexpr int FD_PMAX = 16;
#endif
static_assert(FD_TP % 32 == 0, "a tile is whole warps of positions");

// The merge's workspace: a block's state is (m, l) [GMAX] and acc [GMAX][128].
constexpr int FD_WS_BLOCKS = 512;   // most blocks of a split grid
constexpr int FD_STATE = 2 * FD_GMAX + FD_GMAX * 128;
__device__ float fd_ws[FD_WS_BLOCKS * FD_STATE];
__device__ int fd_cnt[FD_WS_BLOCKS];

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
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Shared memory of one block, in bytes from the start of the dynamic array.
template <int D, int KVB, int GP>
struct Layout {
  static constexpr int ROWB = D * KVB / 8;            // bytes of a cache row
  static constexpr int CB = ROWB >= 64 ? ROWB / 4 : 16;   // bytes of a row a lane scores
  static constexpr int NJ = ROWB / CB;                // lanes a position: 4 (2 for 32 bytes)
  static constexpr int CV = CB * 8 / KVB;             // values a lane scores
  static constexpr int QR = NJ * (CV + 4);            // a q row lane by lane, 4 floats of pad
  static constexpr int KV = FD_TP * ROWB;             // a K or V tile
  static constexpr int STAGE = 2 * KV + 2 * FD_TP * 4;   // K, V, K scales, V scales
  static constexpr int Q = FD_STAGES * STAGE;         // q rows [GP][QR] f32
  static constexpr int S = Q + GP * QR * 4;           // scores [GP][TP]
  static constexpr int P = S + GP * FD_TP * 4;        // rounded p x V scale [GP][TP]
  static constexpr int RED = P + GP * FD_TP * 4;      // per-warp P.V sums [WARPS][GP][D]
  static constexpr int VEC = RED + FD_WARPS * GP * D * 4;   // alpha, m, l [GMAX]; a flag
  static constexpr int BYTES = VEC + 3 * FD_GMAX * 4 + 16;
};

// Where dim d of a q row lies in the layout of the lanes' shares: lane c of
// a position takes bytes [c CB, (c + 1) CB) of the row, which hold dims
// [c CV, (c + 1) CV), or for int4 dims [c CB, (c + 1) CB) in their low
// nibbles and the same dims of the high half in their high nibbles.
template <int D, int KVB, int CB>
__device__ __forceinline__ int qidx(int d) {
  constexpr int CV = CB * 8 / KVB;
  if constexpr (KVB == 4) {
    const int hi = d >= D / 2, e = d - hi * (D / 2);
    return (e / CB) * (CV + 4) + hi * CB + e % CB;
  }
  return (d / CV) * (CV + 4) + d % CV;
}

// A lane's CB bytes of a cache row as f32, in the order of qidx.
template <int KVB, int CB>
__device__ __forceinline__ void chunk_to_f(const unsigned char* p, float* x) {
#pragma unroll
  for (int h = 0; h < CB / 16; ++h) {
    const uint4 u = reinterpret_cast<const uint4*>(p)[h];
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (KVB == 16) {
        x[8 * h + 2 * i] = __uint_as_float(w[i] << 16);
        x[8 * h + 2 * i + 1] = __uint_as_float(w[i] & 0xFFFF0000u);
      } else if constexpr (KVB == 8) {
#pragma unroll
        for (int k = 0; k < 4; ++k) x[16 * h + 4 * i + k] = (float)(int8_t)(w[i] >> (8 * k));
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          x[16 * h + 4 * i + k] = (float)((int)((w[i] >> (8 * k)) & 0xFu) - 8);
          x[CB + 16 * h + 4 * i + k] = (float)((int)((w[i] >> (8 * k + 4)) & 0xFu) - 8);
        }
      }
    }
  }
}

// A float as an int that orders as the float does (for a max by integer
// atomics), and back.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7FFFFFFF;
}
__device__ __forceinline__ float key_value(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7FFFFFFF);
}

// VB bytes of a V row as f32: VB / 2 bf16 values, VB int8 values, or VB int4
// bytes, whose low nibbles come first and high nibbles after.
template <int KVB, int VB>
__device__ __forceinline__ void v_to_f(const uint8_t* p, float* v) {
  uint32_t w[2] = {0u, 0u};
  if constexpr (VB == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    w[0] = u.x, w[1] = u.y;
  } else if constexpr (VB == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (VB == 2) {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    w[0] = *p;
  }
#pragma unroll
  for (int i = 0; i < (KVB == 16 ? VB / 2 : VB); ++i) {
    if constexpr (KVB == 16) {
      v[i] = __uint_as_float(((w[i / 2] >> (16 * (i % 2))) & 0xFFFFu) << 16);
    } else if constexpr (KVB == 8) {
      v[i] = (float)(int8_t)(w[0] >> (8 * i));
    } else {
      v[i] = (float)((int)((w[0] >> (8 * i)) & 0xFu) - 8);
      v[VB + i] = (float)((int)((w[0] >> (8 * i + 4)) & 0xFu) - 8);
    }
  }
}

// Block (part, bh) of the grid [P][B * Hkv], part-major, so that the blocks
// of low parts, which short sequences keep busy, are dispatched first.
template <int D, int KVB, int GP>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ k_cache,
                    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ kv_len,
                    bf16* __restrict__ out, int B, int Hkv, int G, int S, int layer,
                    int window, int sink, float scale, int P) {
  using L = Layout<D, KVB, GP>;
  constexpr bool QUANT = KVB < 16;
  constexpr int ROWB = L::ROWB, CB = L::CB, NJ = L::NJ, CV = L::CV, QR = L::QR;
  constexpr int PP = FD_THREADS / NJ;                 // positions a pass of the scores
  constexpr int VB = ROWB / 32;                       // P.V: a warp a position, VB bytes a lane
  constexpr int VD = KVB == 16 ? VB / 2 : KVB == 8 ? VB : 2 * VB;   // ... and VD dims
  constexpr int QPT = (GP * D + FD_THREADS - 1) / FD_THREADS;       // q values a thread stages
  static_assert(GP <= FD_GMAX && GP <= FD_WARPS, "a warp a query row in the softmax");
  static_assert(NJ <= 32 && VB >= 1, "a position's lanes lie in one warp");
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::Q);
  float* s_s = reinterpret_cast<float*>(smem + L::S);
  float* p_s = reinterpret_cast<float*>(smem + L::P);
  float* red_s = reinterpret_cast<float*>(smem + L::RED);
  float* alpha_s = reinterpret_cast<float*>(smem + L::VEC);
  int* tmax_s = reinterpret_cast<int*>(alpha_s);     // GP = 1: the tile's max [2], by tile parity
  float* m_s = alpha_s + FD_GMAX;
  float* l_s = m_s + FD_GMAX;
  int* flag = reinterpret_cast<int*>(l_s + FD_GMAX);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int BH = B * Hkv;
  const int part = blockIdx.x / BH, bh = blockIdx.x - part * BH;
  const int b = bh / Hkv;
  const long base = ((long)(layer * B + b) * Hkv + (bh - b * Hkv)) * S;
  const uint8_t* kc = k_cache + base * ROWB;
  const uint8_t* vc = v_cache + base * ROWB;
  const float* ksc = QUANT ? k_scale + base : nullptr;
  const float* vsc = QUANT ? v_scale + base : nullptr;

  // q goes out first, into registers; it lands in shared memory later
  bf16 qv[QPT];
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int i = tid + k * FD_THREADS, g = i / D;
    qv[k] = i < GP * D && g < G ? q[((long)bh * G + g) * D + i - g * D] : __float2bfloat16_rn(0.f);
  }

  // The visible positions, in order: the sink's [0, n_sink), then [w0, n),
  // in tiles of FD_TP; this block takes tiles part, part + P, ... Its i-th
  // tile goes to stage i & 1, positions past `count` zero-filled.
  int w0 = 0, n_sink = 0, count = S;
  auto load_tile = [&](int i) {
    unsigned char* st = smem + (i & 1) * L::STAGE;
    float* kst = reinterpret_cast<float*>(st + 2 * L::KV);
    const int vb = (part + i * P) * FD_TP;
#pragma unroll
    for (int c = tid; c < FD_TP * (ROWB / 16); c += FD_THREADS) {
      const int r = c / (ROWB / 16), x = (c - r * (ROWB / 16)) * 16;
      const int v = vb + r;
      const bool ok = v < count;
      const long off = ok ? (long)(v < n_sink ? v : w0 + v - n_sink) * ROWB + x : 0;
      cp16(st + r * ROWB + x, kc + off, ok);
      cp16(st + L::KV + r * ROWB + x, vc + off, ok);
    }
    if (QUANT && tid < 2 * FD_TP) {
      const int v = vb + tid % FD_TP;
      const bool ok = v < count;
      const long pos = ok ? (v < n_sink ? v : w0 + v - n_sink) : 0;
      cp4(kst + tid, (tid < FD_TP ? ksc : vsc) + pos, ok);
    }
  };
  // Without a window, block 0's first tile is positions [0, FD_TP) whatever
  // the length: it goes out before the length is read (positions past it
  // are masked below). The others wait for the length.
  const bool early = window <= 0 && part == 0;
  if (early) load_tile(0);
  const int n = min(max(kv_len[b], 0), S);
  if (window > 0) {
    w0 = max(0, n - window);
    n_sink = min(max(sink, 0), w0);
  }
  count = n_sink + n - w0;
  const int all_tiles = (count + FD_TP - 1) / FD_TP;
  const int active = min(P, all_tiles);    // blocks that take positions
  const int tiles = part < all_tiles ? (all_tiles - part + P - 1) / P : 0;
  if (active <= 1 && part > 0) return;     // block 0 alone: no merge, nothing to wait for
  if (!early && tiles > 0) load_tile(0);
  commit();
  if (tiles > 1) load_tile(1);
  commit();
#pragma unroll
  for (int k = 0; k < QPT; ++k) {   // q rows in the chunked order; the padded rows are zero
    const int i = tid + k * FD_THREADS, g = i / D;
    if (i < GP * D) q_s[g * QR + qidx<D, KVB, CB>(i - g * D)] = bf2f(qv[k]);
  }

  // row `warp`'s state (warps < GP); with one row, every warp's share of it
  float m = NEG_INF, l = 0.f;
  constexpr int KEY_MIN = -0x7FFFFFFF - 1;
  if (GP == 1 && tid < 2) tmax_s[tid] = KEY_MIN;
  float acc[GP][VD];
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int k = 0; k < VD; ++k) acc[g][k] = 0.f;
  for (int j = 0; j < tiles; ++j) {
    wait_copies<1>();
    __syncthreads();
    const unsigned char* st = smem + (j & 1) * L::STAGE;
    const float* kst = reinterpret_cast<const float*>(st + 2 * L::KV);
    const float* vst = kst + FD_TP;
    const int valid = min(FD_TP, count - (part + j * P) * FD_TP);   // positions of this tile

    // scores: NJ lanes a position, CB bytes of its row each
#pragma unroll
    for (int r0 = 0; r0 < FD_TP; r0 += PP) {
      const int r = r0 + tid / NJ, cj = tid % NJ;
      if (r0 + warp * (32 / NJ) < valid) {   // a warp with no valid position rests
        float kv[CV];
        chunk_to_f<KVB, CB>(st + min(r, FD_TP - 1) * ROWB + cj * CB, kv);
        const float* qc = q_s + cj * (CV + 4);
        float dot[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          dot[g] = 0.f;
#pragma unroll
          for (int e = 0; e < CV; e += 4) {
            const float4 q4 = *reinterpret_cast<const float4*>(qc + g * QR + e);
            dot[g] += q4.x * kv[e] + q4.y * kv[e + 1] + q4.z * kv[e + 2] + q4.w * kv[e + 3];
          }
        }
#pragma unroll
        for (int o = 1; o < NJ; o <<= 1)
#pragma unroll
          for (int g = 0; g < GP; ++g) dot[g] += __shfl_xor_sync(0xffffffffu, dot[g], o);
        const float ks = QUANT ? kst[min(r, FD_TP - 1)] : 1.f;
        float sc[GP];
#pragma unroll
        for (int g = 0; g < GP; ++g)
          sc[g] = __fmul_rn(QUANT ? __fmul_rn(dot[g], ks) : dot[g], scale);
        if (r < FD_TP)
#pragma unroll
          for (int g = 0; g < GP; ++g)
            if (cj == g % NJ) s_s[g * FD_TP + r] = sc[g];
        if constexpr (GP == 1) {   // the tile's max: the warp's, then an atomic one
          const int wmax = __reduce_max_sync(0xffffffffu, r < valid ? order_key(sc[0]) : KEY_MIN);
          if (lane == 0) atomicMax(tmax_s + (j & 1), wmax);
        }
      }
    }
    __syncthreads();

    // one max and one sum per query row across the tile: a warp a row (with
    // one row, the max is in and each warp sums its own positions in P.V)
    if (GP > 1 && warp < GP) {
      constexpr int PL = FD_TP / 32;
      float sv[PL], mx = NEG_INF;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        sv[i] = lane + 32 * i < valid ? s_s[warp * FD_TP + lane + 32 * i] : NEG_INF;
        mx = fmaxf(mx, sv[i]);
      }
      const float m_new = fmaxf(m, warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < PL; ++i) {
        const int t = lane + 32 * i;
        const float p = t < valid ? expf(sv[i] - m_new) : 0.f;
        psum += p;
        if (t < valid) p_s[warp * FD_TP + t] = round_bf16(QUANT ? __fmul_rn(p, vst[t]) : p);
      }
      const float alpha = expf(m - m_new);
      l = l * alpha + warp_sum(psum);
      m = m_new;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    if (GP > 1) __syncthreads();

    // P.V: warp w takes the tile's positions w, w + 8, ..., each lane VB
    // bytes of the V row, for every query row
    if constexpr (GP == 1) {
      const float m_new = fmaxf(m, key_value(tmax_s[j & 1]));
      const float a = expf(m - m_new);
      l *= a;
#pragma unroll
      for (int k = 0; k < VD; ++k) acc[0][k] *= a;
      m = m_new;
      if (tid == 0) tmax_s[(j + 1) & 1] = KEY_MIN;   // read by no one since the top barrier
    } else {
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float a = alpha_s[g];
#pragma unroll
        for (int k = 0; k < VD; ++k) acc[g][k] *= a;
      }
    }
#pragma unroll
    for (int t = warp; t < FD_TP; t += FD_WARPS) {
      if (t >= valid) break;
      float v[VD], p1 = 0.f;
      if constexpr (GP == 1) {
        const float e = expf(s_s[t] - m);
        l += e;
        p1 = round_bf16(QUANT ? __fmul_rn(e, vst[t]) : e);
      }
      v_to_f<KVB, VB>(st + L::KV + t * ROWB + lane * VB, v);
#pragma unroll
      for (int g = 0; g < GP; ++g) {
        const float p = GP == 1 ? p1 : p_s[g * FD_TP + t];
#pragma unroll
        for (int k = 0; k < VD; ++k) acc[g][k] = fmaf(p, v[k], acc[g][k]);
      }
    }
    if (j + 2 < tiles) {
      __syncthreads();   // the stage and p_s are free again
      load_tile(j + 2);
    }
    commit();
  }
  wait_copies<0>();

  // The warps' sums through shared memory, added in a fixed order.
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int k = 0; k < VD; ++k) {
      const int d = KVB == 4 ? (k < VB ? lane * VB + k : D / 2 + lane * VB + k - VB)
                             : lane * VD + k;
      red_s[(warp * GP + g) * D + d] = acc[g][k];
    }
  if (lane == 0 && (GP == 1 || warp < GP)) {   // with one row, l_s holds the warps' shares
    if (GP > 1 || warp == 0) m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  auto row_l = [&](int g) {
    float lg = l_s[g];
    if constexpr (GP == 1)
#pragma unroll
      for (int w = 1; w < FD_WARPS; ++w) lg += l_s[w];
    return lg;
  };

  bf16* o = out + (long)bh * G * D;
  if (active <= 1) {
    for (int i = tid; i < G * D; i += FD_THREADS) {
      const int g = i / D, d = i - g * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) a += red_s[(w * GP + g) * D + d];
      const float lg = row_l(g);
      o[i] = __float2bfloat16_rn(a / (lg == 0.f ? 1.f : lg));
    }
    return;
  }

  // Park this block's state in the workspace (slot part * BH + bh); the last
  // of the KV head's P blocks to arrive merges the states of the `active`
  // ones in block order. A block past the positions parks nothing but
  // arrives all the same.
  if (tiles > 0) {
    float* mine = fd_ws + (long)blockIdx.x * FD_STATE;
    if (tid < G) {
      __stcg(mine + tid, m_s[tid]);
      __stcg(mine + FD_GMAX + tid, row_l(tid));
    }
    for (int i = tid; i < G * D; i += FD_THREADS) {
      const int g = i / D, d = i - g * D;
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < FD_WARPS; ++w) a += red_s[(w * GP + g) * D + d];
      __stcg(mine + 2 * FD_GMAX + i, a);
    }
  }
  if (!arrive_last(&fd_cnt[bh], P, flag)) return;
  for (int i = tid; i < G * D; i += FD_THREADS) {
    const int g = i / D;
    float mp[FD_PMAX], lp[FD_PMAX], ap[FD_PMAX];   // every load goes out before the math
#pragma unroll
    for (int r = 0; r < FD_PMAX; ++r) {
      const float* st = fd_ws + ((long)min(r, active - 1) * BH + bh) * FD_STATE;
      mp[r] = __ldcg(st + g);
      lp[r] = __ldcg(st + FD_GMAX + g);
      ap[r] = __ldcg(st + 2 * FD_GMAX + i);
    }
    float mx = NEG_INF;
#pragma unroll
    for (int r = 0; r < FD_PMAX; ++r)
      if (r < active) mx = fmaxf(mx, mp[r]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int r = 0; r < FD_PMAX; ++r)
      if (r < active) {
        const float e = expf(mp[r] - mx);
        lsum += lp[r] * e;
        a += ap[r] * e;
      }
    o[i] = __float2bfloat16_rn(a / (lsum == 0.f ? 1.f : lsum));
  }
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

// Blocks a (batch row, KV head): the most of 1, 2, 4, 8, 16 (up to FD_PMAX)
// whose grid stays within two blocks an SM and the workspace, with at least
// one tile of the capacity S a block. The lengths never enter: they stay on
// the device.
static int fd_splits(int B, int Hkv, int S) {
  const long bh = (long)B * Hkv;
  int P = 1;
  while (2 * P <= FD_PMAX && bh * 2 * P <= 2L * sm_count() && bh * 2 * P <= FD_WS_BLOCKS &&
         (long)S >= (long)FD_TP * 2 * P)
    P *= 2;
  return P;
}

template <int D, int KVB, int GP>
static int launch(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* lens, void* out, int B, int Hkv, int G,
                  int S, int layer, int window, int sink, float scale, cudaStream_t st) {
  auto kern = flash_decode_kernel<D, KVB, GP>;
  static size_t granted = 48 << 10;
  cudaError_t e = allow_smem(kern, Layout<D, KVB, GP>::BYTES, granted);
  if (e != cudaSuccess) return (int)e;
  const int P = fd_splits(B, Hkv, S);
  kern<<<B * Hkv * P, FD_THREADS, Layout<D, KVB, GP>::BYTES, st>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<bf16*>(out), B, Hkv, G, S, layer, window, sink, scale, P);
  return (int)cudaGetLastError();
}

// f(D, KVB, GP) for a head dim, cache width and group: GP = G rounded up to a
// power of two. -1 where no kernel serves them.
template <typename F>
static int with_kernel(int D, int kv_bits, int G, F&& f) {
#define MNN_FD_GROUPS(DD, KK)                                                       \
  if (D == DD && kv_bits == KK) {                                                   \
    if (G <= 1) return f(std::integral_constant<int, DD>(), std::integral_constant<int, KK>(), \
                         std::integral_constant<int, 1>());                         \
    if (G <= 2) return f(std::integral_constant<int, DD>(), std::integral_constant<int, KK>(), \
                         std::integral_constant<int, 2>());                         \
    if (G <= 4) return f(std::integral_constant<int, DD>(), std::integral_constant<int, KK>(), \
                         std::integral_constant<int, 4>());                         \
    return f(std::integral_constant<int, DD>(), std::integral_constant<int, KK>(),  \
             std::integral_constant<int, 8>());                                     \
  }
  MNN_FD_GROUPS(64, 16)
  MNN_FD_GROUPS(64, 8)
  MNN_FD_GROUPS(64, 4)
  MNN_FD_GROUPS(128, 16)
  MNN_FD_GROUPS(128, 8)
  MNN_FD_GROUPS(128, 4)
#undef MNN_FD_GROUPS
  return -1;
}

}  // namespace
}  // namespace mnn

using namespace mnn;

MNN_API int mnn_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                             const void* k_scale, const void* v_scale, const void* kv_len,
                             void* out, int B, int Hkv, int G, int D, int S, int layer,
                             int kv_bits, int window, int sink, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > FD_GMAX || B < 1 || Hkv < 1 || S < 1) return (int)cudaErrorInvalidValue;
  if (((uintptr_t)k_cache | (uintptr_t)v_cache) % 16) return (int)cudaErrorMisalignedAddress;
  const int e = with_kernel(D, kv_bits, G, [&](auto dd, auto kk, auto gp) {
    return launch<decltype(dd)::value, decltype(kk)::value, decltype(gp)::value>(
        q, k_cache, v_cache, k_scale, v_scale, kv_len, out, B, Hkv, G, S, layer, window, sink,
        scale, st);
  });
  return e < 0 ? (int)cudaErrorInvalidValue : e;
}

// The split mnn_flash_decode takes: out = (blocks a KV head, positions a
// tile, dynamic shared bytes a block, blocks). Launches nothing.
MNN_API int mnn_flash_decode_split(int B, int Hkv, int G, int S, int D, int kv_bits, int* out) {
  if (G < 1 || G > FD_GMAX || B < 1 || Hkv < 1 || S < 1) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  if (with_kernel(D, kv_bits, G, [&](auto dd, auto kk, auto gp) {
        bytes = Layout<decltype(dd)::value, decltype(kk)::value, decltype(gp)::value>::BYTES;
        return 0;
      }) < 0)
    return (int)cudaErrorInvalidValue;
  const int P = fd_splits(B, Hkv, S);
  out[0] = P;
  out[1] = FD_TP;
  out[2] = bytes;
  out[3] = B * Hkv * P;
  return 0;
}
