// Whole-model decode step in one kernel (sm_90a), the kernel template: every
// layer of one decode position, then the final norm, the lm-head GEMV and the
// greedy argmax.
//
// Replaces mnn_tpu/kernels/decode_model.py::_kernel. Contract (operands,
// packed layouts, rounding points) as kernels/decode_model.py describes it;
// the TPU kernel's VMEM plan and slot rings are not carried over.
//
// Design. One decode token reads every weight byte once and does two
// operations per weight, so the bound is bytes; what the per-layer path pays
// instead is some hundreds of launches. This is one cooperative launch of a
// persistent grid (as many 256-thread blocks as are co-resident, at most two
// per SM) with a grid-wide barrier between phases:
//
//   prologue   x -> residual stream, sums of squares for the first norm
//   per layer  qkv GEMV | attention per (batch row, KV head) | wo GEMV +
//              residual | gate/up GEMV + SwiGLU | down GEMV + residual
//   head       final norm + lm-head GEMV + per-tile argmax | argmax merge
//
// A GEMV is cut into (128-column tile, K range) items, one per block, so all
// blocks stream weights at once even where N is 896. Inside an item the 8
// warps take 32-value K chunks: a lane loads one x value (normalized and
// rounded to bf16 on the way) and broadcasts it by shuffle, and reads 4
// adjacent output columns as one 32-bit word per packed row, 16 rows in
// flight. Warps are summed in shared memory; K ranges of one tile meet in
// device memory, and the last block to arrive (an atomic counter per tile)
// adds them in a fixed order and applies the phase's epilogue, so the result
// does not depend on timing. The attention phase is latency, not bytes: a
// (batch row, KV head) gets one block per 64 cached positions, each warp takes
// 8 positions with four lanes to a column (attn_common.cuh), and the blocks'
// softmax states are merged by the last to arrive, again in a fixed order.
// Activations live in small scratch buffers that stay in L2 and are read
// with __ldcg (L1 is not coherent across SMs). Loads whose values are summed
// go out together before the first add: an add waits for its load, and a
// loop of load-add pairs would pay one trip to L2 per term. Lengths are read
// from device memory; every block reaches every barrier.
//
// The kernel is a template on BM, the batch rows it holds in registers
// (1, 2, 4 or 8). Each instantiation is compiled in a source of its own,
// decode_model_b<BM>.cu, so that the build compiles them side by side;
// decode_model.cu holds the C entry.
#pragma once

#include <cooperative_groups.h>

#include "attn_common.cuh"

namespace cg = cooperative_groups;

namespace mnn {

constexpr int DM_THREADS = 256, DM_WARPS = 8, DM_TILE = 128, DM_MAXB = 8;
constexpr int DM_ATT_SPLIT = 16;   // most blocks that share one (batch row, KV head)
enum { EPI_QKV = 0, EPI_RES = 1, EPI_ACT = 2, EPI_HEAD = 3 };

struct DmParams {
  const float* x;
  const int* lengths;
  const float *cos, *sin;
  const uint8_t *wqkv_p, *wo_p, *wgu_p, *wdn_p, *head_p;
  const bf16 *wqkv_s, *wqkv_b, *wo_s, *wo_b, *wgu_s, *wgu_b, *wdn_s, *wdn_b, *head_s, *head_b;
  const float *qkv_bias, *in_norm, *post_norm, *q_norm, *k_norm, *final_norm;
  uint8_t *k_cache, *v_cache;
  float *k_scale, *v_scale;
  float *x_out, *k_rows, *v_rows, *k_sc, *v_sc, *logits;
  int* token;
  // scratch
  float *qkv, *att, *act, *part, *ssq, *best_val, *att_part;
  int *best_idx, *counters;
  long long* clocks;   // optional: block 0's clock after every phase, or null
  int B, L, H, NH, Hkv, D, I, S, V, NQ, DQ;
  int bits, bs_h, bs_i, head_bits, bs_head, kv_bits, window, sink, write_cache;
  int split_qkv, split_wo, split_gu, split_dn, split_head, att_split;
  float sm_scale, eps;
};

struct Gemv {               // one quantized projection of the step
  const float* in;          // [B, K] f32
  const float* norm_w;      // RMS-norm weight [K]; null: the input as it is
  const uint8_t* packed;    // this layer's [K * bits / 8, N]
  const bf16 *scale, *bias;  // [K / bs, N]
  int K, N, bs, nsplit, epi;
  const float* out_bias;    // EPI_QKV, or null
  float* out;               // QKV: [B, N]; RES: the residual stream [B, N],
                            // updated in place; ACT: [B, N / 2]; HEAD: logits
};

// Block 0 notes its SM clock at the end of a phase (after the barrier).
__device__ __forceinline__ void stamp(const DmParams& p, int& slot) {
  if (p.clocks && blockIdx.x == 0 && threadIdx.x == 0) p.clocks[slot] = clock64();
  ++slot;
}

// y = x @ dequant(W) for B <= BM rows, then the phase's epilogue.
template <int BITS, int BM>
__device__ __noinline__ void gemv(const Gemv& g, const DmParams& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);       // [WARPS][BM][TILE]
  float* fin = red + DM_WARPS * BM * DM_TILE;        // [BM][TILE]
  float* rinv = fin + BM * DM_TILE;                  // [DM_MAXB]
  int* flag = reinterpret_cast<int*>(rinv + DM_MAXB);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, K = g.K, N = g.N, bs = g.bs, nsplit = g.nsplit;

  if (g.norm_w) {   // 1 / rms of each input row, from the tiles' sums of squares:
    float s = 0.f;  // warp b sums row b's tiles, one load per lane
    if (warp < B)
      for (int t = lane; t < (K + DM_TILE - 1) / DM_TILE; t += 32)
        s += __ldcg(&p.ssq[t * DM_MAXB + warp]);
    s = warp_sum(s);
    if (lane == 0) rinv[warp] = rsqrtf(s / (float)K + p.eps);
  }
  __syncthreads();

  constexpr int RPC = BITS == 4 ? 16 : 32;   // packed rows per 32-value chunk
  const int ntiles = (N + DM_TILE - 1) / DM_TILE;
  const int nchunks = K / 32, cps = (nchunks + nsplit - 1) / nsplit;
  const int cpb = bs / 32, half = bs >> 1;

  for (int item = blockIdx.x; item < ntiles * nsplit; item += gridDim.x) {
    const int t = item % ntiles, ks = item / ntiles;
    const int c0 = t * DM_TILE + lane * 4;
    const bool col_ok = c0 < N;
    float acc[BM][4];
#pragma unroll
    for (int b = 0; b < BM; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

    const int ch_hi = min(nchunks, (ks + 1) * cps);
    for (int ch = ks * cps + warp; ch < ch_hi; ch += DM_WARPS) {
      const int kb = ch / cpb, sub = ch - kb * cpb;
      // W4: lanes 0-15 hold x for the low nibbles of the chunk's 16 packed
      // rows, lanes 16-31 for the high nibbles (offset bs / 2 in the block)
      const int kx = BITS == 4 ? kb * bs + sub * 16 + (lane & 15) + (lane >> 4) * half
                               : ch * 32 + lane;
      const long row0 = BITS == 4 ? (long)kb * half + sub * 16 : (long)ch * 32;
      float part[BM][4], rs[BM];
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        rs[b] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) part[b][j] = 0.f;
      }
      const uint8_t* wp = g.packed + row0 * N + c0;
      float xv[BM];
#pragma unroll
      for (int r0 = 0; r0 < RPC; r0 += 16) {
        uint32_t w[16];   // the weight loads go out before anything waits on x
#pragma unroll
        for (int i = 0; i < 16; ++i)
          w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(wp + (long)(r0 + i) * N)) : 0u;
        if (r0 == 0) {
#pragma unroll
          for (int b = 0; b < BM; ++b) {
            xv[b] = 0.f;
            if (b < B) {
              float v = __ldcg(&g.in[(long)b * K + kx]);
              if (g.norm_w) v = __fmul_rn(__fmul_rn(v, rinv[b]), g.norm_w[kx]);
              xv[b] = round_bf16(v);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          if (BITS == 4) {
            float lo[4], hi[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              lo[j] = u2f((w[i] >> (8 * j)) & 0xFu);
              hi[j] = u2f((w[i] >> (8 * j + 4)) & 0xFu);
            }
#pragma unroll
            for (int b = 0; b < BM; ++b) {
              const float xa = __shfl_sync(0xffffffffu, xv[b], i);
              const float xb = __shfl_sync(0xffffffffu, xv[b], 16 + i);
              rs[b] += xa + xb;
#pragma unroll
              for (int j = 0; j < 4; ++j) part[b][j] += xa * lo[j] + xb * hi[j];
            }
          } else {
            float q[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) q[j] = u2f((w[i] >> (8 * j)) & 0xFFu);
#pragma unroll
            for (int b = 0; b < BM; ++b) {
              const float xa = __shfl_sync(0xffffffffu, xv[b], r0 + i);
              rs[b] += xa;
#pragma unroll
              for (int j = 0; j < 4; ++j) part[b][j] += xa * q[j];
            }
          }
        }
      }
      if (col_ok) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float s = bf2f(g.scale[(long)kb * N + c0 + j]);
          const float m = bf2f(g.bias[(long)kb * N + c0 + j]);
#pragma unroll
          for (int b = 0; b < BM; ++b)
            acc[b][j] = __fadd_rn(__fadd_rn(acc[b][j], __fmul_rn(part[b][j], s)),
                                  __fmul_rn(rs[b], m));
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BM; ++b)
#pragma unroll
      for (int j = 0; j < 4; ++j) red[(warp * BM + b) * DM_TILE + lane * 4 + j] = acc[b][j];
    __syncthreads();
    for (int idx = tid; idx < BM * DM_TILE; idx += DM_THREADS) {
      const int b = idx / DM_TILE, c = idx - b * DM_TILE;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < DM_WARPS; ++w) v += red[(w * BM + b) * DM_TILE + c];
      fin[idx] = v;
    }
    bool last = true;
    if (nsplit > 1) {
      // the K ranges of this tile meet in device memory; the last block to
      // arrive adds them in the order of the ranges
      for (int idx = tid; idx < BM * DM_TILE; idx += DM_THREADS) {
        const int b = idx / DM_TILE, col = t * DM_TILE + idx - b * DM_TILE;
        if (b < B && col < N) __stcg(&p.part[((long)ks * B + b) * N + col], fin[idx]);
      }
      __threadfence();
      __syncthreads();
      if (tid == 0) {
        const int arrived = atomicAdd(&p.counters[t], 1);
        *flag = arrived == nsplit - 1;
        if (arrived == nsplit - 1) p.counters[t] = 0;   // ready for the next phase
      }
      __syncthreads();
      last = *flag != 0;
      if (last) {
        __threadfence();
        for (int idx = tid; idx < BM * DM_TILE; idx += DM_THREADS) {
          const int b = idx / DM_TILE, col = t * DM_TILE + idx - b * DM_TILE;
          float v = 0.f;
          if (b < B && col < N) {
            const float* src = p.part + (long)b * N + col;
            for (int k0 = 0; k0 < nsplit; k0 += 8) {   // 8 loads in flight
              float t8[8];
#pragma unroll
              for (int k = 0; k < 8; ++k)
                t8[k] = k0 + k < nsplit ? __ldcg(src + (long)(k0 + k) * B * N) : 0.f;
#pragma unroll
              for (int k = 0; k < 8; ++k) v += t8[k];
            }
          }
          fin[idx] = v;
        }
      }
    }
    __syncthreads();
    if (last) {
      if (g.epi == EPI_QKV) {
        for (int idx = tid; idx < BM * DM_TILE; idx += DM_THREADS) {
          const int b = idx / DM_TILE, col = t * DM_TILE + idx - b * DM_TILE;
          if (b >= B || col >= N) continue;
          float v = fin[idx];
          if (g.out_bias) v = __fadd_rn(v, g.out_bias[col]);
          __stcg(&g.out[(long)b * N + col], round_bf16(v));
        }
      } else if (g.epi == EPI_RES) {
        // x <- bf16(x + bf16(y)), and the tile's sum of squares of the new x
        for (int idx = tid; idx < BM * DM_TILE; idx += DM_THREADS) {
          const int b = idx / DM_TILE, col = t * DM_TILE + idx - b * DM_TILE;
          float nx = 0.f;
          if (b < B && col < N) {
            const float x = __ldcg(&g.out[(long)b * N + col]);
            nx = round_bf16(__fadd_rn(x, round_bf16(fin[idx])));
            __stcg(&g.out[(long)b * N + col], nx);
          }
          fin[idx] = nx;
        }
        __syncthreads();
        for (int b = warp; b < B; b += DM_WARPS) {
          float s = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float v = fin[b * DM_TILE + lane * 4 + j];
            s += v * v;
          }
          s = warp_sum(s);
          if (lane == 0) __stcg(&p.ssq[t * DM_MAXB + b], s);
        }
      } else if (g.epi == EPI_ACT) {
        // the tile holds 64 gate columns, then their 64 up columns
        for (int idx = tid; idx < BM * (DM_TILE / 2); idx += DM_THREADS) {
          const int b = idx / (DM_TILE / 2), c = idx - b * (DM_TILE / 2);
          if (b >= B) continue;
          const float gate = round_bf16(fin[b * DM_TILE + c]);
          const float up = round_bf16(fin[b * DM_TILE + c + DM_TILE / 2]);
          const float si = round_bf16(__fmul_rn(gate, 1.f / (1.f + expf(-gate))));
          __stcg(&g.out[(long)b * (N / 2) + t * (DM_TILE / 2) + c],
                 round_bf16(__fmul_rn(si, up)));
        }
      } else {   // EPI_HEAD: f32 logits, and the tile's (max, lowest index)
        for (int idx = tid; idx < BM * DM_TILE; idx += DM_THREADS) {
          const int b = idx / DM_TILE, col = t * DM_TILE + idx - b * DM_TILE;
          if (b < B && col < N) g.out[(long)b * N + col] = fin[idx];
        }
        for (int b = warp; b < B; b += DM_WARPS) {
          float bv = -INFINITY;
          int bi = 0x7fffffff;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = t * DM_TILE + lane * 4 + j;
            const float v = fin[b * DM_TILE + lane * 4 + j];
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
    }
    __syncthreads();   // red, fin and flag are reused by the next item
  }
}

template <int BM>
__device__ __forceinline__ void run_gemv(const Gemv& g, const DmParams& p, int bits) {
  if (bits == 4)
    gemv<4, BM>(g, p);
  else
    gemv<8, BM>(g, p);
}

// Rope, QK-norm, quantization of the new K/V row, the seeded softmax over
// the cached positions [0, len_old) of `layer`, for every (batch row, KV head).
// Up to p.att_split blocks share one (row, head): block s of ns takes the
// 8-column steps (i * ns + s) * 8 + warp, and the last of them to arrive
// merges their softmax states with the new token's seed. ns follows the
// row's length (one block per 64 positions), read from device memory.
template <int D, int KVB>
__device__ __noinline__ void attn_phase(const DmParams& p, int layer) {
  extern __shared__ __align__(16) unsigned char smem[];
  AttnSmem<D>& sm = *reinterpret_cast<AttnSmem<D>*>(smem);
  constexpr bool QUANT = KVB < 16;
  constexpr int DP = D / 32, ROWB = D * KVB / 8, DS = KVB == 4 ? D / 2 : D;
  constexpr int STATE = D + 2;   // a block's merged state per query row: acc, m, l
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int G = p.NH / p.Hkv, R = G + 2, B = p.B, Hkv = p.Hkv, S = p.S, NS = p.att_split;
  const float* q_norm = p.q_norm ? p.q_norm + (long)layer * D : nullptr;
  const float* k_norm = p.k_norm ? p.k_norm + (long)layer * D : nullptr;

  for (int item = blockIdx.x; item < B * Hkv * NS; item += gridDim.x) {
    const int bh = item / NS, split = item - bh * NS;
    const int b = bh / Hkv, hi = bh - b * Hkv;
    const int len_old = p.lengths[b];
    const int limit = min(max(len_old, 0), S);
    const int ns = max(1, min(NS, (limit + AT_WARPS * AT_CW - 1) / (AT_WARPS * AT_CW)));
    if (split >= ns) continue;   // the same for the whole block

    for (int i = threadIdx.x; i < R * D; i += blockDim.x)
      sm.rows[i / D][i % D] = __ldcg(&p.qkv[(long)b * p.NQ + (long)hi * R * D + i]);
    float cs[DP], sn[DP];   // this lane's rope phases, on their way with the rows
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      cs[j] = p.cos[b * D + lane * DP + j];
      sn[j] = p.sin[b * D + lane * DP + j];
    }
    __syncthreads();

    // QK-norm + rope on the G query rows and the K row, one warp per row;
    // q stays f32 afterwards
    for (int r = warp; r <= G; r += AT_WARPS) {
      float x[DP];
#pragma unroll
      for (int j = 0; j < DP; ++j) x[j] = sm.rows[r][lane * DP + j];
      const float* nw = r < G ? q_norm : k_norm;
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
        sm.rows[r][d] = __fadd_rn(__fmul_rn(x[j], cs[j]), __fmul_rn(rot, sn[j]));
      }
    }
    __syncthreads();

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
    __syncthreads();

    // the new token's score: always visible
    for (int g = warp; g < G; g += AT_WARPS) {
      float dot = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) dot += sm.rows[g][lane * DP + j] * sm.katt[lane * DP + j];
      const float s = warp_sum(dot) * p.sm_scale;
      if (lane == 0) sm.seed[g] = s;
    }

    const long base = ((long)(layer * B + b) * Hkv + hi) * S;
    float m[AT_GMAX], l[AT_GMAX], acc[AT_GMAX][DP];
    attend_cached<D, KVB, false>(
        sm.rows, G, p.k_cache + base * ROWB, p.v_cache + base * ROWB,
        QUANT ? p.k_scale + base : nullptr, QUANT ? p.v_scale + base : nullptr,
        (split * AT_WARPS + warp) * AT_CW, ns * AT_WARPS * AT_CW, limit, len_old - p.window,
        p.window > 0, p.sink, p.sm_scale, sm.pv[warp], lane, m, l, acc);
    park_state<D, KVB>(sm, G, warp, lane, m, l, acc);
    __syncthreads();

    bool last = true;
    float* mine = p.att_part + ((long)bh * NS + split) * AT_GMAX * STATE;
    if (ns > 1) {
      // this block's warps merged into one state per query row, published;
      // the last block of the (row, head) to arrive merges them all
      for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
        const int g = i / D, d = i - g * D;
        float mx = NEG_INF;
        for (int w = 0; w < AT_WARPS; ++w) mx = fmaxf(mx, sm.m[w][g]);
        float Lsum = 0.f, A = 0.f;
        for (int w = 0; w < AT_WARPS; ++w) {
          const float e = expf(sm.m[w][g] - mx);
          Lsum += sm.l[w][g] * e;
          A += sm.acc[w][g][d] * e;
        }
        __stcg(&mine[g * STATE + d], A);
        if (d == 0) {
          __stcg(&mine[g * STATE + D], mx);
          __stcg(&mine[g * STATE + D + 1], Lsum);
        }
      }
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        const int arrived = atomicAdd(&p.counters[bh], 1);
        sm.flag = arrived == ns - 1;
        if (arrived == ns - 1) p.counters[bh] = 0;
      }
      __syncthreads();
      last = sm.flag != 0;
      if (last) __threadfence();
    }
    if (last) {
      const float* all = p.att_part + (long)bh * NS * AT_GMAX * STATE;
      for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
        const int g = i / D, d = i - g * D;
        float mx = sm.seed[g];
        float Lsum, A;
        if (ns > 1) {
          float mk[DM_ATT_SPLIT], lk[DM_ATT_SPLIT], ak[DM_ATT_SPLIT];   // all loads go out first
#pragma unroll
          for (int k = 0; k < DM_ATT_SPLIT; ++k) {
            const float* st = all + (k * AT_GMAX + g) * STATE;
            mk[k] = k < ns ? __ldcg(&st[D]) : NEG_INF;
            lk[k] = k < ns ? __ldcg(&st[D + 1]) : 0.f;
            ak[k] = k < ns ? __ldcg(&st[d]) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < DM_ATT_SPLIT; ++k) mx = fmaxf(mx, mk[k]);
          const float e0 = expf(sm.seed[g] - mx);
          Lsum = e0;
          A = sm.vatt[d] * e0;
#pragma unroll
          for (int k = 0; k < DM_ATT_SPLIT; ++k) {
            const float e = expf(mk[k] - mx);
            Lsum += lk[k] * e;
            A += ak[k] * e;
          }
        } else {
          for (int w = 0; w < AT_WARPS; ++w) mx = fmaxf(mx, sm.m[w][g]);
          const float e0 = expf(sm.seed[g] - mx);
          Lsum = e0;
          A = sm.vatt[d] * e0;
          for (int w = 0; w < AT_WARPS; ++w) {
            const float e = expf(sm.m[w][g] - mx);
            Lsum += sm.l[w][g] * e;
            A += sm.acc[w][g][d] * e;
          }
        }
        if (Lsum == 0.f) Lsum = 1.f;
        __stcg(&p.att[(long)b * p.DQ + ((long)hi * G + g) * D + d], A / Lsum);
      }
      // the stored rows go out, and into the cache at the clamped length:
      // every block of this (row, head) has read its columns by now
      const long orow = ((long)layer * B * Hkv + bh) * DS;
      const int pos = min(max(len_old, 0), S - 1);
      for (int i = threadIdx.x; i < DS; i += blockDim.x) {
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
    }
    __syncthreads();   // shared memory is reused by the next item
  }
}

__device__ __forceinline__ void run_attn(const DmParams& p, int layer) {
#define MNN_DM_ATT(DD, KK) \
  if (p.D == DD && p.kv_bits == KK) return attn_phase<DD, KK>(p, layer);
  MNN_DM_ATT(64, 16)
  MNN_DM_ATT(64, 8)
  MNN_DM_ATT(64, 4)
  MNN_DM_ATT(128, 16)
  MNN_DM_ATT(128, 8)
  MNN_DM_ATT(128, 4)
#undef MNN_DM_ATT
}

template <int BM>
__global__ void __launch_bounds__(DM_THREADS, BM == 8 ? 1 : 2)
decode_model_kernel(const __grid_constant__ DmParams p) {
  cg::grid_group grid = cg::this_grid();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int B = p.B, H = p.H;

  // prologue: the residual stream starts as x; its sums of squares per tile
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
  int slot = 0;
  stamp(p, slot);
  grid.sync();
  stamp(p, slot);

  Gemv g;
  for (int l = 0; l < p.L; ++l) {
    const long kh = (long)H * p.bits / 8, nbh = H / p.bs_h;
    g = Gemv{p.x_out, p.in_norm + (long)l * H, p.wqkv_p + l * kh * p.NQ,
             p.wqkv_s + l * nbh * p.NQ, p.wqkv_b + l * nbh * p.NQ, H, p.NQ, p.bs_h,
             p.split_qkv, EPI_QKV, p.qkv_bias ? p.qkv_bias + (long)l * p.NQ : nullptr, p.qkv};
    run_gemv<BM>(g, p, p.bits);
    grid.sync();
    stamp(p, slot);
    run_attn(p, l);
    grid.sync();
    stamp(p, slot);
    const long kq = (long)p.DQ * p.bits / 8, nbq = p.DQ / p.bs_h;
    g = Gemv{p.att, nullptr, p.wo_p + l * kq * H, p.wo_s + l * nbq * H, p.wo_b + l * nbq * H,
             p.DQ, H, p.bs_h, p.split_wo, EPI_RES, nullptr, p.x_out};
    run_gemv<BM>(g, p, p.bits);
    grid.sync();
    stamp(p, slot);
    const long n2 = 2L * p.I;
    g = Gemv{p.x_out, p.post_norm + (long)l * H, p.wgu_p + l * kh * n2, p.wgu_s + l * nbh * n2,
             p.wgu_b + l * nbh * n2, H, (int)n2, p.bs_h, p.split_gu, EPI_ACT, nullptr, p.act};
    run_gemv<BM>(g, p, p.bits);
    grid.sync();
    stamp(p, slot);
    const long ki = (long)p.I * p.bits / 8, nbi = p.I / p.bs_i;
    g = Gemv{p.act, nullptr, p.wdn_p + l * ki * H, p.wdn_s + l * nbi * H, p.wdn_b + l * nbi * H,
             p.I, H, p.bs_i, p.split_dn, EPI_RES, nullptr, p.x_out};
    run_gemv<BM>(g, p, p.bits);
    grid.sync();
    stamp(p, slot);
  }
  if (!p.head_p) return;   // uniform over the grid: no barrier follows

  g = Gemv{p.x_out, p.final_norm, p.head_p, p.head_s, p.head_b, H, p.V, p.bs_head,
           p.split_head, EPI_HEAD, nullptr, p.logits};
  run_gemv<BM>(g, p, p.head_bits);
  grid.sync();
  stamp(p, slot);

  // merge the tiles' (max, lowest index) into the token, one block per row
  extern __shared__ __align__(16) unsigned char smem[];
  float* bv_s = reinterpret_cast<float*>(smem);       // [DM_THREADS]
  int* bi_s = reinterpret_cast<int*>(bv_s + DM_THREADS);
  const int ntiles = (p.V + DM_TILE - 1) / DM_TILE;
  for (int b = blockIdx.x; b < B; b += gridDim.x) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int t = tid; t < ntiles; t += DM_THREADS) {
      const float v = __ldcg(&p.best_val[b * ntiles + t]);
      const int i = __ldcg(&p.best_idx[b * ntiles + t]);
      if (v > bv || (v == bv && i < bi)) {
        bv = v;
        bi = i;
      }
    }
    bv_s[tid] = bv;
    bi_s[tid] = bi;
    __syncthreads();
    for (int o = DM_THREADS / 2; o > 0; o >>= 1) {
      if (tid < o) {
        const float ov = bv_s[tid + o];
        const int oi = bi_s[tid + o];
        if (ov > bv_s[tid] || (ov == bv_s[tid] && oi < bi_s[tid])) {
          bv_s[tid] = ov;
          bi_s[tid] = oi;
        }
      }
      __syncthreads();
    }
    if (tid == 0) p.token[b] = bi_s[0];
    __syncthreads();
  }
  stamp(p, slot);
}

// K ranges per column tile: enough items for the grid, at least 8 chunks each
inline int pick_split(int n, int k, int grid) {
  const int ntiles = (n + DM_TILE - 1) / DM_TILE, nchunks = k / 32;
  int s = grid / ntiles;
  const int cap = (nchunks + DM_WARPS - 1) / DM_WARPS;
  if (s > cap) s = cap;
  return s < 1 ? 1 : s;
}

template <int BM>
int launch(DmParams& p, float* ws, long ws_floats, int n_counters, cudaStream_t st) {
  static int sms = 0, blocks_per_sm = 0;
  const size_t gemv_smem = (size_t)(DM_WARPS * BM * DM_TILE + BM * DM_TILE + DM_MAXB + 4) * sizeof(float);
  const size_t smem = gemv_smem > sizeof(AttnSmem<128>) ? gemv_smem : sizeof(AttnSmem<128>);
  auto kern = decode_model_kernel<BM>;
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    static size_t granted = 0;
    if (e == cudaSuccess) e = allow_smem(kern, smem, granted);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks_per_sm, kern, DM_THREADS, smem);
    if (e != cudaSuccess) {
      sms = 0;
      return (int)e;
    }
    if (blocks_per_sm > 2) blocks_per_sm = 2;
  }
  if (blocks_per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  const int grid = sms * blocks_per_sm;   // all blocks co-resident

  p.split_qkv = pick_split(p.NQ, p.H, grid);
  p.split_wo = pick_split(p.H, p.DQ, grid);
  p.split_gu = pick_split(2 * p.I, p.H, grid);
  p.split_dn = pick_split(p.H, p.I, grid);
  p.split_head = p.head_p ? pick_split(p.V, p.H, grid) : 1;
  // blocks per (batch row, KV head) in the attention phase: one per 64
  // positions of the capacity, as far as the grid goes
  p.att_split = grid / (p.B * p.Hkv);
  const int by_cap = (p.S + AT_WARPS * AT_CW - 1) / (AT_WARPS * AT_CW);
  if (p.att_split > by_cap) p.att_split = by_cap;
  if (p.att_split > DM_ATT_SPLIT) p.att_split = DM_ATT_SPLIT;
  if (p.att_split < 1) p.att_split = 1;

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
  p.part = take((long)grid * DM_TILE * B);
  p.ssq = take(ht * DM_MAXB);
  p.best_val = take(B * vt);
  p.best_idx = reinterpret_cast<int*>(take(B * vt));
  p.att_part = take(B * p.Hkv * p.att_split * AT_GMAX * (p.D + 2));
  long need_counters = (p.NQ > 2 * p.I ? p.NQ : 2 * p.I);
  if (p.H > need_counters) need_counters = p.H;
  if (p.V > need_counters) need_counters = p.V;
  need_counters = (need_counters + DM_TILE - 1) / DM_TILE;
  if (B * p.Hkv > need_counters) need_counters = B * p.Hkv;
  if (off > ws_floats || need_counters > n_counters) return (int)cudaErrorInvalidValue;

  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(DM_THREADS), args,
                                              smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One instantiation per source file: decode_model_b<BM>.cu defines these.
int launch_b1(DmParams& p, float* ws, long ws_floats, int n_counters, cudaStream_t st);
int launch_b2(DmParams& p, float* ws, long ws_floats, int n_counters, cudaStream_t st);
int launch_b4(DmParams& p, float* ws, long ws_floats, int n_counters, cudaStream_t st);
int launch_b8(DmParams& p, float* ws, long ws_floats, int n_counters, cudaStream_t st);

}  // namespace mnn
