// Single-position attention over cached K/V rows, for the whole-model decode
// kernel (decode_model.cuh).
//
// A block serves one (batch row, KV head), or a share of its positions: its 8
// warps take the cached positions 8 columns at a time, and each warp keeps
// an online-softmax state (m, l, acc) for all G query rows of the group,
// which the caller merges through shared memory. The work per position is
// small and serial (G x D multiply-adds), so a step is spread over the whole
// warp: four lanes per column for the scores, D / 32 dims per lane for P.V. Cache rows are bf16, int8
// or nibble-packed int4 (byte j = dims (j, j + D/2), low nibble first,
// stored as q + 8); a quantized row's K scale multiplies its score column
// and its V scale its probability column, so nothing is dequantized. An
// optional softcap (gemma2) takes each score to tanh(s / cap) * cap before
// the running max. Head dims 64, 128 and 256; at 256 the state holds up to 4
// query rows a KV head (`at_gmax`), so that it takes the shared memory that
// 8 rows take at 128 and leaves the whole-model kernel its weight ring.
#pragma once

#include "common.cuh"

namespace mnn {

constexpr int AT_WARPS = 8, AT_GMAX = 8;

// query rows a KV head that the state holds at head dim D
template <int D>
__host__ __device__ constexpr int at_gmax() { return D > 128 ? 4 : AT_GMAX; }

template <int D>
struct AttnSmem {
  static constexpr int GM = at_gmax<D>();
  float rows[GM + 2][D];            // query rows (then the new K, V rows)
  float katt[D], vatt[D];           // new K/V as attention sees them
  float krow[D], vrow[D];           // new K/V as the cache stores them
  float seed[GM];
  float new_sc[2];                  // the new K and V rows' scales
  int flag;
  float pv[AT_WARPS][GM][32];
  float m[AT_WARPS][GM], l[AT_WARPS][GM];
  float acc[AT_WARPS][GM][D];
};

// The head dim that `lane` accumulates in slot j of its D / 32 slots. int4
// rows give a lane whole bytes, i.e. dims from both halves of the head.
template <int D, int KVB>
__device__ __forceinline__ int own_dim(int lane, int j) {
  constexpr int DP = D / 32;
  if (KVB == 4) {
    constexpr int HP = DP / 2;
    return j < HP ? lane * HP + j : D / 2 + lane * HP + (j - HP);
  }
  return lane * DP + j;
}

constexpr int AT_CW = 8;   // cached positions a warp takes per step: 4 lanes each

template <int NB> struct RawBytes;
template <> struct RawBytes<1> { using T = uint8_t; };
template <> struct RawBytes<2> { using T = uint16_t; };
template <> struct RawBytes<4> { using T = uint32_t; };
template <> struct RawBytes<8> { using T = uint2; };
template <> struct RawBytes<16> { using T = uint4; };

// s[g] += q[g][d0 .. d0 + 4) . k[0 .. 4) for the G query rows in shared memory.
template <int D>
__device__ __forceinline__ void dot4(const float (*q)[D], int G, int d0, const float* k,
                                     float* s) {
#pragma unroll
  for (int g = 0; g < at_gmax<D>(); ++g) {
    if (g < G) {
      const float4 q4 = *reinterpret_cast<const float4*>(&q[g][d0]);
      s[g] += q4.x * k[0] + q4.y * k[1] + q4.z * k[2] + q4.w * k[3];
    }
  }
}

// A quarter of a K row: lane r of the 4 that share a column takes D / 4 dims,
// [r * D/4, (r + 1) * D/4), or for int4 the bytes [r * D/8, (r + 1) * D/8),
// i.e. those dims of the low half and the same of the high half.
template <int D, int KVB>
struct KSeg {
  static constexpr int BYTES = D / 4 * KVB / 8;          // 8, 16, 32 or 64
  static constexpr int N16 = BYTES >= 16 ? BYTES / 16 : 1;
  uint4 raw[N16];

  __device__ __forceinline__ void load(const uint8_t* __restrict__ row, int r) {
    if (BYTES == 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + r * 8);
      raw[0] = make_uint4(u.x, u.y, 0u, 0u);
    } else {
#pragma unroll
      for (int i = 0; i < N16; ++i)
        raw[i] = *reinterpret_cast<const uint4*>(row + r * BYTES + i * 16);
    }
  }

  // s[g] += q[g] . k over this lane's dims
  __device__ __forceinline__ void dot(const float (*q)[D], int G, int r, float* s) const {
    if (KVB == 16) {
      const bf16* t = reinterpret_cast<const bf16*>(raw);
#pragma unroll
      for (int i = 0; i < D / 4; i += 4) {
        const float k[4] = {bf2f(t[i]), bf2f(t[i + 1]), bf2f(t[i + 2]), bf2f(t[i + 3])};
        dot4<D>(q, G, r * (D / 4) + i, k, s);
      }
    } else if (KVB == 8) {
      const int8_t* t = reinterpret_cast<const int8_t*>(raw);
#pragma unroll
      for (int i = 0; i < D / 4; i += 4) {
        const float k[4] = {(float)t[i], (float)t[i + 1], (float)t[i + 2], (float)t[i + 3]};
        dot4<D>(q, G, r * (D / 4) + i, k, s);
      }
    } else {
      const uint8_t* t = reinterpret_cast<const uint8_t*>(raw);
#pragma unroll
      for (int i = 0; i < D / 8; i += 4) {
        float lo[4], hi[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          lo[e] = (float)((int)(t[i + e] & 0xF) - 8);
          hi[e] = (float)((int)(t[i + e] >> 4) - 8);
        }
        dot4<D>(q, G, r * (D / 8) + i, lo, s);
        dot4<D>(q, G, D / 2 + r * (D / 8) + i, hi, s);
      }
    }
  }
};

// This lane's D / 32 values of a V row (own_dim order), loaded raw so that
// nothing waits on them before they are needed.
template <int D, int KVB>
struct VSeg {
  static constexpr int DP = D / 32, BYTES = DP * KVB / 8;   // 1, 2, 4 or 8
  typename RawBytes<BYTES>::T raw;

  __device__ __forceinline__ void load(const uint8_t* __restrict__ row, int lane) {
    raw = *reinterpret_cast<const typename RawBytes<BYTES>::T*>(row + lane * BYTES);
  }

  __device__ __forceinline__ void values(float* vv) const {
    if (KVB == 16) {
      const bf16* t = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < DP; ++j) vv[j] = bf2f(t[j]);
    } else if (KVB == 8) {
      const int8_t* t = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < DP; ++j) vv[j] = (float)t[j];
    } else {
      const uint8_t* t = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) {
        vv[j] = (float)((int)(t[j] & 0xF) - 8);
        vv[DP / 2 + j] = (float)((int)(t[j] >> 4) - 8);
      }
    }
  }
};

// One warp's share of the cached positions [0, limit): the 8-column steps at
// `first`, `first + stride`, ... In a step four lanes share a column, each
// dotting a quarter of its K row with the G query rows, and for P.V every lane
// owns D / 32 dims over the step's 8 columns; the K and V loads of a step go
// out together. Columns are visible when col < limit and, with a window,
// col > wlo or col < sink. `softcap` > 0 caps the scaled scores. ROUND_P
// rounds the probability (times the V scale) to bf16 before the P.V product.
// m, l, acc come back as this warp's online-softmax state over its columns.
template <int D, int KVB, bool ROUND_P>
__device__ __forceinline__ void attend_cached(
    const float (*q)[D], int G, const uint8_t* __restrict__ kc,
    const uint8_t* __restrict__ vc, const float* __restrict__ ksc,
    const float* __restrict__ vsc, int first, int stride, int limit, int wlo,
    bool windowed, int sink, float scale, float softcap, float (*pv)[32], int lane,
    float* m, float* l, float (*acc)[D / 32]) {
  constexpr bool QUANT = KVB < 16;
  constexpr int DP = D / 32, ROWB = D * KVB / 8, GM = at_gmax<D>();
  const int cl = lane >> 2, r = lane & 3;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) acc[g][j] = 0.f;
  }
  for (int c0 = first; c0 < limit; c0 += stride) {
    const int col = c0 + cl;
    const bool in_buf = col < limit;
    const int colc = min(col, limit - 1);   // a safe row for the lanes past the end
    bool ok = in_buf;
    if (windowed) ok = ok && (col > wlo || (sink && col < sink));
    KSeg<D, KVB> kseg;
    kseg.load(kc + (long)colc * ROWB, r);
    const float ks = QUANT ? ksc[colc] : 1.f;
    const float vs = QUANT ? vsc[colc] : 1.f;
    VSeg<D, KVB> vseg[AT_CW];
#pragma unroll
    for (int c = 0; c < AT_CW; ++c)
      vseg[c].load(vc + (long)min(c0 + c, limit - 1) * ROWB, lane);

    // Each step below runs over all GM query rows at once, so that the
    // rows' shuffles and exponentials overlap; rows past G carry zeros.
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
    kseg.dot(q, G, r, s);
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], 1);
#pragma unroll
    for (int g = 0; g < GM; ++g) {   // the column's four quarters
      s[g] += __shfl_xor_sync(0xffffffffu, s[g], 2);
      if (QUANT) s[g] = __fmul_rn(s[g], ks);
      float v = __fmul_rn(s[g], scale);
      if (softcap > 0.f) v = tanhf(v / softcap) * softcap;
      s[g] = ok ? v : NEG_INF;
    }
    float mx[GM], psum[GM];   // over the step's 8 columns
#pragma unroll
    for (int g = 0; g < GM; ++g) mx[g] = s[g];
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) mx[g] = fmaxf(mx[g], __shfl_xor_sync(0xffffffffu, mx[g], o));
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      mx[g] = fmaxf(m[g], mx[g]);   // the new running max
      s[g] = expf(s[g] - mx[g]);    // p
      psum[g] = s[g];
    }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) psum[g] += __shfl_xor_sync(0xffffffffu, psum[g], o);
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float alpha = expf(m[g] - mx[g]);
      l[g] = l[g] * alpha + psum[g];
      m[g] = mx[g];
      float w = in_buf && g < G ? (QUANT ? __fmul_rn(s[g], vs) : s[g]) : 0.f;
      if (ROUND_P) w = round_bf16(w);
      if (r == 0) pv[g][cl] = w;
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[g][j] *= alpha;
    }
    __syncwarp();
#pragma unroll
    for (int c = 0; c < AT_CW; ++c) {
      float vv[DP];
      vseg[c].values(vv);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float w = pv[g][c];
#pragma unroll
        for (int j = 0; j < DP; ++j) acc[g][j] += w * vv[j];
      }
    }
    __syncwarp();
  }
}

// Park a warp's state in shared memory for the block-wide merge.
template <int D, int KVB>
__device__ __forceinline__ void park_state(AttnSmem<D>& sm, int G, int warp, int lane,
                                           const float* m, const float* l,
                                           const float (*acc)[D / 32]) {
#pragma unroll
  for (int g = 0; g < at_gmax<D>(); ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm.m[warp][g] = m[g];
      sm.l[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < D / 32; ++j) sm.acc[warp][g][own_dim<D, KVB>(lane, j)] = acc[g][j];
  }
}

}  // namespace mnn
