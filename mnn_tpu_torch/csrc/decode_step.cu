// Fused single-position decode attention for one layer (sm_90a).
//
// Replaces mnn_tpu/kernels/decode_step.py::_kernel. One block per
// (batch row, KV head) takes the grouped projection rows [G + 2, D] (G query
// rows, then K, then V), applies the optional QK RMS-norm and full-width
// neox rope, quantizes the new K and V rows to int8 (absmax / 127, rint,
// clip to +-127), seeds the softmax with the new token against its
// quantize -> dequantize round trip, and attends over the cached positions
// [0, len_old) of layer `layer` of the stacked [L, B, Hkv, S, D] cache, with
// the K scale on score columns and the V scale on probability columns. It
// returns the attention rows and the quantized K/V rows and scales; the
// caller writes those into the cache at len_old.
//
// The work is tiny (a few hundred cached positions of 64 bytes per head), so
// the kernel is bound by latency, not by bytes or FLOPs. Its 8 warps split
// the cached positions into 32-column chunks (one column per lane); each
// warp keeps its own online-softmax state for all G rows, and the states and
// the seed are merged in shared memory at the end.
#include "common.cuh"

namespace mnn {

constexpr int DS_WARPS = 8, DS_GMAX = 8;

template <typename T> struct CacheVec;
template <> struct CacheVec<int8_t> { static constexpr int N = 16; };
template <> struct CacheVec<bf16> { static constexpr int N = 8; };

__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <int D, typename T>
__global__ void __launch_bounds__(DS_WARPS * 32)
decode_step_kernel(const bf16* __restrict__ qkv, const T* __restrict__ k_cache,
                   const T* __restrict__ v_cache, const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, const float* __restrict__ cosf_,
                   const float* __restrict__ sinf_, const float* __restrict__ q_norm,
                   const float* __restrict__ k_norm, const int* __restrict__ lengths,
                   bf16* __restrict__ att, float* __restrict__ k_row, float* __restrict__ v_row,
                   float* __restrict__ k_sc, float* __restrict__ v_sc, int B, int Hkv, int G,
                   int S, int layer, int window, int sink, float softcap, float scale,
                   float eps) {
  constexpr bool QUANT = sizeof(T) == 1;
  constexpr int DP = D / 32;
  __shared__ float rows_s[DS_GMAX + 2][D];   // roped q rows, then K, V
  __shared__ float katt_s[D], vatt_s[D];     // new K/V as attention sees them
  __shared__ float seed_s[DS_GMAX];
  __shared__ float pv_s[DS_WARPS][DS_GMAX][32];
  __shared__ float m_s[DS_WARPS][DS_GMAX], l_s[DS_WARPS][DS_GMAX];
  __shared__ float acc_s[DS_WARPS][DS_GMAX][D];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int R = G + 2;
  const int len_old = lengths[b];

  for (int i = threadIdx.x; i < R * D; i += blockDim.x)
    rows_s[i / D][i % D] = __bfloat162float(qkv[(long)bh * R * D + i]);
  __syncthreads();

  // QK-norm + rope on the G query rows and the K row, one warp per row
  for (int r = warp; r <= G; r += DS_WARPS) {
    float x[DP];
#pragma unroll
    for (int j = 0; j < DP; ++j) x[j] = rows_s[r][lane * DP + j];
    const float* nw = r < G ? q_norm : k_norm;
    if (nw) {
      float ss = 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) ss += x[j] * x[j];
      const float rinv = rsqrtf(warp_sum(ss) / D + eps);
#pragma unroll
      for (int j = 0; j < DP; ++j) x[j] = __fmul_rn(__fmul_rn(x[j], rinv), nw[lane * DP + j]);
    }
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      const int d = lane * DP + j;
      const float partner = __shfl_xor_sync(0xffffffffu, x[j], 16);   // dim d +- D/2
      const float rot = d < D / 2 ? -partner : partner;
      rows_s[r][d] = __fadd_rn(__fmul_rn(x[j], cosf_[b * D + d]),
                               __fmul_rn(rot, sinf_[b * D + d]));
    }
  }
  __syncthreads();

  // quantize the new K (warp 0) and V (warp 1) rows
  if (warp < 2) {
    const float* src = rows_s[G + warp];
    float x[DP], amax = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) {
      x[j] = src[lane * DP + j];
      amax = fmaxf(amax, fabsf(x[j]));
    }
    amax = warp_max(amax);
    const float sc = amax == 0.f ? 1.f : amax / 127.f;
    float* att_dst = warp == 0 ? katt_s : vatt_s;
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
      att_dst[lane * DP + j] = av;
      row_dst[lane * DP + j] = qv;
    }
    if (QUANT && lane == 0) (warp == 0 ? k_sc : v_sc)[bh] = sc;
  }
  __syncthreads();

  // the new token's score, always visible
  for (int g = warp; g < G; g += DS_WARPS) {
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) dot += rows_s[g][lane * DP + j] * katt_s[lane * DP + j];
    float s = warp_sum(dot) * scale;
    if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
    if (lane == 0) seed_s[g] = s;
  }

  // cached positions [0, len_old) of this layer, 32-column chunks per warp
  const long base = ((long)(layer * B + b) * Hkv + (bh - b * Hkv)) * S;
  const T* kc = k_cache + base * D;
  const T* vc = v_cache + base * D;
  const float* ksc = QUANT ? k_scale + base : nullptr;
  const float* vsc = QUANT ? v_scale + base : nullptr;

  float m[DS_GMAX], l[DS_GMAX], acc[DS_GMAX][DP];
#pragma unroll
  for (int g = 0; g < DS_GMAX; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) acc[g][j] = 0.f;
  }
  for (int c0 = warp * 32; c0 < len_old; c0 += DS_WARPS * 32) {
    const int col = c0 + lane;
    const bool in_buf = col < S;
    bool ok = col < len_old && in_buf;
    if (window) ok = ok && (col > len_old - window || (sink && col < sink));
    float s[DS_GMAX];
#pragma unroll
    for (int g = 0; g < DS_GMAX; ++g) s[g] = 0.f;
    if (in_buf) {
      constexpr int VN = CacheVec<T>::N;
      const T* kr = kc + (long)col * D;
#pragma unroll
      for (int d0 = 0; d0 < D; d0 += VN) {
        const uint4 u = *reinterpret_cast<const uint4*>(kr + d0);   // 16-byte load
        const T* t = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int e = 0; e < VN; ++e) {
          const float kv = to_f(t[e]);
#pragma unroll
          for (int g = 0; g < DS_GMAX; ++g)
            if (g < G) s[g] += rows_s[g][d0 + e] * kv;
        }
      }
    }
    const float ks = (QUANT && in_buf) ? ksc[col] : 1.f;
    const float vs = (QUANT && in_buf) ? vsc[col] : 1.f;
#pragma unroll
    for (int g = 0; g < DS_GMAX; ++g) {
      if (g >= G) break;
      float sg = QUANT ? __fmul_rn(s[g], ks) : s[g];
      sg = __fmul_rn(sg, scale);
      if (softcap > 0.f) sg = tanhf(sg / softcap) * softcap;
      sg = ok ? sg : NEG_INF;
      const float m_new = fmaxf(m[g], warp_max(sg));
      const float p = expf(sg - m_new);
      const float alpha = expf(m[g] - m_new);
      l[g] = l[g] * alpha + warp_sum(p);
      m[g] = m_new;
      pv_s[warp][g][lane] = in_buf ? (QUANT ? __fmul_rn(p, vs) : p) : 0.f;
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[g][j] *= alpha;
    }
    __syncwarp();
    const int ncol = min(32, S - c0);
    for (int c = 0; c < ncol; ++c) {
      const T* vr = vc + (long)(c0 + c) * D + lane * DP;
      float vv[DP];
#pragma unroll
      for (int j = 0; j < DP; ++j) vv[j] = to_f(vr[j]);
#pragma unroll
      for (int g = 0; g < DS_GMAX; ++g) {
        if (g >= G) break;
        const float w = pv_s[warp][g][c];
#pragma unroll
        for (int j = 0; j < DP; ++j) acc[g][j] += w * vv[j];
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int g = 0; g < DS_GMAX; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int j = 0; j < DP; ++j) acc_s[warp][g][lane * DP + j] = acc[g][j];
  }
  __syncthreads();

  // merge the seed and the warps' partial softmax states
  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = seed_s[g];
    for (int w = 0; w < DS_WARPS; ++w) mx = fmaxf(mx, m_s[w][g]);
    const float e0 = expf(seed_s[g] - mx);
    float L = e0, A = vatt_s[d] * e0;
    for (int w = 0; w < DS_WARPS; ++w) {
      const float e = expf(m_s[w][g] - mx);
      L += l_s[w][g] * e;
      A += acc_s[w][g][d] * e;
    }
    if (L == 0.f) L = 1.f;
    att[((long)bh * G + g) * D + d] = __float2bfloat16_rn(A / L);
  }
}

template <int D, typename T>
static int launch(const void* qkv, const void* kc, const void* vc, const void* ks,
                  const void* vs, const void* cs, const void* sn, const void* qn,
                  const void* kn, const void* lengths, void* att, void* krow, void* vrow,
                  void* ksc, void* vsc, int B, int Hkv, int G, int S, int layer, int window,
                  int sink, float softcap, float scale, float eps, cudaStream_t st) {
  decode_step_kernel<D, T><<<B * Hkv, DS_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(qkv), static_cast<const T*>(kc), static_cast<const T*>(vc),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const float*>(cs), static_cast<const float*>(sn),
      static_cast<const float*>(qn), static_cast<const float*>(kn),
      static_cast<const int*>(lengths), static_cast<bf16*>(att), static_cast<float*>(krow),
      static_cast<float*>(vrow), static_cast<float*>(ksc), static_cast<float*>(vsc), B, Hkv,
      G, S, layer, window, sink, softcap, scale, eps);
  return (int)cudaGetLastError();
}

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
  if (G < 1 || G > DS_GMAX) return (int)cudaErrorInvalidValue;
#define MNN_DS_CASE(DD)                                                                    \
  case DD:                                                                                 \
    return quantized                                                                       \
        ? launch<DD, int8_t>(qkv, k_cache, v_cache, k_scale, v_scale, cos, sin, q_norm,    \
                             k_norm, lengths, att, k_row, v_row, k_sc, v_sc, B, Hkv, G, S, \
                             layer, window, sink, softcap, scale, eps, st)                 \
        : launch<DD, bf16>(qkv, k_cache, v_cache, k_scale, v_scale, cos, sin, q_norm,      \
                           k_norm, lengths, att, k_row, v_row, k_sc, v_sc, B, Hkv, G, S,   \
                           layer, window, sink, softcap, scale, eps, st);
  switch (D) {
    MNN_DS_CASE(32)
    MNN_DS_CASE(64)
    MNN_DS_CASE(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef MNN_DS_CASE
}
