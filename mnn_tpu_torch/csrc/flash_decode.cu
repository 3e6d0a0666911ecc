// Single-position GQA decode attention over the stacked KV cache (sm_90a).
//
// Replaces mnn_tpu/kernels/flash_attention.py::_decode_kernel. One query
// position per sequence, q [B, H, D] bf16, attends over the first kv_len[b]
// positions of layer `layer` of a [L, B, Hkv, S, D] cache that already holds
// the new token. The cache is bf16, int8 or nibble-packed int4 ([.., D/2]
// bytes, unpacked as (lo - 8, hi - 8) for dims (j, j + D/2)); the K scale
// multiplies score columns, the V scale probability columns, and the
// probability is rounded to bf16 before the P.V product, as the TPU kernel
// casts it to V's type. Masks: col < kv_len, and with a window
// col > kv_len - 1 - window or col < sink. l == 0 -> 1; bf16 out.
//
// At batch 1 the work is a few hundred positions of 32 to 128 bytes per KV
// head: latency bounds it, not bytes. One block per (batch row, KV head)
// hands the positions to its 8 warps, 8 columns at a time (attn_common.cuh),
// and merges their softmax states in shared memory.
#include "attn_common.cuh"

namespace mnn {

template <int D, int KVB>
__global__ void __launch_bounds__(AT_WARPS * 32)
flash_decode_kernel(const bf16* __restrict__ q, const uint8_t* __restrict__ k_cache,
                    const uint8_t* __restrict__ v_cache, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ kv_len,
                    bf16* __restrict__ out, int B, int Hkv, int G, int S, int layer,
                    int window, int sink, float scale) {
  constexpr int DP = D / 32, ROWB = D * KVB / 8;
  __shared__ AttnSmem<D> sm;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / Hkv;
  const int n = min(max(kv_len[b], 0), S);

  for (int i = threadIdx.x; i < G * D; i += blockDim.x)
    sm.rows[i / D][i % D] = __bfloat162float(q[(long)bh * G * D + i]);
  __syncthreads();

  const long base = ((long)(layer * B + b) * Hkv + (bh - b * Hkv)) * S;
  float m[AT_GMAX], l[AT_GMAX], acc[AT_GMAX][DP];
  attend_cached<D, KVB, true>(
      sm.rows, G, k_cache + base * ROWB, v_cache + base * ROWB,
      KVB < 16 ? k_scale + base : nullptr, KVB < 16 ? v_scale + base : nullptr,
      warp * AT_CW, AT_WARPS * AT_CW, n, n - 1 - window, window > 0, sink, scale, sm.pv[warp],
      lane, m, l, acc);
  park_state<D, KVB>(sm, G, warp, lane, m, l, acc);
  __syncthreads();

  for (int i = threadIdx.x; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i - g * D;
    float mx = NEG_INF;
    for (int w = 0; w < AT_WARPS; ++w) mx = fmaxf(mx, sm.m[w][g]);
    float L = 0.f, A = 0.f;
    for (int w = 0; w < AT_WARPS; ++w) {
      const float e = expf(sm.m[w][g] - mx);
      L += sm.l[w][g] * e;
      A += sm.acc[w][g][d] * e;
    }
    if (L == 0.f) L = 1.f;
    out[((long)bh * G + g) * D + d] = __float2bfloat16_rn(A / L);
  }
}

template <int D, int KVB>
static int launch(const void* q, const void* k, const void* v, const void* ks,
                  const void* vs, const void* lens, void* out, int B, int Hkv, int G,
                  int S, int layer, int window, int sink, float scale, cudaStream_t st) {
  flash_decode_kernel<D, KVB><<<B * Hkv, AT_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(lens),
      static_cast<bf16*>(out), B, Hkv, G, S, layer, window, sink, scale);
  return (int)cudaGetLastError();
}

}  // namespace mnn

using namespace mnn;

MNN_API int mnn_flash_decode(const void* q, const void* k_cache, const void* v_cache,
                             const void* k_scale, const void* v_scale, const void* kv_len,
                             void* out, int B, int Hkv, int G, int D, int S, int layer,
                             int kv_bits, int window, int sink, float scale,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || G > AT_GMAX) return (int)cudaErrorInvalidValue;
#define MNN_FD_CASE(DD, KK)                                                              \
  if (D == DD && kv_bits == KK)                                                          \
    return launch<DD, KK>(q, k_cache, v_cache, k_scale, v_scale, kv_len, out, B, Hkv, G, \
                          S, layer, window, sink, scale, st);
  MNN_FD_CASE(64, 16)
  MNN_FD_CASE(64, 8)
  MNN_FD_CASE(64, 4)
  MNN_FD_CASE(128, 16)
  MNN_FD_CASE(128, 8)
  MNN_FD_CASE(128, 4)
#undef MNN_FD_CASE
  return (int)cudaErrorInvalidValue;
}
