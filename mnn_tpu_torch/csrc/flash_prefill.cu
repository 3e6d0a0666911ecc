// Causal GQA flash attention for chunked prefill (sm_90a).
//
// Replaces mnn_tpu/kernels/flash_attention.py::_prefill_kernel. q is bf16
// [B, H, Tq, D]; k and v are bf16 [B, Hkv, S, D], a fixed-capacity buffer
// of which the first kv_len columns are valid; query row i sits at global
// position q_offset + i. lens = (kv_len, q_offset) is read from device
// memory, so a chunk never waits for the host.
//
// A block owns one (b*h, 32-row query tile); its 4 warps take 8 rows each.
// The loop over 64-column KV tiles replaces the TPU's sequential grid axis:
// nothing carries across blocks. Tiles at or past kv_len or wholly past the
// causal edge are skipped. Per row the online softmax follows the Pallas
// kernel: scores scaled then masked with -1e30, p = exp(s - m_new), p
// rounded to bf16 for the P.V product (as `p.astype(v.dtype)`), l == 0 -> 1.
// At the main-path sizes the kernel is bound by its CUDA-core FLOPs (no
// tensor cores yet); K/V tiles sit in shared memory with rows padded by one
// word so that lanes reading different rows hit different banks.
#include "common.cuh"

namespace mnn {

constexpr int FP_BQ = 32, FP_BKV = 64, FP_WARPS = 4, FP_RPW = FP_BQ / FP_WARPS;

template <int D>
__global__ void __launch_bounds__(FP_WARPS * 32)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     const int* __restrict__ lens, int H, int Hkv, int Tq, int S,
                     int causal, int window, int sink, float scale) {
  constexpr int DP = D / 32;       // dims per lane
  constexpr int LD = D + 2;        // padded smem row (odd word stride)
  __shared__ __align__(16) bf16 q_s[FP_BQ * D];
  __shared__ __align__(16) bf16 k_s[FP_BKV * LD];
  __shared__ __align__(16) bf16 v_s[FP_BKV * LD];
  __shared__ float p_s[FP_WARPS][FP_BKV];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh - b * H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.x * FP_BQ;
  const int kv_len = lens[0], q_offset = lens[1];
  const bf16* qb = q + (long)bh * Tq * D;
  const bf16* kb = k + (long)(b * Hkv + kvh) * S * D;
  const bf16* vb = v + (long)(b * Hkv + kvh) * S * D;

  for (int i = threadIdx.x; i < FP_BQ * D; i += blockDim.x) {
    int r = i / D;
    q_s[i] = (q0 + r < Tq) ? qb[(long)q0 * D + i] : __float2bfloat16_rn(0.f);
  }

  float m[FP_RPW], l[FP_RPW], acc[FP_RPW][DP];
#pragma unroll
  for (int r = 0; r < FP_RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DP; ++j) acc[r][j] = 0.f;
  }

  const int last_row = min(q0 + FP_BQ, Tq) - 1;
  const int kv_end = causal ? min(kv_len, q_offset + last_row + 1) : kv_len;
  for (int t0 = 0; t0 < kv_end; t0 += FP_BKV) {
    __syncthreads();
    for (int i = threadIdx.x; i < FP_BKV * (D / 2); i += blockDim.x) {
      int c = i / (D / 2), w = i - c * (D / 2);
      int col = t0 + c;
      uint32_t kw = 0, vw = 0;
      if (col < S) {
        kw = reinterpret_cast<const uint32_t*>(kb + (long)col * D)[w];
        vw = reinterpret_cast<const uint32_t*>(vb + (long)col * D)[w];
      }
      reinterpret_cast<uint32_t*>(k_s + c * LD)[w] = kw;
      reinterpret_cast<uint32_t*>(v_s + c * LD)[w] = vw;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < FP_RPW; ++r) {
      const int rl = warp * FP_RPW + r;
      const int row = q0 + rl;
      if (row >= Tq) break;
      const int qpos = q_offset + row;
      float s[2];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half;
        const __nv_bfloat162* qp = reinterpret_cast<const __nv_bfloat162*>(q_s + rl * D);
        const __nv_bfloat162* kp = reinterpret_cast<const __nv_bfloat162*>(k_s + c * LD);
        float dot = 0.f;
#pragma unroll
        for (int w = 0; w < D / 2; ++w) {
          float2 qa = __bfloat1622float2(qp[w]);
          float2 ka = __bfloat1622float2(kp[w]);
          dot += qa.x * ka.x + qa.y * ka.y;
        }
        const int col = t0 + c;
        bool ok = col < kv_len;
        if (causal) ok = ok && col <= qpos;
        if (window) ok = ok && (col > qpos - window || (sink && col < sink));
        s[half] = ok ? dot * scale : NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[0], s[1])));
      const float p0 = expf(s[0] - m_new), p1 = expf(s[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
      p_s[warp][lane] = round_bf16(p0);
      p_s[warp][lane + 32] = round_bf16(p1);
      __syncwarp();
      float pv[DP];
#pragma unroll
      for (int j = 0; j < DP; ++j) pv[j] = 0.f;
#pragma unroll 8
      for (int c = 0; c < FP_BKV; ++c) {
        const float pc = p_s[warp][c];
#pragma unroll
        for (int j = 0; j < DP; ++j) pv[j] += pc * bf2f(v_s[c * LD + lane * DP + j]);
      }
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[r][j] = acc[r][j] * alpha + pv[j];
      __syncwarp();
    }
  }

#pragma unroll
  for (int r = 0; r < FP_RPW; ++r) {
    const int row = q0 + warp * FP_RPW + r;
    if (row >= Tq) break;
    const float lr = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int j = 0; j < DP; ++j)
      o[((long)bh * Tq + row) * D + lane * DP + j] = __float2bfloat16_rn(acc[r][j] / lr);
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* o, const void* lens,
                  int B, int H, int Hkv, int Tq, int S, int causal, int window, int sink,
                  float scale, cudaStream_t st) {
  dim3 grid((Tq + FP_BQ - 1) / FP_BQ, B * H);
  flash_prefill_kernel<D><<<grid, FP_WARPS * 32, 0, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<const int*>(lens), H, Hkv, Tq, S, causal, window,
      sink, scale);
  return (int)cudaGetLastError();
}

}  // namespace mnn

using namespace mnn;

MNN_API int mnn_flash_prefill(const void* q, const void* k, const void* v, void* o,
                              const void* lens, int B, int H, int Hkv, int Tq, int S, int D,
                              int causal, int window, int sink, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (H % Hkv) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return launch<32>(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window, sink, scale, st);
    case 64: return launch<64>(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window, sink, scale, st);
    case 128: return launch<128>(q, k, v, o, lens, B, H, Hkv, Tq, S, causal, window, sink, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
