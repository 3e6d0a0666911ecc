// Grouped mixture-of-experts prefill MLP (sm_90a): every expert's capacity
// batch of one layer in one entry.
//
// Replaces mnn_tpu/kernels/moe_prefill.py::_kernel. For each expert e,
//   y[e] = w_e[e] * down_e(act(gate_up_e(xe[e])))
// over xe bf16 [E, C, H] (rows gathered by the caller, empty slots zero with
// weight 0), W4/W8 expert stacks [E, ...] in the packed per-block format, and
// f32 output [E, C, H]. Each product picks its algebra as the TPU kernel
// does: partial products ((x @ q) * s + rowsum(x) * m) when the capacity C is
// below the quant block, else dequantize the block to bf16 and dot
// (deq_dot.cuh holds both). The gate/up result is rounded to bf16, split by
// the 64-block interleave, bf16(bf16(g * sigmoid(g)) * u).
//
// Close to the ridge at the serving shapes (60 experts x 72 rows: 75 GFLOP a
// layer over 0.33 GB of weights and rows), so both products run on the tensor
// cores.
// Two dependent products, two launches on the caller's stream: the
// activations [E, C, mi] (bf16) are parked in device memory between them,
// since a block holds one 128-column tile of one expert and the down product
// needs all of mi. Blocks: (column tile, 80-row slab of the capacity, expert).
// A gate/up tile is 64 gate columns and their 64 up columns, and a thread's
// two accumulators of a row are such a pair, so SwiGLU needs no exchange.
#include "deq_dot.cuh"

namespace mnn {

template <int BITS, bool PARTIAL>
__global__ void __launch_bounds__(DD_THREADS)
moe_prefill_gu_kernel(const bf16* __restrict__ xe, const uint8_t* __restrict__ packed,
                      const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                      bf16* __restrict__ act, int C, int H, int mi, int bs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DdSmem& sm = *reinterpret_cast<DdSmem*>(smem_raw);
  const long e = blockIdx.z;
  const int row0 = blockIdx.y * DD_ROWS, rows = min(DD_ROWS, C - row0);
  const int N = 2 * mi;
  float acc[DD_MT][2][4];
  deq_dot_tile<BITS, PARTIAL>(xe + (e * C + row0) * H, H, rows, packed + e * (H * BITS / 8) * N,
                              scale + e * (H / bs) * N, bias + e * (H / bs) * N, H, N, bs,
                              blockIdx.x * DD_TILE_N, sm, acc);
  const int col = blockIdx.x * 64 + dd_col(0, 0);     // of act: even
#pragma unroll
  for (int mt = 0; mt < DD_MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = dd_row(mt, hr);
      if (r >= rows) continue;
      float a[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float g = round_bf16(acc[mt][0][2 * hr + j]);
        const float up = round_bf16(acc[mt][1][2 * hr + j]);
        const float si = round_bf16(__fmul_rn(g, 1.f / (1.f + expf(-g))));
        a[j] = __fmul_rn(si, up);
      }
      *reinterpret_cast<__nv_bfloat162*>(&act[(e * C + row0 + r) * mi + col]) =
          __floats2bfloat162_rn(a[0], a[1]);
    }
}

template <int BITS, bool PARTIAL>
__global__ void __launch_bounds__(DD_THREADS)
moe_prefill_down_kernel(const bf16* __restrict__ act, const float* __restrict__ w_e,
                        const uint8_t* __restrict__ packed, const bf16* __restrict__ scale,
                        const bf16* __restrict__ bias, float* __restrict__ y, int C, int H, int mi,
                        int bs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DdSmem& sm = *reinterpret_cast<DdSmem*>(smem_raw);
  const long e = blockIdx.z;
  const int row0 = blockIdx.y * DD_ROWS, rows = min(DD_ROWS, C - row0);
  const int n0 = blockIdx.x * DD_TILE_N;
  float acc[DD_MT][2][4];
  deq_dot_tile<BITS, PARTIAL>(act + (e * C + row0) * mi, mi, rows, packed + e * (mi * BITS / 8) * H,
                              scale + e * (mi / bs) * H, bias + e * (mi / bs) * H, mi, H, bs, n0,
                              sm, acc);
#pragma unroll
  for (int mt = 0; mt < DD_MT; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = dd_row(mt, hr);
      if (r >= rows) continue;
      const float w = w_e[e * C + row0 + r];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + dd_col(nt, 0);
        if (col < H)
          *reinterpret_cast<float2*>(&y[(e * C + row0 + r) * H + col]) =
              make_float2(__fmul_rn(acc[mt][nt][2 * hr], w), __fmul_rn(acc[mt][nt][2 * hr + 1], w));
      }
    }
}

template <int BITS, bool PG, bool PD>
static cudaError_t launch_moe_prefill(const bf16* xe, const float* w_e, const uint8_t* gu_p,
                                      const bf16* gu_s, const bf16* gu_b, const uint8_t* dn_p,
                                      const bf16* dn_s, const bf16* dn_b, bf16* act, float* y,
                                      int E, int C, int H, int mi, int bs_h, int bs_mi,
                                      cudaStream_t st) {
  auto gu = moe_prefill_gu_kernel<BITS, PG>;
  auto dn = moe_prefill_down_kernel<BITS, PD>;
  static size_t granted_gu = 0, granted_dn = 0;
  cudaError_t err = allow_smem(gu, sizeof(DdSmem), granted_gu);
  if (err == cudaSuccess) err = allow_smem(dn, sizeof(DdSmem), granted_dn);
  if (err != cudaSuccess) return err;
  const int slabs = (C + DD_ROWS - 1) / DD_ROWS;
  gu<<<dim3(2 * mi / DD_TILE_N, slabs, E), DD_THREADS, sizeof(DdSmem), st>>>(
      xe, gu_p, gu_s, gu_b, act, C, H, mi, bs_h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dn<<<dim3((H + DD_TILE_N - 1) / DD_TILE_N, slabs, E), DD_THREADS, sizeof(DdSmem), st>>>(
      act, w_e, dn_p, dn_s, dn_b, y, C, H, mi, bs_mi);
  return cudaGetLastError();
}

template <int BITS>
static cudaError_t launch_moe_prefill_bits(bool pg, bool pd, const bf16* xe, const float* w_e,
                                           const uint8_t* gu_p, const bf16* gu_s,
                                           const bf16* gu_b, const uint8_t* dn_p,
                                           const bf16* dn_s, const bf16* dn_b, bf16* act, float* y,
                                           int E, int C, int H, int mi, int bs_h, int bs_mi,
                                           cudaStream_t st) {
#define MNN_MOE_PREFILL(PG, PD) \
  launch_moe_prefill<BITS, PG, PD>(xe, w_e, gu_p, gu_s, gu_b, dn_p, dn_s, dn_b, act, y, E, C, H, \
                                   mi, bs_h, bs_mi, st)
  if (pg) return pd ? MNN_MOE_PREFILL(true, true) : MNN_MOE_PREFILL(true, false);
  return pd ? MNN_MOE_PREFILL(false, true) : MNN_MOE_PREFILL(false, false);
#undef MNN_MOE_PREFILL
}

}  // namespace mnn

using namespace mnn;

// y[E, C, H] (f32) = w_e * expert MLP of xe[E, C, H] (bf16); act: scratch
// bf16 [E, C, mi]. partial_gu / partial_dn pick each product's algebra.
MNN_API int mnn_moe_prefill(const void* xe, const void* w_e, const void* gu_p, const void* gu_s,
                            const void* gu_b, const void* dn_p, const void* dn_s,
                            const void* dn_b, void* act, void* y, int E, int C, int H, int mi,
                            int bits, int bs_h, int bs_mi, int partial_gu, int partial_dn,
                            void* stream) {
  if (E < 1 || C < 1 || mi % 64 || H % 8) return (int)cudaErrorInvalidValue;
  if (bs_h > DD_MAXBS || bs_mi > DD_MAXBS || bs_h % 16 || bs_mi % 16 || H % bs_h || mi % bs_mi)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MNN_ARGS \
  partial_gu != 0, partial_dn != 0, static_cast<const bf16*>(xe), static_cast<const float*>(w_e), \
      static_cast<const uint8_t*>(gu_p), static_cast<const bf16*>(gu_s), \
      static_cast<const bf16*>(gu_b), static_cast<const uint8_t*>(dn_p), \
      static_cast<const bf16*>(dn_s), static_cast<const bf16*>(dn_b), static_cast<bf16*>(act), \
      static_cast<float*>(y), E, C, H, mi, bs_h, bs_mi, st
  if (bits == 4) return (int)launch_moe_prefill_bits<4>(MNN_ARGS);
  if (bits == 8) return (int)launch_moe_prefill_bits<8>(MNN_ARGS);
#undef MNN_ARGS
  return (int)cudaErrorInvalidValue;
}
