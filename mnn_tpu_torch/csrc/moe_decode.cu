// Routed mixture-of-experts MLP of one decode step (sm_90a): every (token,
// expert) pair of the layer and the shared expert in one entry.
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
// (35 MB a layer at qwen1.5-moe-a2.7b's widths) and does two operations per
// weight. The design spreads that stream over the whole card and keeps the
// host out of it:
//
// * The expert ids are read from device memory. A block computes its own
//   weight pointers from sel[p] and the flat [L * E] stacks, so no id crosses
//   to the host and no expert is copied.
// * Two dependent products, two launches on the caller's stream. The first
//   cuts every gate/up GEMV (k pairs, then the shared expert) into
//   (128-column tile, K range) items, one per block; a tile holds 64 gate
//   columns and their 64 up columns, so the block that completes a tile
//   applies SwiGLU and parks 64 activations in device memory. The second
//   cuts the down GEMVs the same way.
// * Inside an item the 8 warps take 32-value K chunks as the whole-model
//   decode kernel does: a lane reads four adjacent columns as one 32-bit word
//   per packed row, 16 rows in flight, and x is broadcast by shuffle.
// * The same bits from run to run: K ranges meet in device memory and the
//   last block to arrive (one counter per tile, reset by that block) adds
//   them in range order. In the second launch a tile of y waits for all its
//   pairs and for the shared expert, and its last block adds pair 0 .. k-1,
//   then the shared term. No floating-point atomics.
#include "common.cuh"

namespace mnn {

constexpr int MD_THREADS = 256, MD_WARPS = 8, MD_TILE = 128;

struct MoeDecodeParams {
  const float* x;          // [n, H]
  const int* sel;          // [n * k] expert ids of this layer
  const float* wsel;       // [n * k] routing weights
  const float* gate;       // [n] shared-expert gate, or null (1)
  const uint8_t *gu_p, *dn_p;                    // flat expert stacks [L * E, ...]
  const bf16 *gu_s, *gu_b, *dn_s, *dn_b;
  const uint8_t *sgu_p, *sdn_p;                  // this layer's shared expert, or null
  const bf16 *sgu_s, *sgu_b, *sdn_s, *sdn_b;
  float* y;                // [n, H]
  float *act_r, *act_s;    // scratch: [n * k, mi], [n, si]
  float *part_a, *part_b;  // scratch: K-range partial sums of each launch
  int *cnt_a, *cnt_b;      // scratch: arrival counters, zero between launches
  int n, k, E, layer, H, mi, si;
  int bs_h, bs_mi, bs_sh, bs_sd;                 // quant blocks: gu, down, shared gu, shared down
  int split_gu, split_dn, split_sdn;             // K ranges per tile
};

// Sum `count` floats `stride` apart, eight loads in flight before the adds.
__device__ __forceinline__ float sum_ldcg(const float* src, long stride, int count) {
  float v = 0.f;
  for (int k0 = 0; k0 < count; k0 += 8) {
    float t8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t8[k] = k0 + k < count ? __ldcg(src + (long)(k0 + k) * stride) : 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) v += t8[k];
  }
  return v;
}

// The block's share of in[B, K] @ dequant(W)[:, tile t] over the 32-value K
// chunks [ch_lo, ch_hi), summed over its warps into fin[BM][MD_TILE]. `in` is
// rounded to bf16 on the way. Ends with the block in step.
template <int BITS, int BM>
__device__ __noinline__ void gemv_partial(const float* in, int B, const uint8_t* packed,
                                          const bf16* scale, const bf16* bias, int K, int N,
                                          int bs, int t, int ch_lo, int ch_hi, float* red,
                                          float* fin) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int RPC = BITS == 4 ? 16 : 32;   // packed rows per 32-value chunk
  const int cpb = bs / 32, half = bs >> 1;
  const int c0 = t * MD_TILE + lane * 4;
  const bool col_ok = c0 < N;
  float acc[BM][4];
#pragma unroll
  for (int b = 0; b < BM; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][j] = 0.f;

  for (int ch = ch_lo + warp; ch < ch_hi; ch += MD_WARPS) {
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
    const uint8_t* wp = packed + row0 * N + c0;
    float xv[BM];
#pragma unroll
    for (int r0 = 0; r0 < RPC; r0 += 16) {
      uint32_t w[16];   // the weight loads go out before anything waits on x
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(wp + (long)(r0 + i) * N)) : 0u;
      if (r0 == 0) {
#pragma unroll
        for (int b = 0; b < BM; ++b)
          xv[b] = b < B ? round_bf16(__ldcg(&in[(long)b * K + kx])) : 0.f;
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
        const float s = bf2f(scale[(long)kb * N + c0 + j]);
        const float m = bf2f(bias[(long)kb * N + c0 + j]);
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
    for (int j = 0; j < 4; ++j) red[(warp * BM + b) * MD_TILE + lane * 4 + j] = acc[b][j];
  __syncthreads();
  for (int idx = tid; idx < BM * MD_TILE; idx += MD_THREADS) {
    const int b = idx / MD_TILE, c = idx - b * MD_TILE;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < MD_WARPS; ++w) v += red[(w * BM + b) * MD_TILE + c];
    fin[idx] = v;
  }
  __syncthreads();
}

// One more block has stored its share: true in the last of `total` to arrive,
// which also sees what the others stored (read it with __ldcg) and leaves the
// counter at zero for the next launch.
__device__ __forceinline__ bool arrive_last(int* counter, int total, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int arrived = atomicAdd(counter, 1);
    *flag = arrived == total - 1;
    if (arrived == total - 1) *counter = 0;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// First launch: gate/up GEMV items, SwiGLU by the block that completes a tile.
template <int BITS, int BM>
__global__ void __launch_bounds__(MD_THREADS) moe_decode_gu_kernel(MoeDecodeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);       // [WARPS][BM][TILE]
  float* fin = red + MD_WARPS * BM * MD_TILE;        // [BM][TILE]
  int* flag = reinterpret_cast<int*>(fin + BM * MD_TILE);
  const int tid = threadIdx.x;
  const int nk = p.n * p.k, sp = p.split_gu, H = p.H;
  const int tiles_r = 2 * p.mi / MD_TILE;
  const int nchunks = H / 32, cps = (nchunks + sp - 1) / sp;
  const int item = blockIdx.x;
  const int ks = item % sp, jt = item / sp;          // K range, (job, tile)
  const int ch_lo = ks * cps, ch_hi = min(nchunks, (ks + 1) * cps);
  const bool routed = jt < nk * tiles_r;
  int B, t, inter;
  float* act;
  if (routed) {
    t = jt % tiles_r;
    const int pr = jt / tiles_r;
    const long e = (long)p.layer * p.E + p.sel[pr];
    const long N = 2 * p.mi;
    gemv_partial<BITS, 1>(p.x + (long)(pr / p.k) * H, 1, p.gu_p + e * (H * BITS / 8) * N,
                          p.gu_s + e * (H / p.bs_h) * N, p.gu_b + e * (H / p.bs_h) * N, H, (int)N,
                          p.bs_h, t, ch_lo, ch_hi, red, fin);
    B = 1;
    inter = p.mi;
    act = p.act_r + (long)pr * p.mi;
  } else {
    t = jt - nk * tiles_r;
    gemv_partial<BITS, BM>(p.x, p.n, p.sgu_p, p.sgu_s, p.sgu_b, H, 2 * p.si, p.bs_sh, t, ch_lo,
                           ch_hi, red, fin);
    B = p.n;
    inter = p.si;
    act = p.act_s;
  }
  if (sp > 1) {
    // part_a: [(job, tile)][K range][row][column]; a routed tile has one row,
    // the shared tiles follow them with n rows each
    float* part = p.part_a + (routed ? (long)jt * sp
                                     : (long)nk * tiles_r * sp + (long)t * sp * p.n) * MD_TILE;
    for (int idx = tid; idx < B * MD_TILE; idx += MD_THREADS) __stcg(&part[(long)ks * B * MD_TILE + idx], fin[idx]);
    if (!arrive_last(&p.cnt_a[jt], sp, flag)) return;
    for (int idx = tid; idx < B * MD_TILE; idx += MD_THREADS)
      fin[idx] = sum_ldcg(part + idx, (long)B * MD_TILE, sp);
    __syncthreads();
  }
  // the tile holds 64 gate columns, then their 64 up columns
  for (int idx = tid; idx < B * (MD_TILE / 2); idx += MD_THREADS) {
    const int b = idx / (MD_TILE / 2), c = idx - b * (MD_TILE / 2);
    const float g = round_bf16(fin[b * MD_TILE + c]);
    const float up = round_bf16(fin[b * MD_TILE + c + MD_TILE / 2]);
    const float si = round_bf16(__fmul_rn(g, 1.f / (1.f + expf(-g))));
    act[(long)b * inter + t * (MD_TILE / 2) + c] = round_bf16(__fmul_rn(si, up));
  }
}

// Second launch: down GEMV items; the last block of a tile of y combines.
template <int BITS, int BM>
__global__ void __launch_bounds__(MD_THREADS) moe_decode_down_kernel(MoeDecodeParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);
  float* fin = red + MD_WARPS * BM * MD_TILE;
  int* flag = reinterpret_cast<int*>(fin + BM * MD_TILE);
  const int tid = threadIdx.x;
  const int n = p.n, nk = p.n * p.k, H = p.H;
  const int tiles_h = (H + MD_TILE - 1) / MD_TILE;
  const int sr = p.split_dn, ss = p.si ? p.split_sdn : 0;
  const int per_tile = nk * sr + ss;                 // shares that meet in one tile of y
  const int t = blockIdx.x / per_tile, j = blockIdx.x - t * per_tile;
  // part_b: [tile][share][row][column]; shares 0 .. nk * sr - 1 are the pairs'
  // K ranges (one row each), then the shared expert's (n rows each)
  float* tile_part = p.part_b + (long)t * (nk * sr + ss * n) * MD_TILE;
  if (j < nk * sr) {
    const int pr = j / sr, ks = j - pr * sr;
    const int nchunks = p.mi / 32, cps = (nchunks + sr - 1) / sr;
    const long e = (long)p.layer * p.E + p.sel[pr];
    gemv_partial<BITS, 1>(p.act_r + (long)pr * p.mi, 1, p.dn_p + e * (p.mi * BITS / 8) * H,
                          p.dn_s + e * (p.mi / p.bs_mi) * H, p.dn_b + e * (p.mi / p.bs_mi) * H,
                          p.mi, H, p.bs_mi, t, ks * cps, min(nchunks, (ks + 1) * cps), red, fin);
    for (int idx = tid; idx < MD_TILE; idx += MD_THREADS) __stcg(&tile_part[(long)j * MD_TILE + idx], fin[idx]);
  } else {
    const int ks = j - nk * sr;
    const int nchunks = p.si / 32, cps = (nchunks + ss - 1) / ss;
    gemv_partial<BITS, BM>(p.act_s, n, p.sdn_p, p.sdn_s, p.sdn_b, p.si, H, p.bs_sd, t, ks * cps,
                           min(nchunks, (ks + 1) * cps), red, fin);
    float* dst = tile_part + ((long)nk * sr + (long)ks * n) * MD_TILE;
    for (int idx = tid; idx < n * MD_TILE; idx += MD_THREADS) __stcg(&dst[idx], fin[idx]);
  }
  if (!arrive_last(&p.cnt_b[t], per_tile, flag)) return;
  // y = pair 0 .. k-1 in order, then the shared term
  for (int idx = tid; idx < n * MD_TILE; idx += MD_THREADS) {
    const int r = idx / MD_TILE, c = idx - r * MD_TILE;
    const int col = t * MD_TILE + c;
    if (col >= H) continue;
    float v = 0.f;
    for (int kk = 0; kk < p.k; ++kk) {
      const int pr = r * p.k + kk;
      const float term = sum_ldcg(tile_part + (long)pr * sr * MD_TILE + c, MD_TILE, sr);
      v = __fadd_rn(v, __fmul_rn(term, p.wsel[pr]));
    }
    if (ss) {
      const float sh = sum_ldcg(tile_part + ((long)nk * sr + r) * MD_TILE + c, (long)n * MD_TILE, ss);
      v = __fadd_rn(v, __fmul_rn(sh, p.gate ? p.gate[r] : 1.f));
    }
    p.y[(long)r * H + col] = v;
  }
}

template <int BITS, int BM>
static cudaError_t launch_moe_decode(const MoeDecodeParams& p, cudaStream_t st) {
  const size_t smem = (size_t)(MD_WARPS + 1) * BM * MD_TILE * sizeof(float) + 16;
  const int nk = p.n * p.k;
  const int items_a = (nk * (2 * p.mi / MD_TILE) + 2 * p.si / MD_TILE) * p.split_gu;
  const int tiles_h = (p.H + MD_TILE - 1) / MD_TILE;
  const int items_b = tiles_h * (nk * p.split_dn + (p.si ? p.split_sdn : 0));
  moe_decode_gu_kernel<BITS, BM><<<items_a, MD_THREADS, smem, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  moe_decode_down_kernel<BITS, BM><<<items_b, MD_THREADS, smem, st>>>(p);
  return cudaGetLastError();
}

template <int BITS>
static cudaError_t launch_moe_decode_rows(const MoeDecodeParams& p, cudaStream_t st) {
  if (p.n == 1) return launch_moe_decode<BITS, 1>(p, st);
  if (p.n == 2) return launch_moe_decode<BITS, 2>(p, st);
  if (p.n <= 4) return launch_moe_decode<BITS, 4>(p, st);
  return launch_moe_decode<BITS, 8>(p, st);
}

}  // namespace mnn

using namespace mnn;

// y[n, H] = sum_k wsel * expert_sel(x) + gate * shared(x) for one layer.
// Pointers: x, sel, wsel, gate (or null); the flat expert stacks gu/dn
// (packed, scale, bias); this layer's shared expert sgu/sdn (or nulls with
// si = 0); y; the scratch buffers.
MNN_API int mnn_moe_decode(const void* x, const void* sel, const void* wsel, const void* gate,
                           const void* gu_p, const void* gu_s, const void* gu_b,
                           const void* dn_p, const void* dn_s, const void* dn_b,
                           const void* sgu_p, const void* sgu_s, const void* sgu_b,
                           const void* sdn_p, const void* sdn_s, const void* sdn_b,
                           void* y, void* act_r, void* act_s, void* part_a, void* part_b,
                           void* cnt_a, void* cnt_b,
                           int n, int k, int E, int layer, int H, int mi, int si, int bits,
                           int bs_h, int bs_mi, int bs_sh, int bs_sd,
                           int split_gu, int split_dn, int split_sdn, void* stream) {
  if (n < 1 || n > 8 || k < 1 || mi % 64 || si % 64 || H % 32) return (int)cudaErrorInvalidValue;
  if (bs_h % 32 || bs_mi % 32 || (si && (bs_sh % 32 || bs_sd % 32))) return (int)cudaErrorInvalidValue;
  MoeDecodeParams p;
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
  p.act_r = static_cast<float*>(act_r);
  p.act_s = static_cast<float*>(act_s);
  p.part_a = static_cast<float*>(part_a);
  p.part_b = static_cast<float*>(part_b);
  p.cnt_a = static_cast<int*>(cnt_a);
  p.cnt_b = static_cast<int*>(cnt_b);
  p.n = n; p.k = k; p.E = E; p.layer = layer; p.H = H; p.mi = mi; p.si = si;
  p.bs_h = bs_h; p.bs_mi = bs_mi; p.bs_sh = bs_sh; p.bs_sd = bs_sd;
  p.split_gu = split_gu; p.split_dn = split_dn; p.split_sdn = split_sdn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4) return (int)launch_moe_decode_rows<4>(p, st);
  if (bits == 8) return (int)launch_moe_decode_rows<8>(p, st);
  return (int)cudaErrorInvalidValue;
}
