// Fused per-block dequantize + matmul for W2/W3/W4/W8 weights (sm_90a).
//
// Replaces mnn_tpu/kernels/dequant_matmul.py::_kernel (bf16 rows: the GEMV
// kernel at M = 1, the tensor-core tile kernel above),
// ::_kernel_a8 (int8 rows) and ::_kernel_deq (dequantized tiles). Weights
// stay packed: int8 [K*bits/8, N] with W4 nibble pairs (i, i + bs/2) inside
// each quant block, W2 four 2-bit groups (i + m bs/4, bit pair 2m), W3 a
// 2-bit plane of bs/4 rows (W2's grouping of q & 3) then a 1-bit plane of
// bs/8 rows (bit m of row j: q >> 2 of offset j + m bs/8), q = lo + 4 hi;
// bf16 scale s and bias m [K/bs, N]. A quant block contributes
//     (x_b . q_b) * s_b + rowsum(x_b) * m_b            (bf16 rows)
//     (x_b . (q_b - c)) * s_b + rowsum(x_b) * (c s_b + m_b)   (int8 rows, c = 2^(bits-1))
// accumulated in f32 in the order acc + part*s + rowsum*m, with no FMA
// contraction, so the plain PyTorch version reproduces the same rounding.
//
// dqmm_gemv_kernel replaces ::_kernel at M = 1 (every decode GEMV and the lm
// head). It is bound by the packed weight bytes, but a grid of one block a
// 128-column tile gave qwen2-0.5b's N = 896 seven blocks, each reading its
// K serially, so latency held it. The design, that of the fused expert
// decode kernel (moe_decode.cu):
//  * (128-column tile, K range) items, one a block; the K ranges are whole
//    quant blocks, as many a tile as fill about two blocks an SM with at
//    least a unit a warp (gemv_split), and the lm heads' 1,187 tiles take one;
//  * inside an item the 8 warps take units of 16 packed rows of one quant
//    block; a lane reads its four columns as one 32-bit word a row, all 16
//    loads of a unit in flight and the next unit's issued before this one's
//    math; x, scale and bias of the range come by cp.async at the start;
//  * each unit's column sums go to shared memory; a thread a column then
//    takes the quant blocks in order, part = the units' sums, and the f32
//    step acc = (acc + part * s) + rs * m of the plain version;
//  * K ranges meet in a workspace in device memory: the last block of a tile
//    to arrive (one counter a tile, left at zero by that block) adds them in
//    range order, then applies the output rounding and out_bias. No
//    floating-point atomics, the same bits every run. The workspace and
//    counters are this file's own device arrays, allocated once per device
//    when the module loads and zero at load, so the C entry keeps its
//    arguments and a captured CUDA graph replays with the counters at zero.
//    Two calls on one device must not run at once (on two streams): they
//    would share the workspace.
//
// dqmm_a8_kernel replaces ::_kernel_a8 (the W4A8/W8A8 prefill GEMM). At
// M = 512 its two bounds on this card are close (qwen2-0.5b's qkv 0.53 us of
// int8 operations against 0.66 us of bytes, gate/up 4.5 against 4.5, the
// mixture-of-experts qkv 6.5 against 4.2). What holds it back is neither:
// it is the latency of the serial steps each quant block takes (copy issue,
// unpack, products, the f32 step; about 1.1 us a block at 4 to 16 warps an
// SM, measured with clock64 stamps). The design:
//  * products on the int8 tensor cores, `mma.sync.m16n8k32.s8.u8.s32` on the
//    unsigned pattern q (exact int32, as __dp4a was); the re-centring is
//    folded into the row sum: x . (q - c) = x . q - c * rs;
//  * a ring of A8_STAGES quant blocks in shared memory filled by `cp.async`
//    (packed rows as they lie in memory, the xq rows, the scale and bias
//    rows), so the copy of block kb + 2 runs under the math of block kb;
//    each thread's copy addresses are fixed but for the block's offset;
//  * the unpack once per tile and block: a thread reads four packed rows of
//    four columns as words, transposes 4 x 4 bytes (__byte_perm) into words
//    of four K-values of one column, the B fragment register, and splits the
//    nibbles; stored 16 bytes a lane, read conflict-free (8-word row
//    padding), shared by all rows of the tile;
//  * A fragments by ldmatrix.x4 from xq rows padded to 144 bytes (conflict-
//    free); row sums by __dp4a on those fragments;
//  * the f32 step per quant block on the int32 fragment, in the order of the
//    plain version, so the two give the same bits;
//  * tiles of 64 x 64, 32 x 64 or 16 x 64 with four warps, the tallest that
//    still gives every SM a block, so 32-row buckets and N = 896 fill the card.
// A quant block of fewer than 32 K-values (the mma depth) is padded with
// zero K-values of xq in shared memory.
//
// dqmm_bf16_tile_kernel replaces ::_kernel at M > 1 (bf16 rows: the
// mixture-of-experts shared expert in prefill, and every prefill projection
// under prefill_act_bits = 16). At M = 512 it is bound by bf16 tensor-core
// operations (the shared expert's gate/up: 23.6 GFLOP, 24 us). It is the
// a8 kernel's design, sharing its copy ring, with bf16 A fragments; its
// body is the tile body of deq_dot.cuh in the ALG_ROWS algebra:
//  * `mma.sync.m16n8k16.bf16` on the unsigned pattern q, exact in bf16 (W4
//    0..15 as bf16(128 + q) - 128 from a mask and one bf16x2 subtraction,
//    W8 through f32); the row sums are one more product, with a B of ones;
//  * the packed tile unpacked once per tile and block into bf16 K-rows (a
//    thread: 16 columns of one packed row; W4's low nibbles to row i, high
//    ones to row i + bs/2, the packed layout's pairing), so B fragments
//    come by ldmatrix.x4.trans, two n8 tiles at a time; A by ldmatrix.x4
//    from x rows padded to 272 bytes;
//  * the f32 step per quant block on the fragment, in the plain version's
//    order: acc = (acc + part * s) + rs * m;
//  * tiles from 64 x 128 to 16 x 8, the largest that still gives every SM
//    a block (bf16_tile). Quant blocks of fewer than 16 K-values are padded
//    with zero K-values of x and of the pattern.
//
// dqmm_deq_kernel replaces ::_kernel_deq, the dequantize-tile variant for
// many bf16 rows: per quant block the weights become wd = bf16(q * s + m)
// and acc += x_b @ wd in f32. It is the same tile body in the ALG_DEQUANT
// algebra, shared with the grouped mixture-of-experts prefill kernel: the
// same copy ring and tiles, the scale and bias applied in the unpack (an f32
// product and sum, then the bf16 rounding, as the plain version rounds), the
// products accumulated straight into acc with no per-block step and no row
// sums. It rounds the weight where the two kernels above never do, so it
// has a plain version of its own (deq_dot_plain). Bound by operations from
// a few hundred rows on.
//
// The three tensor-core kernels take quant blocks of up to 256 K-values, in
// two builds (dequant_matmul.cuh): blocks of up to 128 in the kernels this
// file instantiates, blocks of 136 to 256 in those of dequant_matmul_k256.cu,
// which stage the whole block and unpack it in two chunks. The GEMV takes
// blocks of up to 2,048 at W4.
#include <algorithm>
#include <type_traits>

#include "dequant_matmul.cuh"

namespace mnn {

constexpr int GV_THREADS = 256, GV_WARPS = 8;
constexpr int GV_TILE = 128;       // 32 lanes x 4 columns
constexpr int GV_UNIT = 16;        // packed rows a warp loads at once
constexpr int GV_UMAX = 64;        // units an item sums in shared memory
#ifdef MNN_GV_RMAX
constexpr int GV_RMAX = MNN_GV_RMAX;   // most K ranges a tile (build-time cap, for timing)
#else
constexpr int GV_RMAX = 1 << 20;
#endif
constexpr long GV_WS_FLOATS = 1 << 20;   // the K ranges' sums, [tile][range][128]
constexpr int GV_WS_TILES = 1 << 13;
__device__ float gv_ws[GV_WS_FLOATS];
__device__ int gv_cnt[GV_WS_TILES];

// The K split of a GEMV: `ranges` K ranges a tile, each of at most `qb_max`
// quant blocks of `units` units; `smem` dynamic bytes a block.
struct GvSplit {
  int tiles, ranges, qb_max, units, smem;
};

// Shapes the GEMV serves: W2, W3, W4 or W8, N a multiple of 4 (32-bit
// loads), K whole quant blocks of a multiple of 8 K-values, and a quant
// block's packed rows no more than the units an item stages (bs up to 4096
// at W2, 2048 at W4, 1024 at W8).
static bool gemv_shape_ok(int K, int N, int bits, int bs) {
  return (bits == 2 || bits == 3 || bits == 4 || bits == 8) && bs >= 8 && bs % 8 == 0 &&
         K % bs == 0 && N % 4 == 0 && bs * bits / 8 <= GV_UMAX * GV_UNIT;
}

static GvSplit gemv_split(int K, int N, int bits, int bs) {
  GvSplit sp;
  const int nq = K / bs;
  const int R = (bs * bits / 8 + GV_UNIT - 1) / GV_UNIT;   // units a quant block
  sp.tiles = (N + GV_TILE - 1) / GV_TILE;
  const long units = (long)sp.tiles * nq * R;
  const long want = std::min<long>(2L * sm_count(), (units + GV_WARPS - 1) / GV_WARPS);
  int r = (int)std::max<long>(1, (want + sp.tiles - 1) / sp.tiles);
  r = std::min(r, GV_RMAX);
  r = std::max(r, (nq + GV_UMAX / R - 1) / (GV_UMAX / R));   // no more units than staged
  sp.ranges = std::min(r, nq);
  sp.qb_max = (nq + sp.ranges - 1) / sp.ranges;
  sp.units = sp.qb_max * R;
  sp.smem = (sp.units * (GV_TILE + 1) + 3) / 4 * 16         // unit sums, row sums
            + sp.qb_max * GV_TILE * 2 * 2 + sp.qb_max * bs * 2 + 16;   // s, m, x; flag
  return sp;
}

// 16 packed rows of unit u (quant block u / R of the range, rows 16 (u % R)
// on) at this lane's four columns; rows past the quant block repeat its last.
__device__ __forceinline__ void gv_load(uint32_t (&w)[GV_UNIT], const uint8_t* wbase, int u,
                                        int R, int rows, int N, bool col_ok) {
  const int qb = u / R, g = u - qb * R;
  const int last = rows - 1 - g * GV_UNIT;
#pragma unroll
  for (int i = 0; i < GV_UNIT; ++i)
    w[i] = col_ok ? __ldg(reinterpret_cast<const uint32_t*>(
                        wbase + (long)(qb * rows + g * GV_UNIT + min(i, last)) * N))
                  : 0u;
}

// y[1, N] = x[1, K] @ dequant(W) (+ out_bias): item blockIdx.x is K range
// blockIdx.x % ranges of tile blockIdx.x / ranges. At W2 and W3 a packed row
// holds K values spread over its quant block: a 2-bit row j those at
// j + m bs/4, counted into the row sum; a W3 1-bit row j those at j + m bs/8,
// with x times 4 (q = lo + 4 hi is linear in the partial product) and no
// row sum, since the 2-bit plane covers every K value of the block once.
template <int BITS>
__global__ void __launch_bounds__(GV_THREADS)
dqmm_gemv_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                 const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                 const float* __restrict__ out_bias, void* __restrict__ out, int K, int N,
                 int bs, int out_f32, int ranges, int qb_max) {
  const int rows = bs * BITS / 8, R = (rows + GV_UNIT - 1) / GV_UNIT, umax = qb_max * R;
  extern __shared__ __align__(16) unsigned char smem[];
  float* parts = reinterpret_cast<float*>(smem);     // [umax][TILE] column sums of a unit
  float* rs_s = parts + umax * GV_TILE;              // [umax] row sums of a unit
  bf16* s_s = reinterpret_cast<bf16*>(smem + (umax * (GV_TILE + 1) + 3) / 4 * 16);
  bf16* m_s = s_s + qb_max * GV_TILE;                // [qb_max][TILE] scale, bias rows
  bf16* x_s = m_s + qb_max * GV_TILE;                // [qb_max * bs] the range's x
  int* flag = reinterpret_cast<int*>(x_s + qb_max * bs);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x / ranges, j = blockIdx.x - t * ranges;
  const int nq = K / bs;
  const int kb0 = (int)((long)nq * j / ranges), nqb = (int)((long)nq * (j + 1) / ranges) - kb0;
  const int units = nqb * R, n0 = t * GV_TILE;

  // the range's x, scale and bias rows, without waiting
  for (int c = tid; c < nqb * bs / 8; c += GV_THREADS)
    cp_async<16>(x_s + c * 8, x + (long)kb0 * bs + c * 8, true);
  for (int c = tid; c < 2 * nqb * (GV_TILE / 4); c += GV_THREADS) {
    const int sm = c >= nqb * (GV_TILE / 4), cc = c - sm * nqb * (GV_TILE / 4);
    const int q = cc / (GV_TILE / 4), col = n0 + (cc % (GV_TILE / 4)) * 4;
    const bool ok = col < N;                         // N % 4 == 0: a piece is all in or out
    cp_async<8>((sm ? m_s : s_s) + q * GV_TILE + (cc % (GV_TILE / 4)) * 4,
                (sm ? bias : scale) + (long)(kb0 + q) * N + (ok ? col : 0), ok);
  }
  cp_async_commit();

  const int c0 = n0 + lane * 4;
  const bool col_ok = c0 < N;
  const uint8_t* wbase = packed + (long)kb0 * rows * N + c0;
  uint32_t w[GV_UNIT], wn[GV_UNIT];
  if (warp < units) gv_load(w, wbase, warp, R, rows, N, col_ok);
  cp_async_wait<0>();
  __syncthreads();

  for (int u = warp; u < units; u += GV_WARPS) {
    if (u + GV_WARPS < units) gv_load(wn, wbase, u + GV_WARPS, R, rows, N, col_ok);
    const int qb = u / R, g = u - qb * R;
    const int last = rows - 1 - g * GV_UNIT;
    const bf16* xq = x_s + qb * bs + g * GV_UNIT;
    float part[4] = {0.f, 0.f, 0.f, 0.f}, rs = 0.f;
#pragma unroll
    for (int i = 0; i < GV_UNIT; ++i) {
      const int ii = min(i, last);
      if (BITS == 4) {   // row i holds K-values i (low nibbles) and i + bs/2 (high)
        float xa = bf2f(xq[ii]), xb = bf2f(xq[rows + ii]);
        if (i > last) xa = xb = 0.f;
        rs += xa + xb;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          part[k] += xa * u2f((w[i] >> (8 * k)) & 0xFu) + xb * u2f((w[i] >> (8 * k + 4)) & 0xFu);
      } else if (BITS == 8) {
        float xa = bf2f(xq[ii]);
        if (i > last) xa = 0.f;
        rs += xa;
#pragma unroll
        for (int k = 0; k < 4; ++k) part[k] += xa * u2f((w[i] >> (8 * k)) & 0xFFu);
      } else {
        const int ri = g * GV_UNIT + ii, q4 = bs >> 2;   // the row in its quant block
        const bf16* xb = x_s + qb * bs;
        if (BITS == 3 && ri >= q4) {   // 1-bit plane: K values j + m bs/8, bit m
          const int j = ri - q4, e8 = bs >> 3;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float xa = i > last ? 0.f : 4.f * bf2f(xb[j + m * e8]);
#pragma unroll
            for (int k = 0; k < 4; ++k) part[k] += xa * u2f((w[i] >> (8 * k + m)) & 1u);
          }
        } else {                       // 2-bit row: K values ri + m bs/4, bit pair 2m
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            const float xa = i > last ? 0.f : bf2f(xb[ri + m * q4]);
            rs += xa;
#pragma unroll
            for (int k = 0; k < 4; ++k) part[k] += xa * u2f((w[i] >> (8 * k + 2 * m)) & 3u);
          }
        }
      }
    }
    *reinterpret_cast<float4*>(parts + u * GV_TILE + lane * 4) =
        make_float4(part[0], part[1], part[2], part[3]);
    if (lane == 0) rs_s[u] = rs;
#pragma unroll
    for (int i = 0; i < GV_UNIT; ++i) w[i] = wn[i];
  }
  __syncthreads();

  // a thread a column: the quant blocks in order, each one f32 step
  const int col = n0 + tid;
  float acc = 0.f;
  if (tid < GV_TILE) {
    for (int qb = 0; qb < nqb; ++qb) {
      float part = 0.f, rsum = 0.f;
      for (int g = 0; g < R; ++g) {
        part += parts[(qb * R + g) * GV_TILE + tid];
        rsum += rs_s[qb * R + g];
      }
      acc = __fadd_rn(__fadd_rn(acc, __fmul_rn(part, bf2f(s_s[qb * GV_TILE + tid]))),
                      __fmul_rn(rsum, bf2f(m_s[qb * GV_TILE + tid])));
    }
    if (ranges > 1) __stcg(&gv_ws[((long)t * ranges + j) * GV_TILE + tid], acc);
  }
  if (ranges > 1) {
    if (!arrive_last(&gv_cnt[t], ranges, flag)) return;
    if (tid < GV_TILE) acc = sum_ldcg(gv_ws + (long)t * ranges * GV_TILE + tid, GV_TILE, ranges);
  }
  if (tid < GV_TILE && col < N) {
    float v = as_out(acc, out_f32);
    if (out_bias) v = __fadd_rn(v, out_bias[col]);
    store_out(out, col, v, out_f32);
  }
}

template <int BITS>
static cudaError_t launch_gemv(const void* x, const void* packed, const void* scale,
                               const void* bias, const void* out_bias, void* out, int K, int N,
                               int bs, int out_f32, cudaStream_t st) {
  const GvSplit sp = gemv_split(K, N, BITS, bs);
  if (sp.ranges > 1 && ((long)sp.tiles * sp.ranges * GV_TILE > GV_WS_FLOATS ||
                        sp.tiles > GV_WS_TILES))
    return cudaErrorInvalidValue;   // past the workspace
  auto kern = dqmm_gemv_kernel<BITS>;
  static size_t granted = 48 << 10;
  cudaError_t e = allow_smem(kern, sp.smem, granted);
  if (e != cudaSuccess) return e;
  kern<<<sp.tiles * sp.ranges, GV_THREADS, sp.smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<const float*>(out_bias), out, K, N, bs, out_f32, sp.ranges, sp.qb_max);
  return cudaGetLastError();
}

}  // namespace mnn

using namespace mnn;

// y[1, N] = x[1, K] (bf16) @ dequant(packed, scale, bias) (+ out_bias), on
// dqmm_gemv_kernel: M = 1 only (more rows take mnn_dequant_matmul_bf16_tile,
// as mnn_dequant_matmul_tile rules); x 16-byte aligned
MNN_API int mnn_dequant_matmul(const void* x, const void* packed, const void* scale,
                               const void* bias, const void* out_bias, void* out,
                               int M, int K, int N, int bits, int bs, int out_f32,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M != 1 || !gemv_shape_ok(K, N, bits, bs)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || (uintptr_t)packed % 4 || ((uintptr_t)scale | (uintptr_t)bias) % 8)
    return (int)cudaErrorMisalignedAddress;
  return with_bits(bits, [&](auto b) {
    return (int)launch_gemv<decltype(b)::value>(x, packed, scale, bias, out_bias, out, K, N, bs,
                                                out_f32, st);
  });
}

// The split mnn_dequant_matmul takes at M = 1: out = (columns a tile, K
// ranges a tile, blocks, dynamic shared bytes a block). Launches nothing.
MNN_API int mnn_dequant_matmul_gemv_split(int K, int N, int bits, int bs, int* out) {
  if (!gemv_shape_ok(K, N, bits, bs)) return (int)cudaErrorInvalidValue;
  const GvSplit sp = gemv_split(K, N, bits, bs);
  out[0] = GV_TILE;
  out[1] = sp.ranges;
  out[2] = sp.tiles * sp.ranges;
  out[3] = sp.smem;
  return 0;
}

// The same function on the bf16 tensor cores (dqmm_bf16_tile_kernel) at any
// M, in the tile bf16_tile picks; x 16-byte aligned
MNN_API int mnn_dequant_matmul_bf16_tile(const void* x, const void* packed, const void* scale,
                                         const void* bias, const void* out_bias, void* out,
                                         int M, int K, int N, int bits, int bs, int out_f32,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs > BLOCK_MAX || bs % 8 || K % bs || N % 4 || !bits_ok(bits))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || ((uintptr_t)packed | (uintptr_t)scale | (uintptr_t)bias) % 4)
    return (int)cudaErrorMisalignedAddress;
  if (bs > BF_KMAX)
    return launch_bf16_tile_k256(false, x, packed, scale, bias, out_bias, out, M, K, N, bits, bs,
                                 out_f32, st);
  return launch_bf16_tile_bits<false, BF_KMAX>(x, packed, scale, bias, out_bias, out, M, K, N,
                                               bits, bs, out_f32, st);
}

// y[M, N] = x[M, K] (bf16) @ bf16(dequant(packed, scale, bias)) (+ out_bias): the
// dequantize-tile algebra, same operands as mnn_dequant_matmul, in the tile
// bf16_tile picks; x 16-byte aligned
MNN_API int mnn_dequant_matmul_deq(const void* x, const void* packed, const void* scale,
                                   const void* bias, const void* out_bias, void* out,
                                   int M, int K, int N, int bits, int bs, int out_f32,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs > BLOCK_MAX || bs % 16 || K % bs || K % 8 || N % 4 || !bits_ok(bits))
    return (int)cudaErrorInvalidValue;
  if ((uintptr_t)x % 16 || ((uintptr_t)packed | (uintptr_t)scale | (uintptr_t)bias) % 4)
    return (int)cudaErrorMisalignedAddress;
  if (bs > BF_KMAX)
    return launch_bf16_tile_k256(true, x, packed, scale, bias, out_bias, out, M, K, N, bits, bs,
                                 out_f32, st);
  return launch_bf16_tile_bits<true, BF_KMAX>(x, packed, scale, bias, out_bias, out, M, K, N,
                                              bits, bs, out_f32, st);
}

// y[M, N] = ((int8 xq @ (q - c)) algebra) rounded, times xscale[M], (+ out_bias)
MNN_API int mnn_dequant_matmul_a8(const void* xq, const void* xscale, const void* packed,
                                  const void* scale, const void* bias, const void* out_bias,
                                  void* out, int M, int K, int N, int bits, int bs,
                                  int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs > BLOCK_MAX || bs % 8 || K % bs || N % 4 || !bits_ok(bits))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)xq | (uintptr_t)packed | (uintptr_t)scale | (uintptr_t)bias) % 4)
    return (int)cudaErrorMisalignedAddress;
  if (bs > BF_KMAX)
    return launch_a8_k256(xq, xscale, packed, scale, bias, out_bias, out, M, K, N, bits, bs,
                          out_f32, st);
  return launch_a8_bits<BF_KMAX>(xq, xscale, packed, scale, bias, out_bias, out, M, K, N, bits,
                                 bs, out_f32, st);
}

// The tile mnn_dequant_matmul_a8 takes for M rows and N columns at quant
// block bs: rows, columns and dynamic shared memory per block, in
// out[0..2]. Launches nothing.
MNN_API int mnn_dequant_matmul_a8_tile(int M, int N, int bits, int bs, int* out) {
  if (!bits_ok(bits) || bs > BLOCK_MAX) return (int)cudaErrorInvalidValue;
  const int tile = a8_tile(M, N);
#define MNN_A8_INFO(t, MT, NT, WM, WN)                                                         \
  if (tile == t) {                                                                            \
    out[0] = A8Tile<4, MT, NT, WM, WN>::BM;                                                   \
    out[1] = A8Tile<4, MT, NT, WM, WN>::BN;                                                   \
    out[2] = with_bits(bits, [&](auto b) {                                                    \
      return bs > BF_KMAX ? A8Tile<decltype(b)::value, MT, NT, WM, WN, BLOCK_MAX>::SMEM       \
                          : A8Tile<decltype(b)::value, MT, NT, WM, WN>::SMEM;                 \
    });                                                                                       \
    return 0;                                                                                 \
  }
  MNN_A8_TILES(MNN_A8_INFO)
#undef MNN_A8_INFO
  return (int)cudaErrorInvalidValue;
}

// Which kernel takes bf16 rows at M rows and N columns: the tile of
// dqmm_bf16_tile_kernel (or its KMAX = 256 build, for a quant block bs above
// 128) as rows, columns and dynamic shared memory per block in out[0..2],
// or zeros where the GEMV kernel (M = 1) takes them. Launches nothing.
MNN_API int mnn_dequant_matmul_tile(int M, int N, int bits, int bs, int* out) {
  out[0] = out[1] = out[2] = 0;
  if (!bits_ok(bits) || bs > BLOCK_MAX) return (int)cudaErrorInvalidValue;
  if (M < BF_TILE_MIN_M) return 0;
  const int tile = bf16_tile(M, N);
#define MNN_BF_INFO(t, MT, NT, WM, WN)                                                           \
  if (tile == t) {                                                                            \
    out[0] = Bf16Tile<4, MT, NT, WM, WN>::BM;                                                 \
    out[1] = Bf16Tile<4, MT, NT, WM, WN>::BN;                                                 \
    out[2] = with_bits(bits, [&](auto b) {                                                    \
      return bs > BF_KMAX ? Bf16Tile<decltype(b)::value, MT, NT, WM, WN, BLOCK_MAX>::SMEM     \
                          : Bf16Tile<decltype(b)::value, MT, NT, WM, WN>::SMEM;               \
    });                                                                                       \
    return 0;                                                                                 \
  }
  MNN_BF_TILES(MNN_BF_INFO)
#undef MNN_BF_INFO
  return (int)cudaErrorInvalidValue;
}

#ifdef MNN_DD_CLOCKS
// The tile body's step cycles (deq_dot.cuh, MNN_DD_CLOCKS) of the kernels
// launched since the last read, into out[0..7]; zeroed after.
MNN_API int mnn_dequant_matmul_clocks(long long* out) { return dd_clocks_read(out); }
#endif
