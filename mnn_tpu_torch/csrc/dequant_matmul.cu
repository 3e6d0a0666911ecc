// Fused per-block dequantize + matmul for W4/W8 weights (sm_90a).
//
// Replaces mnn_tpu/kernels/dequant_matmul.py::_kernel (bf16 rows) and
// ::_kernel_a8 (int8 rows). Weights stay packed: int8 [K*bits/8, N] with
// W4 nibble pairs (i, i + bs/2) inside each quant block, bf16 scale s and
// bias m [K/bs, N]. A quant block contributes
//     (x_b . q_b) * s_b + rowsum(x_b) * m_b            (bf16 rows)
//     (x_b . (q_b - c)) * s_b + rowsum(x_b) * (c s_b + m_b)   (int8 rows, c = 2^(bits-1))
// accumulated in f32 in the order acc + part*s + rowsum*m, with no FMA
// contraction, so the plain PyTorch version reproduces the same rounding.
//
// dqmm_rows_kernel: 256 threads = 32 lanes x 8 K-groups. A lane owns four
// adjacent output columns and reads them as one 32-bit word per packed row,
// so a warp streams 128 contiguous bytes; the 8 warps take interleaved
// quant blocks and are summed in shared memory. MR rows of x sit in shared
// memory. At M = 1 the kernel is bound by the packed weight bytes.
//
// dqmm_a8_kernel: a 64 x 64 output tile per block, 256 threads with 4 x 4
// outputs each. Per quant block it stages the int8 rows and the unpacked,
// re-centred weights as packed int8 quads in shared memory and runs __dp4a
// (exact int32). Tensor-core int8 (mma / wgmma) is later work.
#include "common.cuh"

namespace mnn {

constexpr int ROWS_THREADS = 256;
constexpr int ROWS_KSPLIT = 8;     // warps, each a K-group
constexpr int ROWS_COLS = 128;     // 32 lanes x 4 columns

template <int BITS, int MR>
__global__ void __launch_bounds__(ROWS_THREADS)
dqmm_rows_kernel(const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
                 const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                 const float* __restrict__ out_bias, void* __restrict__ out,
                 int M, int K, int N, int bs, int out_f32) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);           // [MR][K]
  __shared__ float red[ROWS_KSPLIT][MR][ROWS_COLS];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.y * MR;
  const int c0 = blockIdx.x * ROWS_COLS + lane * 4;

  for (int i = threadIdx.x; i < MR * K; i += ROWS_THREADS) {
    int r = i / K, k = i - r * K;
    xs[i] = (row0 + r < M) ? x[(long)(row0 + r) * K + k] : __float2bfloat16_rn(0.f);
  }
  __syncthreads();

  float acc[MR][4];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  const int nb = K / bs;
  if (c0 < N) {
    for (int kb = warp; kb < nb; kb += ROWS_KSPLIT) {
      float part[MR][4], rs[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        rs[r] = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) part[r][j] = 0.f;
      }
      const int kbase = kb * bs;
      if (BITS == 4) {
        const int half = bs >> 1;
        const uint8_t* p = packed + (long)(kb * half) * N + c0;
#pragma unroll 4
        for (int i = 0; i < half; ++i) {
          uint32_t w = *reinterpret_cast<const uint32_t*>(p + (long)i * N);
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            float xa = bf2f(xs[r * K + kbase + i]);
            float xb = bf2f(xs[r * K + kbase + half + i]);
            rs[r] += xa + xb;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              float lo = (float)((w >> (8 * j)) & 0xF);
              float hi = (float)((w >> (8 * j + 4)) & 0xF);
              part[r][j] += xa * lo + xb * hi;
            }
          }
        }
      } else {
        const uint8_t* p = packed + (long)kbase * N + c0;
#pragma unroll 4
        for (int i = 0; i < bs; ++i) {
          uint32_t w = *reinterpret_cast<const uint32_t*>(p + (long)i * N);
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            float xa = bf2f(xs[r * K + kbase + i]);
            rs[r] += xa;
#pragma unroll
            for (int j = 0; j < 4; ++j) part[r][j] += xa * (float)((w >> (8 * j)) & 0xFF);
          }
        }
      }
      float s[4], m[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = bf2f(scale[(long)kb * N + c0 + j]);
        m[j] = bf2f(bias[(long)kb * N + c0 + j]);
      }
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[r][j] = __fadd_rn(__fadd_rn(acc[r][j], __fmul_rn(part[r][j], s[j])),
                                __fmul_rn(rs[r], m[j]));
    }
  }
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][r][lane * 4 + j] = acc[r][j];
  __syncthreads();

  // one thread per (row, column) of the tile sums the K-groups in order
  for (int t = threadIdx.x; t < MR * ROWS_COLS; t += ROWS_THREADS) {
    int r = t / ROWS_COLS, c = t - r * ROWS_COLS;
    int row = row0 + r, col = blockIdx.x * ROWS_COLS + c;
    if (row >= M || col >= N) continue;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < ROWS_KSPLIT; ++w) v += red[w][r][c];
    v = as_out(v, out_f32);
    if (out_bias) v = __fadd_rn(v, out_bias[col]);
    store_out(out, (long)row * N + col, v, out_f32);
  }
}

constexpr int A8_BM = 64, A8_BN = 64, A8_THREADS = 256, A8_MAXQ = 32;  // bs <= 128

template <int BITS>
__global__ void __launch_bounds__(A8_THREADS)
dqmm_a8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xscale,
               const uint8_t* __restrict__ packed, const bf16* __restrict__ scale,
               const bf16* __restrict__ bias, const float* __restrict__ out_bias,
               void* __restrict__ out, int M, int K, int N, int bs, int out_f32) {
  __shared__ int xs[A8_BM][A8_MAXQ + 1];     // int8 quads of x, padded rows
  __shared__ int ws[A8_MAXQ][A8_BN];         // int8 quads of (q - c) along K
  __shared__ int rsum[A8_BM];
  __shared__ float s_s[A8_BN], b_s[A8_BN];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * A8_BM, n0 = blockIdx.x * A8_BN;
  const int nq = bs >> 2;
  const int nb = K / bs;
  const int center = 1 << (BITS - 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nb; ++kb) {
    __syncthreads();
    for (int idx = tid; idx < A8_BM * nq; idx += A8_THREADS) {
      int r = idx / nq, kq = idx - r * nq;
      int row = m0 + r;
      xs[r][kq] = row < M
          ? *reinterpret_cast<const int*>(xq + (long)row * K + kb * bs + 4 * kq) : 0;
    }
    for (int idx = tid; idx < nq * A8_BN; idx += A8_THREADS) {
      int kq = idx / A8_BN, c = idx - kq * A8_BN;
      int col = n0 + c;
      uint32_t quad = 0;
      if (col < N) {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          int k = 4 * kq + jj, v;
          if (BITS == 4) {
            int half = bs >> 1;
            uint8_t byte = packed[(long)(kb * half + (k < half ? k : k - half)) * N + col];
            v = (k < half ? (byte & 0xF) : (byte >> 4)) - center;
          } else {
            v = (int)packed[(long)(kb * bs + k) * N + col] - center;
          }
          quad |= (uint32_t)(v & 0xFF) << (8 * jj);
        }
      }
      ws[kq][c] = (int)quad;
    }
    if (tid < A8_BN) {
      int col = n0 + tid;
      float s = col < N ? bf2f(scale[(long)kb * N + col]) : 0.f;
      float m = col < N ? bf2f(bias[(long)kb * N + col]) : 0.f;
      s_s[tid] = s;
      b_s[tid] = __fadd_rn(__fmul_rn((float)center, s), m);   // folded bias plane
    }
    __syncthreads();
    if (tid < A8_BM) {
      int t = 0;
      for (int kq = 0; kq < nq; ++kq) t = __dp4a(xs[tid][kq], 0x01010101, t);
      rsum[tid] = t;
    }
    int part[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i][j] = 0;
    for (int kq = 0; kq < nq; ++kq) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[ty * 4 + i][kq];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[kq][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = __dp4a(a[i], b[j], part[i][j]);
    }
    __syncthreads();   // rsum ready
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rs = (float)rsum[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tx + 16 * j;
        acc[i][j] = __fadd_rn(__fadd_rn(acc[i][j], __fmul_rn((float)part[i][j], s_s[c])),
                              __fmul_rn(rs, b_s[c]));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int row = m0 + ty * 4 + i;
    if (row >= M) continue;
    float xsc = xscale[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int col = n0 + tx + 16 * j;
      if (col >= N) continue;
      float v = as_out(acc[i][j], out_f32);
      v = as_out(__fmul_rn(v, xsc), out_f32);
      if (out_bias) v = __fadd_rn(v, out_bias[col]);
      store_out(out, (long)row * N + col, v, out_f32);
    }
  }
}

template <int BITS, int MR>
static cudaError_t launch_rows(const void* x, const void* packed, const void* scale,
                               const void* bias, const void* out_bias, void* out,
                               int M, int K, int N, int bs, int out_f32, cudaStream_t st) {
  size_t smem = (size_t)MR * K * sizeof(bf16);
  auto kern = dqmm_rows_kernel<BITS, MR>;
  static size_t granted = 0;
  cudaError_t e = allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((N + ROWS_COLS - 1) / ROWS_COLS, (M + MR - 1) / MR);
  kern<<<grid, ROWS_THREADS, smem, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<const float*>(out_bias), out, M, K, N, bs, out_f32);
  return cudaGetLastError();
}

}  // namespace mnn

using namespace mnn;

// y[M, N] = x[M, K] (bf16) @ dequant(packed, scale, bias) (+ out_bias)
MNN_API int mnn_dequant_matmul(const void* x, const void* packed, const void* scale,
                               const void* bias, const void* out_bias, void* out,
                               int M, int K, int N, int bits, int bs, int out_f32,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return M == 1 ? launch_rows<4, 1>(x, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, st)
                  : launch_rows<4, 4>(x, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, st);
  if (bits == 8)
    return M == 1 ? launch_rows<8, 1>(x, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, st)
                  : launch_rows<8, 4>(x, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, st);
  return (int)cudaErrorInvalidValue;
}

// y[M, N] = ((int8 xq @ (q - c)) algebra) rounded, times xscale[M], (+ out_bias)
MNN_API int mnn_dequant_matmul_a8(const void* xq, const void* xscale, const void* packed,
                                  const void* scale, const void* bias, const void* out_bias,
                                  void* out, int M, int K, int N, int bits, int bs,
                                  int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bs > 4 * A8_MAXQ || bs % 8) return (int)cudaErrorInvalidValue;
  dim3 grid((N + A8_BN - 1) / A8_BN, (M + A8_BM - 1) / A8_BM);
  const int8_t* xp = static_cast<const int8_t*>(xq);
  const float* xs = static_cast<const float*>(xscale);
  const uint8_t* pp = static_cast<const uint8_t*>(packed);
  const bf16* sp = static_cast<const bf16*>(scale);
  const bf16* bp = static_cast<const bf16*>(bias);
  const float* ob = static_cast<const float*>(out_bias);
  if (bits == 4)
    dqmm_a8_kernel<4><<<grid, A8_THREADS, 0, st>>>(xp, xs, pp, sp, bp, ob, out, M, K, N, bs, out_f32);
  else if (bits == 8)
    dqmm_a8_kernel<8><<<grid, A8_THREADS, 0, st>>>(xp, xs, pp, sp, bp, ob, out, M, K, N, bs, out_f32);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
