// One output tile of x[M, K] (bf16) @ dequant(W)[K, N] on the tensor cores
// (sm_90a), shared by the dequantize-tile matmul (dequant_matmul.cu) and the
// grouped mixture-of-experts prefill kernel (moe_prefill.cu).
//
// The counterpart of mnn_tpu/kernels/moe_prefill.py::_deq_dot and of the body
// of mnn_tpu/kernels/dequant_matmul.py::_kernel_deq. Per quant block kb, one
// of two algebras:
//   dequant (PARTIAL = false)  wd = bf16(q * s + m);  acc += x_b @ wd
//   partial (PARTIAL = true)   acc += (x_b @ q) * s + rowsum(x_b) * m
// with f32 accumulation. Both dots are bf16 x bf16 -> f32 (q < 256 is exact
// in bf16), so both run on `mma.sync.m16n8k16`.
//
// A block of 8 warps computes up to 80 rows x 128 columns over the whole of
// K. Per quant block it stages the x rows in shared memory as they are, and
// the unpacked (and, for the dequant algebra, scaled and rounded) weights as
// 32-bit words that hold the two K-neighbours of one column, which is what a
// B fragment register holds: a lane unpacks four columns of two packed rows
// and stores 16 bytes, and every B fragment load is one conflict-free 32-bit
// load (row strides of 8 words mod 32). Warp w owns columns 8w .. 8w+7 and 64+8w .. 64+8w+7 of the tile, so that a
// thread's two accumulators of a row are a gate column and its up column in
// the 64-block interleaved layout.
// No copy is overlapped with the math yet: stage, barrier, mma, barrier.
#pragma once

#include "common.cuh"

namespace mnn {

constexpr int DD_THREADS = 256, DD_WARPS = 8, DD_TILE_N = 128;
constexpr int DD_MT = 5, DD_ROWS = 16 * DD_MT;   // m16 tiles and rows per block
constexpr int DD_MAXBS = 128;                    // largest quant block staged
constexpr int DD_XS = DD_MAXBS + 8;              // bf16 per staged x row
constexpr int DD_BW = DD_TILE_N + 8;             // words per staged K-pair row

struct DdSmem {
  bf16 xs[DD_ROWS][DD_XS];
  uint32_t bw[DD_MAXBS / 2][DD_BW];
  float rs[DD_ROWS];
};

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(   // registers only: the compiler is free to schedule it among the loads
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two f32 as one word of two bf16: `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The column of the tile that accumulator (nt, j) of this thread holds.
__device__ __forceinline__ int dd_col(int nt, int j) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  return nt * 64 + warp * 8 + 2 * (lane & 3) + j;
}

// The row of the block that accumulator (mt, hrow) of this thread holds.
__device__ __forceinline__ int dd_row(int mt, int hrow) {
  return mt * 16 + ((threadIdx.x & 31) >> 2) + 8 * hrow;
}

// acc[mt][nt][2 * hrow + j] = (x[0 .. rows) @ dequant(W))[dd_row, n0 + dd_col].
// x: `rows` <= DD_ROWS rows of K bf16, `x_stride` apart (a multiple of 8);
// packed/scale/bias: one weight matrix [K * BITS / 8, N], [K / bs, N];
// bs <= DD_MAXBS, a multiple of 16, dividing K; N a multiple of 4.
template <int BITS, bool PARTIAL>
__device__ __forceinline__ void deq_dot_tile(const bf16* __restrict__ x, long x_stride, int rows,
                                             const uint8_t* __restrict__ packed,
                                             const bf16* __restrict__ scale,
                                             const bf16* __restrict__ bias, int K, int N, int bs,
                                             int n0, DdSmem& sm, float (&acc)[DD_MT][2][4]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int mtiles = (rows + 15) >> 4;
  const int nb = K / bs, half = bs >> 1;
  const int c4 = n0 + lane * 4;
  const bool col_ok = c4 < N;
#pragma unroll
  for (int mt = 0; mt < DD_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[mt][nt][j] = 0.f;

  for (int kb = 0; kb < nb; ++kb) {
    __syncthreads();   // the previous block's fragments and row sums are read
    const int vecs = bs >> 3;   // 16-byte pieces of a staged row
    for (int idx = tid; idx < mtiles * 16 * vecs; idx += DD_THREADS) {
      const int r = idx / vecs, v = idx - r * vecs;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows)
        val = __ldg(reinterpret_cast<const uint4*>(x + (long)r * x_stride + (long)kb * bs + v * 8));
      *reinterpret_cast<uint4*>(&sm.xs[r][v * 8]) = val;
    }
    float s4[4], m4[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s4[j] = 1.f;
      m4[j] = 0.f;
      if (!PARTIAL && col_ok) {
        s4[j] = bf2f(scale[(long)kb * N + c4 + j]);
        m4[j] = bf2f(bias[(long)kb * N + c4 + j]);
      }
    }
    // a weight as the dot sees it: the pattern itself, or bf16(q * s + m)
    auto wval = [&](uint32_t q, int j) {
      const float f = u2f(q);
      return PARTIAL ? f : __fadd_rn(__fmul_rn(f, s4[j]), m4[j]);
    };
    if (BITS == 4) {
      // packed rows 2jp, 2jp + 1 of the block: K offsets (2jp, 2jp + 1) in
      // the low nibbles and (half + 2jp, half + 2jp + 1) in the high ones
      const uint8_t* wp = packed + (long)kb * half * N + c4;
      for (int jp = warp; jp < (half >> 1); jp += DD_WARPS) {
        uint32_t w0 = 0u, w1 = 0u;
        if (col_ok) {
          w0 = __ldg(reinterpret_cast<const uint32_t*>(wp + (long)(2 * jp) * N));
          w1 = __ldg(reinterpret_cast<const uint32_t*>(wp + (long)(2 * jp + 1) * N));
        }
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          lo[j] = pack_bf16(wval((w0 >> (8 * j)) & 0xFu, j), wval((w1 >> (8 * j)) & 0xFu, j));
          hi[j] = pack_bf16(wval((w0 >> (8 * j + 4)) & 0xFu, j), wval((w1 >> (8 * j + 4)) & 0xFu, j));
        }
        *reinterpret_cast<uint4*>(&sm.bw[jp][lane * 4]) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(&sm.bw[(half >> 1) + jp][lane * 4]) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    } else {
      const uint8_t* wp = packed + (long)kb * bs * N + c4;
      for (int jp = warp; jp < half; jp += DD_WARPS) {
        uint32_t w0 = 0u, w1 = 0u;
        if (col_ok) {
          w0 = __ldg(reinterpret_cast<const uint32_t*>(wp + (long)(2 * jp) * N));
          w1 = __ldg(reinterpret_cast<const uint32_t*>(wp + (long)(2 * jp + 1) * N));
        }
        uint32_t q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          q[j] = pack_bf16(wval((w0 >> (8 * j)) & 0xFFu, j), wval((w1 >> (8 * j)) & 0xFFu, j));
        *reinterpret_cast<uint4*>(&sm.bw[jp][lane * 4]) = make_uint4(q[0], q[1], q[2], q[3]);
      }
    }
    __syncthreads();
    if (PARTIAL) {   // row sums of the staged x block, one warp per row
      for (int r = warp; r < mtiles * 16; r += DD_WARPS) {
        float s = 0.f;
        for (int k = lane; k < bs; k += 32) s += bf2f(sm.xs[r][k]);
        s = warp_sum(s);
        if (lane == 0) sm.rs[r] = s;
      }
    }
    float part[DD_MT][2][4];
    __nv_bfloat162 sv[2], mv[2];   // this thread's columns of the block's planes
    if (PARTIAL) {
#pragma unroll
      for (int mt = 0; mt < DD_MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) part[mt][nt][j] = 0.f;
      // on their way while the tensor cores work
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = n0 + dd_col(nt, 0);
        sv[nt] = mv[nt] = __floats2bfloat162_rn(0.f, 0.f);
        if (col < N) {
          sv[nt] = *reinterpret_cast<const __nv_bfloat162*>(&scale[(long)kb * N + col]);
          mv[nt] = *reinterpret_cast<const __nv_bfloat162*>(&bias[(long)kb * N + col]);
        }
      }
    }
    for (int ks = 0; ks < (bs >> 4); ++ks) {
      uint32_t b[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int col = nt * 64 + warp * 8 + gid;
        b[nt][0] = sm.bw[ks * 8 + tig][col];
        b[nt][1] = sm.bw[ks * 8 + 4 + tig][col];
      }
#pragma unroll
      for (int mt = 0; mt < DD_MT; ++mt) {
        if (mt < mtiles) {
          const int r = mt * 16 + gid, k = ks * 16 + 2 * tig;
          uint32_t a[4];
          a[0] = *reinterpret_cast<const uint32_t*>(&sm.xs[r][k]);
          a[1] = *reinterpret_cast<const uint32_t*>(&sm.xs[r + 8][k]);
          a[2] = *reinterpret_cast<const uint32_t*>(&sm.xs[r][k + 8]);
          a[3] = *reinterpret_cast<const uint32_t*>(&sm.xs[r + 8][k + 8]);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            if (PARTIAL)
              mma_bf16_16816(part[mt][nt], a, b[nt]);
            else
              mma_bf16_16816(acc[mt][nt], a, b[nt]);
          }
        }
      }
    }
    if (PARTIAL) {
      __syncthreads();   // the row sums are written
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float s2[2] = {bf2f(sv[nt].x), bf2f(sv[nt].y)};
        const float m2[2] = {bf2f(mv[nt].x), bf2f(mv[nt].y)};
#pragma unroll
        for (int mt = 0; mt < DD_MT; ++mt) {
          if (mt < mtiles) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
              const float rsum = sm.rs[dd_row(mt, hr)];
#pragma unroll
              for (int j = 0; j < 2; ++j)
                acc[mt][nt][2 * hr + j] = __fadd_rn(
                    __fadd_rn(acc[mt][nt][2 * hr + j], __fmul_rn(part[mt][nt][2 * hr + j], s2[j])),
                    __fmul_rn(rsum, m2[j]));
            }
          }
        }
      }
    }
  }
}

}  // namespace mnn
