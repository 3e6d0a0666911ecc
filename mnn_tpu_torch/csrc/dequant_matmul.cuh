// The tensor-core kernels of dequant_matmul.cu (sm_90a): the int8-row
// kernel (dqmm_a8_kernel), the bf16-row tile kernel (dqmm_bf16_tile_kernel)
// and the dequantize-tile kernel (dqmm_deq_kernel), their tiles and their
// launches, each templated on the largest quant block it stages (KMAX). The
// design and the TPU kernels they replace are in dequant_matmul.cu's notes.
//
// Blocks of up to 128 K-values take the KMAX = 128 build, whose kernels
// dequant_matmul.cu instantiates. Blocks of 136 to 256 take the KMAX = 256
// build, kernels of their own names (`_k256`) that dequant_matmul_k256.cu
// instantiates, so the two compile side by side: a ring stage holds the
// whole quant block (x rows of 256 K-values, 272 bytes of xq or 528 of
// bf16 a row), and the block is unpacked into the same unpacked buffer in
// two chunks of K-values, 0..127 and 128..bs-1; the block's int32 (a8) or
// f32 (bf16 rows) partial sums run on across both chunks, and the f32 step
// comes once per quant block, as the JAX kernel takes it.
#pragma once

#include <algorithm>
#include <type_traits>

#include "deq_dot.cuh"

namespace mnn {

// ---------------------------------------------------------------------------
// dqmm_a8_kernel: int8 rows x re-centred W4/W8 pattern on the int8 tensor cores
// ---------------------------------------------------------------------------

constexpr int A8_KW = BF_KMAX / 4;   // K words (4 K-values each) of an unpacked chunk

// Shared memory of one tile shape for quant blocks of up to KMAX K-values:
// A8_STAGES stages of [raw packed rows of one quant block][BN] bytes,
// [BM][XSTR] bytes of xq and the block's scale and bias rows, then the
// unpacked pattern of one chunk as [A8_KW][BW] words, each word four
// consecutive K-values of one column (a B fragment register).
template <int BITS, int MT, int NT, int WM, int WN, int KMAX = BF_KMAX>
struct A8Tile {
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8, THREADS = 32 * WM * WN;
  static constexpr int CHUNKS = KMAX / BF_KMAX;
  static constexpr int XSTR = KMAX + 16;   // bytes per staged xq row: 144 or 272, conflict-free
  static constexpr int W_BYTES = KMAX * BITS / 8 * BN;
  static constexpr int X_BYTES = BM * XSTR;
  static constexpr int STAGE = W_BYTES + X_BYTES + 2 * BN * 2;
  static constexpr int BW = BN + 8;           // 8 words mod 32: B loads are conflict-free
  static constexpr int SMEM = A8_STAGES * STAGE + A8_KW * BW * 4;
};

// d += a (int8) . b (uint8), exact in int32
__device__ __forceinline__ void mma_s8u8_16832(int (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(   // registers only: the compiler is free to schedule it among the loads
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Rows r0..r3 of four byte columns -> t[j], the four rows' bytes of column j.
__device__ __forceinline__ void transpose4x4(uint32_t r0, uint32_t r1, uint32_t r2, uint32_t r3,
                                             uint32_t (&t)[4]) {
  const uint32_t a = __byte_perm(r0, r1, 0x5140), b = __byte_perm(r0, r1, 0x7362);
  const uint32_t c = __byte_perm(r2, r3, 0x5140), d = __byte_perm(r2, r3, 0x7362);
  t[0] = __byte_perm(a, c, 0x5410);
  t[1] = __byte_perm(a, c, 0x7632);
  t[2] = __byte_perm(b, d, 0x5410);
  t[3] = __byte_perm(b, d, 0x7632);
}

// The W2/W3 unpack of dqmm_a8_kernel: quant block `st` (bs K-values, packed
// rows of BN bytes) into the K-major words of bt (word kw of a column: K
// values 4 kw .. 4 kw + 3), the pattern q = lo + 4 hi joined before it is
// multiplied, so the int32 products stay exact. A 2-bit row j holds K values
// j + m bs/4 (bit pair 2m); for K value k, W3's 1-bit plane holds q >> 2 in
// row bs/4 + k % (bs/8), bit k / (bs/8): for a 2-bit row j, row bs/4 +
// j % (bs/8), bit j / (bs/8) + 2m. Where the four K values of a word lie in
// four consecutive 2-bit rows (W2: bs % 16 == 0; W3: bs % 32 == 0, so that
// their 1-bit rows are consecutive too), a thread transposes four rows x
// four columns as the W4 unpack does and stores 16 bytes a K word; other
// blocks (W2 of 8, W3 of 8 to 24 K values a block past a multiple of 32)
// take a 2-bit row x four columns a thread and store bytes. With CHUNKS > 1
// only the words of the chunk from word w0 on are written, at word w - w0.
template <int BITS, int BN, int BW, int THREADS, int CHUNKS>
__device__ __forceinline__ void a8_unpack_sub4(const unsigned char* st, uint32_t* bt, int bs,
                                               int w0, int tid) {
  constexpr int CQ = BN / 4;
  const uint32_t* raw = reinterpret_cast<const uint32_t*>(st);
  const int q4 = bs >> 2, e8 = bs >> 3;
  if (bs % (BITS == 2 ? 16 : 32) == 0) {
    for (int u = tid; u < (q4 >> 2) * CQ; u += THREADS) {
      const int iq = u / CQ, cq = u - iq * CQ;
      const uint32_t* p = raw + 4 * iq * CQ + cq;
      uint32_t t[4], h[4] = {0u, 0u, 0u, 0u};
      transpose4x4(p[0], p[CQ], p[2 * CQ], p[3 * CQ], t);
      int sh = 0;
      if (BITS == 3) {
        const uint32_t* ph = raw + (q4 + (4 * iq) % e8) * CQ + cq;
        transpose4x4(ph[0], ph[CQ], ph[2 * CQ], ph[3 * CQ], h);
        sh = 4 * iq / e8;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int wd = iq + m * (bs >> 4) - w0;   // the K word in the chunk
        if (CHUNKS > 1 && (unsigned)wd >= (unsigned)A8_KW) continue;
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = ((t[j] >> (2 * m)) & 0x03030303u) |
                 (BITS == 3 ? ((h[j] >> (2 * m + sh)) & 0x01010101u) << 2 : 0u);
        *reinterpret_cast<uint4*>(bt + wd * BW + 4 * cq) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  } else {
    unsigned char* b8 = reinterpret_cast<unsigned char*>(bt);
    for (int u = tid; u < q4 * CQ; u += THREADS) {
      const int j = u / CQ, cq = u - j * CQ;
      const uint32_t lo = raw[j * CQ + cq];
      const uint32_t hi = BITS == 3 ? raw[(q4 + j % e8) * CQ + cq] : 0u;
      const int sh = BITS == 3 ? j / e8 : 0;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t v = ((lo >> (2 * m)) & 0x03030303u) |
                           (BITS == 3 ? ((hi >> (2 * m + sh)) & 0x01010101u) << 2 : 0u);
        const int k = j + m * q4 - 4 * w0;   // the K value in the chunk
        if (CHUNKS > 1 && (unsigned)k >= (unsigned)BF_KMAX) continue;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          b8[((k >> 2) * BW + 4 * cq + c) * 4 + (k & 3)] = (unsigned char)(v >> (8 * c));
      }
    }
  }
}

// One BM x BN output tile over the whole of K, for quant blocks of up to
// KMAX K-values. vx, vw, vp: the bytes per asynchronous copy of xq, of the
// packed rows and of the scale/bias rows (16, 8 or 4, as their alignment
// allows).
template <int BITS, int MT, int NT, int WM, int WN, int KMAX>
__device__ __forceinline__ void a8_tile_matmul(const int8_t* __restrict__ xq,
                                               const float* __restrict__ xscale,
                                               const uint8_t* __restrict__ packed,
                                               const bf16* __restrict__ scale,
                                               const bf16* __restrict__ bias,
                                               const float* __restrict__ out_bias,
                                               void* __restrict__ out, int M, int K, int N,
                                               int bs, int out_f32, int vx, int vw, int vp) {
  using T = A8Tile<BITS, MT, NT, WM, WN, KMAX>;
  constexpr int BM = T::BM, BN = T::BN, BW = T::BW, THREADS = T::THREADS, NC = T::CHUNKS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* bt = reinterpret_cast<uint32_t*>(smem_raw + A8_STAGES * T::STAGE);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_w = (warp / WN) * MT * 16, col_w = (warp % WN) * NT * 8;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nb = K / bs, kp = (bs + 31) & ~31;   // K-values per block, padded to the mma depth
  const int rows_w = bs * BITS / 8;              // packed rows per quant block
  const float center = (float)(1 << (BITS - 1));

  using R = Ring<1, KMAX, T::XSTR, BM, BN, THREADS, T::W_BYTES, T::X_BYTES, T::STAGE>;
  R::zero_pad(smem_raw, bs, kp, tid);
  const R ring(tid, n0, N, scale, bias, vx, vw, vp);
  auto load = [&](int kb) {
    if (kb < nb)
      ring.load(smem_raw + (kb % A8_STAGES) * T::STAGE, kb, packed, rows_w,
                reinterpret_cast<const unsigned char*>(xq), m0, M, K, bs, N, n0);
    cp_async_commit();   // an empty group past the last block keeps the count
  };

  // the row scales and output biases this thread applies at the end
  float xsc[MT][2], ob[NT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_w + mt * 16 + gid + 8 * h;
      xsc[mt][h] = row < M ? xscale[row] : 0.f;
    }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + col_w + nt * 8 + 2 * tig + j;
      ob[nt][j] = out_bias && col < N ? out_bias[col] : 0.f;
    }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

#pragma unroll
  for (int s = 0; s < A8_STAGES - 1; ++s) load(s);

  for (int kb = 0; kb < nb; ++kb) {
    cp_async_wait<A8_STAGES - 2>();
    __syncthreads();          // block kb has landed; every warp is done with kb - 1
    load(kb + A8_STAGES - 1);
    const unsigned char* st = smem_raw + (kb % A8_STAGES) * T::STAGE;

    int part[MT][NT][4], rs[MT][2];   // the block's sums, over its chunks
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      const int w0 = ch * A8_KW;   // the chunk's first K word
      if (ch) __syncthreads();     // every warp is done with the chunk before

      // unpack once per tile: four packed rows x four columns a thread,
      // transposed into K-major words and (W4) split into nibbles, words iq
      // and iq + bs/8 of the block (those of the chunk, less w0); stored 16
      // bytes at a time
      if constexpr (BITS < 4) {
        a8_unpack_sub4<BITS, BN, BW, THREADS, NC>(st, bt, bs, w0, tid);
      } else {
        constexpr int CQ = BN / 4;
        const uint32_t* raw = reinterpret_cast<const uint32_t*>(st);
        const int words = rows_w >> 2;   // word iq: packed rows 4 iq .. 4 iq + 3
        int i0 = 0, i1 = words;
        if constexpr (NC > 1) {          // the rows with a K word in the chunk
          i0 = BITS == 8 ? w0 : max(0, w0 - words);
          i1 = min(words, w0 + A8_KW);
        }
        for (int u = tid + i0 * CQ; u < i1 * CQ; u += THREADS) {
          const int iq = u / CQ, cq = u - iq * CQ;
          const uint32_t* p = raw + 4 * iq * CQ + cq;
          uint32_t t[4];
          transpose4x4(p[0], p[CQ], p[2 * CQ], p[3 * CQ], t);
          if (BITS == 4) {
            constexpr uint32_t LO = 0x0F0F0F0Fu;
            if (NC == 1 || (unsigned)(iq - w0) < (unsigned)A8_KW)
              *reinterpret_cast<uint4*>(bt + (iq - w0) * BW + 4 * cq) =
                  make_uint4(t[0] & LO, t[1] & LO, t[2] & LO, t[3] & LO);
            if (NC == 1 || (unsigned)(iq + (bs >> 3) - w0) < (unsigned)A8_KW)
              *reinterpret_cast<uint4*>(bt + (iq + (bs >> 3) - w0) * BW + 4 * cq) = make_uint4(
                  (t[0] >> 4) & LO, (t[1] >> 4) & LO, (t[2] >> 4) & LO, (t[3] >> 4) & LO);
          } else {
            *reinterpret_cast<uint4*>(bt + (iq - w0) * BW + 4 * cq) =
                make_uint4(t[0], t[1], t[2], t[3]);
          }
        }
      }
      __syncthreads();          // the unpacked chunk is complete

      if (ch == 0)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          rs[mt][0] = rs[mt][1] = 0;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0;
        }
      // Rows past M are zeros in shared memory: their tiles add nothing, and
      // computing them keeps the loop free of branches. ldmatrix.x4 row
      // addresses: lanes 0-15 rows 0-15 of an m16 tile at K bytes 0-15, lanes
      // 16-31 the same rows at K bytes 16-31, from the chunk's first K byte.
      const unsigned xr = static_cast<unsigned>(__cvta_generic_to_shared(
          st + T::W_BYTES + (row_w + (lane & 15)) * T::XSTR + (lane >> 4) * 16 + ch * BF_KMAX));
      const uint32_t* br = bt + tig * BW + col_w + gid;
      const int ksteps = (ch < NC - 1 ? BF_KMAX : kp - (NC - 1) * BF_KMAX) >> 5;
#pragma unroll 4
      for (int ks = 0; ks < ksteps; ++ks, br += 8 * BW) {
        uint32_t a[MT][4], b[NT][2];   // every fragment of the step, then the products
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          b[nt][0] = br[nt * 8];
          b[nt][1] = br[4 * BW + nt * 8];
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xr + ks * 32 + mt * 16 * T::XSTR);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          // the row sums ride on the A fragments: rows gid and gid + 8
          constexpr int ONES = 0x01010101;
          rs[mt][0] = __dp4a((int)a[mt][2], ONES, __dp4a((int)a[mt][0], ONES, rs[mt][0]));
          rs[mt][1] = __dp4a((int)a[mt][3], ONES, __dp4a((int)a[mt][1], ONES, rs[mt][1]));
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_s8u8_16832(part[mt][nt], a[mt], b[nt]);
        }
      }
    }

    // the block's f32 step: acc = (acc + part * s) + rs * (c * s + m), where
    // part = x . (q - c) = x . q - c * rs, exact in int32
    const bf16* sp = reinterpret_cast<const bf16*>(st + T::W_BYTES + T::X_BYTES);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {   // sum over the four lanes that share a row
        rs[mt][h] += __shfl_xor_sync(0xffffffffu, rs[mt][h], 1);
        rs[mt][h] += __shfl_xor_sync(0xffffffffu, rs[mt][h], 2);
      }
    __nv_bfloat162 sv[NT], mv[NT];   // this thread's two columns of each n-tile
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int col = col_w + nt * 8 + 2 * tig;
      sv[nt] = *reinterpret_cast<const __nv_bfloat162*>(sp + col);
      mv[nt] = *reinterpret_cast<const __nv_bfloat162*>(sp + BN + col);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float s = bf2f(j ? sv[nt].y : sv[nt].x);
        const float fold = __fadd_rn(__fmul_rn(center, s), bf2f(j ? mv[nt].y : mv[nt].x));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& a = acc[mt][nt][2 * h + j];
            const int pq = part[mt][nt][2 * h + j] - (1 << (BITS - 1)) * rs[mt][h];
            a = __fadd_rn(__fadd_rn(a, __fmul_rn((float)pq, s)),
                          __fmul_rn((float)rs[mt][h], fold));
          }
      }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_w + mt * 16 + gid + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + col_w + nt * 8 + 2 * tig;   // and col + 1: N is even
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = as_out(acc[mt][nt][2 * h + j], out_f32);
          v[j] = as_out(__fmul_rn(v[j], xsc[mt][h]), out_f32);
          if (out_bias) v[j] = __fadd_rn(v[j], ob[nt][j]);
        }
        const long o = (long)row * N + col;
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
              __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

#define MNN_A8_PARAMS                                                                        \
  const int8_t *__restrict__ xq, const float *__restrict__ xscale,                          \
      const uint8_t *__restrict__ packed, const bf16 *__restrict__ scale,                   \
      const bf16 *__restrict__ bias, const float *__restrict__ out_bias,                    \
      void *__restrict__ out, int M, int K, int N, int bs, int out_f32, int vx, int vw, int vp
#define MNN_A8_ARGS xq, xscale, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, vx, vw, vp

// The int8-row kernel for quant blocks of up to 128 K-values, and of up to 256
template <int BITS, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) dqmm_a8_kernel(MNN_A8_PARAMS) {
  a8_tile_matmul<BITS, MT, NT, WM, WN, BF_KMAX>(MNN_A8_ARGS);
}
template <int BITS, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) dqmm_a8_k256_kernel(MNN_A8_PARAMS) {
  a8_tile_matmul<BITS, MT, NT, WM, WN, BLOCK_MAX>(MNN_A8_ARGS);
}

// ---------------------------------------------------------------------------
// dqmm_bf16_tile_kernel and dqmm_deq_kernel: bf16 rows on the bf16 tensor
// cores, through the tile body of deq_dot.cuh
// ---------------------------------------------------------------------------

// One BM x BN output tile over the whole of K in algebra ALG, rounded to
// the output dtype, plus out_bias.
template <int BITS, int MT, int NT, int WM, int WN, int ALG, int KMAX>
__device__ __forceinline__ void bf16_tile_matmul(const bf16* __restrict__ x,
                                                 const uint8_t* __restrict__ packed,
                                                 const bf16* __restrict__ scale,
                                                 const bf16* __restrict__ bias,
                                                 const float* __restrict__ out_bias,
                                                 void* __restrict__ out, int M, int K, int N,
                                                 int bs, int out_f32, int vx, int vw, int vp) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN, KMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_w = (warp / WN) * MT * 16, col_w = (warp % WN) * NT * 8;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;

  float ob[NT][2];   // the output biases this thread adds at the end
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int col = n0 + col_w + nt * 8 + 2 * tig + j;
      ob[nt][j] = out_bias && col < N ? out_bias[col] : 0.f;
    }

  float acc[MT][NT][4];
  tile_body<BITS, MT, NT, WM, WN, ALG, KMAX>(smem_raw, x, m0, M, K, packed, scale, bias, N, bs,
                                             n0, vx, vw, vp, acc);

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_w + mt * 16 + gid + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + col_w + nt * 8 + 2 * tig;   // and col + 1: N is even
        if (col >= N) continue;
        float v[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[j] = as_out(acc[mt][nt][2 * h + j], out_f32);
          if (out_bias) v[j] = __fadd_rn(v[j], ob[nt][j]);
        }
        const long o = (long)row * N + col;
        if (out_f32)
          *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v[0], v[1]);
        else
          *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + o) =
              __floats2bfloat162_rn(v[0], v[1]);
      }
    }
}

#define MNN_BF_PARAMS                                                                        \
  const bf16 *__restrict__ x, const uint8_t *__restrict__ packed,                           \
      const bf16 *__restrict__ scale, const bf16 *__restrict__ bias,                        \
      const float *__restrict__ out_bias, void *__restrict__ out, int M, int K, int N, int bs, \
      int out_f32, int vx, int vw, int vp
#define MNN_BF_ARGS x, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, vx, vw, vp

// bf16 rows x the pattern (::_kernel at M > 1): per quant block, part =
// x_b . q_b, the row sums as one more product with a B of ones, then
// acc = (acc + part * s) + rs * m in f32 in the plain version's order.
template <int BITS, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) dqmm_bf16_tile_kernel(MNN_BF_PARAMS) {
  bf16_tile_matmul<BITS, MT, NT, WM, WN, ALG_ROWS, BF_KMAX>(MNN_BF_ARGS);
}
template <int BITS, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) dqmm_bf16_tile_k256_kernel(MNN_BF_PARAMS) {
  bf16_tile_matmul<BITS, MT, NT, WM, WN, ALG_ROWS, BLOCK_MAX>(MNN_BF_ARGS);
}

// bf16 rows x bf16(q * s + m) (::_kernel_deq): the quant block's weights
// rounded in the unpack, the products accumulated straight into acc.
template <int BITS, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) dqmm_deq_kernel(MNN_BF_PARAMS) {
  bf16_tile_matmul<BITS, MT, NT, WM, WN, ALG_DEQUANT, BF_KMAX>(MNN_BF_ARGS);
}
template <int BITS, int MT, int NT, int WM, int WN>
__global__ void __launch_bounds__(32 * WM * WN) dqmm_deq_k256_kernel(MNN_BF_PARAMS) {
  bf16_tile_matmul<BITS, MT, NT, WM, WN, ALG_DEQUANT, BLOCK_MAX>(MNN_BF_ARGS);
}

// The tile shapes of dqmm_a8_kernel as (MT, NT, WM, WN), tallest first:
// 64 x 64, 32 x 64 and 16 x 64, four warps each. (128 x 128 with eight
// warps took 255 registers and one block an SM, and was slower at every
// main-path shape.)
#define MNN_A8_TILES(X) X(0, 2, 4, 2, 2) X(1, 1, 4, 2, 2) X(2, 1, 2, 1, 4)
#define MNN_A8_BM(t, MT, NT, WM, WN) A8Tile<4, MT, NT, WM, WN>::BM,
#define MNN_A8_BN(t, MT, NT, WM, WN) A8Tile<4, MT, NT, WM, WN>::BN,
constexpr int A8_TILE_BM[] = {MNN_A8_TILES(MNN_A8_BM)};
constexpr int A8_TILE_BN[] = {MNN_A8_TILES(MNN_A8_BN)};
constexpr int A8_NTILES = sizeof(A8_TILE_BM) / sizeof(int);
#undef MNN_A8_BM
#undef MNN_A8_BN

// The tallest of `count` tiles (rows bm[t], columns bn[t], tallest first)
// that is no taller than the rows (rounded up to 16) and still gives every
// SM a block; the shortest where none does.
static int pick_tile(int M, int N, const int* bm, const int* bn, int count) {
  const int m16 = (M + 15) & ~15;
  for (int t = 0; t + 1 < count; ++t) {
    const long blocks = (long)((M + bm[t] - 1) / bm[t]) * ((N + bn[t] - 1) / bn[t]);
    if (bm[t] <= m16 && blocks >= sm_count()) return t;
  }
  return count - 1;
}

static int a8_tile(int M, int N) { return pick_tile(M, N, A8_TILE_BM, A8_TILE_BN, A8_NTILES); }

// The tile shapes of dqmm_bf16_tile_kernel as (MT, NT, WM, WN), largest
// first: 64 x 128 (eight warps), 64 x 64, 32 x 64 and 16 x 64 (four), then
// 16 x 32, 16 x 16 and 16 x 8 (two warps, one, one), so that the 32-row
// bucket fills the card at N = 2048 (16 x 16: 256 blocks) and N = 896
// (16 x 8: 224 blocks) too. Each warp holds at most 32 x 32.
#define MNN_BF_TILES(X)                                                                      \
  X(0, 2, 4, 2, 4) X(1, 2, 4, 2, 2) X(2, 1, 4, 2, 2) X(3, 1, 2, 1, 4) X(4, 1, 2, 1, 2)        \
  X(5, 1, 2, 1, 1) X(6, 1, 1, 1, 1)
#define MNN_BF_BM(t, MT, NT, WM, WN) Bf16Tile<4, MT, NT, WM, WN>::BM,
#define MNN_BF_BN(t, MT, NT, WM, WN) Bf16Tile<4, MT, NT, WM, WN>::BN,
constexpr int BF_TILE_BM[] = {MNN_BF_TILES(MNN_BF_BM)};
constexpr int BF_TILE_BN[] = {MNN_BF_TILES(MNN_BF_BN)};
constexpr int BF_NTILES = sizeof(BF_TILE_BM) / sizeof(int);
#undef MNN_BF_BM
#undef MNN_BF_BN

// Rows from which bf16 rows take dqmm_bf16_tile_kernel; below, the GEMV
// kernel, which keeps M = 1 (the decode GEMVs and the head). The crossover,
// measured against the row kernel that then served M > 1 too
// (dqmm_rows_kernel<4, 4>, since replaced) on an H100 80GB HBM3 at 700 W
// (profile_a8.py --kernel rows, W4 block 128), lies below M = 2: at M = 2
// the tile kernel takes 9.5 / 10.4 / 45.2 / 51.3 us against 31.6 / 32.2 /
// 147.1 / 174.9 at K x N = 896 x 1152, 896 x 9728, 4864 x 896 and
// 5632 x 2048, and it stays 2.8 to 4.6 times faster at M = 4, 8, 16 and 32.
constexpr int BF_TILE_MIN_M = 2;

static int bf16_tile(int M, int N) { return pick_tile(M, N, BF_TILE_BM, BF_TILE_BN, BF_NTILES); }

template <int BITS, int MT, int NT, int WM, int WN, int KMAX>
static cudaError_t launch_a8(const void* xq, const void* xscale, const void* packed,
                             const void* scale, const void* bias, const void* out_bias,
                             void* out, int M, int K, int N, int bs, int out_f32,
                             cudaStream_t st) {
  using T = A8Tile<BITS, MT, NT, WM, WN, KMAX>;
  auto kern = [] {
    if constexpr (KMAX == BF_KMAX) return dqmm_a8_kernel<BITS, MT, NT, WM, WN>;
    else return dqmm_a8_k256_kernel<BITS, MT, NT, WM, WN>;
  }();
  static size_t granted = 0;
  cudaError_t e = allow_smem(kern, T::SMEM, granted);
  if (e != cudaSuccess) return e;
  const int vx = copy_width((uintptr_t)xq | (uintptr_t)K | (uintptr_t)bs);
  const int vw = copy_width((uintptr_t)packed | (uintptr_t)N);
  const int vp = copy_width((uintptr_t)scale | (uintptr_t)bias | (uintptr_t)(2 * N));
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kern<<<grid, T::THREADS, T::SMEM, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(xscale),
      static_cast<const uint8_t*>(packed), static_cast<const bf16*>(scale),
      static_cast<const bf16*>(bias), static_cast<const float*>(out_bias), out, M, K, N, bs,
      out_f32, vx, vw, vp);
  return cudaGetLastError();
}

// dqmm_bf16_tile_kernel, or dqmm_deq_kernel when DEQ, in one tile shape
template <int BITS, int MT, int NT, int WM, int WN, bool DEQ, int KMAX>
static cudaError_t launch_bf16_tile(const void* x, const void* packed, const void* scale,
                                   const void* bias, const void* out_bias, void* out, int M,
                                   int K, int N, int bs, int out_f32, cudaStream_t st) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN, KMAX>;
  auto kern = [] {
    if constexpr (KMAX == BF_KMAX)
      return DEQ ? dqmm_deq_kernel<BITS, MT, NT, WM, WN> : dqmm_bf16_tile_kernel<BITS, MT, NT, WM, WN>;
    else
      return DEQ ? dqmm_deq_k256_kernel<BITS, MT, NT, WM, WN>
                 : dqmm_bf16_tile_k256_kernel<BITS, MT, NT, WM, WN>;
  }();
  constexpr int SMEM = T::smem(DEQ ? ALG_DEQUANT : ALG_ROWS);
  static size_t granted = 0;
  cudaError_t e = allow_smem(kern, SMEM, granted);
  if (e != cudaSuccess) return e;
  const int vx = copy_width((uintptr_t)x | (uintptr_t)(2 * K) | (uintptr_t)(2 * bs));
  const int vw = std::min(copy_width((uintptr_t)packed | (uintptr_t)N), T::BN);
  const int vp = copy_width((uintptr_t)scale | (uintptr_t)bias | (uintptr_t)(2 * N));
  dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM);
  kern<<<grid, T::THREADS, SMEM, st>>>(
      static_cast<const bf16*>(x), static_cast<const uint8_t*>(packed),
      static_cast<const bf16*>(scale), static_cast<const bf16*>(bias),
      static_cast<const float*>(out_bias), out, M, K, N, bs, out_f32, vx, vw, vp);
  return cudaGetLastError();
}

// f(std::integral_constant<int, bits>()) for weight bits of 2, 3, 4 or 8
template <class F>
static int with_bits(int bits, F&& f) {
  switch (bits) {
    case 2: return f(std::integral_constant<int, 2>());
    case 3: return f(std::integral_constant<int, 3>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    default: return (int)cudaErrorInvalidValue;
  }
}

static bool bits_ok(int bits) { return bits == 2 || bits == 3 || bits == 4 || bits == 8; }

// The tile bf16_tile picks for M rows and N columns, at `bits`.
template <bool DEQ, int KMAX>
static int launch_bf16_tile_bits(const void* x, const void* packed, const void* scale,
                                 const void* bias, const void* out_bias, void* out, int M, int K,
                                 int N, int bits, int bs, int out_f32, cudaStream_t st) {
  const int tile = bf16_tile(M, N);
#define MNN_BF_CASE(t, MT, NT, WM, WN)                                                     \
  if (tile == t)                                                                          \
    return with_bits(bits, [&](auto b) {                                                  \
      return (int)launch_bf16_tile<decltype(b)::value, MT, NT, WM, WN, DEQ, KMAX>(        \
          x, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, st);               \
    });
  MNN_BF_TILES(MNN_BF_CASE)
#undef MNN_BF_CASE
  return (int)cudaErrorInvalidValue;
}

// The tile a8_tile picks for M rows and N columns, at `bits`.
template <int KMAX>
static int launch_a8_bits(const void* xq, const void* xscale, const void* packed,
                          const void* scale, const void* bias, const void* out_bias, void* out,
                          int M, int K, int N, int bits, int bs, int out_f32, cudaStream_t st) {
  const int tile = a8_tile(M, N);
#define MNN_A8_CASE(t, MT, NT, WM, WN)                                                     \
  if (tile == t)                                                                          \
    return with_bits(bits, [&](auto b) {                                                  \
      return (int)launch_a8<decltype(b)::value, MT, NT, WM, WN, KMAX>(                    \
          xq, xscale, packed, scale, bias, out_bias, out, M, K, N, bs, out_f32, st);      \
    });
  MNN_A8_TILES(MNN_A8_CASE)
#undef MNN_A8_CASE
  return (int)cudaErrorInvalidValue;
}

// The KMAX = 256 launches (dequant_matmul_k256.cu): blocks of 136 to 256.
int launch_bf16_tile_k256(bool deq, const void* x, const void* packed, const void* scale,
                          const void* bias, const void* out_bias, void* out, int M, int K, int N,
                          int bits, int bs, int out_f32, cudaStream_t st);
int launch_a8_k256(const void* xq, const void* xscale, const void* packed, const void* scale,
                   const void* bias, const void* out_bias, void* out, int M, int K, int N,
                   int bits, int bs, int out_f32, cudaStream_t st);

}  // namespace mnn
