// The bf16 tensor-core tile body (sm_90a) shared by three kernels: the
// bf16-row matmul at M > 1 and the dequantize-tile matmul (dequant_matmul.cu),
// and both products of the grouped mixture-of-experts prefill kernel
// (moe_prefill.cu). It computes one BM x BN tile of x[M, K] (bf16) @
// dequant(W)[K, N] over the whole of K and leaves it in registers for the
// caller's epilogue.
//
// Per quant block kb (bs K-values, packed W4 nibble pairs (i, i + bs/2), W8
// bytes, W2 four 2-bit groups (i + m bs/4) or W3 a 2-bit plane of bs/4 rows
// and a 1-bit plane of bs/8 rows; bf16 scale s and bias m per column), one
// of three algebras:
//   ALG_ROWS     part = x_b . q_b;  acc = (acc + part * s) + rs * m
//   ALG_PARTIAL  part = x_b . q_b;  acc = acc + (part * s + rs * m)
//   ALG_DEQUANT  wd = bf16(q * s + m);  acc += x_b . wd
// with rs = rowsum(x_b). ALG_ROWS is the order of dequant_matmul_plain,
// ALG_PARTIAL and ALG_DEQUANT those of deq_dot_plain (the counterparts of
// mnn_tpu/kernels/moe_prefill.py::_deq_dot and of the body of
// mnn_tpu/kernels/dequant_matmul.py::_kernel_deq), all f32 without FMA
// contraction. Every product is bf16 x bf16 -> f32 on `mma.sync.m16n8k16`:
// the pattern q < 256 is exact in bf16.
//
// The design, which takes the serial steps off each quant block:
//  * a ring of A8_STAGES quant blocks in shared memory filled by `cp.async`
//    (packed rows as they lie in memory, the x rows, the scale and bias
//    rows), so the copies run ahead of the math; each thread's copy
//    addresses are fixed but for the block's offset;
//  * the packed tile unpacked once per tile and block into bf16 K-rows (a
//    thread: 8 or 16 columns of one packed row; W4's low nibbles to row i,
//    high ones to row i + bs/2; a W2 or W3 2-bit row i to rows i + m bs/4,
//    W3's bits of the 1-bit plane joined in first, q = lo + 4 hi, so that
//    the dequantize algebra rounds q * s + m on the whole code, as the
//    JAX kernel does), the raw pattern for the two partial
//    algebras (W4 as bf16(128 + q) - 128 from a mask and one bf16x2
//    subtraction), the rounded weight for the dequantize one, with the
//    block's scale and bias read from the ring stage;
//  * B fragments by ldmatrix.x4.trans, two n8 tiles at a time, A by
//    ldmatrix.x4 from x rows padded to 272 bytes (both conflict-free);
//  * the partial algebras' row sums as one more product with a B of ones,
//    so no pass and no barrier of their own; the f32 step on the fragment;
//  * the dequantize algebra accumulates straight into acc;
//  * two barriers a quant block (the stage has landed, the unpacked tile is
//    complete), or, for the new algebras where a second unpacked buffer
//    costs no resident block, one: block kb + 1 is unpacked while block
//    kb's products run (Bf16Tile::pipe).
// Quant blocks of fewer than 16 K-values are padded with zero K-values of x
// and of the pattern. Rows past M are zero in shared memory. What holds it
// on the H100 (clock64 stamps, PERF.md): the unpack and the ldmatrix
// traffic of shared memory, each a few thousand cycles a quant block.
//
// Quant blocks of 136 to 256 K-values take a second build of the body
// (KMAX = 256): a ring stage holds the whole block (its packed rows
// interleave across it), and the block is unpacked in two chunks of K-rows,
// 0..127 and 128..bs-1, into the same [BF_KMAX][BN] buffer. The partial
// algebras' product and row sum run on across both chunks and take the f32
// step once per quant block, as the JAX kernel does; the chunks are steps of
// the schedules above (two more barriers a block with one buffer; with two,
// chunk 0 then chunk 1 of block kb, each unpacked under the other's
// products). Three ring stages where they fit in a block's shared memory,
// else two. Blocks of up to 128 keep the first build: the same stages,
// tiles and code.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace mnn {

constexpr int A8_STAGES = 3;    // quant blocks in flight in the copy ring
constexpr int SMEM_BLOCK_MAX = 232448;   // dynamic shared memory a block may take

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The A fragment of m16n8k16 / m16n8k32 (rows gid and gid + 8, two 8-value
// K halves) is what ldmatrix.x4 of 8 x 8 b16 matrices gives each lane.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], unsigned smem_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(smem_addr));
}

// B fragments of m16n8k16 for two n8 tiles from K-rows of bf16 in shared
// memory: lanes 0-15 address K rows 0-15 of the first tile, lanes 16-31 the
// same rows of the second; .trans hands each lane the K-pair of its column.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], unsigned smem_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr));
}

// The same for one n8 tile: lanes 0-15 address its K rows 0-15.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&b)[2], unsigned smem_addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(smem_addr));
}

// Copy W (16, 8 or 4) bytes from device to shared memory without waiting;
// when `valid` is false nothing is read and the destination is zeroed.
template <int W>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = smem_u32(dst);
  const int n = valid ? W : 0;
  if constexpr (W == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(W),
                 "r"(n)
                 : "memory");
}

// f(std::integral_constant<int, w>()) for a copy width w of 16, 8 or 4, so a
// loop of copies is compiled once per width and chosen once.
template <class F>
__device__ __forceinline__ void with_width(int w, F&& f) {
  if (w == 16)
    f(std::integral_constant<int, 16>());
  else if (w == 8)
    f(std::integral_constant<int, 8>());
  else
    f(std::integral_constant<int, 4>());
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// The widest of 16, 8 and 4 bytes that divides every address and stride in `a`.
inline int copy_width(uintptr_t a) { return a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4; }

// The card's streaming multiprocessors, read once.
inline int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// One thread's share of filling a ring stage with quant block kb, the same
// for every block but for its offset: a column piece of every w_step-th
// packed row, of every x_step-th row of x, and at most one piece of the
// scale or bias row. A stage (STAGES of them) is [packed rows of the
// largest block][BN] bytes, then [BM][XSTR] bytes of x (E bytes a K-value, XROW bytes for the
// largest block; rows K values apart from row m0 on, M rows in all), then
// the block's scale and bias rows of BN bf16 each. vx, vw, vp: the bytes
// per copy of x, of the packed rows and of the scale/bias rows (16, 8 or 4,
// as their alignment allows).
template <int E, int XROW, int XSTR, int BM, int BN, int THREADS, int W_BYTES, int X_BYTES,
          int STAGE, int STAGES = A8_STAGES>
struct Ring {
  int w_r0, w_c, w_step, x_r0, x_c, x_step, p_plane, p_c, vx, vw, vp;
  bool w_ok, p_ok;
  const unsigned char* p_src;

  __device__ __forceinline__ Ring(int tid, int n0, int N, const bf16* scale, const bf16* bias,
                                  int vx_, int vw_, int vp_)
      : vx(vx_), vw(vw_), vp(vp_) {
    const int wc = BN / vw, xcs = XROW / vx, pc = 2 * BN / vp;
    w_r0 = tid / wc;
    w_c = (tid - w_r0 * wc) * vw;
    w_step = THREADS / wc;
    w_ok = n0 + w_c < N;
    x_r0 = tid / xcs;
    x_c = (tid - x_r0 * xcs) * vx;
    x_step = THREADS / xcs;
    p_plane = tid / pc;
    p_c = (tid - p_plane * pc) * vp;
    p_ok = p_plane < 2 && n0 + p_c / 2 < N;
    p_src = reinterpret_cast<const unsigned char*>((p_plane ? bias : scale) + n0) + p_c;
  }

  // x rows are padded with zeros from `from` to `to` bytes in every stage;
  // the copies never write there, and a zero adds nothing to any product
  __device__ __forceinline__ static void zero_pad(unsigned char* smem, int from, int to, int tid) {
    const int pad = (to - from) >> 3;
    for (int i = tid; i < STAGES * BM * pad; i += THREADS) {
      const int s = i / (BM * pad), r = (i / pad) % BM, j = i % pad;
      *reinterpret_cast<uint2*>(smem + s * STAGE + W_BYTES + r * XSTR + from + 8 * j) =
          make_uint2(0u, 0u);
    }
  }

  // stage quant block kb: packed rows as they lie in memory, x, scale, bias
  __device__ __forceinline__ void load(unsigned char* st, int kb, const uint8_t* packed,
                                       int rows_w, const unsigned char* x, int m0, int M, int K,
                                       int bs, int N, int n0) const {
    with_width(vw, [&](auto w) {
      const uint8_t* ws = packed + ((long)kb * rows_w + w_r0) * N + n0 + w_c;
      for (int r = w_r0; r < rows_w; r += w_step, ws += (long)w_step * N)
        cp_async<decltype(w)::value>(st + r * BN + w_c, w_ok ? ws : packed, w_ok);
    });
    if (x_c < bs * E)
      with_width(vx, [&](auto w) {
        const unsigned char* xsrc = x + ((long)(m0 + x_r0) * K + (long)kb * bs) * E + x_c;
        for (int r = x_r0; r < BM; r += x_step, xsrc += (long)x_step * K * E)
          cp_async<decltype(w)::value>(st + W_BYTES + r * XSTR + x_c, m0 + r < M ? xsrc : x,
                                       m0 + r < M);
      });
    if (p_plane < 2)
      with_width(vp, [&](auto w) {
        cp_async<decltype(w)::value>(st + W_BYTES + X_BYTES + p_plane * 2 * BN + p_c,
                                     p_ok ? p_src + (long)kb * N * 2 : packed, p_ok);
      });
  }
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

// Two 16-bit integers 0..15 in the low nibbles of t's halves, as two bf16,
// exactly: 0x4300 | q is bf16(128 + q), and 128 is taken off in bf16x2.
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t t) {
  const uint32_t v = (t & 0x000F000Fu) | 0x43004300u, c = 0x43004300u;
  const __nv_bfloat162 r = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v),
                                   *reinterpret_cast<const __nv_bfloat162*>(&c));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Two integers q < 256 in t's halves and the bf16 pairs of their columns'
// scale s2 and bias m2 -> bf16(q * s + m) each, rounded as the plain
// version rounds: f32 product, f32 sum, then bf16.
__device__ __forceinline__ uint32_t dequant_bf16x2(uint32_t t, uint32_t s2, uint32_t m2) {
  const float s0 = __uint_as_float(s2 << 16), s1 = __uint_as_float(s2 & 0xFFFF0000u);
  const float b0 = __uint_as_float(m2 << 16), b1 = __uint_as_float(m2 & 0xFFFF0000u);
  return pack_bf16(__fadd_rn(__fmul_rn(u2f(t & 0xFFFFu), s0), b0),
                   __fadd_rn(__fmul_rn(u2f(t >> 16), s1), b1));
}

constexpr int BF_KMAX = 128;    // K-rows of the unpacked buffer: a chunk of a quant block
constexpr int BLOCK_MAX = 2 * BF_KMAX;   // the largest quant block (the KMAX = 256 build)

constexpr int ALG_ROWS = 0, ALG_PARTIAL = 1, ALG_DEQUANT = 2;

// Where a second unpacked buffer costs no resident block (by shared memory
// and threads), the two new algebras unpack block kb + 1 into it while the
// tensor cores take block kb, with one barrier a quant block; elsewhere the
// block it would cost hides more (measured, PERF.md). ALG_ROWS keeps one
// buffer and two barriers. -DMNN_DD_PIPE=0 never pipelines (profiling).
#ifndef MNN_DD_PIPE
#define MNN_DD_PIPE 1
#endif

// Blocks of `threads` threads and `smem` bytes of dynamic shared memory
// that one SM holds (228 KB of shared memory, 1 KB of it reserved a block;
// 2048 threads), registers aside.
__host__ __device__ constexpr int sm_blocks(int smem, int threads) {
  return 233472 / (smem + 1024) < 2048 / threads ? 233472 / (smem + 1024) : 2048 / threads;
}

// Shared memory of one tile shape for quant blocks of up to KMAX (128 or
// 256) K-values: STAGES stages of [raw packed rows of one quant block][BN]
// bytes, [BM][XSTR] bytes of x and the block's scale and bias rows, then
// the unpacked chunk (two in turn where pipe(alg)) as [BF_KMAX][BN] bf16,
// one K-value a row (rows BTS bytes apart, an odd multiple of 16, so
// ldmatrix.trans is conflict-free). MT x NT m16n8 tiles a warp, WM x WN
// warps. Three stages, or two where three do not fit in a block.
template <int BITS, int MT, int NT, int WM, int WN, int KMAX = BF_KMAX>
struct Bf16Tile {
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8, THREADS = 32 * WM * WN;
  static constexpr int CHUNKS = KMAX / BF_KMAX;
  static constexpr int XSTR = 2 * KMAX + 16;   // bytes per staged x row: 272 or 528, conflict-free
  static constexpr int W_BYTES = KMAX * BITS / 8 * BN;
  static constexpr int X_BYTES = BM * XSTR;
  static constexpr int STAGE = W_BYTES + X_BYTES + 2 * BN * 2;
  static constexpr int BTS = BN == 8 ? 16 : 2 * BN + 16;
  static constexpr int BT_BYTES = BF_KMAX * BTS;
  static constexpr int STAGES = 3 * STAGE + BT_BYTES <= SMEM_BLOCK_MAX ? 3 : 2;
  static constexpr int SMEM = STAGES * STAGE + BT_BYTES;   // one unpacked buffer
  __host__ __device__ static constexpr bool pipe(int alg) {
    return alg != ALG_ROWS && MNN_DD_PIPE &&
           sm_blocks(SMEM + BT_BYTES, THREADS) >= sm_blocks(SMEM, THREADS);
  }
  __host__ __device__ static constexpr int smem(int alg) {
    return SMEM + (pipe(alg) ? BT_BYTES : 0);
  }
};

// Built with -DMNN_DD_CLOCKS, thread 0 of block (0, 0, 0) adds up the
// cycles (clock64) of each step of its quant blocks: slot 0 waiting for the
// stage and the barrier, 1 the unpack, 2 the second barrier (one-buffer
// schedule only), 3 the products and the f32 step; slot 4 the blocks, 5 the
// whole K loop. dd_clocks_read (a C entry of each source) reads them back.
#ifdef MNN_DD_CLOCKS
static __device__ long long dd_clocks[8];
#define MNN_DD_STAMP(slot)                                                    \
  if (clk) {                                                                  \
    const long long now = clock64();                                          \
    dd_clocks[slot] += now - clk_last;                                        \
    clk_last = now;                                                           \
  }
#else
#define MNN_DD_STAMP(slot)
#endif

// The W2/W3 unpack of tile_body: quant block kb's packed rows in its ring
// stage `st` (BN bytes a row; scale and bias rows at sp) into bf16 K-rows at
// bt (BTS bytes apart). A thread takes IB columns of one 2-bit row i and
// writes K rows i + m bs/4, m = 0..3, from bit pair 2m; at W3 it first joins
// the 1-bit plane's bit, row bs/4 + i % (bs/8), bit i / (bs/8) + 2m, into
// q = lo + 4 hi < 8. The dequantize algebra writes bf16(q * s + m), the
// others q. With CHUNKS > 1 only the K rows of the chunk from K0 on are
// written, at row k - K0.
template <int BITS, int ALG, int IB, int BN, int BTS, int THREADS, int CHUNKS, int K0>
__device__ __forceinline__ void unpack_sub4(const unsigned char* st, const bf16* sp,
                                            unsigned char* bt, int bs, int tid) {
  constexpr int CQ = BN / IB, IW = IB / 4;
  const int q4 = bs >> 2, e8 = bs >> 3;
  for (int u = tid; u < q4 * CQ; u += THREADS) {
    const int i = u / CQ, c = u - i * CQ;
    uint32_t w[IW], hw[IW], s2[2 * IW], m2[2 * IW];
    auto words = [&](int row, uint32_t (&to)[IW]) {
      if constexpr (IW == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + row * BN + IB * c);
        to[0] = v.x, to[1] = v.y, to[2] = v.z, to[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(st + row * BN + IB * c);
        to[0] = v.x, to[1] = v.y;
      }
    };
    words(i, w);
    int sh = 0;
    if constexpr (BITS == 3) {
      words(q4 + i % e8, hw);
      sh = i / e8;
    }
    if constexpr (ALG == ALG_DEQUANT) {   // the columns' scales and biases as bf16 pairs
#pragma unroll
      for (int q = 0; q < IW / 2; ++q) {
        const uint4 sv = reinterpret_cast<const uint4*>(sp + IB * c)[q];
        const uint4 mv = reinterpret_cast<const uint4*>(sp + BN + IB * c)[q];
        s2[4 * q] = sv.x, s2[4 * q + 1] = sv.y, s2[4 * q + 2] = sv.z, s2[4 * q + 3] = sv.w;
        m2[4 * q] = mv.x, m2[4 * q + 1] = mv.y, m2[4 * q + 2] = mv.z, m2[4 * q + 3] = mv.w;
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int row = i + m * q4 - K0;   // the K row in the chunk
      if (CHUNKS > 1 && (unsigned)row >= (unsigned)BF_KMAX) continue;
      uint32_t out[2 * IW];
#pragma unroll
      for (int j = 0; j < IW; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          // bytes 2 hf and 2 hf + 1 of the word as 16-bit halves: two columns
          const uint32_t sel = hf ? 0x4342u : 0x4140u;
          uint32_t q = (__byte_perm(w[j], 0u, sel) >> (2 * m)) & 0x00030003u;
          if constexpr (BITS == 3)
            q |= ((__byte_perm(hw[j], 0u, sel) >> (2 * m + sh)) & 0x00010001u) << 2;
          if constexpr (ALG == ALG_DEQUANT)
            out[2 * j + hf] = dequant_bf16x2(q, s2[2 * j + hf], m2[2 * j + hf]);
          else
            out[2 * j + hf] = nibbles_bf16x2(q);
        }
      uint4* d = reinterpret_cast<uint4*>(bt + row * BTS + 2 * IB * c);
#pragma unroll
      for (int q = 0; q < IW / 2; ++q)
        d[q] = make_uint4(out[4 * q], out[4 * q + 1], out[4 * q + 2], out[4 * q + 3]);
    }
  }
}

// acc[mt][nt][2 h + j] = (x @ dequant(W))[m0 + row_w + 16 mt + gid + 8 h,
// n0 + col_w + 8 nt + 2 tig + j] in algebra ALG (the layout of the m16n8
// accumulator; row_w = (warp / WN) * 16 MT, col_w = (warp % WN) * 8 NT).
// x: M rows of K bf16 (16-byte copies need a 16-byte aligned x);
// packed/scale/bias: one weight matrix [K * BITS / 8, N], [K / bs, N];
// bs <= KMAX (above BF_KMAX when KMAX is 256), a multiple of 8 (16 for
// ALG_DEQUANT), dividing K; N a multiple of 4. smem: Bf16Tile::smem(ALG)
// bytes. vx, vw, vp: the bytes per asynchronous copy of x, of the packed
// rows and of the scale/bias rows.
// Ends with every warp still possibly reading the last ring stage: a caller
// that reuses the shared memory synchronizes first.
template <int BITS, int MT, int NT, int WM, int WN, int ALG, int KMAX = BF_KMAX>
__device__ __forceinline__ void tile_body(unsigned char* smem, const bf16* __restrict__ x, int m0,
                                          int M, int K, const uint8_t* __restrict__ packed,
                                          const bf16* __restrict__ scale,
                                          const bf16* __restrict__ bias, int N, int bs, int n0,
                                          int vx, int vw, int vp, float (&acc)[MT][NT][4]) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN, KMAX>;
  constexpr int BN = T::BN, BTS = T::BTS, THREADS = T::THREADS, STAGES = T::STAGES;
  constexpr int NC = T::CHUNKS;
  static_assert(NC == 1 || NC == 2, "blocks of up to 256 K-values: one or two chunks");
  constexpr bool PIPE = T::pipe(ALG);
  unsigned char* bt0 = smem + STAGES * T::STAGE;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tig = lane & 3;
  const int row_w = (warp / WN) * MT * 16, col_w = (warp % WN) * NT * 8;
  const int nb = K / bs, kp = (bs + 15) & ~15;   // K-values per block, padded to the mma depth
  const int rows_w = bs * BITS / 8;              // packed rows per quant block
  // the last chunk's K-values and their count padded to the mma depth
  const int kl = bs - (NC - 1) * BF_KMAX, kpl = kp - (NC - 1) * BF_KMAX;

  using R = Ring<2, 2 * KMAX, T::XSTR, T::BM, BN, THREADS, T::W_BYTES, T::X_BYTES, T::STAGE,
                 STAGES>;
  R::zero_pad(smem, 2 * bs, 2 * kp, tid);
  // the pattern's rows from kl to kpl are zeros too: a zero x times stale
  // shared memory could be NaN (with one buffer and two chunks, chunk 0
  // leaves finite values there)
  for (int b = 0; b < (PIPE ? 2 : 1); ++b)
    for (int i = tid; i < (kpl - kl) * BTS / 16; i += THREADS)
      reinterpret_cast<uint4*>(bt0 + b * T::BT_BYTES + kl * BTS)[i] = make_uint4(0u, 0u, 0u, 0u);
  const R ring(tid, n0, N, scale, bias, vx, vw, vp);
  auto load = [&](int kb) {
    if (kb < nb)
      ring.load(smem + (kb % STAGES) * T::STAGE, kb, packed, rows_w,
                reinterpret_cast<const unsigned char*>(x), m0, M, K, bs, N, n0);
    cp_async_commit();   // an empty group past the last block keeps the count
  };

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  // ldmatrix row addresses. A: lanes 0-15 rows 0-15 of an m16 tile at K
  // values 0-7, lanes 16-31 the same rows at 8-15. B (.trans): lanes 0-15 K
  // rows 0-15 of the first n8 tile of a pair, lanes 16-31 of the second.
  const unsigned xr0 =
      smem_u32(smem + T::W_BYTES + (row_w + (lane & 15)) * T::XSTR + (lane >> 4) * 16);
  const unsigned br0 = smem_u32(bt0 + (lane & 15) * BTS + (col_w + 8 * (lane >> 4)) * 2);

  // Unpack chunk ch (K-values k0 = 128 ch on) of quant block kb from its
  // ring stage into the buffer at bt, once per tile: a thread takes IB
  // columns of one packed row and writes them as bf16 K-rows: W4 the low
  // nibbles to row i and the high ones to row i + bs/2 (the pairing of the
  // packed layout), W8 the bytes to row i, each less k0 and where it falls
  // in the chunk. The dequantize algebra writes bf16(q * s + m) with the
  // columns' scale and bias from the stage, the others the pattern q. IB = 8
  // (the new algebras, and tiles 8 wide): eight threads store 128
  // consecutive bytes, free of bank conflicts; ALG_ROWS keeps its 16.
  auto unpack = [&](int kb, auto ch, unsigned char* bt) {
    const unsigned char* st = smem + (kb % STAGES) * T::STAGE;
    const bf16* sp = reinterpret_cast<const bf16*>(st + T::W_BYTES + T::X_BYTES);
    constexpr int IB = BN < 16 || ALG != ALG_ROWS ? 8 : 16, CQ = BN / IB, IW = IB / 4;
    constexpr int k0 = decltype(ch)::value * BF_KMAX;
    if constexpr (BITS < 4) {
      unpack_sub4<BITS, ALG, IB, BN, BTS, THREADS, NC, k0>(st, sp, bt, bs, tid);
      return;
    }
    // the packed rows with a K-value in the chunk: W8's rows k0.., W4's
    // rows whose low (i) or high (i + bs/2) K-value is there
    int i0 = 0, i1 = rows_w;
    if constexpr (NC > 1) {
      i0 = BITS == 8 ? k0 : max(0, k0 - rows_w);
      i1 = min(rows_w, k0 + BF_KMAX);
    }
    for (int u = tid + i0 * CQ; u < i1 * CQ; u += THREADS) {
      const int i = u / CQ, c = u - i * CQ;
      uint32_t w[IW], s2[2 * IW], m2[2 * IW];
      if constexpr (IW == 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(st + i * BN + IB * c);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      } else {
        const uint2 v = *reinterpret_cast<const uint2*>(st + i * BN + IB * c);
        w[0] = v.x, w[1] = v.y;
      }
      if constexpr (ALG == ALG_DEQUANT) {   // the columns' scales and biases as bf16 pairs
#pragma unroll
        for (int q = 0; q < IW / 2; ++q) {
          const uint4 sv = reinterpret_cast<const uint4*>(sp + IB * c)[q];
          const uint4 mv = reinterpret_cast<const uint4*>(sp + BN + IB * c)[q];
          s2[4 * q] = sv.x, s2[4 * q + 1] = sv.y, s2[4 * q + 2] = sv.z, s2[4 * q + 3] = sv.w;
          m2[4 * q] = mv.x, m2[4 * q + 1] = mv.y, m2[4 * q + 2] = mv.z, m2[4 * q + 3] = mv.w;
        }
      }
      uint32_t lo[2 * IW], hi[2 * IW];
#pragma unroll
      for (int j = 0; j < IW; ++j) {
        // bytes 0, 1 and 2, 3 of the word as 16-bit halves: two columns each
        const uint32_t t0 = __byte_perm(w[j], 0u, 0x4140), t1 = __byte_perm(w[j], 0u, 0x4342);
        if constexpr (ALG == ALG_DEQUANT) {
          constexpr uint32_t MASK = BITS == 4 ? 0x000F000Fu : 0x00FF00FFu;
          lo[2 * j] = dequant_bf16x2(t0 & MASK, s2[2 * j], m2[2 * j]);
          lo[2 * j + 1] = dequant_bf16x2(t1 & MASK, s2[2 * j + 1], m2[2 * j + 1]);
          if (BITS == 4) {
            hi[2 * j] = dequant_bf16x2((t0 >> 4) & MASK, s2[2 * j], m2[2 * j]);
            hi[2 * j + 1] = dequant_bf16x2((t1 >> 4) & MASK, s2[2 * j + 1], m2[2 * j + 1]);
          }
        } else if (BITS == 4) {
          lo[2 * j] = nibbles_bf16x2(t0);
          lo[2 * j + 1] = nibbles_bf16x2(t1);
          hi[2 * j] = nibbles_bf16x2(t0 >> 4);
          hi[2 * j + 1] = nibbles_bf16x2(t1 >> 4);
        } else {
          lo[2 * j] = pack_bf16(u2f(t0 & 0xFFFFu), u2f(t0 >> 16));
          lo[2 * j + 1] = pack_bf16(u2f(t1 & 0xFFFFu), u2f(t1 >> 16));
        }
      }
      uint4* d = reinterpret_cast<uint4*>(bt + (i - k0) * BTS + 2 * IB * c);
      if (NC == 1 || (unsigned)(i - k0) < (unsigned)BF_KMAX)
#pragma unroll
        for (int q = 0; q < IW / 2; ++q)
          d[q] = make_uint4(lo[4 * q], lo[4 * q + 1], lo[4 * q + 2], lo[4 * q + 3]);
      if (BITS == 4 && (NC == 1 || (unsigned)(i + (bs >> 1) - k0) < (unsigned)BF_KMAX)) {
        d = reinterpret_cast<uint4*>(bt + (i + (bs >> 1) - k0) * BTS + 2 * IB * c);
#pragma unroll
        for (int q = 0; q < IW / 2; ++q)
          d[q] = make_uint4(hi[4 * q], hi[4 * q + 1], hi[4 * q + 2], hi[4 * q + 3]);
      }
    }
  };

  // The products of quant block kb: x rows from its stage, the pattern or
  // weights from the unpacked buffer at br (this lane's ldmatrix address),
  // then, for the partial algebras, the block's f32 step. With two chunks a
  // block, chunk 0's products, then between() (the barrier and the unpack
  // that make chunk 1 ready, in the buffer at br1), then chunk 1's, all
  // into the same sums. Rows past M are zeros in shared memory: their tiles
  // add nothing, and computing them keeps the loop free of branches.
  auto products = [&](int kb, unsigned br, [[maybe_unused]] unsigned br1,
                      [[maybe_unused]] auto between) {
    const int stage = (kb % STAGES) * T::STAGE;
    unsigned xr = xr0 + stage;
    // every fragment of a K-step of 16, then the products
    auto fragments = [&](int ks, uint32_t (&a)[MT][4], uint32_t (&b)[NT][2]) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t t[4];
        ldmatrix_x4_trans(t, br + ks * 16 * BTS + np * 32);
        b[2 * np][0] = t[0];
        b[2 * np][1] = t[1];
        b[2 * np + 1][0] = t[2];
        b[2 * np + 1][1] = t[3];
      }
      if constexpr (NT % 2) {   // the last n8 tile alone
        uint32_t t[2];
        ldmatrix_x2_trans(t, br + ks * 16 * BTS + (NT / 2) * 32);
        b[NT - 1][0] = t[0];
        b[NT - 1][1] = t[1];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], xr + ks * 32 + mt * 16 * T::XSTR);
    };

    if constexpr (ALG == ALG_DEQUANT) {
#pragma unroll 4
      for (int ks = 0; ks < ((NC == 1 ? kp : BF_KMAX) >> 4); ++ks) {   // chunk 0
        uint32_t a[MT][4], b[NT][2];
        fragments(ks, a, b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
      }
      if constexpr (NC > 1) {
        between();
        br = br1, xr += 2 * BF_KMAX;
#pragma unroll 4
        for (int ks = 0; ks < kpl >> 4; ++ks) {
          uint32_t a[MT][4], b[NT][2];
          fragments(ks, a, b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
        }
      }
    } else {
      const uint32_t ones[2] = {0x3F803F80u, 0x3F803F80u};   // bf16 1.0 pairs
      float part[MT][NT][4], rs[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          rs[mt][i] = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) part[mt][nt][i] = 0.f;
        }
#pragma unroll 4
      for (int ks = 0; ks < ((NC == 1 ? kp : BF_KMAX) >> 4); ++ks) {   // chunk 0
        uint32_t a[MT][4], b[NT][2];
        fragments(ks, a, b);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16_16816(rs[mt], a[mt], ones);   // every column: the row's sum
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(part[mt][nt], a[mt], b[nt]);
        }
      }
      if constexpr (NC > 1) {
        between();
        br = br1, xr += 2 * BF_KMAX;
#pragma unroll 4
        for (int ks = 0; ks < kpl >> 4; ++ks) {
          uint32_t a[MT][4], b[NT][2];
          fragments(ks, a, b);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_bf16_16816(rs[mt], a[mt], ones);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(part[mt][nt], a[mt], b[nt]);
          }
        }
      }

      // the block's f32 step, in the algebra's order
      const bf16* sp = reinterpret_cast<const bf16*>(smem + stage + T::W_BYTES + T::X_BYTES);
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
          const float s = bf2f(j ? sv[nt].y : sv[nt].x), m = bf2f(j ? mv[nt].y : mv[nt].x);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int h = 0; h < 2; ++h) {   // rows gid and gid + 8
              float& a = acc[mt][nt][2 * h + j];
              const float ps = __fmul_rn(part[mt][nt][2 * h + j], s);
              const float rm = __fmul_rn(rs[mt][2 * h], m);
              a = ALG == ALG_ROWS ? __fadd_rn(__fadd_rn(a, ps), rm) : __fadd_rn(a, __fadd_rn(ps, rm));
            }
        }
    }
  };

#ifdef MNN_DD_CLOCKS
  const bool clk = blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0 && tid == 0;
  long long clk_last = clk ? clock64() : 0;
  const long long clk_start = clk_last;
#endif
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  constexpr std::integral_constant<int, 0> C0{};   // the chunks of a block
  constexpr std::integral_constant<int, 1> C1{};
  auto none = [] {};
  if constexpr (PIPE && NC == 1) {
    // block kb + 1 is unpacked into one buffer while block kb's products
    // read the other; the copy of block kb + 2 runs under both
    static_assert(STAGES == 3, "the copy of block kb + 1 lands a block ahead");
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    unpack(0, C0, bt0);
    for (int kb = 0; kb < nb; ++kb) {
      cp_async_wait<0>();
      __syncthreads();   // block kb is unpacked, kb + 1 has landed; every warp is done with kb - 1
      MNN_DD_STAMP(0)
      load(kb + STAGES - 1);
      if (kb + 1 < nb) unpack(kb + 1, C0, bt0 + ((kb + 1) & 1) * T::BT_BYTES);
      MNN_DD_STAMP(1)
      products(kb, br0 + (kb & 1) * T::BT_BYTES, 0u, none);
      MNN_DD_STAMP(3)
    }
  } else if constexpr (PIPE) {
    // two chunks a block: chunk 1 of block kb is unpacked into buffer 1
    // while chunk 0's products read buffer 0, then chunk 0 of block kb + 1
    // into buffer 0 while chunk 1's read buffer 1; the copy of block
    // kb + STAGES - 1 runs under all four
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    unpack(0, C0, bt0);
    for (int kb = 0; kb < nb; ++kb) {
      __syncthreads();   // chunk 0 of block kb is unpacked; every warp is done with kb - 1
      MNN_DD_STAMP(0)
      load(kb + STAGES - 1);
      unpack(kb, C1, bt0 + T::BT_BYTES);
      MNN_DD_STAMP(1)
      products(kb, br0, br0 + T::BT_BYTES, [&] {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // chunk 1 is unpacked, block kb + 1 has landed; chunk 0 is done
        if (kb + 1 < nb) unpack(kb + 1, C0, bt0);
      });
      MNN_DD_STAMP(3)
    }
  } else {
    for (int kb = 0; kb < nb; ++kb) {
      cp_async_wait<STAGES - 2>();
      __syncthreads();   // block kb has landed; every warp is done with kb - 1
      MNN_DD_STAMP(0)
      load(kb + STAGES - 1);
      unpack(kb, C0, bt0);
      MNN_DD_STAMP(1)
      __syncthreads();   // the unpacked block (or its chunk 0) is complete
      MNN_DD_STAMP(2)
      products(kb, br0, br0, [&] {
        __syncthreads();   // every warp is done with chunk 0
        unpack(kb, C1, bt0);
        __syncthreads();   // chunk 1 is complete
      });
      MNN_DD_STAMP(3)
    }
  }
#ifdef MNN_DD_CLOCKS
  if (clk) {
    dd_clocks[4] += nb;
    dd_clocks[5] += clock64() - clk_start;
  }
#endif
}

#ifdef MNN_DD_CLOCKS
// dd_clocks into out[0..7], then zeroed
inline int dd_clocks_read(long long* out) {
  void* dev = nullptr;
  cudaError_t e = cudaMemcpyFromSymbol(out, dd_clocks, sizeof(dd_clocks));
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&dev, dd_clocks);
  if (e == cudaSuccess) e = cudaMemset(dev, 0, sizeof(dd_clocks));
  return (int)e;
}
#endif

}  // namespace mnn
