// The fused expert decode kernel's step stamps (moe_decode.cu), built only
// with -DMNN_MD_CLOCKS; the served build carries none of it.
//
// Thread 0 of a block logs clock64() at the steps of each item it takes
// into its row of md_clock_log: entry 0 the count, then one event each,
// tag << 56 | kind << 52 | aux << 40 | the clock's low 40 bits (MD_EV_START
// carries the SM's id as aux). A block's clock is its SM's, so only
// differences within a row mean anything. `mnn_moe_decode_clocks` copies
// the log to the host and zeroes it (`profile_a8 --kernel mdec --clocks`
// reads it).
#pragma once

#include <cuda_runtime.h>

namespace mnn {

enum { MD_EV_START, MD_EV_ITEM, MD_EV_WEIGHTS, MD_EV_WAITED, MD_EV_X, MD_EV_PRODUCTS,
       MD_EV_PUBLISHED, MD_EV_MERGED, MD_EV_DONE, MD_EV_EXIT,
       // an item's cycles in waits, in place of a clock: the consumers' (thread
       // 0's) for full ring slots, the producer's for free ones (its own row)
       MD_EV_FULL_WAIT, MD_EV_EMPTY_WAIT };
// item kinds: routed gate/up, shared gate/up, routed down, shared down (an
// epilogue's stamps carry the kind + 4)
enum { MD_K_GU_R, MD_K_GU_S, MD_K_DN_R, MD_K_DN_S };

#ifdef MNN_MD_CLOCKS
constexpr int MD_EV_MAX = 256, MD_CLK_ROWS = 4096;
constexpr int MD_CLK_ROW2 = 2048;   // the producer warps' rows
__device__ long long md_clock_log[MD_CLK_ROWS * MD_EV_MAX];

// one event into `row`, by the one thread that logs there
__device__ __forceinline__ void md_log(int row, int tag, int kind, int aux, long long value) {
  if (row >= MD_CLK_ROWS) return;
  long long* r = md_clock_log + (long)row * MD_EV_MAX;
  const int n = (int)r[0];
  if (n >= MD_EV_MAX - 1) return;
  r[n + 1] = ((long long)tag << 56) | ((long long)(kind & 0xF) << 52) |
             ((long long)(aux & 0xFFF) << 40) | (value & 0xFFFFFFFFFFLL);
  r[0] = n + 1;
}

__device__ __forceinline__ void md_ev(int row, int tag, int kind, int aux) {
  if (threadIdx.x == 0) md_log(row, tag, kind, aux, clock64());
}

__device__ __forceinline__ unsigned md_smid() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;\n" : "=r"(s));
  return s;
}

// rows * MD_EV_MAX int64 of the log into host memory `out`, then the log to zero
inline int md_clocks_read(long long* out, int rows) {
  if (rows < 0 || rows > MD_CLK_ROWS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && rows)
    e = cudaMemcpyFromSymbol(out, md_clock_log, sizeof(long long) * rows * MD_EV_MAX);
  void* at = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&at, md_clock_log);
  if (e == cudaSuccess) e = cudaMemset(at, 0, sizeof(long long) * MD_CLK_ROWS * MD_EV_MAX);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}
#define MD_EV(row, tag, kind, aux) md_ev(row, tag, kind, aux)
// `stmt`, its cycles added to `acc`
#define MD_TIMED(acc, stmt)         \
  do {                              \
    const long long md_t0 = clock64(); \
    stmt;                           \
    acc += clock64() - md_t0;       \
  } while (0)
#else
#define MD_EV(row, tag, kind, aux) \
  do {                             \
  } while (0)
#define MD_TIMED(acc, stmt) stmt
#endif

}  // namespace mnn
