// Softshrink, the plugin example kernel: y = sign(x) * max(|x| - lam, 0),
// elementwise, in x's dtype (f32 or bf16).
//
// Replaces the Pallas kernel of the plugin example, `tests/test_plugin.py`
// `_softshrink_kernel` (`docs/plugins.md`, "Backing an op with a Pallas
// kernel"): no kernel of the serving path, but the one a user registers for
// an op a frontend does not know (`plugin.register_op`, in the ONNX, TF,
// TFLite or Caffe table).
//
// Rounding points, as JAX's: lam arrives as x's dtype (the wrapper rounds it
// to bf16 for bf16 x: JAX's weak-typed Python scalar takes the array's
// dtype), |x| - lam is rounded to x's dtype, the max with 0 keeps a NaN, and
// sign(x) * m is exact, with jnp.sign's signed zero: copysign(m, x). f32
// arithmetic on every element, bf16 rounded once per op.
//
// What bounds it on the H100: bytes, one read and one write of each element
// (4 operations an element). At [32, 256, 56, 56] bf16 that is 102.8 MB, a
// bound of 30.7 us at 3.35 TB/s; in practice a stream that reads and writes
// as much as it reads reaches about 2.8 TB/s on this card (F.softshrink's
// vectorized loop 36.7 us there). The design: registers only, on a grid that
// covers the tensor, one 16-byte vector a thread. Each thread's load bypasses
// L1 with an evict-first hint (`__ldcs`) and its store streams (`__stcs`);
// the blocks sweep the tensor in launch order, every SM keeping as many
// blocks resident as fit. Timed against it in one run (`profile_a8 --kernel
// softshrink`, PERF.md row 10), and slower, so not kept: 2 and 4 loads a
// thread issued before the arithmetic (within 1 %), 128 to 512 threads a
// block, a persistent grid of the same loop, and a TMA bulk-copy ring (a
// persistent grid of the SM count times the resident blocks, one elected
// thread streaming 16 KB tiles with `cp.async.bulk` into 4 stages = 64 KB of
// shared memory a block, one mbarrier a stage, bulk stores back; 5 % slower
// at [32, 256, 56, 56] bf16, 6 % at f32, with 8 and 32 KB tiles no better).
//
// 16-byte accesses need 16-byte aligned addresses, so the head before x's
// first 16-byte boundary and the ragged tail take a scalar path in the same
// launch; so does everything when x and y sit at different offsets within
// 16 bytes (the wrapper places y at x's offset).
#include "common.cuh"

namespace {

using mnn::bf16;

constexpr int SS_THREADS = 256;

__device__ __forceinline__ float shrink(float x, float lam, bool is_bf16) {
  float d = fabsf(x) - lam;
  if (is_bf16) d = mnn::round_bf16(d);
  float m = d < 0.f ? 0.f : d;                    // max(d, 0), NaN kept
  return copysignf(m, x);
}

template <bool BF16>
__device__ __forceinline__ uint4 shrink16(uint4 a, float lam) {
  if (BF16) {
    bf16* e = reinterpret_cast<bf16*>(&a);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = __float2bfloat16_rn(shrink(__bfloat162float(e[k]), lam, true));
  } else {
    float* e = reinterpret_cast<float*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) e[k] = shrink(e[k], lam, false);
  }
  return a;
}

// The scalar elements: the head [0, head) and the tail [head + body, n),
// spread over every thread of the grid.
template <bool BF16>
__device__ __forceinline__ void scalar_part(const void* x, void* y, long long n, long long head,
                                            long long body, float lam) {
  const long long tail = n - head - body;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x; j < head + tail;
       j += stride) {
    const long long i = j < head ? j : head + body + (j - head);
    if (BF16) {
      static_cast<bf16*>(y)[i] = __float2bfloat16_rn(
          shrink(__bfloat162float(static_cast<const bf16*>(x)[i]), lam, true));
    } else {
      static_cast<float*>(y)[i] = shrink(static_cast<const float*>(x)[i], lam, false);
    }
  }
}

// Thread t of the grid takes vector t of the 16-byte body.
template <bool BF16>
__global__ void __launch_bounds__(SS_THREADS)
softshrink_kernel(const void* x, void* y, long long n, long long head, long long nvec, float lam) {
  const int esz = BF16 ? 2 : 4;
  scalar_part<BF16>(x, y, n, head, nvec * (16 / esz), lam);
  const uint4* xv = reinterpret_cast<const uint4*>(static_cast<const char*>(x) + head * esz);
  uint4* yv = reinterpret_cast<uint4*>(static_cast<char*>(y) + head * esz);
  const long long v = (long long)blockIdx.x * SS_THREADS + threadIdx.x;
  if (v < nvec) __stcs(yv + v, shrink16<BF16>(__ldcs(xv + v), lam));
}

template <bool BF16>
int launch(const void* x, void* y, long long n, float lam, cudaStream_t stream) {
  const int esz = BF16 ? 2 : 4;
  const uintptr_t ox = reinterpret_cast<uintptr_t>(x) & 15, oy = reinterpret_cast<uintptr_t>(y) & 15;
  long long head = n, nvec = 0;                   // everything scalar unless x and y line up
  if (ox == oy && ox % esz == 0) {
    head = (long long)((16 - ox) & 15) / esz;
    if (head > n) head = n;
    nvec = (n - head) * esz / 16;
  }
  const long long scalars = n - nvec * (16 / esz);
  // one thread a vector; the scalar head and tail ride along, and a tensor
  // of scalars alone gets a thread each
  const long long work = nvec > scalars ? nvec : scalars;
  const long long blocks = (work + SS_THREADS - 1) / SS_THREADS;
  softshrink_kernel<BF16><<<(unsigned)blocks, SS_THREADS, 0, stream>>>(x, y, n, head, nvec, lam);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 f32, 1 bf16. lam already rounded to x's dtype by the caller.
MNN_API int mnn_softshrink(const void* x, void* y, long long n, float lam, int dtype,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  return dtype ? launch<true>(x, y, n, lam, stream) : launch<false>(x, y, n, lam, stream);
}
