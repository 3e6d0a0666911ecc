// Softshrink, the plugin example kernel: y = sign(x) * max(|x| - lam, 0),
// elementwise, in x's dtype (f32 or bf16).
//
// Replaces the Pallas kernel of the plugin example, `tests/test_plugin.py`
// `_softshrink_kernel` (`docs/plugins.md`, "Backing an op with a Pallas
// kernel"): no kernel of the serving path, but the one a user registers for
// an ONNX op the frontend does not know (`plugin.register_op`).
//
// Rounding points, as JAX's: lam arrives as x's dtype (the wrapper rounds it
// to bf16 for bf16 x: JAX's weak-typed Python scalar takes the array's
// dtype), |x| - lam is rounded to x's dtype, the max with 0 keeps a NaN, and
// sign(x) * m is exact, with jnp.sign's signed zero: copysign(m, x). f32
// arithmetic on every element, bf16 rounded once per op.
//
// What bounds it on the H100: bytes, one read and one write of each element
// (4 operations an element). So each thread moves 16 bytes a load and a store
// (float4, or eight bf16 in a uint4) in a grid-stride loop over the aligned
// body; the ragged tail, and a pointer off 16 bytes, take a scalar loop.
#include "common.cuh"

namespace {

using mnn::bf16;

__device__ __forceinline__ float shrink(float x, float lam, bool is_bf16) {
  float d = fabsf(x) - lam;
  if (is_bf16) d = mnn::round_bf16(d);
  float m = d < 0.f ? 0.f : d;                    // max(d, 0), NaN kept
  return copysignf(m, x);
}

__global__ void softshrink_f32_kernel(const float* __restrict__ x, float* __restrict__ y,
                                      long long n, float lam, int vec_ok) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long body = vec_ok ? (n / 4) * 4 : 0;
  for (long long v = i; v < body / 4; v += stride) {
    float4 a = reinterpret_cast<const float4*>(x)[v];
    a.x = shrink(a.x, lam, false);
    a.y = shrink(a.y, lam, false);
    a.z = shrink(a.z, lam, false);
    a.w = shrink(a.w, lam, false);
    reinterpret_cast<float4*>(y)[v] = a;
  }
  for (long long j = body + i; j < n; j += stride) y[j] = shrink(x[j], lam, false);
}

__global__ void softshrink_bf16_kernel(const bf16* __restrict__ x, bf16* __restrict__ y,
                                       long long n, float lam, int vec_ok) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long body = vec_ok ? (n / 8) * 8 : 0;
  for (long long v = i; v < body / 8; v += stride) {
    uint4 a = reinterpret_cast<const uint4*>(x)[v];
    bf16* e = reinterpret_cast<bf16*>(&a);
#pragma unroll
    for (int k = 0; k < 8; ++k)
      e[k] = __float2bfloat16_rn(shrink(__bfloat162float(e[k]), lam, true));
    reinterpret_cast<uint4*>(y)[v] = a;
  }
  for (long long j = body + i; j < n; j += stride)
    y[j] = __float2bfloat16_rn(shrink(__bfloat162float(x[j]), lam, true));
}

}  // namespace

// dtype: 0 f32, 1 bf16. lam already rounded to x's dtype by the caller.
MNN_API int mnn_softshrink(const void* x, void* y, long long n, float lam, int dtype,
                           cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int per_thread = dtype ? 8 : 4;
  long long want = (n / per_thread + threads - 1) / threads;
  int blocks = (int)(want < 1 ? 1 : (want > 132 * 16 ? 132 * 16 : want));
  int vec_ok = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  if (dtype)
    softshrink_bf16_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const bf16*>(x), static_cast<bf16*>(y), n, lam, vec_ok);
  else
    softshrink_f32_kernel<<<blocks, threads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<float*>(y), n, lam, vec_ok);
  return (int)cudaGetLastError();
}
