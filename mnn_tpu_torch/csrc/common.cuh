// Helpers shared by the port's hand-written Hopper kernels.
//
// Every kernel is reached through a plain C entry point (extern "C") that
// launches on the caller's stream and returns cudaGetLastError(), so the
// Python wrapper can raise on a refused launch. Nothing here allocates.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MNN_API extern "C" __attribute__((visibility("default")))

namespace mnn {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// Round an f32 to bf16 (nearest-even) and back, as a cast to bf16 does.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A small unsigned integer as f32 without a conversion instruction.
__device__ __forceinline__ float u2f(uint32_t v) {   // exact for v < 2^23
  return __uint_as_float(v | 0x4B000000u) - 8388608.f;
}

// Store `v` as the output dtype: bf16 (rounded) or f32.
__device__ __forceinline__ void store_out(void* out, long idx, float v, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[idx] = v;
  else
    static_cast<bf16*>(out)[idx] = __float2bfloat16_rn(v);
}

// The value a store_out would leave, read back as f32.
__device__ __forceinline__ float as_out(float v, int out_f32) {
  return out_f32 ? v : round_bf16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Let `kernel` take `bytes` of dynamic shared memory on top of its static
// arrays (past 48 KB in total this needs the opt-in). `granted` remembers
// the largest size already set for this kernel, so the call is made once.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes, size_t& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (e == cudaSuccess) granted = bytes;
  return e;
}

}  // namespace mnn
