// The tensor-core kernels of dequant_matmul.cu for quant blocks of 136 to
// 256 K-values (dequant_matmul.cuh, KMAX = 256): their own source, so that
// nvcc builds them beside the KMAX = 128 kernels and not after them.
#include "dequant_matmul.cuh"

namespace mnn {

int launch_bf16_tile_k256(bool deq, const void* x, const void* packed, const void* scale,
                          const void* bias, const void* out_bias, void* out, int M, int K, int N,
                          int bits, int bs, int out_f32, cudaStream_t st) {
  return deq ? launch_bf16_tile_bits<true, BLOCK_MAX>(x, packed, scale, bias, out_bias, out, M, K,
                                                      N, bits, bs, out_f32, st)
             : launch_bf16_tile_bits<false, BLOCK_MAX>(x, packed, scale, bias, out_bias, out, M, K,
                                                       N, bits, bs, out_f32, st);
}

int launch_a8_k256(const void* xq, const void* xscale, const void* packed, const void* scale,
                   const void* bias, const void* out_bias, void* out, int M, int K, int N,
                   int bits, int bs, int out_f32, cudaStream_t st) {
  return launch_a8_bits<BLOCK_MAX>(xq, xscale, packed, scale, bias, out_bias, out, M, K, N, bits,
                                   bs, out_f32, st);
}

}  // namespace mnn
