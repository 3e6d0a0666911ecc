// The grouped mixture-of-experts prefill products for quant blocks of 144
// to 256 K-values (moe_prefill.cuh, KMAX = 256): their own source, so that
// nvcc builds them beside the KMAX = 128 kernels and not after them.
#include "moe_prefill.cuh"

namespace mnn {

int launch_moe_product_k256(int tile, int bits, bool gu, bool partial, const MoeArgs& a,
                            cudaStream_t st) {
  return launch_moe_product_tile<BLOCK_MAX>(tile, bits, gu, partial, a, st);
}

}  // namespace mnn
