// The whole-model decode kernel for up to 1 batch row (decode_model.cuh).
#include "decode_model.cuh"

namespace mnn {

int launch_b1(DmParams& p, float* ws, long ws_floats, int n_counters, const int* hdr,
              cudaStream_t st) {
  return launch<1>(p, ws, ws_floats, n_counters, hdr, st);
}

int limits_b1(int D, int bits, int* out) { return limits<1>(D, bits, out); }

}  // namespace mnn
