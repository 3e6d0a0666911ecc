// The whole-model decode kernel for up to 2 batch rows (decode_model.cuh).
#include "decode_model.cuh"

namespace mnn {

int launch_b2(DmParams& p, float* ws, long ws_floats, int n_counters, const int* hdr,
              cudaStream_t st) {
  return launch<2>(p, ws, ws_floats, n_counters, hdr, st);
}

int limits_b2(int D, int bits, int* out) { return limits<2>(D, bits, out); }

}  // namespace mnn
