// Grouped mixture-of-experts prefill MLP (sm_90a): every expert's capacity
// batch of one layer in one entry.
//
// Replaces mnn_tpu/kernels/moe_prefill.py::_kernel (with its _deq_dot). For
// each expert e,
//   y[e] = w_e[e] * down_e(act(gate_up_e(xe[e])))
// over xe bf16 [E, C, H] (rows gathered by the caller, empty slots zero with
// weight 0), W4/W8 expert stacks [E, ...] in the packed per-block format, and
// f32 output [E, C, H]. Each product picks its algebra as the TPU kernel
// does: partial products, acc + ((x @ q) * s + rowsum(x) * m), when the
// capacity C is below the quant block, else dequantize the block to bf16 and
// dot. The gate/up result is rounded to bf16, split by the 64-block
// interleave, bf16(bf16(g * sigmoid(g)) * u).
//
// Close to the ridge at the serving shapes (60 experts x 72 rows: 75 GFLOP a
// layer over 0.33 GB of weights and rows), so both products run on the
// bf16 tensor cores, in the tile body of deq_dot.cuh (ALG_PARTIAL or
// ALG_DEQUANT): a cp.async ring of quant blocks, one unpack per tile and
// block into bf16 K-rows, ldmatrix fragments, the partial side's row sums as
// one more mma. Two dependent products, two launches on the caller's stream:
// the activations [E, C, mi] (bf16) are parked in device memory between
// them, since a block holds one 128-column tile of one expert and the down
// product needs all of mi. Blocks: (column tile, row slab of the capacity,
// expert); the slab height comes from C (moe_tile). A gate/up tile is 64
// gate columns and their 64 up columns; the warps hold them apart, so the
// rounded values meet through the freed ring memory after the K loop.
#include <algorithm>

#include "moe_prefill.cuh"

namespace mnn {

// The tile for E experts of C rows: of those that give every SM a block in
// the narrower product, the one with the least slabs * (rows + 16), the
// padded rows plus a per-slab charge for the weights' unpack and second
// read (ties to the taller); the shortest where none fills the card. At
// qwen1.5-moe-a2.7b's 60 experts: C = 8 takes 16 rows, 24 takes 32, 72
// takes 80 (8 padded rows), 144 two slabs of 80; qwen3-moe-30b-a3b's
// C = 64 takes 64. Built with -DMNN_MP_TILE=t, always tile t (profiling).
static int moe_tile(int E, int C, int H, int mi) {
#ifdef MNN_MP_TILE
  (void)E, (void)C, (void)H, (void)mi;
  return MNN_MP_TILE;
#else
  const long cols = (std::min(2 * mi, H) + MP_TILE_BN - 1) / MP_TILE_BN;
  int best = MP_NTILES - 1;
  long best_cost = -1;
  for (int t = 0; t < MP_NTILES; ++t) {
    const long slabs = (C + MP_TILE_BM[t] - 1) / MP_TILE_BM[t];
    if ((long)E * slabs * cols < sm_count()) continue;
    const long cost = slabs * (MP_TILE_BM[t] + 16);
    if (best_cost < 0 || cost < best_cost) best = t, best_cost = cost;
  }
  return best;
#endif
}

}  // namespace mnn

using namespace mnn;

// y[E, C, H] (f32) = w_e * expert MLP of xe[E, C, H] (bf16); act: scratch
// bf16 [E, C, mi]. partial_gu / partial_dn pick each product's algebra.
MNN_API int mnn_moe_prefill(const void* xe, const void* w_e, const void* gu_p, const void* gu_s,
                            const void* gu_b, const void* dn_p, const void* dn_s,
                            const void* dn_b, void* act, void* y, int E, int C, int H, int mi,
                            int bits, int bs_h, int bs_mi, int partial_gu, int partial_dn,
                            void* stream) {
  if (E < 1 || C < 1 || mi % 64 || H % 8 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  if (bs_h > BLOCK_MAX || bs_mi > BLOCK_MAX || bs_h % 16 || bs_mi % 16 || H % bs_h || mi % bs_mi)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)xe | (uintptr_t)gu_p | (uintptr_t)gu_s | (uintptr_t)gu_b | (uintptr_t)dn_p |
       (uintptr_t)dn_s | (uintptr_t)dn_b | (uintptr_t)act) % 4)
    return (int)cudaErrorMisalignedAddress;
  const MoeArgs a{static_cast<const bf16*>(xe),    static_cast<const float*>(w_e),
                  static_cast<const uint8_t*>(gu_p), static_cast<const bf16*>(gu_s),
                  static_cast<const bf16*>(gu_b),  static_cast<const uint8_t*>(dn_p),
                  static_cast<const bf16*>(dn_s),  static_cast<const bf16*>(dn_b),
                  static_cast<bf16*>(act),         static_cast<float*>(y),
                  E, C, H, mi, bs_h, bs_mi};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tile = moe_tile(E, C, H, mi);
  // gate/up, then down, on the caller's stream, each in the build its block takes
  const bool pg = partial_gu != 0, pd = partial_dn != 0;
  int err = bs_h > BF_KMAX ? launch_moe_product_k256(tile, bits, true, pg, a, st)
                           : launch_moe_product_tile<BF_KMAX>(tile, bits, true, pg, a, st);
  if (err) return err;
  return bs_mi > BF_KMAX ? launch_moe_product_k256(tile, bits, false, pd, a, st)
                         : launch_moe_product_tile<BF_KMAX>(tile, bits, false, pd, a, st);
}

// The tile mnn_moe_prefill takes for E experts of C rows, H and mi: rows,
// columns and dynamic shared memory per block of a product whose quant
// block is bs (the same in both algebras), in out[0..2]. Launches nothing.
MNN_API int mnn_moe_prefill_tile(int E, int C, int H, int mi, int bits, int bs, int* out) {
  if (E < 1 || C < 1 || mi < 64 || H < 8 || (bits != 4 && bits != 8) || bs > BLOCK_MAX)
    return (int)cudaErrorInvalidValue;
  const int tile = moe_tile(E, C, H, mi);
#define MNN_MP_INFO(t, MT, NT, WM, WN)                                                         \
  if (tile == t) {                                                                            \
    out[0] = Bf16Tile<4, MT, NT, WM, WN>::BM;                                                 \
    out[1] = Bf16Tile<4, MT, NT, WM, WN>::BN;                                                 \
    out[2] = bs > BF_KMAX                                                                     \
                 ? (bits == 4 ? Bf16Tile<4, MT, NT, WM, WN, BLOCK_MAX>::smem(ALG_PARTIAL)     \
                              : Bf16Tile<8, MT, NT, WM, WN, BLOCK_MAX>::smem(ALG_PARTIAL))    \
                 : (bits == 4 ? Bf16Tile<4, MT, NT, WM, WN>::smem(ALG_PARTIAL)                \
                              : Bf16Tile<8, MT, NT, WM, WN>::smem(ALG_PARTIAL));              \
    return 0;                                                                                 \
  }
  MNN_MP_TILES(MNN_MP_INFO)
#undef MNN_MP_INFO
  return (int)cudaErrorInvalidValue;
}

#ifdef MNN_DD_CLOCKS
// The tile body's step cycles (deq_dot.cuh, MNN_DD_CLOCKS) of the kernels
// launched since the last read, into out[0..7]; zeroed after.
MNN_API int mnn_moe_prefill_clocks(long long* out) { return dd_clocks_read(out); }
#endif
