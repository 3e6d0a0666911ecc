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

#include "deq_dot.cuh"

namespace mnn {

struct MoeArgs {
  const bf16* xe;
  const float* w_e;
  const uint8_t* gu_p;
  const bf16* gu_s;
  const bf16* gu_b;
  const uint8_t* dn_p;
  const bf16* dn_s;
  const bf16* dn_b;
  bf16* act;
  float* y;
  int E, C, H, mi, bs_h, bs_mi;
};

template <int BITS, int MT, int NT, int WM, int WN, int ALG>
__global__ void __launch_bounds__(32 * WM * WN)
moe_prefill_gu_kernel(const bf16* __restrict__ xe, const uint8_t* __restrict__ packed,
                      const bf16* __restrict__ scale, const bf16* __restrict__ bias,
                      bf16* __restrict__ act, int C, int H, int mi, int bs, int vx, int vw,
                      int vp) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN>;
  static_assert(T::BN == 128, "a gate/up tile is 64 gate columns and their 64 up columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long e = blockIdx.z;
  const int N = 2 * mi, m0 = blockIdx.y * T::BM;
  float acc[MT][NT][4];
  tile_body<BITS, MT, NT, WM, WN, ALG>(smem_raw, xe + e * C * H, m0, C, H,
                                       packed + e * ((long)H * BITS / 8) * N,
                                       scale + e * (H / bs) * (long)N, bias + e * (H / bs) * (long)N,
                                       N, bs, blockIdx.x * T::BN, vx, vw, vp, acc);

  // the tile's gate/up values, rounded to bf16, staged in the ring's memory
  constexpr int GS = T::BN + 8;   // bf16 a staged row: 272 bytes, conflict-free
  bf16* gs = reinterpret_cast<bf16*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_w = (warp / WN) * MT * 16, col_w = (warp % WN) * NT * 8;
  __syncthreads();   // every warp is done with the ring
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<__nv_bfloat162*>(gs + (row_w + mt * 16 + gid + 8 * h) * GS + col_w +
                                           nt * 8 + 2 * tig) =
            __floats2bfloat162_rn(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
  __syncthreads();
  // act = bf16(bf16(g * sigmoid(g)) * u), two columns a thread: gate column
  // j of the tile and its up column 64 + j
  for (int i = threadIdx.x; i < T::BM * 32; i += T::THREADS) {
    const int r = i >> 5, j = 2 * (i & 31);
    if (m0 + r >= C) break;
    const __nv_bfloat162 g2 = *reinterpret_cast<const __nv_bfloat162*>(gs + r * GS + j);
    const __nv_bfloat162 u2 = *reinterpret_cast<const __nv_bfloat162*>(gs + r * GS + 64 + j);
    float a[2];
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float g = bf2f(k ? g2.y : g2.x), up = bf2f(k ? u2.y : u2.x);
      const float si = round_bf16(__fmul_rn(g, 1.f / (1.f + expf(-g))));
      a[k] = __fmul_rn(si, up);
    }
    *reinterpret_cast<__nv_bfloat162*>(&act[(e * C + m0 + r) * mi + blockIdx.x * 64 + j]) =
        __floats2bfloat162_rn(a[0], a[1]);
  }
}

template <int BITS, int MT, int NT, int WM, int WN, int ALG>
__global__ void __launch_bounds__(32 * WM * WN)
moe_prefill_down_kernel(const bf16* __restrict__ act, const float* __restrict__ w_e,
                        const uint8_t* __restrict__ packed, const bf16* __restrict__ scale,
                        const bf16* __restrict__ bias, float* __restrict__ y, int C, int H, int mi,
                        int bs, int vx, int vw, int vp) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long e = blockIdx.z;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[MT][NT][4];
  tile_body<BITS, MT, NT, WM, WN, ALG>(smem_raw, act + e * C * mi, m0, C, mi,
                                       packed + e * ((long)mi * BITS / 8) * H,
                                       scale + e * (mi / bs) * (long)H, bias + e * (mi / bs) * (long)H,
                                       H, bs, n0, vx, vw, vp, acc);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int row_w = (warp / WN) * MT * 16, col_w = (warp % WN) * NT * 8;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + row_w + mt * 16 + gid + 8 * h;
      if (row >= C) continue;
      const float w = w_e[e * C + row];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = n0 + col_w + nt * 8 + 2 * tig;   // and col + 1: H is even
        if (col < H)
          *reinterpret_cast<float2*>(&y[(e * C + row) * H + col]) =
              make_float2(__fmul_rn(acc[mt][nt][2 * h], w), __fmul_rn(acc[mt][nt][2 * h + 1], w));
      }
    }
}

// The tile shapes as (MT, NT, WM, WN), every one 128 columns wide (a gate/up
// tile pairs 64 gate columns with their up columns) with 32 columns a warp:
// 80 rows (twenty warps of 16 x 32), 64 (eight of 32 x 32), 32 (eight of
// 16 x 32) and 16 (four of 16 x 32). Each warp holds at most 32 x 32 of the
// sum, and as much again of the partial algebra's per-block products. (96
// rows, twelve warps of 32 x 32, took 612 us against 80 rows' 590 at
// qwen1.5-moe-a2.7b's C = 72 on an H100 80GB HBM3 at 700 W, and no served
// capacity needs it.)
#define MNN_MP_TILES(X) X(0, 1, 4, 5, 4) X(1, 2, 4, 2, 4) X(2, 1, 4, 2, 4) X(3, 1, 4, 1, 4)
#define MNN_MP_BM(t, MT, NT, WM, WN) Bf16Tile<4, MT, NT, WM, WN>::BM,
constexpr int MP_TILE_BM[] = {MNN_MP_TILES(MNN_MP_BM)};
constexpr int MP_NTILES = sizeof(MP_TILE_BM) / sizeof(int);
#undef MNN_MP_BM
constexpr int MP_TILE_BN = 128;

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

template <int BITS, int MT, int NT, int WM, int WN, int ALG_GU, int ALG_DN>
static cudaError_t launch_moe_prefill(const MoeArgs& a, cudaStream_t st) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN>;
  auto gu = moe_prefill_gu_kernel<BITS, MT, NT, WM, WN, ALG_GU>;
  auto dn = moe_prefill_down_kernel<BITS, MT, NT, WM, WN, ALG_DN>;
  constexpr int SMEM_GU = T::smem(ALG_GU), SMEM_DN = T::smem(ALG_DN);
  static size_t granted_gu = 0, granted_dn = 0;
  cudaError_t err = allow_smem(gu, SMEM_GU, granted_gu);
  if (err == cudaSuccess) err = allow_smem(dn, SMEM_DN, granted_dn);
  if (err != cudaSuccess) return err;
  const int slabs = (a.C + T::BM - 1) / T::BM, N = 2 * a.mi;
  gu<<<dim3(N / T::BN, slabs, a.E), T::THREADS, SMEM_GU, st>>>(
      a.xe, a.gu_p, a.gu_s, a.gu_b, a.act, a.C, a.H, a.mi, a.bs_h,
      copy_width((uintptr_t)a.xe | (uintptr_t)(2 * a.H) | (uintptr_t)(2 * a.bs_h)),
      std::min(copy_width((uintptr_t)a.gu_p | (uintptr_t)N), T::BN),
      copy_width((uintptr_t)a.gu_s | (uintptr_t)a.gu_b | (uintptr_t)(2 * N)));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dn<<<dim3((a.H + T::BN - 1) / T::BN, slabs, a.E), T::THREADS, SMEM_DN, st>>>(
      a.act, a.w_e, a.dn_p, a.dn_s, a.dn_b, a.y, a.C, a.H, a.mi, a.bs_mi,
      copy_width((uintptr_t)a.act | (uintptr_t)(2 * a.mi) | (uintptr_t)(2 * a.bs_mi)),
      std::min(copy_width((uintptr_t)a.dn_p | (uintptr_t)a.H), T::BN),
      copy_width((uintptr_t)a.dn_s | (uintptr_t)a.dn_b | (uintptr_t)(2 * a.H)));
  return cudaGetLastError();
}

// One tile shape, each product in the algebra its flag picks
template <int BITS, int MT, int NT, int WM, int WN>
static cudaError_t launch_moe_prefill_algs(bool pg, bool pd, const MoeArgs& a, cudaStream_t st) {
  constexpr int P = ALG_PARTIAL, D = ALG_DEQUANT;
  if (pg)
    return pd ? launch_moe_prefill<BITS, MT, NT, WM, WN, P, P>(a, st)
              : launch_moe_prefill<BITS, MT, NT, WM, WN, P, D>(a, st);
  return pd ? launch_moe_prefill<BITS, MT, NT, WM, WN, D, P>(a, st)
            : launch_moe_prefill<BITS, MT, NT, WM, WN, D, D>(a, st);
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
  if (bs_h > BF_KMAX || bs_mi > BF_KMAX || bs_h % 16 || bs_mi % 16 || H % bs_h || mi % bs_mi)
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
  const bool pg = partial_gu != 0, pd = partial_dn != 0;
  const int tile = moe_tile(E, C, H, mi);
#define MNN_MP_CASE(t, MT, NT, WM, WN)                                               \
  if (tile == t)                                                                    \
    return (int)(bits == 4 ? launch_moe_prefill_algs<4, MT, NT, WM, WN>(pg, pd, a, st) \
                           : launch_moe_prefill_algs<8, MT, NT, WM, WN>(pg, pd, a, st));
  MNN_MP_TILES(MNN_MP_CASE)
#undef MNN_MP_CASE
  return (int)cudaErrorInvalidValue;
}

// The tile mnn_moe_prefill takes for E experts of C rows, H and mi: rows,
// columns and dynamic shared memory per block of both products (the same
// in both algebras), in out[0..2]. Launches nothing.
MNN_API int mnn_moe_prefill_tile(int E, int C, int H, int mi, int bits, int* out) {
  if (E < 1 || C < 1 || mi < 64 || H < 8 || (bits != 4 && bits != 8))
    return (int)cudaErrorInvalidValue;
  const int tile = moe_tile(E, C, H, mi);
#define MNN_MP_INFO(t, MT, NT, WM, WN)                                                         \
  if (tile == t) {                                                                            \
    out[0] = Bf16Tile<4, MT, NT, WM, WN>::BM;                                                 \
    out[1] = Bf16Tile<4, MT, NT, WM, WN>::BN;                                                 \
    out[2] = bits == 4 ? Bf16Tile<4, MT, NT, WM, WN>::smem(ALG_PARTIAL)                       \
                       : Bf16Tile<8, MT, NT, WM, WN>::smem(ALG_PARTIAL);                      \
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
