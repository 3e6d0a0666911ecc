// The grouped mixture-of-experts prefill kernels (moe_prefill.cu's notes),
// their tiles and launches, each product templated on the largest quant
// block it stages (KMAX, deq_dot.cuh): blocks of up to 128 K-values in the
// kernels moe_prefill.cu instantiates, blocks of 144 to 256 in those of
// their own names (`_k256`) that moe_prefill_k256.cu instantiates, so the
// two compile side by side. Each product takes its own build: gate/up at
// its block over H, down at its block over mi.
#pragma once

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

// The gate/up product of one (column tile, row slab, expert) block, for
// quant blocks of up to KMAX K-values
template <int BITS, int MT, int NT, int WM, int WN, int ALG, int KMAX>
__device__ __forceinline__ void moe_gu_tile(const bf16* __restrict__ xe,
                                            const uint8_t* __restrict__ packed,
                                            const bf16* __restrict__ scale,
                                            const bf16* __restrict__ bias,
                                            bf16* __restrict__ act, int C, int H, int mi, int bs,
                                            int vx, int vw, int vp) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN, KMAX>;
  static_assert(T::BN == 128, "a gate/up tile is 64 gate columns and their 64 up columns");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long e = blockIdx.z;
  const int N = 2 * mi, m0 = blockIdx.y * T::BM;
  float acc[MT][NT][4];
  tile_body<BITS, MT, NT, WM, WN, ALG, KMAX>(smem_raw, xe + e * C * H, m0, C, H,
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

// The down product of one (column tile, row slab, expert) block, times the
// routing weights, for quant blocks of up to KMAX K-values
template <int BITS, int MT, int NT, int WM, int WN, int ALG, int KMAX>
__device__ __forceinline__ void moe_down_tile(const bf16* __restrict__ act,
                                              const float* __restrict__ w_e,
                                              const uint8_t* __restrict__ packed,
                                              const bf16* __restrict__ scale,
                                              const bf16* __restrict__ bias, float* __restrict__ y,
                                              int C, int H, int mi, int bs, int vx, int vw,
                                              int vp) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN, KMAX>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long e = blockIdx.z;
  const int m0 = blockIdx.y * T::BM, n0 = blockIdx.x * T::BN;
  float acc[MT][NT][4];
  tile_body<BITS, MT, NT, WM, WN, ALG, KMAX>(smem_raw, act + e * C * mi, m0, C, mi,
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

#define MNN_GU_PARAMS                                                                        \
  const bf16 *__restrict__ xe, const uint8_t *__restrict__ packed,                          \
      const bf16 *__restrict__ scale, const bf16 *__restrict__ bias, bf16 *__restrict__ act,  \
      int C, int H, int mi, int bs, int vx, int vw, int vp
#define MNN_GU_ARGS xe, packed, scale, bias, act, C, H, mi, bs, vx, vw, vp
#define MNN_DN_PARAMS                                                                        \
  const bf16 *__restrict__ act, const float *__restrict__ w_e,                              \
      const uint8_t *__restrict__ packed, const bf16 *__restrict__ scale,                   \
      const bf16 *__restrict__ bias, float *__restrict__ y, int C, int H, int mi, int bs,    \
      int vx, int vw, int vp
#define MNN_DN_ARGS act, w_e, packed, scale, bias, y, C, H, mi, bs, vx, vw, vp

// Each product for quant blocks of up to 128 K-values, and of up to 256
template <int BITS, int MT, int NT, int WM, int WN, int ALG>
__global__ void __launch_bounds__(32 * WM * WN) moe_prefill_gu_kernel(MNN_GU_PARAMS) {
  moe_gu_tile<BITS, MT, NT, WM, WN, ALG, BF_KMAX>(MNN_GU_ARGS);
}
template <int BITS, int MT, int NT, int WM, int WN, int ALG>
__global__ void __launch_bounds__(32 * WM * WN) moe_prefill_gu_k256_kernel(MNN_GU_PARAMS) {
  moe_gu_tile<BITS, MT, NT, WM, WN, ALG, BLOCK_MAX>(MNN_GU_ARGS);
}
template <int BITS, int MT, int NT, int WM, int WN, int ALG>
__global__ void __launch_bounds__(32 * WM * WN) moe_prefill_down_kernel(MNN_DN_PARAMS) {
  moe_down_tile<BITS, MT, NT, WM, WN, ALG, BF_KMAX>(MNN_DN_ARGS);
}
template <int BITS, int MT, int NT, int WM, int WN, int ALG>
__global__ void __launch_bounds__(32 * WM * WN) moe_prefill_down_k256_kernel(MNN_DN_PARAMS) {
  moe_down_tile<BITS, MT, NT, WM, WN, ALG, BLOCK_MAX>(MNN_DN_ARGS);
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

// One product (gate/up, or down) of every expert in one tile shape, in
// algebra ALG, for quant blocks of up to KMAX K-values
template <int BITS, int MT, int NT, int WM, int WN, int ALG, int KMAX>
static cudaError_t launch_moe_product(bool gu, const MoeArgs& a, cudaStream_t st) {
  using T = Bf16Tile<BITS, MT, NT, WM, WN, KMAX>;
  constexpr bool K256 = KMAX != BF_KMAX;
  constexpr int SMEM = T::smem(ALG);
  const int slabs = (a.C + T::BM - 1) / T::BM, N = 2 * a.mi;
  cudaError_t err;
  if (gu) {
    auto kern = [] {
      if constexpr (K256) return moe_prefill_gu_k256_kernel<BITS, MT, NT, WM, WN, ALG>;
      else return moe_prefill_gu_kernel<BITS, MT, NT, WM, WN, ALG>;
    }();
    static size_t granted = 0;
    if ((err = allow_smem(kern, SMEM, granted)) != cudaSuccess) return err;
    kern<<<dim3(N / T::BN, slabs, a.E), T::THREADS, SMEM, st>>>(
        a.xe, a.gu_p, a.gu_s, a.gu_b, a.act, a.C, a.H, a.mi, a.bs_h,
        copy_width((uintptr_t)a.xe | (uintptr_t)(2 * a.H) | (uintptr_t)(2 * a.bs_h)),
        std::min(copy_width((uintptr_t)a.gu_p | (uintptr_t)N), T::BN),
        copy_width((uintptr_t)a.gu_s | (uintptr_t)a.gu_b | (uintptr_t)(2 * N)));
  } else {
    auto kern = [] {
      if constexpr (K256) return moe_prefill_down_k256_kernel<BITS, MT, NT, WM, WN, ALG>;
      else return moe_prefill_down_kernel<BITS, MT, NT, WM, WN, ALG>;
    }();
    static size_t granted = 0;
    if ((err = allow_smem(kern, SMEM, granted)) != cudaSuccess) return err;
    kern<<<dim3((a.H + T::BN - 1) / T::BN, slabs, a.E), T::THREADS, SMEM, st>>>(
        a.act, a.w_e, a.dn_p, a.dn_s, a.dn_b, a.y, a.C, a.H, a.mi, a.bs_mi,
        copy_width((uintptr_t)a.act | (uintptr_t)(2 * a.mi) | (uintptr_t)(2 * a.bs_mi)),
        std::min(copy_width((uintptr_t)a.dn_p | (uintptr_t)a.H), T::BN),
        copy_width((uintptr_t)a.dn_s | (uintptr_t)a.dn_b | (uintptr_t)(2 * a.H)));
  }
  return cudaGetLastError();
}

// One product in tile `tile`, at `bits`, in the algebra `partial` picks
template <int KMAX>
static int launch_moe_product_tile(int tile, int bits, bool gu, bool partial, const MoeArgs& a,
                                   cudaStream_t st) {
  constexpr int P = ALG_PARTIAL, D = ALG_DEQUANT;
#define MNN_MP_CASE(t, MT, NT, WM, WN)                                                        \
  if (tile == t) {                                                                           \
    if (bits == 4)                                                                           \
      return (int)(partial ? launch_moe_product<4, MT, NT, WM, WN, P, KMAX>(gu, a, st)       \
                           : launch_moe_product<4, MT, NT, WM, WN, D, KMAX>(gu, a, st));     \
    return (int)(partial ? launch_moe_product<8, MT, NT, WM, WN, P, KMAX>(gu, a, st)         \
                         : launch_moe_product<8, MT, NT, WM, WN, D, KMAX>(gu, a, st));       \
  }
  MNN_MP_TILES(MNN_MP_CASE)
#undef MNN_MP_CASE
  return (int)cudaErrorInvalidValue;
}

// The KMAX = 256 launches (moe_prefill_k256.cu): a product whose quant
// block is 144 to 256 K-values.
int launch_moe_product_k256(int tile, int bits, bool gu, bool partial, const MoeArgs& a,
                            cudaStream_t st);

}  // namespace mnn
