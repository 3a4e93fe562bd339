// A plain tiled bf16 tensor-core GEMM, C[M, N] = A[M, K] @ W[K, N], used by
// the paired-bias matmul alone (B18, tcq4_pb.cu, which no model path
// calls). Its weight-tile loader dequantizes the format into a bf16
// shared-memory tile, so no dequantized weight ever reaches device memory.
//
// Tile: BM x 64 (N) x 64 (K), 128 threads (4 warps), WMMA m16n16k16 bf16 with
// f32 accumulators. One K tile is 64 logical k, given as two 32-wide runs
// (k0 .. k0+31 and k1 .. k1+31). Loads are synchronous and there is no
// split-K. Every other weight matmul runs on the split-K stream and the
// pipelined GEMM of gemm_sm90.cuh: B2, B4 (and B17 through B4) and B11 since
// their redesigns, B10, B13 and B19 on its expert grid.
#pragma once

#include <mma.h>

#include "common.cuh"

namespace rrs {
namespace gemm {

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kLdA = kBK + 8;   // bf16 elements; rows stay 32-byte aligned per 16
constexpr int kLdB = kBN + 8;
constexpr int kLdC = kBN + 4;   // f32 elements

template <int BM>
struct Shape {
  static constexpr int kWarpsM = BM >= 32 ? BM / 32 : 1;
  static constexpr int kWarpsN = 4 / kWarpsM;
  static constexpr int kWarpTileM = BM / kWarpsM;
  static constexpr int kWarpTileN = kBN / kWarpsN;
  static constexpr int kFragM = kWarpTileM / 16;
  static constexpr int kFragN = kWarpTileN / 16;
};

template <int BM>
struct Smem {
  __align__(32) __nv_bfloat16 a[BM * kLdA];
  __align__(32) __nv_bfloat16 b[kBK * kLdB];
  __align__(32) float c[BM * kLdC];
};

__device__ __forceinline__ void to_bf16x4(const float4 v, __nv_bfloat16* dst) {
  dst[0] = __float2bfloat16_rn(v.x);
  dst[1] = __float2bfloat16_rn(v.y);
  dst[2] = __float2bfloat16_rn(v.z);
  dst[3] = __float2bfloat16_rn(v.w);
}

// A tile: rows m0 .. m0+BM-1 (zero past M), k runs at k0 and k1, rounded to bf16.
template <int BM>
__device__ __forceinline__ void load_a(const float* __restrict__ a, int M, int K, int m0,
                                       int k0, int k1, __nv_bfloat16* sa) {
  for (int c = threadIdx.x; c < BM * (kBK / 4); c += kThreads) {
    const int row = c / (kBK / 4);
    const int kk = (c % (kBK / 4)) * 4;
    const int gk = kk < 32 ? k0 + kk : k1 + (kk - 32);
    const int gr = m0 + row;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < M) v = *reinterpret_cast<const float4*>(a + static_cast<size_t>(gr) * K + gk);
    to_bf16x4(v, sa + row * kLdA + kk);
  }
}

template <int BM>
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ a, int M, int K, int m0,
                                       int k0, int k1, __nv_bfloat16* sa) {
  for (int c = threadIdx.x; c < BM * (kBK / 4); c += kThreads) {
    const int row = c / (kBK / 4);
    const int kk = (c % (kBK / 4)) * 4;
    const int gk = kk < 32 ? k0 + kk : k1 + (kk - 32);
    const int gr = m0 + row;
    uint2 v = make_uint2(0u, 0u);
    if (gr < M) v = *reinterpret_cast<const uint2*>(a + static_cast<size_t>(gr) * K + gk);
    *reinterpret_cast<uint2*>(sa + row * kLdA + kk) = v;
  }
}

template <int BM>
struct Acc {
  using Frag = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;
  Frag f[Shape<BM>::kFragM][Shape<BM>::kFragN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < Shape<BM>::kFragM; ++i)
#pragma unroll
      for (int j = 0; j < Shape<BM>::kFragN; ++j) nvcuda::wmma::fill_fragment(f[i][j], 0.0f);
  }

  // One 64-deep K tile from shared memory.
  __device__ __forceinline__ void mma(const __nv_bfloat16* sa, const __nv_bfloat16* sb) {
    using namespace nvcuda;
    using S = Shape<BM>;
    const int warp = threadIdx.x >> 5;
    const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[S::kFragM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf[S::kFragN];
#pragma unroll
      for (int i = 0; i < S::kFragM; ++i)
        wmma::load_matrix_sync(af[i], sa + (wm * S::kWarpTileM + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < S::kFragN; ++j)
        wmma::load_matrix_sync(bf[j], sb + kk * kLdB + wn * S::kWarpTileN + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < S::kFragM; ++i)
#pragma unroll
        for (int j = 0; j < S::kFragN; ++j) wmma::mma_sync(f[i][j], af[i], bf[j], f[i][j]);
    }
  }

  // Accumulators -> shared f32 tile -> global (f32 or bf16), masked at the edges.
  template <typename OutT>
  __device__ __forceinline__ void store(float* sc, OutT* __restrict__ out, int M, int N, int m0,
                                        int n0) {
    using namespace nvcuda;
    using S = Shape<BM>;
    const int warp = threadIdx.x >> 5;
    const int wm = warp / S::kWarpsN, wn = warp % S::kWarpsN;
#pragma unroll
    for (int i = 0; i < S::kFragM; ++i)
#pragma unroll
      for (int j = 0; j < S::kFragN; ++j)
        wmma::store_matrix_sync(sc + (wm * S::kWarpTileM + i * 16) * kLdC + wn * S::kWarpTileN + j * 16,
                                f[i][j], kLdC, wmma::mem_row_major);
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * kBN; idx += kThreads) {
      const int r = idx / kBN, c = idx % kBN;
      const int gr = m0 + r, gc = n0 + c;
      if (gr < M && gc < N) store_one(out + static_cast<size_t>(gr) * N + gc, sc[r * kLdC + c]);
    }
  }

  static __device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
  static __device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
};

}  // namespace gemm
}  // namespace rrs
