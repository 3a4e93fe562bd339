// The TCQ4 weight-tile loader of the bf16 WMMA GEMM (gemm_bf16.cuh), used by
// the expert matmuls (tcq4_experts.cu: B10, B19). B4 and B17 have their own
// loader on gemm_sm90.cuh (tcq4_matmul.cu).
//
// One K tile is a quarter superblock: 32 byte rows of qs, whose low nibbles
// are one scale group (k = 256 sb + 32 q .. + 31) and whose high nibbles are
// the group 128 later, so every qs byte is read once and every tile row has
// one eff per column. The unpacked int4 times the eff (bf16, or f32 for the
// selected-experts kernel) is rounded to bf16 in shared memory,
// exactly as the TPU kernels round their operand before the MXU pass.
#pragma once

#include "gemm_bf16.cuh"

namespace rrs {
namespace gemm {

__device__ __forceinline__ float eff_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float eff_f32(float v) { return v; }

// B tile for (superblock sb, quarter q): 32 byte rows x 64 columns of qs ->
// 64 bf16 k rows (0..31 low nibbles, 32..63 high nibbles); columns past N
// are zero.
template <typename EffT>
__device__ __forceinline__ void load_b_tcq4(const uint8_t* __restrict__ qs,
                                            const EffT* __restrict__ eff, int N,
                                            int sb, int q, int n0, __nv_bfloat16* sb_tile) {
  const int r = threadIdx.x >> 2;          // byte row 0..31
  const int cb = (threadIdx.x & 3) * 16;   // 16 columns per thread
  const int row = sb * 128 + q * 32 + r;
  const int g_lo = sb * 8 + q, g_hi = g_lo + 4;
  uint4 packed;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(&packed);
  const int gc0 = n0 + cb;
  if ((N & 15) == 0 && gc0 + 16 <= N) {
    packed = __ldg(reinterpret_cast<const uint4*>(qs + static_cast<size_t>(row) * N + gc0));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      bytes[j] = (gc0 + j < N) ? qs[static_cast<size_t>(row) * N + gc0 + j] : 0;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int gc = gc0 + j;
    float elo = 0.f, ehi = 0.f;
    if (gc < N) {
      elo = eff_f32(eff[static_cast<size_t>(g_lo) * N + gc]);
      ehi = eff_f32(eff[static_cast<size_t>(g_hi) * N + gc]);
    }
    const int lo = static_cast<int>(static_cast<uint32_t>(bytes[j]) << 28) >> 28;
    const int hi = static_cast<int>(static_cast<uint32_t>(bytes[j]) << 24) >> 28;
    sb_tile[r * kLdB + cb + j] = __float2bfloat16_rn(static_cast<float>(lo) * elo);
    sb_tile[(32 + r) * kLdB + cb + j] = __float2bfloat16_rn(static_cast<float>(hi) * ehi);
  }
}

static_assert(kThreads == 128 && kBK == 64 && kBN == 64,
              "load_b_tcq4 maps 128 threads onto 32 byte rows x 4 runs of 16 columns");

}  // namespace gemm
}  // namespace rrs
