// W4A4 integer matmul for M <= 32 on the int8 tensor cores: one exact int32
// dot per 32-wide scale group, the integer oracle kernel.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:89 tcq4_matmul_a8 (_kernel_a8 at :64).
// For each 256-row superblock sb, in the JAX kernel's order:
//     p_g    = sum_{k in group g} a_q[m, k] * w4[k, n]       (exact int32)
//     sbacc  = sum over g = 0..7 of p_g * eff[sb*8 + g, n]   (f32, in g order)
//     acc   += sbacc * (a_scale[m, sb] / 7)
// with w4 the sign-extended nibbles of qs (the low nibble of byte row r of a
// superblock is its element r, the high nibble element r + 128).
//
// Bound on the H100: bytes. The weights stream once (K/2 * N bytes of qs and
// K/32 * N * 4 bytes of f32 eff); even at M = 32 the 2 * M * K * N int8 ops
// take a fifth of the weight stream's time at the int8 peak.
//
// Design: one warp per 8-column tile of N over all of K, four warps a block,
// and two m16 tiles (the second only when M > 16; rows past M read as zero
// and are not stored). Per group the warp issues one
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32 per m tile: the A fragment is four
// 32-bit loads of the int8 codes straight from device memory (every warp
// reads the same few KiB, which stay in L1 / L2), the B fragment is eight
// byte loads of the packed weights, whose nibbles are sign-extended to s8 in
// registers. The epilogue runs in f32 with explicit round-to-nearest
// operations in the order above. Loads are synchronous (no cp.async, no
// shared-memory staging, no split of K): a first kernel that is right; the
// change that makes it fast stages the weights and splits K across warps.

#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four k-consecutive weights of one column as s8 bytes: byte rows r .. r+3 of
// qs at column n, their low (hi = 0) or high nibbles.
__device__ __forceinline__ uint32_t w4_word(const uint8_t* __restrict__ qs, size_t r, int N, int n,
                                            int hi) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t b = __ldg(qs + (r + i) * N + n);
    const uint32_t nib = hi ? (b >> 4) : (b & 15u);
    const uint32_t s8 = (nib ^ 8u) - 8u;              // sign-extend 4 -> 32 bits
    w |= (s8 & 0xffu) << (8 * i);
  }
  return w;
}

__device__ __forceinline__ uint32_t a_word(const int8_t* __restrict__ a, int row, int M, int K,
                                           int k) {
  return row < M ? __ldg(reinterpret_cast<const uint32_t*>(a + static_cast<size_t>(row) * K + k))
                 : 0u;
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
a8_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
          const uint8_t* __restrict__ qs, const float* __restrict__ eff,
          float* __restrict__ out, int M, int K, int N) {
  const int lane = threadIdx.x & 31;
  const int n0 = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * 8;
  if (n0 >= N) return;
  const int g = lane >> 2, t = lane & 3;
  const int nsb = K / 256;
  const int ecol = n0 + t * 2;                        // this thread's two output columns

  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.0f;

  for (int sb = 0; sb < nsb; ++sb) {
    float sbacc[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) sbacc[i][r] = 0.0f;
#pragma unroll 2
    for (int gi = 0; gi < 8; ++gi) {
      const size_t r0 = static_cast<size_t>(sb) * 128 + (gi & 3) * 32;
      const int hi = gi >> 2;
      const uint32_t b[2] = {w4_word(qs, r0 + t * 4, N, n0 + g, hi),
                             w4_word(qs, r0 + 16 + t * 4, N, n0 + g, hi)};
      const int k = sb * 256 + gi * 32 + t * 4;
      const float2 e = __ldg(reinterpret_cast<const float2*>(
          eff + static_cast<size_t>(sb * 8 + gi) * N + ecol));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int row = i * 16 + g;
        const uint32_t af[4] = {a_word(a, row, M, K, k), a_word(a, row + 8, M, K, k),
                                a_word(a, row, M, K, k + 16), a_word(a, row + 8, M, K, k + 16)};
        int p[4] = {0, 0, 0, 0};
        mma_s8(p, af, b);
#pragma unroll
        for (int r = 0; r < 4; ++r)
          sbacc[i][r] = __fadd_rn(sbacc[i][r],
                                  __fmul_rn(static_cast<float>(p[r]), (r & 1) ? e.y : e.x));
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = i * 16 + g + h * 8;
        const float s = row < M ? __fmul_rn(a_scale[static_cast<size_t>(row) * nsb + sb],
                                            1.0f / 7.0f)
                                : 0.0f;
#pragma unroll
        for (int c = 0; c < 2; ++c)
          acc[i][h * 2 + c] = __fadd_rn(acc[i][h * 2 + c], __fmul_rn(sbacc[i][h * 2 + c], s));
      }
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = i * 16 + g + (r >> 1) * 8;
      if (row < M) out[static_cast<size_t>(row) * N + ecol + (r & 1)] = acc[i][r];
    }
}

}  // namespace

RRS_EXPORT int rrs_tcq4_a8(const void* a_q, const void* a_scale, const void* qs, const void* eff,
                           void* out, int M, int K, int N, void* stream) {
  if (K % 256 != 0 || N % 8 != 0 || M < 1 || M > 32) return rrs::kBadArgs;
  const dim3 grid((N / 8 + kWarps - 1) / kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a_q);
  const float* sp = static_cast<const float*>(a_scale);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  const float* ep = static_cast<const float*>(eff);
  float* op = static_cast<float*>(out);
  if (M <= 16)
    a8_kernel<1><<<grid, kThreads, 0, s>>>(ap, sp, qp, ep, op, M, K, N);
  else
    a8_kernel<2><<<grid, kThreads, 0, s>>>(ap, sp, qp, ep, op, M, K, N);
  return rrs::status();
}
