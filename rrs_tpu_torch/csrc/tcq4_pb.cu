// W4A4 paired-bias matmul over the group-interleaved TCQ4 pack, f32 out:
//
//   out = a_gi @ bf16(bf16(q + 24) * e[r mod G])  -  ag24 @ [e; e]
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:453 tcq4_matmul_pb (_kernel_pb at
// :413). a_gi bf16 [M, K] holds the activations in k_new = j * G + g order
// (G = K / 32 groups), qs_gi uint8 [K/2, N] the int4 codes in the same order
// (byte row r: k_new = 2r in its low nibble, 2r + 1 in its high nibble), so
// row k_new's group scale is eff[k_new mod G]; ag24 bf16 [M, 2G] is the hi /
// lo split of 24 * (the per-group sums of a), whose 2G-deep dot against the
// scales stacked twice cancels the +24 bias of the decoded weights.
//
// Arithmetic, as on the TPU: a nibble n decodes to the bf16 bit pattern
// 0x4180 | ((n ^ 8) << 3), which is q + 24 exactly (the 16 values land in the
// binade [16, 31]); that times the f32 of the bf16 scale is exact in f32 and
// is rounded once to bf16 (__float2bfloat16_rn), the TPU's bf16 product. The
// dots take bf16 operands with f32 sums; only the order of the sums differs
// from the plain version.
//
// Bound on the H100: bytes at decode M (the 4.625-bit weights, as B1 reads
// them), operations at prefill M (2 M K N bf16 FLOPs plus the 2G-deep bias
// dot, 2 M 2G N).
//
// Design: the tiled WMMA GEMM of gemm_bf16.cuh (BM x 64 x 64 tiles, 4 warps,
// f32 accumulators). Each output tile first runs the bias dot once, over
// 64-deep tiles of ag24 and of the NEGATED scales (exact in bf16), so its
// accumulators start at -bias as the TPU kernel's output block does; then it
// walks K in 64-deep tiles, each 32 byte rows of qs_gi decoded by the bit
// recipe into shared memory. Loads are synchronous, as in the other GEMMs.

#include "gemm_bf16.cuh"

namespace {

using namespace rrs::gemm;

// Bias A tile: ag24 rows m0 .. m0+BM-1, columns t0 .. t0+63 (zero past M or 2G).
template <int BM>
__device__ __forceinline__ void load_ag(const __nv_bfloat16* __restrict__ ag, int M, int G2,
                                        int m0, int t0, __nv_bfloat16* sa) {
  for (int idx = threadIdx.x; idx < BM * kBK; idx += kThreads) {
    const int r = idx / kBK, c = idx % kBK;
    const int gr = m0 + r, t = t0 + c;
    sa[r * kLdA + c] = (gr < M && t < G2) ? ag[static_cast<size_t>(gr) * G2 + t]
                                          : __float2bfloat16_rn(0.f);
  }
}

// Bias B tile: row t of [-e; -e] is -eff[t mod G] (zero past 2G or N).
__device__ __forceinline__ void load_neg_e2(const __nv_bfloat16* __restrict__ eff, int G, int N,
                                            int t0, int n0, __nv_bfloat16* sb) {
  for (int idx = threadIdx.x; idx < kBK * kBN; idx += kThreads) {
    const int r = idx / kBN, c = idx % kBN;
    const int t = t0 + r, gc = n0 + c;
    sb[r * kLdB + c] = (t < 2 * G && gc < N) ? __hneg(eff[static_cast<size_t>(t % G) * N + gc])
                                             : __float2bfloat16_rn(0.f);
  }
}

// One decoded weight: bf16(bf16(q + 24) * e).
__device__ __forceinline__ __nv_bfloat16 biased(uint32_t nib, float e) {
  const uint32_t bits = 0x4180u | ((nib ^ 8u) << 3);
  return __float2bfloat16_rn(__fmul_rn(__uint_as_float(bits << 16), e));
}

// Weight tile for k_new = k0 .. k0+63: byte rows k0/2 .. k0/2+31 x 64 columns;
// tile row 2r from the low nibble of byte row r, 2r + 1 from the high one.
__device__ __forceinline__ void load_b_pb(const uint8_t* __restrict__ qs,
                                          const __nv_bfloat16* __restrict__ eff, int G, int N,
                                          int k0, int n0, __nv_bfloat16* sb) {
  const int r = threadIdx.x >> 2;          // byte row 0..31
  const int cb = (threadIdx.x & 3) * 16;   // 16 columns per thread
  const int row = k0 / 2 + r;
  const int g_lo = (k0 + 2 * r) % G, g_hi = (k0 + 2 * r + 1) % G;
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
    __nv_bfloat16 wl = __float2bfloat16_rn(0.f), wh = wl;
    if (gc < N) {
      wl = biased(bytes[j] & 15u, __bfloat162float(eff[static_cast<size_t>(g_lo) * N + gc]));
      wh = biased(bytes[j] >> 4, __bfloat162float(eff[static_cast<size_t>(g_hi) * N + gc]));
    }
    sb[(2 * r) * kLdB + cb + j] = wl;
    sb[(2 * r + 1) * kLdB + cb + j] = wh;
  }
}

static_assert(kThreads == 128 && kBK == 64 && kBN == 64,
              "load_b_pb maps 128 threads onto 32 byte rows x 4 runs of 16 columns");

// grid (ceil(N / 64), ceil(M / BM))
template <int BM>
__global__ void __launch_bounds__(kThreads)
tcq4_pb_kernel(const __nv_bfloat16* __restrict__ a_gi, const __nv_bfloat16* __restrict__ ag24,
               const uint8_t* __restrict__ qs, const __nv_bfloat16* __restrict__ eff,
               float* __restrict__ out, int M, int K, int N) {
  __shared__ Smem<BM> sm;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int G = K / 32;
  Acc<BM> acc;
  acc.zero();
  for (int t0 = 0; t0 < 2 * G; t0 += kBK) {
    load_ag<BM>(ag24, M, 2 * G, m0, t0, sm.a);
    load_neg_e2(eff, G, N, t0, n0, sm.b);
    __syncthreads();
    acc.mma(sm.a, sm.b);
    __syncthreads();
  }
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a<BM>(a_gi, M, K, m0, k0, k0 + 32, sm.a);
    load_b_pb(qs, eff, G, N, k0, n0, sm.b);
    __syncthreads();
    acc.mma(sm.a, sm.b);
    __syncthreads();
  }
  acc.store(sm.c, out, M, N, m0, n0);
}

}  // namespace

RRS_EXPORT int rrs_tcq4_pb(const void* a_gi, const void* ag24, const void* qs_gi, const void* eff,
                           void* out, int M, int K, int N, void* stream) {
  if (M < 1 || K < 256 || K % 256 != 0 || N < 8 || N % 8 != 0 || (M + 63) / 64 > 65535)
    return rrs::kBadArgs;
  const auto* ap = static_cast<const __nv_bfloat16*>(a_gi);
  const auto* gp = static_cast<const __nv_bfloat16*>(ag24);
  const auto* qp = static_cast<const uint8_t*>(qs_gi);
  const auto* ep = static_cast<const __nv_bfloat16*>(eff);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, 1);
    tcq4_pb_kernel<16><<<grid, kThreads, 0, s>>>(ap, gp, qp, ep, op, M, K, N);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (M + 63) / 64);
    tcq4_pb_kernel<64><<<grid, kThreads, 0, s>>>(ap, gp, qp, ep, op, M, K, N);
  }
  return rrs::status();
}
