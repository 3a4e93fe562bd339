// W4A4 prefill matmul: in-kernel weight dequantization into a bf16 GEMM.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:895 tcq4_matmul (_kernel at :782,
// _kernel_cast at :830) in its fast mode: C = bf16(a) @ bf16(q * eff) with f32
// accumulation, a being the dequantized rotated activations. The output is
// f32, or bf16 when the caller asks for it (padded M >= 1024, as the TPU
// kernel narrows its store there).
//
// Bound on the H100: operations at prefill M (2*M*K*N bf16 FLOPs against
// 4.625 bits per weight); at M = 16 the weight stream is about as long.
//
// Design: the shared tiled WMMA GEMM of gemm_bf16.cuh. One K tile is a
// quarter superblock: 32 byte rows of qs, whose low nibbles are one scale
// group (k = 32q .. 32q+31) and whose high nibbles are the group 128 later,
// so every qs byte is read once and every tile row has one eff per column.
// The unpacked int4 times the bf16 eff is rounded to bf16 in shared memory,
// exactly as the TPU kernel rounds its operand before the MXU pass.

#include "gemm_bf16.cuh"

namespace {

using namespace rrs::gemm;

// B tile for (superblock sb, quarter q): 32 byte rows x 64 columns of qs ->
// 64 bf16 k rows (0..31 low nibbles, 32..63 high nibbles).
__device__ __forceinline__ void load_b_tcq4(const uint8_t* __restrict__ qs,
                                            const __nv_bfloat16* __restrict__ eff, int N,
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
      elo = __bfloat162float(eff[static_cast<size_t>(g_lo) * N + gc]);
      ehi = __bfloat162float(eff[static_cast<size_t>(g_hi) * N + gc]);
    }
    const int lo = static_cast<int>(static_cast<uint32_t>(bytes[j]) << 28) >> 28;
    const int hi = static_cast<int>(static_cast<uint32_t>(bytes[j]) << 24) >> 28;
    sb_tile[r * kLdB + cb + j] = __float2bfloat16_rn(static_cast<float>(lo) * elo);
    sb_tile[(32 + r) * kLdB + cb + j] = __float2bfloat16_rn(static_cast<float>(hi) * ehi);
  }
}

template <int BM, typename OutT>
__global__ void __launch_bounds__(kThreads)
tcq4_gemm_kernel(const float* __restrict__ a, const uint8_t* __restrict__ qs,
                 const __nv_bfloat16* __restrict__ eff, OutT* __restrict__ out, int M, int K,
                 int N) {
  __shared__ Smem<BM> sm;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  Acc<BM> acc;
  acc.zero();
  const int nunits = (K / 256) * 4;
  for (int u = 0; u < nunits; ++u) {
    const int sb = u >> 2, q = u & 3;
    const int k0 = sb * 256 + q * 32;
    load_a<BM>(a, M, K, m0, k0, k0 + 128, sm.a);
    load_b_tcq4(qs, eff, N, sb, q, n0, sm.b);
    __syncthreads();
    acc.mma(sm.a, sm.b);
    __syncthreads();
  }
  acc.store(sm.c, out, M, N, m0, n0);
}

template <int BM>
int launch(const float* a, const uint8_t* qs, const __nv_bfloat16* eff, void* out, int M,
           int K, int N, bool out_bf16, cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  if (out_bf16)
    tcq4_gemm_kernel<BM, __nv_bfloat16><<<grid, kThreads, 0, s>>>(
        a, qs, eff, static_cast<__nv_bfloat16*>(out), M, K, N);
  else
    tcq4_gemm_kernel<BM, float><<<grid, kThreads, 0, s>>>(a, qs, eff, static_cast<float*>(out),
                                                          M, K, N);
  return rrs::status();
}

}  // namespace

RRS_EXPORT int rrs_tcq4_matmul(const void* a, const void* qs, const void* eff, void* out,
                               int M, int K, int N, int out_bf16, void* stream) {
  if (K % 256 != 0 || N % 8 != 0 || M < 1) return rrs::kBadArgs;
  const float* ap = static_cast<const float*>(a);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  const __nv_bfloat16* ep = static_cast<const __nv_bfloat16*>(eff);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch<16>(ap, qp, ep, out, M, K, N, out_bf16 != 0, s);
  return launch<64>(ap, qp, ep, out, M, K, N, out_bf16 != 0, s);
}
