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
// Design: the shared tiled WMMA GEMM of gemm_bf16.cuh with the TCQ4 tile
// loader of tcq4_tile.cuh (one K tile is a quarter superblock).

#include "tcq4_tile.cuh"

namespace {

using namespace rrs::gemm;

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
