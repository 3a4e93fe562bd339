// Q8_0 weight matmul (the lm_head): int8 [K, N] weights with one f32 scale
// per 32 rows, against bf16 or f32 activations, f32 out.
//
// Replaces rrs_tpu/ops/q8_matmul.py:48 q8_matmul (_kernel at :22):
// C = bf16(a) @ bf16(q * scale) with f32 accumulation, the rounding of the TPU
// kernel's single bf16 MXU pass.
//
// Bound on the H100: bytes at decode (K * N int8 + K/32 * N f32 scales, 0.44 GB
// for the padded 151936-token head of qwen3-4b, every step), operations at
// large prefill M.
//
// Design: the shared tiled WMMA GEMM of gemm_bf16.cuh with a BM = 16 row tile
// for M <= 16, so decode wastes 15/16 of a tensor-core tile but reads each
// weight byte once; 2400 column blocks at N = 153600 keep every SM streaming.
// A 64-deep K tile spans two scale groups; the dequantized tile is rounded to
// bf16 in shared memory.

#include "gemm_bf16.cuh"

namespace {

using namespace rrs::gemm;

__device__ __forceinline__ void load_b_q8(const int8_t* __restrict__ q,
                                          const float* __restrict__ scale, int N, int k0,
                                          int n0, __nv_bfloat16* sb_tile) {
  // 64 rows x 64 columns of int8: 256 chunks of 16 bytes, two per thread.
  for (int c = threadIdx.x; c < kBK * (kBN / 16); c += kThreads) {
    const int r = c / (kBN / 16);
    const int cb = (c % (kBN / 16)) * 16;
    const int row = k0 + r;
    const int gc0 = n0 + cb;
    uint4 packed;
    int8_t* vals = reinterpret_cast<int8_t*>(&packed);
    if ((N & 15) == 0 && gc0 + 16 <= N) {
      packed = __ldg(reinterpret_cast<const uint4*>(q + static_cast<size_t>(row) * N + gc0));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        vals[j] = (gc0 + j < N) ? q[static_cast<size_t>(row) * N + gc0 + j] : 0;
    }
    const float* srow = scale + static_cast<size_t>(row / 32) * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int gc = gc0 + j;
      const float s = gc < N ? __ldg(srow + gc) : 0.f;
      sb_tile[r * kLdB + cb + j] = __float2bfloat16_rn(static_cast<float>(vals[j]) * s);
    }
  }
}

template <int BM, typename InT>
__global__ void __launch_bounds__(kThreads)
q8_gemm_kernel(const InT* __restrict__ a, const int8_t* __restrict__ q,
               const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  __shared__ Smem<BM> sm;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  Acc<BM> acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a<BM>(a, M, K, m0, k0, k0 + 32, sm.a);
    load_b_q8(q, scale, N, k0, n0, sm.b);
    __syncthreads();
    acc.mma(sm.a, sm.b);
    __syncthreads();
  }
  acc.store(sm.c, out, M, N, m0, n0);
}

template <int BM, typename InT>
int launch(const InT* a, const int8_t* q, const float* scale, float* out, int M, int K, int N,
           cudaStream_t s) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  q8_gemm_kernel<BM, InT><<<grid, kThreads, 0, s>>>(a, q, scale, out, M, K, N);
  return rrs::status();
}

template <typename InT>
int dispatch(const void* a, const void* q, const void* scale, void* out, int M, int K, int N,
             cudaStream_t s) {
  const InT* ap = static_cast<const InT*>(a);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= 16) return launch<16, InT>(ap, qp, sp, op, M, K, N, s);
  return launch<64, InT>(ap, qp, sp, op, M, K, N, s);
}

}  // namespace

RRS_EXPORT int rrs_q8_matmul(const void* a, int a_is_bf16, const void* q, const void* scale,
                             void* out, int M, int K, int N, void* stream) {
  if (K % 64 != 0 || M < 1 || N < 1) return rrs::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_is_bf16) return dispatch<__nv_bfloat16>(a, q, scale, out, M, K, N, s);
  return dispatch<float>(a, q, scale, out, M, K, N, s);
}
