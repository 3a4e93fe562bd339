// W4A4 mixture-of-experts matmuls over stacked TCQ4 expert weights, f32 out:
//
//   B9  rrs_tcq4_experts_rows  out[i] = bf16(a[i]) @ W[ids[i]]         (decode)
//   B10 rrs_tcq4_all_experts   out[e] = bf16(a or a[e]) @ W[e]         (capacity)
//   B19 rrs_tcq4_experts_sel   out[i] = bf16(a) @ W[ids[i]]            (selected)
//
// Replace rrs_tpu/ops/tcq4_matmul.py:654 tcq4_matmul_experts_rows
// (_kernel_experts_rows at :638), :595 tcq4_matmul_all_experts
// (_kernel_all_experts at :577) and :536 tcq4_matmul_experts
// (_kernel_experts at :519). All compute as the TPU kernels do: the int4
// weight times its f32 group scale, rounded to bf16, against the activations
// rounded to bf16, with f32 sums; only the order of the sums differs from
// the plain versions.
//
// Layout (ops/tcq4_matmul.py): qs uint8 [E][K/2][N], byte row r of
// superblock s holding k = 256 s + r in its low nibble and k = 256 s + 128 + r
// in its high nibble; eff bf16 [E][K/32][N] (B19 also takes f32 eff, as its
// TPU kernel does). K is a multiple of 256, N of 8. Every weight byte is
// decoded on chip; no dequantized expert reaches memory.
//
// Bound on the H100: bytes for B9 and B19 at decode M (the selected experts'
// 4.625-bit weights, 0.88 MB per expert matrix at Qwen3-30B-A3B) and for B10
// at the capacities the model gives it (C = 24 .. 64: every expert's
// weights, 113 MB per projection at E = 128; with the per-expert
// activations and f32 outputs 0.051 ms at 3.35 TB/s against 0.026 ms of
// bf16 tensor-core work at C = 64); operations for B10 from about C = 250
// (gate / up) and C = 1,000 (down) rows on.
//
// Design. B10 and B19 run the pipelined prefill body of gemm_sm90.cuh on its
// expert grid (sm90::experts_kernel, through rrs::tcq4_experts and B4's TCQ4
// loader in tcq4_matmul.cu): block (strip, row tile, z) streams expert
// e(z)'s quarter superblocks through a 3-stage cp.async ring, dequantizing
// the next stage while it multiplies this one (ldmatrix into mma.sync
// m16n8k16), 64 x 128 tiles below 128 rows (the wrapper picks
// the row tile, ops/splitk.py experts_grid), two blocks an SM. At the model's
// capacities the grid has at least 768 blocks for the 264 block slots, so
// no K split is needed, and each weight byte is read once per row tile. The
// activations are bf16 (the wrappers round f32 ones first, as the kernel
// would). B10 takes e(z) = z, with a zero activation stride for shared
// activations; B19 is the same kernel over shared activations with z running
// over the selected experts, e(z) = ids[z] read on the device and clamped to
// [0, E), as B9 does, so with bf16 eff its out[i] is B10's out[ids[i]] bit
// for bit (same body, tile and K order at every M); with f32 eff it takes
// B17's f32-eff loader. B9 is a matrix-vector kernel on the CUDA cores, one
// block per (128 columns, selected row): the block reads its row's expert id
// on the device, holds the row of a in shared memory as bf16-rounded f32,
// and its eight warps split K by quarter superblocks (32 byte rows, two
// scale groups); each lane decodes four columns from 4-byte loads, so a warp
// reads 128 contiguous bytes of a byte row, and the warps' partial sums meet
// in shared memory.

#include "gemm_sm90.cuh"

namespace {

constexpr int kRowsWarps = 8;
constexpr int kRowsCols = 128;     // 32 lanes x 4 columns
constexpr int kRowsMaxK = 8192;    // the row of a in (dynamic) shared memory

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ float as_bf16_f32(float v) { return bf16_round(v); }
__device__ __forceinline__ float as_bf16_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// grid (ceil(N / 128), n_sel): out[row, n0 .. n0 + 127].
template <typename InT>
__global__ void __launch_bounds__(kRowsWarps * 32)
tcq4_rows_kernel(const InT* __restrict__ a, const uint8_t* __restrict__ qs,
                 const __nv_bfloat16* __restrict__ eff, const int* __restrict__ ids,
                 float* __restrict__ out, int K, int N, int n_exp) {
  extern __shared__ float sa[];
  __shared__ float red[kRowsWarps][kRowsCols];
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * kRowsCols;
  const int e = min(max(ids[row], 0), n_exp - 1);
  const InT* ar = a + static_cast<size_t>(row) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) sa[i] = as_bf16_f32(ar[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + lane * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < N) {                    // N % 8 == 0: all four columns are in range
    const uint8_t* qe = qs + static_cast<size_t>(e) * (K / 2) * N + col;
    const __nv_bfloat16* ee = eff + static_cast<size_t>(e) * (K / 32) * N + col;
    for (int u = warp; u < K / 64; u += kRowsWarps) {
      const int sb = u >> 2, q = u & 3;
      const int g_lo = sb * 8 + q;
      const uint2 elo = __ldg(reinterpret_cast<const uint2*>(ee + static_cast<size_t>(g_lo) * N));
      const uint2 ehi =
          __ldg(reinterpret_cast<const uint2*>(ee + static_cast<size_t>(g_lo + 4) * N));
      const __nv_bfloat16* el = reinterpret_cast<const __nv_bfloat16*>(&elo);
      const __nv_bfloat16* eh = reinterpret_cast<const __nv_bfloat16*>(&ehi);
      uint32_t qw[32];
#pragma unroll
      for (int j = 0; j < 32; ++j)
        qw[j] = __ldg(reinterpret_cast<const uint32_t*>(
            qe + static_cast<size_t>(sb * 128 + q * 32 + j) * N));
      const float* alo = sa + sb * 256 + q * 32;
      const float* ahi = alo + 128;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float sl = __bfloat162float(el[c]), sh = __bfloat162float(eh[c]);
        float sum = acc[c];
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          sum = fmaf(alo[j], bf16_round(static_cast<float>(rrs::nib_lo(qw[j], c)) * sl), sum);
          sum = fmaf(ahi[j], bf16_round(static_cast<float>(rrs::nib_hi(qw[j], c)) * sh), sum);
        }
        acc[c] = sum;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) red[warp][lane * 4 + c] = acc[c];
  __syncthreads();
  if (threadIdx.x < kRowsCols) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsWarps; ++w) v += red[w][threadIdx.x];
    const int gc = n0 + threadIdx.x;
    if (gc < N) out[static_cast<size_t>(row) * N + gc] = v;
  }
}

bool bad_shape(int M, int K, int N) { return M < 1 || K < 256 || K % 256 || N < 8 || N % 8; }

}  // namespace

RRS_EXPORT int rrs_tcq4_experts_rows(const void* a, int a_is_bf16, const void* qs,
                                     const void* eff, const void* ids, void* out, int n_sel,
                                     int K, int N, int n_exp, void* stream) {
  if (bad_shape(n_sel, K, N) || K > kRowsMaxK || n_exp < 1 || n_sel > 65535)
    return rrs::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRowsCols - 1) / kRowsCols, n_sel);
  const size_t smem = K * sizeof(float);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  const __nv_bfloat16* ep = static_cast<const __nv_bfloat16*>(eff);
  const int* ip = static_cast<const int*>(ids);
  float* op = static_cast<float*>(out);
  if (a_is_bf16)
    tcq4_rows_kernel<__nv_bfloat16><<<grid, kRowsWarps * 32, smem, s>>>(
        static_cast<const __nv_bfloat16*>(a), qp, ep, ip, op, K, N, n_exp);
  else
    tcq4_rows_kernel<float><<<grid, kRowsWarps * 32, smem, s>>>(static_cast<const float*>(a),
                                                                qp, ep, ip, op, K, N, n_exp);
  return rrs::status();
}

// a bf16 (the wrapper rounds f32 activations first); row_tile 64 or 128
// (ops/splitk.py experts_grid).
RRS_EXPORT int rrs_tcq4_all_experts(const void* a, int per_expert, const void* qs, const void* eff,
                                    void* out, int E, int T, int K, int N, int row_tile,
                                    void* stream) {
  if (bad_shape(T, K, N) || E < 1) return rrs::kBadArgs;
  const size_t a_stride = per_expert ? static_cast<size_t>(T) * K : 0;
  return rrs::tcq4_experts(static_cast<const __nv_bfloat16*>(a), a_stride,
                           static_cast<const uint8_t*>(qs), eff, false, nullptr, E,
                           static_cast<float*>(out), E, T, K, N, row_tile,
                           static_cast<cudaStream_t>(stream));
}

RRS_EXPORT int rrs_tcq4_experts_sel(const void* a, const void* qs, const void* eff,
                                    int eff_is_f32, const void* ids, void* out, int n_sel, int M,
                                    int K, int N, int n_exp, int row_tile, void* stream) {
  if (bad_shape(M, K, N) || n_exp < 1 || n_sel < 1) return rrs::kBadArgs;
  return rrs::tcq4_experts(static_cast<const __nv_bfloat16*>(a), 0,
                           static_cast<const uint8_t*>(qs), eff, eff_is_f32 != 0,
                           static_cast<const int*>(ids), n_exp, static_cast<float*>(out), n_sel,
                           M, K, N, row_tile, static_cast<cudaStream_t>(stream));
}
