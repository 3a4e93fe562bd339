// MXFP4 weight matmuls over gpt-oss's packed expert stacks, f32 out:
//
//   B11 rrs_mxfp4_matmul       C[M, N] = bf16(a[M, K]) @ W[K, N]
//   B12 rrs_mxfp4_rows         out[i] = bf16(a[i]) @ W[ids[i]]        (decode)
//   B13 rrs_mxfp4_all_experts  out[e] = bf16(a or a[e]) @ W[e]        (batched)
//
// Replace rrs_tpu/ops/mxfp4_matmul.py:157 mxfp4_matmul (_kernel at :141),
// :222 mxfp4_matmul_experts_rows (_kernel_rows at :212) and :279
// mxfp4_matmul_all_experts (_kernel_all at :268).
//
// Layout (ops/mxfp4_matmul.py): qs uint8 [E][K/2][N], byte row j holding the
// remapped e2m1 codes of k = 2j (low nibble) and 2j + 1 (high); sexp uint8
// [E][K/32][N], the f32 exponent field of the half block scale. A code decodes
// to the f32 bits (em << 22) + (sexp << 23), em = code & 7, sign in bit 31,
// and code 1 is zero: the bit formula of the TPU kernels, so every weight is
// exact in bf16 and only the order of the f32 sums differs from the plain
// versions. N and K are multiples of 64 (the loader pads N to 128); every
// weight byte is decoded on chip and no dequantized weight reaches memory.
//
// Bound on the H100: bytes for B12 (each selected expert's 4.25-bit tiles,
// 4.5 MB per projection at gpt-oss-20b) and for B13 at decode T; operations
// for B11 and B13 at prefill M.
//
// Design. B11 and B13 are the tiled WMMA GEMM of gemm_bf16.cuh (BM x 64 x 64
// tiles, 4 warps, f32 accumulators) with an MXFP4 tile loader: one 64-deep K
// tile is 32 byte rows by 64 columns, two scale groups; each of the 128
// threads reads one 16-byte run of one byte row (coalesced along N) and its 16
// scale bytes, and writes two bf16 rows of the tile. B13's experts are the
// grid's z axis, with a zero activation stride for shared activations. B12 is
// a matrix-vector kernel on the CUDA cores, one block per (128 columns,
// selected row): the expert id is read on the device, the bf16 row of a is
// held in shared memory as f32, eight warps split K by scale group, each lane
// decodes four columns from 4-byte loads (a warp reads 128 contiguous bytes
// of a byte row), and the warps' partial sums meet in shared memory. Loads
// are synchronous: cp.async / TMA rings and wgmma come with the change that
// makes these fast.

#include "gemm_bf16.cuh"

namespace {

using namespace rrs::gemm;

// f32 bit pattern of remapped code `code` (0..15) times 2^(sexp - 127).
__device__ __forceinline__ uint32_t fp4_bits(uint32_t code, uint32_t sexp) {
  const uint32_t em = code & 7u;
  const uint32_t mag = em == 1u ? 0u : (em << 22) + (sexp << 23);
  return mag | ((code & 8u) << 28);
}

__device__ __forceinline__ __nv_bfloat16 fp4_bf16(uint32_t code, uint32_t sexp) {
  // the low 16 bits of the f32 pattern are zero: bf16 is its top half
  return __ushort_as_bfloat16(static_cast<unsigned short>(fp4_bits(code, sexp) >> 16));
}

// The 64 (k) x 64 (n) bf16 tile at k0, n0 of one expert's packed weight.
__device__ __forceinline__ void load_b_mxfp4(const uint8_t* __restrict__ qs,
                                             const uint8_t* __restrict__ sexp, int N, int k0,
                                             int n0, __nv_bfloat16* sb) {
  const int r = threadIdx.x >> 2;           // byte row of the tile, 0..31
  const int cb = (threadIdx.x & 3) * 16;    // first of 16 columns
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(
      qs + static_cast<size_t>(k0 / 2 + r) * N + n0 + cb));
  const uint4 s = __ldg(reinterpret_cast<const uint4*>(
      sexp + static_cast<size_t>(k0 / 32 + r / 16) * N + n0 + cb));
  const uint8_t* qb = reinterpret_cast<const uint8_t*>(&q);
  const uint8_t* se = reinterpret_cast<const uint8_t*>(&s);
  __nv_bfloat16* lo = sb + (2 * r) * kLdB + cb;
  __nv_bfloat16* hi = lo + kLdB;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint32_t byte = qb[j], e = se[j];
    lo[j] = fp4_bf16(byte & 15u, e);
    hi[j] = fp4_bf16(byte >> 4, e);
  }
}

static_assert(kThreads == 128 && kBK == 64 && kBN == 64,
              "load_b_mxfp4 maps 128 threads onto 32 byte rows x 4 runs of 16 columns");

// grid (N / 64, ceil(M / BM), E): expert blockIdx.z, its activations at
// a + e * a_stride (0: shared), its output at out + e * M * N.
template <int BM, typename InT>
__global__ void __launch_bounds__(kThreads)
mxfp4_gemm_kernel(const InT* __restrict__ a, size_t a_stride, const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ sexp, float* __restrict__ out, int M, int K,
                  int N) {
  __shared__ Smem<BM> sm;
  const size_t e = blockIdx.z;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  a += e * a_stride;
  qs += e * (K / 2) * static_cast<size_t>(N);
  sexp += e * (K / 32) * static_cast<size_t>(N);
  out += e * M * static_cast<size_t>(N);
  Acc<BM> acc;
  acc.zero();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    load_a<BM>(a, M, K, m0, k0, k0 + 32, sm.a);
    load_b_mxfp4(qs, sexp, N, k0, n0, sm.b);
    __syncthreads();
    acc.mma(sm.a, sm.b);
    __syncthreads();
  }
  acc.store(sm.c, out, M, N, m0, n0);
}

template <typename InT>
int launch_gemm(const void* a, size_t a_stride, const void* qs, const void* sexp, void* out,
                int E, int M, int K, int N, cudaStream_t s) {
  const InT* ap = static_cast<const InT*>(a);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  const uint8_t* sp = static_cast<const uint8_t*>(sexp);
  float* op = static_cast<float*>(out);
  if (M <= 16) {
    const dim3 grid(N / kBN, (M + 15) / 16, E);
    mxfp4_gemm_kernel<16, InT><<<grid, kThreads, 0, s>>>(ap, a_stride, qp, sp, op, M, K, N);
  } else {
    const dim3 grid(N / kBN, (M + 63) / 64, E);
    mxfp4_gemm_kernel<64, InT><<<grid, kThreads, 0, s>>>(ap, a_stride, qp, sp, op, M, K, N);
  }
  return rrs::status();
}

constexpr int kRowsWarps = 8;
constexpr int kRowsCols = 128;     // 32 lanes x 4 columns
constexpr int kRowsMaxK = 8192;    // the row of a in (dynamic) shared memory

// grid (ceil(N / 128), n_sel): out[row, n0 .. n0 + 127].
__global__ void __launch_bounds__(kRowsWarps * 32)
mxfp4_rows_kernel(const __nv_bfloat16* __restrict__ a, const uint8_t* __restrict__ qs,
                  const uint8_t* __restrict__ sexp, const int* __restrict__ ids,
                  float* __restrict__ out, int K, int N, int n_exp) {
  extern __shared__ float sa[];
  __shared__ float red[kRowsWarps][kRowsCols];
  const int row = blockIdx.y;
  const int n0 = blockIdx.x * kRowsCols;
  const int e = min(max(ids[row], 0), n_exp - 1);
  const __nv_bfloat16* ar = a + static_cast<size_t>(row) * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) sa[i] = __bfloat162float(ar[i]);
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + lane * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (col < N) {
    const uint8_t* qe = qs + static_cast<size_t>(e) * (K / 2) * N + col;
    const uint8_t* se = sexp + static_cast<size_t>(e) * (K / 32) * N + col;
    for (int g = warp; g < K / 32; g += kRowsWarps) {
      const uint32_t s4 = __ldg(reinterpret_cast<const uint32_t*>(se + static_cast<size_t>(g) * N));
      uint32_t q[16];
#pragma unroll
      for (int j = 0; j < 16; ++j)
        q[j] = __ldg(reinterpret_cast<const uint32_t*>(qe + static_cast<size_t>(g * 16 + j) * N));
      const float* ag = sa + g * 32;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t sc = (s4 >> (8 * c)) & 0xffu;
        float sum = acc[c];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t byte = (q[j] >> (8 * c)) & 0xffu;
          sum = fmaf(ag[2 * j], __uint_as_float(fp4_bits(byte & 15u, sc)), sum);
          sum = fmaf(ag[2 * j + 1], __uint_as_float(fp4_bits(byte >> 4, sc)), sum);
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

bool bad_shape(int M, int K, int N) { return M < 1 || K < 64 || K % 64 || N < 64 || N % 64; }

}  // namespace

RRS_EXPORT int rrs_mxfp4_matmul(const void* a, int a_is_bf16, const void* qs, const void* sexp,
                                void* out, int M, int K, int N, void* stream) {
  if (bad_shape(M, K, N) || (M + 15) / 16 > 65535) return rrs::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_is_bf16) return launch_gemm<__nv_bfloat16>(a, 0, qs, sexp, out, 1, M, K, N, s);
  return launch_gemm<float>(a, 0, qs, sexp, out, 1, M, K, N, s);
}

RRS_EXPORT int rrs_mxfp4_rows(const void* a, const void* qs, const void* sexp, const void* ids,
                              void* out, int n_sel, int K, int N, int n_exp, void* stream) {
  if (bad_shape(n_sel, K, N) || K > kRowsMaxK || n_exp < 1 || n_sel > 65535)
    return rrs::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + kRowsCols - 1) / kRowsCols, n_sel);
  mxfp4_rows_kernel<<<grid, kRowsWarps * 32, K * sizeof(float), s>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(qs),
      static_cast<const uint8_t*>(sexp), static_cast<const int*>(ids), static_cast<float*>(out),
      K, N, n_exp);
  return rrs::status();
}

RRS_EXPORT int rrs_mxfp4_all_experts(const void* a, int per_expert, const void* qs,
                                     const void* sexp, void* out, int E, int T, int K, int N,
                                     void* stream) {
  if (bad_shape(T, K, N) || E < 1 || E > 65535 || (T + 15) / 16 > 65535) return rrs::kBadArgs;
  const size_t a_stride = per_expert ? static_cast<size_t>(T) * K : 0;
  return launch_gemm<__nv_bfloat16>(a, a_stride, qs, sexp, out, E, T, K, N,
                                    static_cast<cudaStream_t>(stream));
}
