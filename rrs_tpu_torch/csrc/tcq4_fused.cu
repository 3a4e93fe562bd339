// W4A4 matmul with the activation rotation and quantization fused, f32 out:
//
//   out = bf16(quant(x_sb @ had)) @ bf16(q * eff)      per 256-superblock sb
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:732 tcq4_matmul_fused (_kernel_fused
// at :700). x is f32 or bf16 [M, K] and unrotated, had any f32 [256, 256]
// (the normalized Hadamard in use), qs / eff the TCQ4 weights (eff bf16 or
// f32). Per row and superblock: rot = x_sb @ had in f32; amax = max |rot|
// (1 where it is below 1e-10); a = clip(rint(rot * (7 / amax)), -7, 7) *
// (amax / 7), both quotients true divisions, as JAX writes it; then the bf16
// dot of a against bf16(q * f32(eff)) with f32 sums. Unlike tcq4_matmul (B4)
// the output is f32 at every M.
//
// The order of the rotation's sums is fixed, because an int4 code at a
// half-way point flips with the last bit of rot: rot[i] = sum over j = 0,
// 1, ..., 255 in turn of x[j] * had[j, i], from +0, each product and each
// sum rounded to nearest (__fmul_rn / __fadd_rn, never contracted to an
// fma). ops/tcq4_matmul.py fused_rotate repeats that order, so the plain
// version's codes equal the kernel's bit for bit, and given those
// activations B4 (tcq4_matmul.cu) returns this kernel's output bit for bit:
// the dot is B4's own body with B4's split-K plan.
//
// Bound on the H100: operations. The dot is 2 M K N bf16 FLOPs on the
// tensor cores; the rotation 2 M K 256 f32 FLOPs on the CUDA cores, done
// once per row and superblock, as unfused sequential sums that cannot use
// the tensor cores or the fma.
//
// Design: two launches in one call. The prologue (rotate_kernel, grid
// (K / 256, ceil(M / 16)), 128 threads) stages 16 rows of x_sb in shared
// memory as f32; each thread owns two columns (i and i + 128) and walks j in
// order, with had streamed through shared memory 32 rows (32 KB) at a time
// (the f32 had is 256 KB, more than a block's 227 KB); one warp per row
// takes the amax by shuffles and quantize-dequantizes the row; the rows go,
// rounded to bf16 as the dot rounds them, to the caller's [M, K] scratch.
// Then B4's body (tcq4_gemm, tcq4_matmul.cu) runs the dot on that scratch
// with the caller's split-K plan, so the output is B4's on those
// activations, bit for bit.

#include "gemm_sm90.cuh"

namespace {

constexpr int kSB = 256;        // superblock width
constexpr int kHadRows = 32;    // rows of had staged at a time
constexpr int kRows = 16;       // rows of x per block
constexpr int kThreads = 128;
constexpr size_t kDynBytes = static_cast<size_t>(kRows + kHadRows) * kSB * sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename InT>
__global__ void __launch_bounds__(kThreads)
rotate_kernel(const InT* __restrict__ x, const float* __restrict__ had,
              __nv_bfloat16* __restrict__ act, int M, int K) {
  extern __shared__ __align__(16) float dyn[];
  float* xs = dyn;                  // [kRows][256]: x_sb, then rot
  float* hs = dyn + kRows * kSB;    // [kHadRows][256]
  const int tid = threadIdx.x;
  const int sb = blockIdx.x, m0 = blockIdx.y * kRows;
  for (int idx = tid; idx < kRows * kSB; idx += kThreads) {
    const int gr = m0 + idx / kSB;
    xs[idx] = gr < M ? to_f32(x[static_cast<size_t>(gr) * K + sb * kSB + idx % kSB]) : 0.f;
  }
  float r0[kRows], r1[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) r0[r] = r1[r] = 0.f;
  for (int j0 = 0; j0 < kSB; j0 += kHadRows) {
    __syncthreads();                // xs staged; hs no longer read
    const float4* src = reinterpret_cast<const float4*>(had + static_cast<size_t>(j0) * kSB);
    for (int idx = tid; idx < kHadRows * kSB / 4; idx += kThreads)
      reinterpret_cast<float4*>(hs)[idx] = __ldg(src + idx);
    __syncthreads();
#pragma unroll 2
    for (int jj = 0; jj < kHadRows; jj += 4) {
      float h0[4], h1[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        h0[t] = hs[(jj + t) * kSB + tid];
        h1[t] = hs[(jj + t) * kSB + tid + 128];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 xv = *reinterpret_cast<const float4*>(xs + r * kSB + j0 + jj);
        r0[r] = __fadd_rn(r0[r], __fmul_rn(xv.x, h0[0]));
        r0[r] = __fadd_rn(r0[r], __fmul_rn(xv.y, h0[1]));
        r0[r] = __fadd_rn(r0[r], __fmul_rn(xv.z, h0[2]));
        r0[r] = __fadd_rn(r0[r], __fmul_rn(xv.w, h0[3]));
        r1[r] = __fadd_rn(r1[r], __fmul_rn(xv.x, h1[0]));
        r1[r] = __fadd_rn(r1[r], __fmul_rn(xv.y, h1[1]));
        r1[r] = __fadd_rn(r1[r], __fmul_rn(xv.z, h1[2]));
        r1[r] = __fadd_rn(r1[r], __fmul_rn(xv.w, h1[3]));
      }
    }
  }
  __syncthreads();                  // every thread is done reading x_sb
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    xs[r * kSB + tid] = r0[r];
    xs[r * kSB + tid + 128] = r1[r];
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    if (m0 + r >= M) break;
    const float* row = xs + r * kSB;
    float v[kSB / 32];
    float amax = 0.f;
#pragma unroll
    for (int t = 0; t < kSB / 32; ++t) {
      v[t] = row[lane + 32 * t];
      amax = fmaxf(amax, fabsf(v[t]));
    }
    amax = rrs::warp_max(amax);
    if (amax < 1e-10f) amax = 1.f;
    const float s = __fdiv_rn(7.f, amax), d = __fdiv_rn(amax, 7.f);
    __nv_bfloat16* dst = act + static_cast<size_t>(m0 + r) * K + sb * kSB;
#pragma unroll
    for (int t = 0; t < kSB / 32; ++t)
      dst[lane + 32 * t] = __float2bfloat16_rn(
          __fmul_rn(fminf(fmaxf(rintf(__fmul_rn(v[t], s)), -7.f), 7.f), d));
  }
}

template <typename InT>
int rotate(const void* x, const float* had, __nv_bfloat16* act, int M, int K, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(rotate_kernel<InT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kDynBytes)) != cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const dim3 grid(K / kSB, (M + kRows - 1) / kRows);
  rotate_kernel<InT><<<grid, kThreads, kDynBytes, s>>>(static_cast<const InT*>(x), had, act, M,
                                                       K);
  return rrs::status();
}

}  // namespace

// act: bf16 [M, K] scratch for the quantized activations; slice_units,
// scratch and counters: B4's split-K plan for (M, K, N) (ops/splitk.py).
RRS_EXPORT int rrs_tcq4_fused(const void* x, int x_is_bf16, const void* had, const void* qs,
                              const void* eff, int eff_is_f32, void* act, void* out, int M, int K,
                              int N, int slice_units, void* scratch, void* counters,
                              void* stream) {
  if (M < 1 || K < 256 || K % 256 != 0 || N < 8 || N % 8 != 0 || (M + kRows - 1) / kRows > 65535)
    return rrs::kBadArgs;
  const auto* hp = static_cast<const float*>(had);
  auto* ap = static_cast<__nv_bfloat16*>(act);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int code = x_is_bf16 ? rotate<__nv_bfloat16>(x, hp, ap, M, K, s)
                             : rotate<float>(x, hp, ap, M, K, s);
  if (code != 0) return code;
  return rrs::tcq4_gemm(ap, true, static_cast<const uint8_t*>(qs), eff, eff_is_f32 != 0, out,
                        false, M, K, N, slice_units, static_cast<float*>(scratch),
                        static_cast<int*>(counters), s);
}
