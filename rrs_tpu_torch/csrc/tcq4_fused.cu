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
// the dot below is B4's, tile for tile.
//
// Bound on the H100: operations. The dot is 2 M K N bf16 FLOPs on the
// tensor cores; the rotation 2 M K 256 f32 FLOPs on the CUDA cores if done
// once per row, but this kernel, like the TPU one, redoes it for every
// 64-column tile of N (N / 64 times the work), and unfused sequential sums
// cannot use the tensor cores or the fma.
//
// Design: the tiled WMMA GEMM of gemm_bf16.cuh (BM x 64 x 64 tiles, 4 warps)
// with a prologue per (M tile, superblock): the block stages its BM rows of
// x_sb in shared memory as f32; then, 16 rows at a time, each thread owns two
// columns (i and i + 128) and walks j in order, with had streamed through
// shared memory 32 rows (32 KB) at a time (the f32 had is 256 KB, more than
// a block's 227 KB); the rotated rows overwrite x_sb in place. One warp per
// row takes the amax by shuffles and quantize-dequantizes the row in place.
// Then the superblock's four quarter units run exactly as in B4: an A tile of
// 32 + 32 columns (k and k + 128) rounded to bf16, the TCQ4 B tile of
// tcq4_tile.cuh, one 64-deep mma step each.

#include "tcq4_tile.cuh"

namespace {

using namespace rrs::gemm;

constexpr int kSB = 256;        // superblock width
constexpr int kHadRows = 32;    // rows of had staged at a time
constexpr int kRowChunk = 16;   // rotated rows in registers at a time

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <int BM>
constexpr size_t dyn_bytes() {
  return (static_cast<size_t>(BM) + kHadRows) * kSB * sizeof(float);
}

// grid (ceil(N / 64), ceil(M / BM)); dynamic shared memory dyn_bytes<BM>().
template <int BM, typename InT, typename EffT>
__global__ void __launch_bounds__(kThreads)
tcq4_fused_kernel(const InT* __restrict__ x, const float* __restrict__ had,
                  const uint8_t* __restrict__ qs, const EffT* __restrict__ eff,
                  float* __restrict__ out, int M, int K, int N) {
  static_assert(kThreads == 128 && BM % kRowChunk == 0, "two columns of 256 per thread");
  __shared__ Smem<BM> sm;
  extern __shared__ __align__(16) float dyn[];
  float* xs = dyn;                  // [BM][256]: x_sb, then rot, then a
  float* hs = dyn + BM * kSB;       // [kHadRows][256]
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  Acc<BM> acc;
  acc.zero();
  for (int sb = 0; sb < K / kSB; ++sb) {
    for (int idx = tid; idx < BM * kSB; idx += kThreads) {
      const int gr = m0 + idx / kSB;
      xs[idx] = gr < M ? to_f32(x[static_cast<size_t>(gr) * K + sb * kSB + idx % kSB]) : 0.f;
    }
    for (int rc = 0; rc < BM; rc += kRowChunk) {
      float r0[kRowChunk], r1[kRowChunk];
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) r0[r] = r1[r] = 0.f;
      for (int j0 = 0; j0 < kSB; j0 += kHadRows) {
        __syncthreads();            // xs staged or written; hs no longer read
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
          for (int r = 0; r < kRowChunk; ++r) {
            const float4 xv = *reinterpret_cast<const float4*>(xs + (rc + r) * kSB + j0 + jj);
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
      __syncthreads();              // every thread is done reading these rows of x_sb
#pragma unroll
      for (int r = 0; r < kRowChunk; ++r) {
        xs[(rc + r) * kSB + tid] = r0[r];
        xs[(rc + r) * kSB + tid + 128] = r1[r];
      }
    }
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < BM; r += kThreads / 32) {
      float* row = xs + r * kSB;
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
#pragma unroll
      for (int t = 0; t < kSB / 32; ++t)
        row[lane + 32 * t] = __fmul_rn(fminf(fmaxf(rintf(__fmul_rn(v[t], s)), -7.f), 7.f), d);
    }
    __syncthreads();
    for (int q = 0; q < 4; ++q) {
      for (int c = tid; c < BM * (kBK / 4); c += kThreads) {
        const int row = c / (kBK / 4);
        const int kk = (c % (kBK / 4)) * 4;
        const int col = kk < 32 ? q * 32 + kk : 128 + q * 32 + (kk - 32);
        to_bf16x4(*reinterpret_cast<const float4*>(xs + row * kSB + col), sm.a + row * kLdA + kk);
      }
      load_b_tcq4(qs, eff, N, sb, q, n0, sm.b);
      __syncthreads();
      acc.mma(sm.a, sm.b);
      __syncthreads();
    }
  }
  acc.store(sm.c, out, M, N, m0, n0);
}

template <int BM, typename InT, typename EffT>
int launch(const void* x, const float* had, const uint8_t* qs, const void* eff, float* out, int M,
           int K, int N, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(tcq4_fused_kernel<BM, InT, EffT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(dyn_bytes<BM>())) != cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM);
  tcq4_fused_kernel<BM, InT, EffT><<<grid, kThreads, dyn_bytes<BM>(), s>>>(
      static_cast<const InT*>(x), had, qs, static_cast<const EffT*>(eff), out, M, K, N);
  return rrs::status();
}

template <typename InT, typename EffT>
int launch_m(const void* x, const float* had, const uint8_t* qs, const void* eff, float* out,
             int M, int K, int N, cudaStream_t s) {
  if (M <= 16) return launch<16, InT, EffT>(x, had, qs, eff, out, M, K, N, s);
  return launch<64, InT, EffT>(x, had, qs, eff, out, M, K, N, s);
}

}  // namespace

RRS_EXPORT int rrs_tcq4_fused(const void* x, int x_is_bf16, const void* had, const void* qs,
                              const void* eff, int eff_is_f32, void* out, int M, int K, int N,
                              void* stream) {
  if (M < 1 || K < 256 || K % 256 != 0 || N < 8 || N % 8 != 0 || (M + 63) / 64 > 65535)
    return rrs::kBadArgs;
  const auto* hp = static_cast<const float*>(had);
  const auto* qp = static_cast<const uint8_t*>(qs);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16 && eff_is_f32)
    return launch_m<__nv_bfloat16, float>(x, hp, qp, eff, op, M, K, N, s);
  if (x_is_bf16) return launch_m<__nv_bfloat16, __nv_bfloat16>(x, hp, qp, eff, op, M, K, N, s);
  if (eff_is_f32) return launch_m<float, float>(x, hp, qp, eff, op, M, K, N, s);
  return launch_m<float, __nv_bfloat16>(x, hp, qp, eff, op, M, K, N, s);
}
