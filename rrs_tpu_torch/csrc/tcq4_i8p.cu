// W4A4 prefill matmul on the int8 tensor cores, over the int8-superblock
// requantized weight pack.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:1107 tcq4_matmul_i8p (_kernel_i8p at
// :1086, pack_i8p :1059, prep_a_sbi :1079). For each 256-row superblock sb:
//     w8[r, n] = (w4[r, n] * f8[sb*8 + r%8, n] + 4) >> 3        in [-127, 127]
//     p[m, n]  = sum_r a_sbi[m, sb*256 + r] * w8[r, n]          (exact int32)
//     acc     += p * (e2[sb, n] * (a_scale[m, sb] / 7))         (f32)
// in the group-interleaved ("sbi") row order that the pack and the
// activations share; the low nibbles of the 128 byte rows of a superblock are
// rows 0..127 and the high nibbles rows 128..255. Output f32, or bf16 when the
// caller asks for it (padded M >= 1024, as the TPU kernel narrows its store).
//
// Bound on the H100: operations at prefill M (2*M*K*N int8 ops against
// 0.5625 bytes per weight); at M = 256 the weight stream is about a third of
// the time at the int8 peak.
//
// Design: a plain tiled GEMM with mma.sync.m16n8k32 s8 x s8 -> s32. A block
// owns a 64 x 64 output tile and walks the superblocks. Per superblock it
// copies the 64 x 256 int8 activation tile into shared memory and decodes its
// 128 x 64 byte tile of qs_sbi into w8, stored column-major (k contiguous per
// column) so that each thread's B fragment is one 32-bit shared load; a 4 x 4
// byte transpose (__byte_perm) turns four row loads of four columns into four
// column words. Four warps each take a 32 x 32 sub-tile, run the 8 k-steps of
// the superblock into int32 fragments, and fold them into f32 accumulators
// with the rank-1 scale, in the JAX kernel's operation order. Loads are
// synchronous (no cp.async or TMA ring, no wgmma): the change that makes this
// kernel fast adds those.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kSB = 256;                 // superblock depth (k)
constexpr int kLd = kSB + 16;            // smem row stride in bytes: 68 words, so the
                                         // 8 rows x 4 words of a fragment hit 32 banks

struct Smem {
  __align__(16) int8_t a[kBM * kLd];     // [m][k] activations, sbi order
  __align__(16) int8_t b[kBN * kLd];     // [n][k] decoded w8
  __align__(16) int8_t f[8 * kBN];       // f8 rows of the superblock
  float e2[kBN];
  float as7[kBM];                        // a_scale / 7
};

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// w8 of one signed nibble times one int8 ratio, as a byte.
__device__ __forceinline__ uint32_t w8_byte(int w4, int f) {
  return static_cast<uint32_t>((w4 * f + 4) >> 3) & 0xffu;
}

__device__ void load_tiles(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
                           const uint8_t* __restrict__ qs, const int8_t* __restrict__ f8,
                           const float* __restrict__ e2, int M, int K, int N, int m0, int n0,
                           int sb, Smem& sm) {
  const int tid = threadIdx.x;
  const int nsb = K / kSB;
  // activations: 64 rows x 256 bytes, 16 bytes a thread per step
  for (int c = tid; c < kBM * (kSB / 16); c += kThreads) {
    const int row = c / (kSB / 16);
    const int col = (c % (kSB / 16)) * 16;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + row < M)
      v = *reinterpret_cast<const uint4*>(a + static_cast<size_t>(m0 + row) * K + sb * kSB + col);
    *reinterpret_cast<uint4*>(sm.a + row * kLd + col) = v;
  }
  for (int r = tid; r < kBM; r += kThreads)
    sm.as7[r] = (m0 + r < M) ? __fmul_rn(a_scale[static_cast<size_t>(m0 + r) * nsb + sb],
                                         1.0f / 7.0f)
                             : 0.0f;
  // f8 rows and e2 of the superblock (columns past N read as 0)
  for (int c = tid; c < 8 * (kBN / 4); c += kThreads) {
    const int g = c / (kBN / 4);
    const int col = (c % (kBN / 4)) * 4;
    uint32_t v = 0u;
    if (n0 + col < N)
      v = *reinterpret_cast<const uint32_t*>(f8 + static_cast<size_t>(sb * 8 + g) * N + n0 + col);
    *reinterpret_cast<uint32_t*>(sm.f + g * kBN + col) = v;
  }
  for (int c = tid; c < kBN; c += kThreads)
    sm.e2[c] = (n0 + c < N) ? e2[static_cast<size_t>(sb) * N + n0 + c] : 0.0f;
  __syncthreads();
  // weights: units of 4 byte rows x 4 columns; 32 row groups x 16 column groups
  for (int u = tid; u < (kSB / 2 / 4) * (kBN / 4); u += kThreads) {
    const int cg = u % (kBN / 4), rg = u / (kBN / 4);
    const int col = cg * 4, rr = rg * 4;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (n0 + col < N) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = __ldg(reinterpret_cast<const uint32_t*>(
            qs + static_cast<size_t>(sb * (kSB / 2) + rr + i) * N + n0 + col));
    }
    // row rr+i (and 128+rr+i) takes f8 row (rr+i) % 8 of the superblock
    uint32_t lo[4], hi[4];      // lo[c] / hi[c]: 4 k bytes of column col+c
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t wl = 0u, wh = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int f = sm.f[((rr + i) & 7) * kBN + col + c];
        wl |= w8_byte(rrs::nib_lo(v[i], c), f) << (8 * i);
        wh |= w8_byte(rrs::nib_hi(v[i], c), f) << (8 * i);
      }
      lo[c] = wl;
      hi[c] = wh;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<uint32_t*>(sm.b + (col + c) * kLd + rr) = lo[c];
      *reinterpret_cast<uint32_t*>(sm.b + (col + c) * kLd + kSB / 2 + rr) = hi[c];
    }
  }
  __syncthreads();
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
i8p_kernel(const int8_t* __restrict__ a, const float* __restrict__ a_scale,
           const uint8_t* __restrict__ qs, const int8_t* __restrict__ f8,
           const float* __restrict__ e2, OutT* __restrict__ out, int M, int K, int N) {
  __shared__ Smem sm;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t = lane & 3;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.0f;

  for (int sb = 0; sb < K / kSB; ++sb) {
    load_tiles(a, a_scale, qs, f8, e2, M, K, N, m0, n0, sb, sm);
    int p[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[i][j][r] = 0;
#pragma unroll
    for (int k0 = 0; k0 < kSB; k0 += 32) {
      uint32_t af[2][4], bf[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int8_t* base = sm.a + (wm + i * 16 + g) * kLd + k0 + t * 4;
        af[i][0] = lds32(base);
        af[i][1] = lds32(base + 8 * kLd);
        af[i][2] = lds32(base + 16);
        af[i][3] = lds32(base + 8 * kLd + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* base = sm.b + (wn + j * 8 + g) * kLd + k0 + t * 4;
        bf[j][0] = lds32(base);
        bf[j][1] = lds32(base + 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(p[i][j], af[i], bf[j]);
    }
    // rank-1 epilogue of the superblock: acc += p * (e2[n] * a_scale[m] / 7)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = wm + i * 16 + g + (r >> 1) * 8;
          const int col = wn + j * 8 + t * 2 + (r & 1);
          const float s = __fmul_rn(sm.e2[col], sm.as7[row]);
          acc[i][j][r] = __fadd_rn(acc[i][j][r], __fmul_rn(static_cast<float>(p[i][j][r]), s));
        }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = m0 + wm + i * 16 + g + (r >> 1) * 8;
        const int col = n0 + wn + j * 8 + t * 2 + (r & 1);
        if (row < M && col < N) store(out + static_cast<size_t>(row) * N + col, acc[i][j][r]);
      }
}

}  // namespace

RRS_EXPORT int rrs_tcq4_i8p(const void* a, const void* a_scale, const void* qs, const void* f8,
                            const void* e2, void* out, int M, int K, int N, int out_bf16,
                            void* stream) {
  if (K % kSB != 0 || N % 4 != 0 || M < 1) return rrs::kBadArgs;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const float* sp = static_cast<const float*>(a_scale);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  const int8_t* fp = static_cast<const int8_t*>(f8);
  const float* ep = static_cast<const float*>(e2);
  if (out_bf16)
    i8p_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(ap, sp, qp, fp, ep,
                                                        static_cast<__nv_bfloat16*>(out), M, K, N);
  else
    i8p_kernel<float><<<grid, kThreads, 0, s>>>(ap, sp, qp, fp, ep, static_cast<float*>(out), M,
                                                K, N);
  return rrs::status();
}
