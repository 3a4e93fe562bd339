// Q8_0 weight matmul (the lm_head, and gpt-oss's attention projections):
// int8 [K, N] weights with one f32 scale per 32 rows, against bf16 or f32
// activations, f32 out.
//
// Replaces rrs_tpu/ops/q8_matmul.py:48 q8_matmul (_kernel at :22):
// C = bf16(a) @ bf16(q * scale) with f32 accumulation, the rounding of the TPU
// kernel's single bf16 MXU pass: q * scale is rounded to f32, then to bf16.
//
// Bound on the H100: bytes at decode (1.125 bytes a weight: K * N int8 plus
// K/32 * N f32 scales; 0.44 GB for the padded 153,600-token head of
// qwen3-4b, 17 MB for gpt-oss's qkv), operations at large prefill M.
//
// Design: the two bodies of gemm_sm90.cuh with this loader. Decode (M <= 16)
// is the split-K stream: a thread's unit is one scale group, 2 x 4 rows of
// 16 bytes and its 16 columns' scales as 4 float4; an int8 becomes an exact
// f32 by a byte permute into 2^23 (no conversion instruction), times its
// scale, then a bf16 pair. Prefill (M > 16) is the pipelined GEMM on bf16
// activations (the wrapper rounds f32 ones first): a stage is 64 rows of
// 128 bytes and their two scale rows.

#include "gemm_sm90.cuh"

namespace {

using namespace rrs::sm90;

template <typename InT>
struct Q8 {
  struct Params {
    const InT* a;
    const int8_t* q;
    const float* scale;
  };

  // -- decode: an inner unit is one 32-row scale group
  static constexpr int kUnitK = 32;
  static constexpr int kInner = 1;
  struct Raw {
    uint4 w[2][4];   // [16-row step][row 4t + r], 16 columns
    float4 s[4];     // the 16 columns' scales
  };

  static __device__ __forceinline__ void load(Raw& raw, const Params& p, int grp, int col, int t,
                                              int N) {
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        raw.w[st][r] = load16(p.q + static_cast<size_t>(grp * 32 + st * 16 + 4 * t + r) * N, col,
                              N);
    const float* srow = p.scale + static_cast<size_t>(grp) * N;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint4 v = load16(srow, col + 4 * c, N);
      raw.s[c] = make_float4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z),
                             __uint_as_float(v.w));
    }
  }

  template <int MT>
  static __device__ __forceinline__ void compute(const Raw& raw, float (&acc)[MT][8][4],
                                                 const Params& p, int grp, int g, int t, int M,
                                                 int K) {
    const float* s = reinterpret_cast<const float*>(raw.s);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int k = grp * 32 + st * 16 + 4 * t;
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) act4(p.a, M, K, mt * 8 + g, k, b[mt][0], b[mt][1]);
      uint32_t w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[r][0] = raw.w[st][r].x ^ 0x80808080u;
        w[r][1] = raw.w[st][r].y ^ 0x80808080u;
        w[r][2] = raw.w[st][r].z ^ 0x80808080u;
        w[r][3] = raw.w[st][r].w ^ 0x80808080u;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c0 = 2 * j, c1 = 2 * j + 1;
        float f[4][2];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          f[r][0] = s8_f32(w[r][c0 >> 2], c0 & 3) * s[c0];
          f[r][1] = s8_f32(w[r][c1 >> 2], c1 & 3) * s[c1];
        }
        const uint32_t a0 = pack_bf16(f[0][0], f[1][0]), a1 = pack_bf16(f[0][1], f[1][1]);
        const uint32_t a2 = pack_bf16(f[2][0], f[3][0]), a3 = pack_bf16(f[2][1], f[3][1]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(acc[mt][j], a0, a1, a2, a3, b[mt][0], b[mt][1]);
      }
    }
  }

  // -- prefill: a stage is 64 contiguous rows (two scale groups)
  static constexpr int kQBytes = kBK * kBN;
  static constexpr int kRawBytes = kQBytes + 2 * kBN * 4;

  static __device__ __forceinline__ void runs(int u, int& k0, int& k1) {
    k0 = u * kBK;
    k1 = k0 + 32;
  }

  static __device__ __forceinline__ void issue(unsigned char* raw, const Params& p, int u, int n0,
                                               int N, int tid) {
    for (int c = tid; c < kQBytes / 16; c += kPrefillThreads) {
      const int r = c / (kBN / 16), cc = (c % (kBN / 16)) * 16;
      copy_chunk(raw + r * kBN + cc, p.q + static_cast<size_t>(u * kBK + r) * N, n0 + cc, N);
    }
    if (tid < 2 * kBN / 4) {
      const int r = tid / (kBN / 4), cc = (tid % (kBN / 4)) * 4;
      copy_chunk(raw + kQBytes + (r * kBN + cc) * 4,
                 p.scale + static_cast<size_t>(u * 2 + r) * N, n0 + cc, N);
    }
  }

  // thread: row tid / 4, 32 columns from 32 * (tid % 4)
  static __device__ __forceinline__ void dequant(const unsigned char* raw, __nv_bfloat16* sb,
                                                 int tid) {
    static_assert(kBK * kBN / 32 == kPrefillThreads, "32 weights a thread");
    const int r = tid / (kBN / 32), cb = (tid % (kBN / 32)) * 32;
    const uint4* q = reinterpret_cast<const uint4*>(raw + r * kBN + cb);
    const float4* s4 = reinterpret_cast<const float4*>(
        reinterpret_cast<const float*>(raw + kQBytes) + (r >> 5) * kBN + cb);
    uint4* dst = reinterpret_cast<uint4*>(sb + r * kLdB + cb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = q[h];
      const uint32_t w[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                             v.w ^ 0x80808080u};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float4 s0 = s4[4 * h + 2 * i], s1 = s4[4 * h + 2 * i + 1];
        const uint32_t w0 = w[2 * i], w1 = w[2 * i + 1];
        dst[2 * h + i] = make_uint4(pack_bf16(s8_f32(w0, 0) * s0.x, s8_f32(w0, 1) * s0.y),
                                    pack_bf16(s8_f32(w0, 2) * s0.z, s8_f32(w0, 3) * s0.w),
                                    pack_bf16(s8_f32(w1, 0) * s1.x, s8_f32(w1, 1) * s1.y),
                                    pack_bf16(s8_f32(w1, 2) * s1.z, s8_f32(w1, 3) * s1.w));
      }
    }
  }
};

template <typename InT>
int run(const void* a, const void* q, const void* scale, float* out, int M, int K, int N,
        int slice_units, float* scratch, int* counters, cudaStream_t s) {
  using L = Q8<InT>;
  const typename L::Params p{static_cast<const InT*>(a), static_cast<const int8_t*>(q),
                             static_cast<const float*>(scale)};
  if (M <= 16) return launch_splitk<L>(p, out, M, K, N, slice_units, scratch, counters, s);
  if constexpr (sizeof(InT) == 2)
    return launch_gemm<L, float>(p, p.a, out, M, K, N, slice_units, scratch, counters, s);
  return rrs::kBadArgs;   // the prefill body takes bf16 activations
}

}  // namespace

// slice_units: scale groups per K slice at M <= 16 (ops/splitk.py); scratch
// and counters as splitk_kernel (gemm_sm90.cuh) takes them, else unused.
RRS_EXPORT int rrs_q8_matmul(const void* a, int a_is_bf16, const void* q, const void* scale,
                             void* out, int M, int K, int N, int slice_units, void* scratch,
                             void* counters, void* stream) {
  if (K % 64 != 0 || M < 1 || N < 1) return rrs::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(scratch);
  int* cp = static_cast<int*>(counters);
  if (a_is_bf16)
    return run<__nv_bfloat16>(a, q, scale, op, M, K, N, slice_units, sp, cp, s);
  return run<float>(a, q, scale, op, M, K, N, slice_units, sp, cp, s);
}
