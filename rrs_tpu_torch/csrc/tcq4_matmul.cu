// W4A4 dequant matmul (every M the gx kernels do not take): in-kernel weight
// dequantization into a bf16 GEMM.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:895 tcq4_matmul (_kernel at :782,
// _kernel_cast at :830) in its fast mode: C = bf16(a) @ bf16(q * eff) with f32
// accumulation, a being the dequantized rotated activations. The output is
// f32, or bf16 when the caller asks for it (padded M >= 1024, as the TPU
// kernel narrows its store there).
//
// Bound on the H100: bytes at M <= 16 (0.578 bytes a weight: a nibble plus a
// bf16 eff per 32), operations at prefill M (2 M K N bf16 FLOPs).
//
// Design: the two bodies of gemm_sm90.cuh with this loader. A qs byte holds
// k = j (low nibble) and k = j + 128 (high nibble) of a superblock, so one
// pass over 32 byte rows feeds two 32-deep runs of k, one eff row each.
// Decode (M <= 16) is the split-K stream over whole superblocks: a thread's
// unit is 2 x 4 byte rows of 16 columns and the 16 columns' eff of both
// groups; a byte permute pairs the same column of two rows, masks put each
// nibble into a bf16 128 + 8 + q, and two bf16x2 fma (- 136, then * eff)
// give bf16(q * eff), rounded once as the plain version rounds it. Prefill
// (M > 16) is the pipelined GEMM on bf16 activations (the wrapper rounds the
// f32 ones first, as the kernel would): a stage is a quarter superblock, 32
// byte rows of 128 columns and two eff rows. B17 (tcq4_fused.cu) runs its dot
// through tcq4_gemm below, so it is this kernel's output bit for bit; B10 and
// B19 (tcq4_experts.cu) run the prefill body on the expert grid through
// tcq4_experts below, and B9 (tcq4_experts.cu) the decode body with the
// selected rows on the grid through tcq4_rows below, with this loader.

#include "gemm_sm90.cuh"

namespace {

using namespace rrs::sm90;

template <typename EffT, typename InT>
struct TCQ4 {
  struct Params {
    const InT* a;
    const uint8_t* qs;
    const EffT* eff;
  };
  static constexpr bool kBf16 = sizeof(EffT) == 2;
  static constexpr int kEffVec = 16 * static_cast<int>(sizeof(EffT)) / 16;   // uint4 per 16 cols

  // expert e of stacks qs [E][K/2][N] and eff [E][K/32][N] (the expert grid)
  static __device__ __forceinline__ Params expert(const Params& p, size_t e, int K, int N) {
    return {p.a, p.qs + e * (K / 2) * static_cast<size_t>(N),
            p.eff + e * (K / 32) * static_cast<size_t>(N)};
  }

  // bf16(q * eff) of the pair of codes in `nib` whose scales are eff[c0] and
  // eff[c1] of the 16 held in e.
  static __device__ __forceinline__ uint32_t pair(uint32_t nib, const uint4* e, int c0, int c1) {
    if constexpr (kBf16) {
      // callers pass c1 == c0 (one column's scale twice) or an even c0 and
      // c1 = c0 + 1 (one word of two columns)
      const uint32_t* ew = reinterpret_cast<const uint32_t*>(e);
      const uint32_t e2 = c1 == c0 ? __byte_perm(ew[c0 >> 1], 0, (c0 & 1) ? 0x3232u : 0x1010u)
                                   : ew[c0 >> 1];
      return scale_pair(s4x2_bf16(nib), e2);
    } else {
      const float* ev = reinterpret_cast<const float*>(e);
      return scale_pair(s4x2_bf16(nib), ev[c0], ev[c1]);
    }
  }

  // -- decode: an inner unit is a quarter superblock, 32 byte rows
  static constexpr int kUnitK = 256;
  static constexpr int kInner = 4;
  struct Raw {
    uint4 w[2][4];            // [16-row step][byte row 4t + r], 16 columns
    uint4 e[2][kEffVec];      // [low / high group], 16 columns
  };

  static __device__ __forceinline__ void load(Raw& raw, const Params& p, int iu, int col, int t,
                                              int N) {
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        raw.w[st][r] = load16(p.qs + static_cast<size_t>(iu * 32 + st * 16 + 4 * t + r) * N, col,
                              N);
    const int g_lo = (iu >> 2) * 8 + (iu & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < kEffVec; ++v)
        raw.e[h][v] = load16(p.eff + static_cast<size_t>(g_lo + 4 * h) * N,
                             col + v * (16 / static_cast<int>(sizeof(EffT))), N);
  }

  template <int MT>
  static __device__ __forceinline__ void compute(const Raw& raw, float (&acc)[MT][8][4],
                                                 const Params& p, int iu, int g, int t, int M,
                                                 int K) {
    const int klo = (iu >> 2) * 256 + (iu & 3) * 32;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      uint32_t w[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        w[r][0] = raw.w[st][r].x ^ 0x88888888u;
        w[r][1] = raw.w[st][r].y ^ 0x88888888u;
        w[r][2] = raw.w[st][r].z ^ 0x88888888u;
        w[r][3] = raw.w[st][r].w ^ 0x88888888u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {            // low nibbles: k; high: k + 128
        const int k = klo + h * 128 + st * 16 + 4 * t;
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) act4(p.a, M, K, mt * 8 + g, k, b[mt][0], b[mt][1]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c0 = 2 * j, c1 = 2 * j + 1, wi = j >> 1, b0 = (c0 & 3);
          // bytes: 0 row 0 col c0, 1 row 0 col c1, 2 row 1 col c0, 3 row 1 col c1
          const uint32_t sel = b0 | ((b0 + 1) << 4) | ((b0 + 4) << 8) | ((b0 + 5) << 12);
          uint32_t x01 = __byte_perm(w[0][wi], w[1][wi], sel);
          uint32_t x23 = __byte_perm(w[2][wi], w[3][wi], sel);
          if (h) {
            x01 >>= 4;
            x23 >>= 4;
          }
          const uint32_t a0 = pair(x01, raw.e[h], c0, c0);
          const uint32_t a1 = pair(x01 >> 8, raw.e[h], c1, c1);
          const uint32_t a2 = pair(x23, raw.e[h], c0, c0);
          const uint32_t a3 = pair(x23 >> 8, raw.e[h], c1, c1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma16816(acc[mt][j], a0, a1, a2, a3, b[mt][0], b[mt][1]);
        }
      }
    }
  }

  // -- prefill: a stage is a quarter superblock (32 byte rows, 64 k)
  static constexpr int kQBytes = 32 * kBN;
  static constexpr int kEffBytes = 2 * kBN * static_cast<int>(sizeof(EffT));
  static constexpr int kRawBytes = kQBytes + kEffBytes;

  static __device__ __forceinline__ void runs(int u, int& k0, int& k1) {
    k0 = (u >> 2) * 256 + (u & 3) * 32;
    k1 = k0 + 128;
  }

  static __device__ __forceinline__ void issue(unsigned char* raw, const Params& p, int u, int n0,
                                               int N, int tid) {
    for (int c = tid; c < kQBytes / 16; c += kPrefillThreads) {
      const int r = c / (kBN / 16), cc = (c % (kBN / 16)) * 16;
      copy_chunk(raw + r * kBN + cc, p.qs + static_cast<size_t>(u * 32 + r) * N, n0 + cc, N);
    }
    constexpr int kPerRow = kBN * static_cast<int>(sizeof(EffT)) / 16;
    constexpr int kE = 16 / static_cast<int>(sizeof(EffT));
    const int g_lo = (u >> 2) * 8 + (u & 3);
    if (tid < 2 * kPerRow) {
      const int h = tid / kPerRow, cc = (tid % kPerRow) * kE;
      copy_chunk(raw + kQBytes + (h * kBN + cc) * static_cast<int>(sizeof(EffT)),
                 p.eff + static_cast<size_t>(g_lo + 4 * h) * N, n0 + cc, N);
    }
  }

  // thread: byte row tid / 8, 16 columns from 16 * (tid % 8); low nibbles
  // to B row r, high nibbles to row 32 + r
  static __device__ __forceinline__ void dequant(const unsigned char* raw, __nv_bfloat16* sb,
                                                 int tid) {
    static_assert(32 * kBN / 16 == kPrefillThreads, "16 bytes a thread");
    const int r = tid / (kBN / 16), cb = (tid % (kBN / 16)) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kBN + cb);
    const uint32_t w[4] = {v.x ^ 0x88888888u, v.y ^ 0x88888888u, v.z ^ 0x88888888u,
                           v.w ^ 0x88888888u};
    const EffT* eff = reinterpret_cast<const EffT*>(raw + kQBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4* e = reinterpret_cast<const uint4*>(eff + h * kBN + cb);
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 2 * i;   // bytes c, c + 1 of the 16: columns c, c + 1
        uint32_t x = __byte_perm(w[c >> 2], 0, (c & 3) | (((c & 3) + 1) << 8));
        if (h) x >>= 4;
        o[i] = pair(x, e, c, c + 1);
      }
      uint4* dst = reinterpret_cast<uint4*>(sb + (h * 32 + r) * kLdB + cb);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }
};

template <typename EffT, typename InT, typename OutT>
int run(const void* a, const uint8_t* qs, const void* eff, void* out, int M, int K, int N,
        int slice_units, float* scratch, int* counters, cudaStream_t s) {
  using L = TCQ4<EffT, InT>;
  const typename L::Params p{static_cast<const InT*>(a), qs, static_cast<const EffT*>(eff)};
  OutT* op = static_cast<OutT*>(out);
  if (M <= 16) {
    if constexpr (sizeof(OutT) == 4)
      return launch_splitk<L>(p, op, M, K, N, slice_units, scratch, counters, s);
    return rrs::kBadArgs;   // bf16 out only where the padded M reaches 1024
  }
  if constexpr (sizeof(InT) == 2)
    return launch_gemm<L, OutT>(p, p.a, op, M, K, N, slice_units, scratch, counters, s);
  return rrs::kBadArgs;     // the prefill body takes bf16 activations
}

}  // namespace

namespace rrs {

int tcq4_gemm(const void* a, bool a_bf16, const uint8_t* qs, const void* eff, bool eff_f32,
              void* out, bool out_bf16, int M, int K, int N, int slice_units, float* scratch,
              int* counters, cudaStream_t s) {
  if (K % 256 != 0 || N % 8 != 0 || M < 1) return kBadArgs;
  using bf16 = __nv_bfloat16;
  if (!a_bf16) {            // B4's decode: f32 activations, bf16 eff
    if (eff_f32 || out_bf16) return kBadArgs;
    return run<bf16, float, float>(a, qs, eff, out, M, K, N, slice_units, scratch, counters, s);
  }
  if (eff_f32) {            // B17 with f32 eff
    if (out_bf16) return kBadArgs;
    return run<float, bf16, float>(a, qs, eff, out, M, K, N, slice_units, scratch, counters, s);
  }
  if (out_bf16)
    return run<bf16, bf16, bf16>(a, qs, eff, out, M, K, N, slice_units, scratch, counters, s);
  return run<bf16, bf16, float>(a, qs, eff, out, M, K, N, slice_units, scratch, counters, s);
}

int tcq4_rows(const __nv_bfloat16* a, const uint8_t* qs, const __nv_bfloat16* eff,
              const int* ids, int n_exp, float* out, int n_sel, int K, int N, int slice_units,
              float* scratch, int* counters, cudaStream_t s) {
  if (K % 256 != 0 || N % 8 != 0) return kBadArgs;
  using L = TCQ4<__nv_bfloat16, __nv_bfloat16>;
  return sm90::launch_rows<L>({a, qs, eff}, ids, n_exp, out, n_sel, K, N, slice_units, scratch,
                              counters, s);
}

int tcq4_experts(const __nv_bfloat16* a, size_t a_stride, const uint8_t* qs, const void* eff,
                 bool eff_f32, const int* ids, int n_exp, float* out, int Z, int M, int K, int N,
                 int row_tile, cudaStream_t s) {
  if (K % 256 != 0 || N % 8 != 0) return kBadArgs;
  using bf16 = __nv_bfloat16;
  if (eff_f32) {            // B19 with f32 eff (B17's loader)
    using L = TCQ4<float, bf16>;
    return sm90::launch_experts<L>({a, qs, static_cast<const float*>(eff)}, a, a_stride, ids,
                                   n_exp, out, Z, M, K, N, row_tile, s);
  }
  using L = TCQ4<bf16, bf16>;
  return sm90::launch_experts<L>({a, qs, static_cast<const bf16*>(eff)}, a, a_stride, ids, n_exp,
                                 out, Z, M, K, N, row_tile, s);
}

}  // namespace rrs

// a f32 (M <= 16) or bf16 (any M); slice_units: superblocks per K slice at
// M <= 16 (ops/splitk.py); scratch and counters as splitk_kernel
// (gemm_sm90.cuh) takes them, else unused.
RRS_EXPORT int rrs_tcq4_matmul(const void* a, int a_is_bf16, const void* qs, const void* eff,
                               void* out, int M, int K, int N, int out_bf16, int slice_units,
                               void* scratch, void* counters, void* stream) {
  return rrs::tcq4_gemm(a, a_is_bf16 != 0, static_cast<const uint8_t*>(qs), eff, false, out,
                        out_bf16 != 0, M, K, N, slice_units, static_cast<float*>(scratch),
                        static_cast<int*>(counters), static_cast<cudaStream_t>(stream));
}
