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
// 4.5 MB per projection at gpt-oss-20b), and for B11 and B13 at decode M and
// at the shared T <= 64 of batched decode (B13 at T = 64 moves every
// expert's 144 MB with its activations and f32 outputs, 0.050 ms at
// 3.35 TB/s, against 0.035 ms of bf16 tensor-core work); operations for B11
// and B13 at prefill M (B13 from about C = 110 rows an expert on).
//
// Design. B11 runs on the two bodies of gemm_sm90.cuh (as B2 and B4 do) with
// the MXFP4 loader below, whose slice unit is one scale group of 32 k. At M
// <= 16 it is the split-K weight stream: a thread's unit is 2 x 2 byte rows
// of 16 columns (k = 4t .. 4t + 3 of each 16-deep step) and their 16 scale
// bytes, decoded in registers into the mma's A operand. Above, it is the
// 3-stage cp.async GEMM on bf16 activations (the wrapper rounds f32 ones
// first, as the kernel would): a 64-deep stage is 32 byte rows x 128 columns
// and two scale rows, and each thread decodes one 16-byte run of a byte row
// into two rows of the bf16 B tile, two columns a 32-bit store. Both bodies
// decode with the same bit formula on 16-bit halves (fp4x2_bf16). B13 runs
// the same prefill body and loader on the expert grid of gemm_sm90.cuh
// (experts_kernel): block (strip, row tile, expert) streams its expert's
// stages through the ring while the next stage is decoded and this one
// multiplied, 64 x 128 tiles below 128 rows (the wrapper picks the row
// tile, ops/splitk.py experts_grid), two blocks an SM, with a zero
// activation stride for shared activations; at gpt-oss-20b the grid has at
// least 736 blocks for the 264 block slots, so K is not split. B12 runs the
// decode body, the split-K weight stream, with the same loader and the
// selected rows on the grid (rows_kernel of gemm_sm90.cuh): block (strip, K
// slice, row) reads its row's expert id on the device, streams that
// expert's scale groups of its slice with 16-byte loads (the next group's
// in flight), decodes them in registers into the A operand of mma.sync
// m16n8k16 against its row of bf16 activations, and each (row, strip)
// tile's last block sums the slices in slice order (ops/splitk.py
// rows_plan: at gpt-oss-20b decode, 4 slices of 23 groups at n_sel = 4,
// 368 blocks, one wave of three blocks an SM).

#include "gemm_sm90.cuh"

namespace {

// Two remapped codes in bits 0-3 and 16-19 of `nib` with the exponents
// s2 = sexp_lo | sexp_hi << 16 -> the exact bf16 pair (the top half of each
// code's f32 bits, the layout's formula above), in 16-bit halves: the
// magnitude (em << 6) + (sexp << 7) cannot carry out of its half (sexp <=
// 251), code 1 (em == 1) is masked to zero, and the sign moves from bit 3
// to bit 15.
__device__ __forceinline__ uint32_t fp4x2_bf16(uint32_t nib, uint32_t s2) {
  const uint32_t em = nib & 0x00070007u;
  const uint32_t mag = (em << 6) + (s2 << 7);
  const uint32_t live = ((em ^ 0x00010001u) + 0x00070007u) & 0x00080008u;   // 8: em != 1
  return (mag & (live * 0x1FFFu)) | ((nib & 0x00080008u) << 12);
}

// Bytes c and c + 1 (c even) of the 16 in `v`, into bits 0-7 and 16-23.
__device__ __forceinline__ uint32_t byte_pair(const uint4& v, int c) {
  const uint32_t w = (&v.x)[c >> 2];
  const uint32_t b = c & 3;
  return __byte_perm(w, 0u, b | (4u << 4) | ((b + 1) << 8) | (4u << 12));
}

// B11's and B13's weight loader for the bodies of gemm_sm90.cuh.
template <typename InT>
struct MXFP4 {
  struct Params {
    const InT* a;
    const uint8_t* qs;
    const uint8_t* sexp;
  };

  // expert e of stacks qs [E][K/2][N] and sexp [E][K/32][N] (the expert grid)
  static __device__ __forceinline__ Params expert(const Params& p, size_t e, int K, int N) {
    return {p.a, p.qs + e * (K / 2) * static_cast<size_t>(N),
            p.sexp + e * (K / 32) * static_cast<size_t>(N)};
  }

  // -- decode: an inner unit is one scale group, 16 byte rows
  static constexpr int kUnitK = 32;
  static constexpr int kInner = 1;
  struct Raw {
    uint4 w[2][2];   // [16-deep step][byte row 2t + r], 16 columns
    uint4 s;         // the 16 columns' exponents
  };

  static __device__ __forceinline__ void load(Raw& raw, const Params& p, int grp, int col, int t,
                                              int N) {
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        raw.w[st][r] = rrs::sm90::load16(
            p.qs + static_cast<size_t>(grp * 16 + st * 8 + 2 * t + r) * N, col, N);
    raw.s = rrs::sm90::load16(p.sexp + static_cast<size_t>(grp) * N, col, N);
  }

  // byte row 2t holds k = 4t (low nibble) and 4t + 1 (high), row 2t + 1 the
  // next two: one byte is one bf16 pair of the mma's A operand
  template <int MT>
  static __device__ __forceinline__ void compute(const Raw& raw, float (&acc)[MT][8][4],
                                                 const Params& p, int grp, int g, int t, int M,
                                                 int K) {
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      const int k = grp * 32 + st * 16 + 4 * t;
      uint32_t b[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        rrs::sm90::act4(p.a, M, K, mt * 8 + g, k, b[mt][0], b[mt][1]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const uint32_t s2 = byte_pair(raw.s, 2 * j);
        const uint32_t x0 = byte_pair(raw.w[st][0], 2 * j);   // columns 2j, 2j + 1
        const uint32_t x1 = byte_pair(raw.w[st][1], 2 * j);
        const uint32_t s_lo = s2 & 0xFFFFu, s_hi = s2 >> 16;
        // one column's byte: its two nibbles in the two halves
        auto col_pair = [](uint32_t x, int h) {
          const uint32_t byte = (x >> (16 * h)) & 0xFFu;
          return (byte & 0xFu) | ((byte & 0xF0u) << 12);
        };
        const uint32_t a0 = fp4x2_bf16(col_pair(x0, 0), s_lo * 0x00010001u);
        const uint32_t a1 = fp4x2_bf16(col_pair(x0, 1), s_hi * 0x00010001u);
        const uint32_t a2 = fp4x2_bf16(col_pair(x1, 0), s_lo * 0x00010001u);
        const uint32_t a3 = fp4x2_bf16(col_pair(x1, 1), s_hi * 0x00010001u);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          rrs::sm90::mma16816(acc[mt][j], a0, a1, a2, a3, b[mt][0], b[mt][1]);
      }
    }
  }

  // -- prefill: a stage is 64 contiguous k, 32 byte rows and two scale rows
  static constexpr int kQBytes = 32 * rrs::sm90::kBN;
  static constexpr int kRawBytes = kQBytes + 2 * rrs::sm90::kBN;

  static __device__ __forceinline__ void runs(int u, int& k0, int& k1) {
    k0 = u * rrs::sm90::kBK;
    k1 = k0 + 32;
  }

  static __device__ __forceinline__ void issue(unsigned char* raw, const Params& p, int u, int n0,
                                               int N, int tid) {
    constexpr int kBN = rrs::sm90::kBN;
    for (int c = tid; c < kQBytes / 16; c += rrs::sm90::kPrefillThreads) {
      const int r = c / (kBN / 16), cc = (c % (kBN / 16)) * 16;
      rrs::sm90::copy_chunk(raw + r * kBN + cc, p.qs + static_cast<size_t>(u * 32 + r) * N,
                            n0 + cc, N);
    }
    if (tid < 2 * kBN / 16) {
      const int r = tid / (kBN / 16), cc = (tid % (kBN / 16)) * 16;
      rrs::sm90::copy_chunk(raw + kQBytes + r * kBN + cc,
                            p.sexp + static_cast<size_t>(u * 2 + r) * N, n0 + cc, N);
    }
  }

  // thread: byte row r = tid / 8, 16 columns from 16 * (tid % 8); low
  // nibbles to B row 2r, high nibbles to row 2r + 1
  static __device__ __forceinline__ void dequant(const unsigned char* raw, __nv_bfloat16* sb,
                                                 int tid) {
    constexpr int kBN = rrs::sm90::kBN, kLdB = rrs::sm90::kLdB;
    static_assert(32 * kBN / 16 == rrs::sm90::kPrefillThreads, "16 bytes a thread");
    const int r = tid / (kBN / 16), cb = (tid % (kBN / 16)) * 16;
    const uint4 q = *reinterpret_cast<const uint4*>(raw + r * kBN + cb);
    const uint4 e = *reinterpret_cast<const uint4*>(raw + kQBytes + (r >> 4) * kBN + cb);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t x = byte_pair(q, 2 * i), s2 = byte_pair(e, 2 * i);
      lo[i] = fp4x2_bf16(x & 0x000F000Fu, s2);
      hi[i] = fp4x2_bf16((x >> 4) & 0x000F000Fu, s2);
    }
    uint4* dlo = reinterpret_cast<uint4*>(sb + (2 * r) * kLdB + cb);
    uint4* dhi = reinterpret_cast<uint4*>(sb + (2 * r + 1) * kLdB + cb);
    dlo[0] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    dlo[1] = make_uint4(lo[4], lo[5], lo[6], lo[7]);
    dhi[0] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    dhi[1] = make_uint4(hi[4], hi[5], hi[6], hi[7]);
  }
};

template <typename InT>
int run_b11(const void* a, const void* qs, const void* sexp, float* out, int M, int K, int N,
            int slice_units, float* scratch, int* counters, cudaStream_t s) {
  using L = MXFP4<InT>;
  const typename L::Params p{static_cast<const InT*>(a), static_cast<const uint8_t*>(qs),
                             static_cast<const uint8_t*>(sexp)};
  if (M <= 16)
    return rrs::sm90::launch_splitk<L>(p, out, M, K, N, slice_units, scratch, counters, s);
  if constexpr (sizeof(InT) == 2)
    return rrs::sm90::launch_gemm<L, float>(p, p.a, out, M, K, N, slice_units, scratch,
                                            counters, s);
  return rrs::kBadArgs;   // the prefill body takes bf16 activations
}

bool bad_shape(int M, int K, int N) { return M < 1 || K < 64 || K % 64 || N < 64 || N % 64; }

}  // namespace

// slice_units: scale groups per K slice (ops/splitk.py); scratch and
// counters as gemm_sm90.cuh's bodies take them, else unused.
RRS_EXPORT int rrs_mxfp4_matmul(const void* a, int a_is_bf16, const void* qs, const void* sexp,
                                void* out, int M, int K, int N, int slice_units, void* scratch,
                                void* counters, void* stream) {
  if (bad_shape(M, K, N)) return rrs::kBadArgs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(scratch);
  int* cp = static_cast<int*>(counters);
  if (a_is_bf16)
    return run_b11<__nv_bfloat16>(a, qs, sexp, op, M, K, N, slice_units, sp, cp, s);
  return run_b11<float>(a, qs, sexp, op, M, K, N, slice_units, sp, cp, s);
}

// a bf16 [n_sel, K]; slice_units: scale groups per K slice (ops/splitk.py
// rows_plan); scratch [n_sel, slices, strips * 128] f32 and counters [n_sel,
// strips] with more than one slice, else unused.
RRS_EXPORT int rrs_mxfp4_rows(const void* a, const void* qs, const void* sexp, const void* ids,
                              void* out, int n_sel, int K, int N, int n_exp, int slice_units,
                              void* scratch, void* counters, void* stream) {
  if (bad_shape(n_sel, K, N)) return rrs::kBadArgs;
  using L = MXFP4<__nv_bfloat16>;
  const L::Params p{static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(qs),
                    static_cast<const uint8_t*>(sexp)};
  return rrs::sm90::launch_rows<L>(p, static_cast<const int*>(ids), n_exp,
                                   static_cast<float*>(out), n_sel, K, N, slice_units,
                                   static_cast<float*>(scratch), static_cast<int*>(counters),
                                   static_cast<cudaStream_t>(stream));
}

// a bf16; row_tile 64 or 128 (ops/splitk.py experts_grid).
RRS_EXPORT int rrs_mxfp4_all_experts(const void* a, int per_expert, const void* qs,
                                     const void* sexp, void* out, int E, int T, int K, int N,
                                     int row_tile, void* stream) {
  if (bad_shape(T, K, N) || E < 1) return rrs::kBadArgs;
  using L = MXFP4<__nv_bfloat16>;
  const L::Params p{static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(qs),
                    static_cast<const uint8_t*>(sexp)};
  const size_t a_stride = per_expert ? static_cast<size_t>(T) * K : 0;
  return rrs::sm90::launch_experts<L>(p, p.a, a_stride, nullptr, E, static_cast<float*>(out), E,
                                      T, K, N, row_tile, static_cast<cudaStream_t>(stream));
}
