// W4A4 paired-bias matmul over the group-interleaved TCQ4 pack, f32 out:
//
//   out = a_gi @ bf16(bf16(q + 24) * e[r mod G])  -  ag24 @ [e; e]
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:453 tcq4_matmul_pb (_kernel_pb at
// :413). a_gi bf16 [M, K] holds the activations in k_new = j * G + g order
// (G = K / 32 groups, j = 0 .. 31 the element of group g), qs_gi uint8 [K/2,
// N] the int4 codes in the same order (byte row r: k_new = 2r in its low
// nibble, 2r + 1 in its high nibble), so row k_new's group scale is
// eff[k_new mod G]; ag24 bf16 [M, 2G] is the hi / lo split of 24 * (the
// per-group sums of a), whose 2G-deep dot against the scales stacked twice
// cancels the +24 bias of the decoded weights.
//
// Arithmetic, as on the TPU: a nibble n decodes to the bf16 bit pattern
// 0x4180 | ((n ^ 8) << 3), which is q + 24 exactly (the 16 values land in the
// binade [16, 31]); its product with the bf16 scale is exact and is rounded
// once to bf16 (one fma.rn.bf16x2 with -0 added), the TPU's bf16 product.
// The dots take bf16 operands with f32 sums; only the order of the sums
// differs from the plain version.
//
// Bound on the H100: bytes at decode M (the 4.625-bit weights, as B4 reads
// them), operations at prefill M (2 M K N bf16 FLOPs plus the 2G-deep bias
// dot, 2 M 2G N).
//
// Design: the two bodies of gemm_sm90.cuh with the PB loader, which walks K
// group by group. G is a multiple of 8, so for an even group g byte row (j G
// + g) / 2 holds element j of group g in its low nibble and of group g + 1 in
// its high nibble: the 32 byte rows j = 0 .. 31 of a group pair, G / 2 rows
// apart, are laid out as a TCQ4 quarter superblock is (the low nibbles one
// 32-deep run with one eff row, the high nibbles the next), and a unit of 8
// groups (256 k) is 32 runs of 4 consecutive byte rows and 8 eff rows.
// 1. Decode (M <= 16), the split-K stream over units: a warp's inner unit is
//    a group pair, and its activations a_gi[m, j G + g .. g + 1] are one
//    32-bit word for each j, read in place. Its share of the bias is one
//    more m16n8k16 per 16-column tile, whose k slots 0, 1 hold the pair's
//    hi entries of ag24 and 8, 9 its lo ones (thread t = 0), against the
//    pair's two eff rows; the other slots are zero.
// 2. Prefill (M > 16), the pipelined GEMM: a stage is a group pair (32 byte
//    rows and two eff rows), its runs k = 32 g .. 32 g + 63 of the
//    activations in group-major order, which is a_gi before pb_prepare's
//    transpose (the wrapper transposes it back, one M x K bf16 copy). The
//    bias is the body's kBiasDot step: per unit the 16 ag24 entries of its
//    groups (hi, then lo) against its 8 eff rows read twice, one m16n8k16
//    per 256 k.
// The bias's activations are negated, which is exact in bf16 and gives each
// product of -ag24 @ [e; e] exactly.

#include "gemm_sm90.cuh"

namespace {

using namespace rrs::sm90;
using bf16 = __nv_bfloat16;

struct PB {
  struct Params {
    const bf16* a;        // decode: a_gi [M, K]; the prefill body reads its own
    const bf16* ag24;     // [M, 2G]
    const uint8_t* qs;    // qs_gi [K/2, N]
    const bf16* eff;      // [G, N]
    int G;
  };
  static constexpr bool kBiasDot = true;

  // bf16(bf16(q + 24) * e) of the two codes n ^ 8 in bits 0-3 and 16-19 of
  // x, with the bf16 scales e2 (lo, hi).
  static __device__ __forceinline__ uint32_t pair(uint32_t x, uint32_t e2) {
    return scale_pair(((x & 0x000F000Fu) << 3) | 0x41804180u, e2);
  }

  // -- decode: an inner unit is a group pair, 32 byte rows G / 2 apart
  static constexpr int kUnitK = 256;
  static constexpr int kInner = 4;
  struct Raw {
    uint4 w[2][4];            // [16-row step][element 4t + r of the step], 16 columns
    uint4 e[2][2];            // [group g, g + 1], 16 bf16 columns
  };

  // the pair's first group: inner unit iu is pair iu & 3 of unit iu >> 2
  static __device__ __forceinline__ int group(int iu) { return (iu >> 2) * 8 + (iu & 3) * 2; }

  static __device__ __forceinline__ void load(Raw& raw, const Params& p, int iu, int col, int t,
                                              int N) {
    const int g0 = group(iu), half = p.G / 2;
#pragma unroll
    for (int st = 0; st < 2; ++st)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        raw.w[st][r] = load16(p.qs + static_cast<size_t>((st * 16 + 4 * t + r) * half + g0 / 2) * N,
                              col, N);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int v = 0; v < 2; ++v)
        raw.e[h][v] = load16(p.eff + static_cast<size_t>(g0 + h) * N, col + v * 8, N);
  }

  template <int MT>
  static __device__ __forceinline__ void compute(const Raw& raw, float (&acc)[MT][8][4],
                                                 const Params& p, int iu, int g, int t, int M,
                                                 int K) {
    const int g0 = group(iu), G = p.G;
    const uint32_t* ew[2] = {reinterpret_cast<const uint32_t*>(raw.e[0]),
                             reinterpret_cast<const uint32_t*>(raw.e[1])};
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
      // a_gi[m, j G + g0 .. g0 + 1] for the step's elements j = 4t .. 4t + 3
      uint32_t av[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + g;
#pragma unroll
        for (int r = 0; r < 4; ++r)
          av[mt][r] = m < M ? __ldg(reinterpret_cast<const uint32_t*>(
                                  p.a + static_cast<size_t>(m) * K +
                                  static_cast<size_t>(st * 16 + 4 * t + r) * G + g0))
                            : 0u;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {            // low nibbles: group g0; high: g0 + 1
        const uint32_t sel = h ? 0x7632u : 0x5410u;
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          b[mt][0] = __byte_perm(av[mt][0], av[mt][1], sel);
          b[mt][1] = __byte_perm(av[mt][2], av[mt][3], sel);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c0 = 2 * j, wi = j >> 1, b0 = (c0 & 3);
          // bytes: 0 row 0 col c0, 1 row 0 col c1, 2 row 1 col c0, 3 row 1 col c1
          const uint32_t bsel = b0 | ((b0 + 1) << 4) | ((b0 + 4) << 8) | ((b0 + 5) << 12);
          uint32_t x01 = __byte_perm(w[0][wi], w[1][wi], bsel);
          uint32_t x23 = __byte_perm(w[2][wi], w[3][wi], bsel);
          if (h) {
            x01 >>= 4;
            x23 >>= 4;
          }
          const uint32_t e_c0 = __byte_perm(ew[h][j], 0, 0x1010u);   // column c0's scale twice
          const uint32_t e_c1 = __byte_perm(ew[h][j], 0, 0x3232u);
          const uint32_t a0 = pair(x01, e_c0);
          const uint32_t a1 = pair(x01 >> 8, e_c1);
          const uint32_t a2 = pair(x23, e_c0);
          const uint32_t a3 = pair(x23 >> 8, e_c1);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            mma16816(acc[mt][j], a0, a1, a2, a3, b[mt][0], b[mt][1]);
        }
      }
    }
    // the pair's bias: k slots 0, 1 the -hi entries of groups g0, g0 + 1 and
    // slots 8, 9 the -lo ones (thread t = 0), against their two eff rows
    uint32_t bb[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int m = mt * 8 + g;
      const bf16* row = p.ag24 + static_cast<size_t>(m) * 2 * G + g0;
      const bool on = t == 0 && m < M;
      bb[mt][0] = on ? __ldg(reinterpret_cast<const uint32_t*>(row)) ^ 0x80008000u : 0u;
      bb[mt][1] = on ? __ldg(reinterpret_cast<const uint32_t*>(row + G)) ^ 0x80008000u : 0u;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      // (e_g0, e_g0+1) of columns c0 and c1, zero outside thread t = 0's slots
      const uint32_t e_c0 = t == 0 ? __byte_perm(ew[0][j], ew[1][j], 0x5410u) : 0u;
      const uint32_t e_c1 = t == 0 ? __byte_perm(ew[0][j], ew[1][j], 0x7632u) : 0u;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        mma16816(acc[mt][j], e_c0, e_c1, e_c0, e_c1, bb[mt][0], bb[mt][1]);
    }
  }

  // -- prefill: a stage is a group pair (32 byte rows, 64 k)
  static constexpr int kQBytes = 32 * kBN;
  static constexpr int kRawBytes = kQBytes + 2 * kBN * 2;

  // stage u is the pair (2u, 2u + 1): k 64 u .. 64 u + 63 in group-major order
  static __device__ __forceinline__ void runs(int u, int& k0, int& k1) {
    k0 = u * 64;
    k1 = k0 + 32;
  }

  static __device__ __forceinline__ void issue(unsigned char* raw, const Params& p, int u, int n0,
                                               int N, int tid) {
    const int half = p.G / 2;
    for (int c = tid; c < kQBytes / 16; c += kPrefillThreads) {
      const int r = c / (kBN / 16), cc = (c % (kBN / 16)) * 16;
      copy_chunk(raw + r * kBN + cc, p.qs + static_cast<size_t>(r * half + u) * N, n0 + cc, N);
    }
    constexpr int kPerRow = kBN * 2 / 16;
    if (tid < 2 * kPerRow) {
      const int h = tid / kPerRow, cc = (tid % kPerRow) * 8;
      copy_chunk(raw + kQBytes + (h * kBN + cc) * 2, p.eff + static_cast<size_t>(2 * u + h) * N,
                 n0 + cc, N);
    }
  }

  // thread: byte row tid / 8, 16 columns from 16 * (tid % 8); low nibbles
  // (group 2u) to B row r, high nibbles (2u + 1) to row 32 + r
  static __device__ __forceinline__ void dequant(const unsigned char* raw, bf16* sb, int tid) {
    static_assert(32 * kBN / 16 == kPrefillThreads, "16 bytes a thread");
    const int r = tid / (kBN / 16), cb = (tid % (kBN / 16)) * 16;
    const uint4 v = *reinterpret_cast<const uint4*>(raw + r * kBN + cb);
    const uint32_t w[4] = {v.x ^ 0x88888888u, v.y ^ 0x88888888u, v.z ^ 0x88888888u,
                           v.w ^ 0x88888888u};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t* ew = reinterpret_cast<const uint32_t*>(raw + kQBytes + (h * kBN + cb) * 2);
      uint32_t o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 2 * i;   // bytes c, c + 1 of the 16: columns c, c + 1
        uint32_t x = __byte_perm(w[c >> 2], 0, (c & 3) | (((c & 3) + 1) << 8));
        if (h) x >>= 4;
        o[i] = pair(x, ew[i]);
      }
      uint4* dst = reinterpret_cast<uint4*>(sb + (h * 32 + r) * kLdB + cb);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    }
  }

  // unit `unit`'s bias tile (BiasTile<BM>): rows m0 .. m0 + BM - 1 of ag24's
  // columns 8 unit .. + 7 (hi) and G + 8 unit .. + 7 (lo), zero past M; eff
  // rows 8 unit .. + 7 of the strip
  template <int BM>
  static __device__ __forceinline__ void bias_issue(unsigned char* dst, const Params& p, int unit,
                                                    int m0, int M, int n0, int N, int tid) {
    for (int c = tid; c < BM * 2; c += kPrefillThreads) {
      const int row = c >> 1, h = c & 1, gr = m0 + row;
      cp_async16(dst + row * 32 + ((h ^ ((row >> 2) & 1)) << 4),
                 p.ag24 + static_cast<size_t>(gr < M ? gr : 0) * 2 * p.G + h * p.G + 8 * unit,
                 gr < M ? 16 : 0);
    }
    unsigned char* eb = dst + BiasTile<BM>::kABytes;
    for (int c = tid; c < 8 * (kBN / 8); c += kPrefillThreads) {
      const int r = c / (kBN / 8), cc = (c % (kBN / 8)) * 8;
      copy_chunk(eb + (r * kLdB + cc) * 2, p.eff + static_cast<size_t>(8 * unit + r) * N,
                 n0 + cc, N);
    }
  }
};

}  // namespace

// a: a_gi [M, K] at M <= 16, else the activations in group-major order
// (a_gi.view(M, 32, G).transpose(1, 2)); slice_units: units of 256 k a K
// slice (ops/splitk.py plan, as B4's); scratch and counters as the bodies of
// gemm_sm90.cuh take them (unused with one slice).
RRS_EXPORT int rrs_tcq4_pb(const void* a, const void* ag24, const void* qs_gi, const void* eff,
                           void* out, int M, int K, int N, int slice_units, void* scratch,
                           void* counters, void* stream) {
  if (M < 1 || K < 256 || K % 256 != 0 || N < 8 || N % 8 != 0) return rrs::kBadArgs;
  const auto* ap = static_cast<const bf16*>(a);
  const PB::Params p{ap, static_cast<const bf16*>(ag24), static_cast<const uint8_t*>(qs_gi),
                     static_cast<const bf16*>(eff), K / 32};
  float* op = static_cast<float*>(out);
  float* sp = static_cast<float*>(scratch);
  int* cp = static_cast<int*>(counters);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch_splitk<PB>(p, op, M, K, N, slice_units, sp, cp, s);
  return launch_gemm<PB, float>(p, ap, op, M, K, N, slice_units, sp, cp, s);
}
