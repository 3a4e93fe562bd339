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
// Design: a pipelined int8 tensor-core GEMM over whole superblocks, built from
// gemm_sm90.cuh's instructions and its split-K end.
// - Tiles: a block owns 128 x 128 outputs, 8 warps (2 x 4, warp tile 64 x 32),
//   mma.sync m16n8k32 s8 x s8 -> s32, both operands from ldmatrix on
//   swizzled int8 rows (16 k a 16-byte chunk).
// - Ring: 3 cp.async stages of one superblock each: the 128 activation rows
//   (32 KB), the strip's 128 byte rows of qs_sbi (16 KB), its 8 f8 rows, its
//   e2 row and the tile's a_scale column (2 KB); plus two decoded w8 tiles
//   [n][k] (32 KB each). 214 KB: one block an SM (kSmemBytes below).
// - Decode once, overlapped: each block decodes each superblock's w8 once, in
//   eight parts, one after each 32-deep MMA step of the superblock before it,
//   so the integer work of the decode sits between tensor-core instructions.
//   A thread takes 4 columns x 16 byte rows and decodes two rows of one
//   column at a time in half2: 1024 + u (a low nibble) or 256 + 4u (a high
//   one, 1/4 of it less 72 in one fma) gives the code's exact half, then
//   fma(w4, f, 0.5) and fma(t, 1/8, 1536) give 1536 + ((w4 * f + 4) >> 3)
//   exactly (the fraction of (p + 0.5) / 8 is never one half), whose low byte
//   is w8.
// - Epilogue: the superblock's exact int32 partials (their first MMA adds
//   them to the bits of 1.5 * 2^23, so one subtraction makes each an exact
//   float), then the rank-1 f32 update in the JAX kernel's order, each
//   product and sum rounded once.
// - K split: where the output tiles alone would leave SMs idle or a last
//   wave short, the grid splits K over whole superblocks (ops/splitk.py,
//   unit 256, the slice count that takes the fewest superblocks on the
//   busiest SM); each tile's last block adds the slices in slice order
//   (finish_slices), with no float atomics, so the output is the same bits
//   on every run and, with one slice, the plain version's bits.
// Measured on the H100 (PERF.md, section 6): the MMA steps, the copies, the
// decode and the epilogue add up rather than overlap; giving the copies and
// the decode warps of their own (a producer / consumer split over named
// barriers) timed no faster, so the body stays uniform.

#include <cuda_fp16.h>

#include "gemm_sm90.cuh"

namespace {

using namespace rrs::sm90;

constexpr int kBM = 128;
constexpr int kBN8 = 128;                // output columns a block
constexpr int kSB = 256;                 // superblock depth (k)
constexpr int kThreads = 256;            // 8 warps, 2 (m) x 4 (n)
constexpr int kStages = 3;
constexpr int kABytes = kBM * kSB;                 // int8 activations, swizzled rows
constexpr int kQBytes = (kSB / 2) * kBN8;          // qs_sbi byte rows
constexpr int kFBytes = 8 * kBN8;                  // f8 rows
constexpr int kStageBytes = kABytes + kQBytes + kFBytes + kBN8 * 4 + kBM * 4;
constexpr int kW8Bytes = kBN8 * kSB;               // decoded w8 [n][k], swizzled rows
constexpr int kSmemBytes = kStages * kStageBytes + 2 * kW8Bytes;
static_assert(kSmemBytes <= 232448, "one block an SM (227 KB)");

// Offsets inside a stage.
constexpr int kOffQ = kABytes;
constexpr int kOffF = kOffQ + kQBytes;
constexpr int kOffE = kOffF + kFBytes;
constexpr int kOffS = kOffE + kBN8 * 4;

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a * b + c for a constant c in every slot (the first step of a superblock).
__device__ __forceinline__ void mma_s8_from(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                            uint32_t b1, int c) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(c));
}

__device__ __forceinline__ void ldsm_x4_s8(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 4 bytes from global into shared (zero when src_bytes is 0).
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

// The 16-byte chunk of w8 row n (column n of the tile) that holds logical
// chunk c: rows n .. n + 7 of any aligned eight meet distinct banks, and so do
// the columns 4 cg + c of one decode store (n >> 3 mixed in).
__device__ __forceinline__ int w8_chunk(int n, int c) { return c ^ ((n ^ (n >> 3)) & 7); }

__device__ __forceinline__ uint32_t h2u(__half2 h) { return *reinterpret_cast<uint32_t*>(&h); }
__device__ __forceinline__ __half2 u2h(uint32_t u) { return *reinterpret_cast<__half2*>(&u); }

// The decode of one superblock held by a thread: its 16 byte-row words (4
// columns, biased by 0x88 a nibble so that u = w4 + 8), the 8 f8 words of
// its columns, and the half2 f pairs and w8 words of the column in work.
struct Decode {
  uint32_t v[16];
  uint32_t fw[8];
  __half2 f2[4];
  uint32_t lo[4], hi[4];
};

// Part ks (0..7) of the decode: column c = ks / 2 of the thread's four, byte
// rows 8 (ks & 1) .. + 7 of its sixteen; the second part of a column stores
// its two chunks (low nibbles: k = 16 rg ..; high nibbles: k = 128 + 16 rg ..).
__device__ __forceinline__ void decode_part(Decode& d, int ks, unsigned char* w8, int cg,
                                            int rg) {
  const int c = ks >> 1, h = ks & 1;
  if (h == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // f rows 2q and 2q + 1 of column c as the half pair 1024 + (f + 128) - 1152
      const uint32_t y = __byte_perm(d.fw[2 * q], d.fw[2 * q + 1], c | ((c + 4) << 8));
      d.f2[q] = __hsub2(u2h(((y ^ 0x00800080u) & 0x00FF00FFu) | 0x64006400u),
                        __float2half2_rn(1152.f));
    }
  }
  const __half2 k1032 = __float2half2_rn(1032.f), half = __float2half2_rn(0.5f);
  const __half2 quarter = __float2half2_rn(0.25f), k72 = __float2half2_rn(-72.f);
  const __half2 eighth = __float2half2_rn(0.125f), k1536 = __float2half2_rn(1536.f);
  uint32_t zl[4], zh[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int i = 8 * h + 2 * q;
    // byte c of rows i and i + 1 in bytes 0 and 2 (and 1 and 3)
    const uint32_t x = __byte_perm(d.v[i], d.v[i + 1], c | (c << 4) | ((c + 4) << 8) |
                                                            ((c + 4) << 12));
    const __half2 wl = __hsub2(u2h((x & 0x000F000Fu) | 0x64006400u), k1032);
    // 0x5C00 | u << 4 is the half 256 + 4u
    const __half2 wh = __hfma2(u2h((x & 0x00F000F0u) | 0x5C005C00u), quarter, k72);
    zl[q] = h2u(__hfma2(__hfma2(wl, d.f2[q], half), eighth, k1536));
    zh[q] = h2u(__hfma2(__hfma2(wh, d.f2[q], half), eighth, k1536));
  }
  d.lo[2 * h] = __byte_perm(zl[0], zl[1], 0x6420);
  d.lo[2 * h + 1] = __byte_perm(zl[2], zl[3], 0x6420);
  d.hi[2 * h] = __byte_perm(zh[0], zh[1], 0x6420);
  d.hi[2 * h + 1] = __byte_perm(zh[2], zh[3], 0x6420);
  if (h == 1) {
    const int n = 4 * cg + c;
    unsigned char* row = w8 + n * kSB;
    *reinterpret_cast<uint4*>(row + w8_chunk(n, rg) * 16) =
        make_uint4(d.lo[0], d.lo[1], d.lo[2], d.lo[3]);
    *reinterpret_cast<uint4*>(row + w8_chunk(n, 8 + rg) * 16) =
        make_uint4(d.hi[0], d.hi[1], d.hi[2], d.hi[3]);
  }
}

__device__ __forceinline__ void decode_load(Decode& d, const unsigned char* st, int cg, int rg) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    d.v[i] = *reinterpret_cast<const uint32_t*>(st + kOffQ + (16 * rg + i) * kBN8 + 4 * cg) ^
             0x88888888u;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    d.fw[r] = *reinterpret_cast<const uint32_t*>(st + kOffF + r * kBN8 + 4 * cg);
}

struct Args {
  const int8_t* a;
  const float* a_scale;
  const uint8_t* qs;
  const int8_t* f8;
  const float* e2;
};

// grid (ceil(N / 128), ceil(M / 128), slices), kThreads threads, kSmemBytes of
// dynamic shared memory. Slice z sums superblocks [z * slice_sbs, (z + 1) *
// slice_sbs); with more than one slice, scratch [slices, M, gridDim.x * 128]
// and counters [gridDim.x * gridDim.y] take the partials (finish_slices).
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 1)
i8p_sm90_kernel(Args g_, OutT* __restrict__ out, int M, int K, int N, int slice_sbs,
                float* __restrict__ scratch, int* __restrict__ counters) {
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* w8s = smem + kStages * kStageBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int cg = lane, rg = warp;                  // decode: 4 columns x 16 byte rows
  const int n0 = blockIdx.x * kBN8, m0 = blockIdx.y * kBM;
  const int nsb = K / kSB;
  const int sb0 = blockIdx.z * slice_sbs;
  const int units = min(nsb - sb0, slice_sbs);

  auto stage = [&](int u) { return smem + (u % kStages) * kStageBytes; };
  auto issue = [&](int u) {
    if (u < units) {
      unsigned char* st = stage(u);
      const int sb = sb0 + u;
      for (int c = tid; c < kBM * (kSB / 16); c += kThreads) {
        const int row = c / (kSB / 16), cc = c % (kSB / 16);
        const int gr = m0 + row;
        cp_async16(st + row * kSB + ((cc ^ (row & 7)) * 16),
                   g_.a + static_cast<size_t>(gr < M ? gr : 0) * K + sb * kSB + cc * 16,
                   gr < M ? 16 : 0);
      }
      for (int c = tid; c < kQBytes / 16; c += kThreads) {
        const int r = c / (kBN8 / 16), cc = (c % (kBN8 / 16)) * 16;
        copy_chunk(st + kOffQ + r * kBN8 + cc,
                   g_.qs + static_cast<size_t>(sb * (kSB / 2) + r) * N, n0 + cc, N);
      }
      if (tid < kFBytes / 16) {
        const int r = tid / (kBN8 / 16), cc = (tid % (kBN8 / 16)) * 16;
        copy_chunk(st + kOffF + r * kBN8 + cc, g_.f8 + static_cast<size_t>(sb * 8 + r) * N,
                   n0 + cc, N);
      } else if (tid < kFBytes / 16 + kBN8 / 4) {
        const int cc = (tid - kFBytes / 16) * 4;
        copy_chunk(st + kOffE + cc * 4, g_.e2 + static_cast<size_t>(sb) * N, n0 + cc, N);
      } else if (tid >= kThreads - kBM) {
        const int row = tid - (kThreads - kBM), gr = m0 + row;
        cp_async4(st + kOffS + row * 4,
                  g_.a_scale + static_cast<size_t>(gr < M ? gr : 0) * nsb + sb, gr < M ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  Decode d;
#pragma unroll
  for (int u = 0; u < kStages - 1; ++u) issue(u);
  cp_async_wait<kStages - 2>();
  __syncthreads();
  decode_load(d, stage(0), cg, rg);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) decode_part(d, ks, w8s, cg, rg);

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kStages - 3>();   // stages up to u + 1 have landed (this thread's copies)
    __syncthreads();                // ... everyone's; w8 tile u is written; superblock u - 1 done
    issue(u + kStages - 1);         // into the slot of stage u - 1
    const unsigned char* st = stage(u);
    const unsigned char* wb = w8s + (u & 1) * kW8Bytes;
    unsigned char* wn8 = w8s + ((u + 1) & 1) * kW8Bytes;
    const bool more = u + 1 < units;
    if (more) decode_load(d, stage(u + 1), cg, rg);

    // p starts at the bits of 1.5 * 2^23: its sums stay exact below 2^22, and
    // its float is then 12582912 + p
    int p[4][4][4];
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + (lane & 15);
        ldsm_x4_s8(af[i], st + r * kSB + (((2 * ks + (lane >> 4)) ^ (r & 7)) * 16));
      }
      uint32_t bf[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n = wn * 32 + jj * 16 + (lane >> 4) * 8 + (lane & 7);
        ldsm_x4_s8(bf[jj], wb + n * kSB + w8_chunk(n, 2 * ks + ((lane >> 3) & 1)) * 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ks == 0)
            mma_s8_from(p[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1],
                        0x4B400000);
          else
            mma_s8(p[i][j], af[i], bf[j >> 1][(j & 1) * 2], bf[j >> 1][(j & 1) * 2 + 1]);
        }
      if (more) decode_part(d, ks, wn8, cg, rg);
    }

    // rank-1 epilogue of the superblock: acc += p * (e2[n] * (a_scale[m] / 7))
    const float* e2s = reinterpret_cast<const float*>(st + kOffE);
    const float* ass = reinterpret_cast<const float*>(st + kOffS);
    float as7[4][2], ev[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        as7[i][h] = __fmul_rn(ass[wm * 64 + i * 16 + g + 8 * h], 1.0f / 7.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 e = *reinterpret_cast<const float2*>(e2s + wn * 32 + j * 8 + 2 * t);
      ev[j][0] = e.x;
      ev[j][1] = e.y;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // |p| <= 7 * 127 * 256 < 2^22: exact through the 1.5 * 2^23 bias
          const float pf = __fsub_rn(__int_as_float(p[i][j][r]), 12582912.f);
          const float s = __fmul_rn(ev[j][r & 1], as7[i][r >> 1]);
          acc[i][j][r] = __fadd_rn(acc[i][j][r], __fmul_rn(pf, s));
        }
  }
  cp_async_wait<0>();

  const int S = gridDim.z, npad = gridDim.x * kBN8;
  float* part = scratch + static_cast<size_t>(blockIdx.z) * M * npad;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = m0 + wm * 64 + i * 16 + g;
      const int c = n0 + wn * 32 + j * 8 + 2 * t;
      if (S == 1) {
        store2(out, M, N, r, c, acc[i][j][0], acc[i][j][1]);
        store2(out, M, N, r + 8, c, acc[i][j][2], acc[i][j][3]);
      } else {
        store2(part, M, npad, r, c, acc[i][j][0], acc[i][j][1]);
        store2(part, M, npad, r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
    }
  if (S > 1)
    finish_slices(scratch, out, counters + blockIdx.y * gridDim.x + blockIdx.x, S, M, N, npad,
                  m0, kBM, n0, kBN8);
}

template <typename OutT>
int launch(const Args& args, OutT* out, int M, int K, int N, int slice_sbs, float* scratch,
           int* counters, cudaStream_t stream) {
  auto kernel = i8p_sm90_kernel<OutT>;
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes) !=
        cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const int nsb = K / kSB;
  if (slice_sbs < 1) return rrs::kBadArgs;
  const dim3 grid((N + kBN8 - 1) / kBN8, (M + kBM - 1) / kBM, (nsb + slice_sbs - 1) / slice_sbs);
  if (grid.y > 65535 || grid.z > 65535 ||
      (grid.z > 1 && (scratch == nullptr || counters == nullptr)))
    return rrs::kBadArgs;
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(args, out, M, K, N, slice_sbs, scratch,
                                                 counters);
  return rrs::status();
}

}  // namespace

// slice_units: superblocks per K slice (ops/splitk.py, unit 256); scratch and
// counters as finish_slices (gemm_sm90.cuh) takes them, else unused.
RRS_EXPORT int rrs_tcq4_i8p(const void* a, const void* a_scale, const void* qs, const void* f8,
                            const void* e2, void* out, int M, int K, int N, int out_bf16,
                            int slice_units, void* scratch, void* counters, void* stream) {
  if (K % kSB != 0 || K < kSB || N % 4 != 0 || N < 4 || M < 1) return rrs::kBadArgs;
  const Args args{static_cast<const int8_t*>(a), static_cast<const float*>(a_scale),
                  static_cast<const uint8_t*>(qs), static_cast<const int8_t*>(f8),
                  static_cast<const float*>(e2)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(scratch);
  int* cp = static_cast<int*>(counters);
  if (out_bf16)
    return launch(args, static_cast<__nv_bfloat16*>(out), M, K, N, slice_units, sp, cp, s);
  return launch(args, static_cast<float*>(out), M, K, N, slice_units, sp, cp, s);
}
