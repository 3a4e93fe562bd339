// W4A4 decode matmuls over int8 group dots: the pre-quantized one (gx), the
// one with the activation quantization fused into its prologue (gx2), and the
// one that also fuses the 256-point Walsh-Hadamard rotation (gx3). The three
// share one body and differ only in the prologue that fills shared memory
// with the int4 activation codes and their per-superblock scales.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:1262 tcq4_matmul_gx2 (_kernel_gx2 at
// :1194), :272 tcq4_matmul_gx (_kernel_gx at :160) and :1394
// tcq4_matmul_gx3 (_kernel_gx3 at :1332). C[m, n] = sum over 32-groups g of
//     (dot32(q_a[m, g], w_q[g, n]) * (amax[m, sb] / 7)) * eff[g, n]
// where, for gx2, q_a = clip(rint(a_rot * (7 / amax)), -7, 7) per 256-block,
// exactly as quantize_activations_rrs computes it; gx3 first rotates the raw
// activations, x_rot = FWHT256(x) / 16; gx takes q_a and amax as given. The
// group dots are int32-exact.
//
// Bound on the H100: bytes. At M = 1 each weight byte feeds two int8 MACs,
// far below the card's ops/byte balance, so the time is the qs
// (K/2 * N bytes) plus bf16 eff (K/32 * N * 2 bytes) stream.
//
// Design: one block per 32-column tile of N, 256 threads. Each block
// re-quantizes the <= 8 activation rows into shared memory (M*K <= 32 KiB
// under gx_viable), which costs an L2 read of the activations but no extra
// launch. Threads take 4 adjacent columns (one 32-bit load per byte row) and
// 32 K-slices share the block: a slice walks (superblock, quarter) units of
// 32 byte rows, whose low and high nibbles are two whole scale groups, so
// each unit ends in one exact int32 dot per group and column. The slices
// reduce by warp shuffles and then through shared memory. A thin N tile keeps
// enough blocks in flight for the fat-K, thin-N projections (o, down);
// split-K, wider loads and dp4a are left for a later change.
//
// gx3's rotation: the quantizing prologue already gives one warp per (row,
// superblock) with 8 consecutive elements per lane, which is the layout of a
// 256-point butterfly: stages h = 1, 2, 4 run inside the lane's registers and
// h = 8 ... 128 exchange with lane ^ (h / 8) by __shfl_xor_sync (the lower
// index keeps a + b, the upper a - b), then the result is scaled by 1/16,
// which is exact. That is the Sylvester (natural) order of
// formats/fwht.py hadamard_matrix, about 2k adds per (row, superblock) in
// place of JAX's in-kernel 256 x 256 dot. The epilogue uses explicit
// round-to-nearest products and sums, so that every instantiation rounds
// alike and gx is bit-equal to gx2 given gx2's own codes.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 8;                       // threads across the N tile
constexpr int kBN = kColThreads * 4;                 // 32 columns per block
constexpr int kSlices = kThreads / kColThreads;      // 32 K-slices
constexpr int kWarps = kThreads / 32;

// The prologue: what fills aq / ascale in shared memory.
enum Prologue { kGiven = 0, kQuantize = 1, kRotateQuantize = 2 };

struct Layout {
  size_t scale_off, red_off, bytes;
};

inline Layout layout(int M, int K) {
  Layout l;
  l.scale_off = rrs::round_up(static_cast<size_t>(M) * K, 16);
  l.red_off = l.scale_off + rrs::round_up(static_cast<size_t>(M) * (K / 256) * 4, 16);
  l.bytes = l.red_off + static_cast<size_t>(kWarps) * M * kBN * 4;
  return l;
}

struct Args {
  const void* a;           // f32 / bf16 activations [M, K], or int8 codes (kGiven)
  const float* a_scale;    // kGiven: f32 [M, K/256] per-block absmax
  const uint8_t* qs;       // [K/2, N]
  const void* eff;         // bf16 or f32 [K/32, N]
  float* out;              // f32 [M, N]
  int K, N, scale_off, red_off;
  int x_bf16, eff_f32;
};

// Quantize one lane's 8 rotated values of a (row, superblock) and store the
// codes and the block's scale amax / 7.
__device__ __forceinline__ void quantize8(float (&x)[8], int8_t* dst, float* scale, int lane) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
  amax = rrs::warp_max(amax);
  if (amax < 1e-10f) amax = 1.0f;
  const float rec = 7.0f / amax;                     // a true division
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(x[i], rec)), -7.0f), 7.0f);
    dst[i] = static_cast<int8_t>(q);
  }
  if (lane == 0) *scale = __fmul_rn(amax, 1.0f / 7.0f);
}

// In-place natural-order 256-point Walsh-Hadamard transform over a warp, 8
// consecutive elements per lane, scaled by 1/16.
__device__ __forceinline__ void fwht256(float (&x)[8], int lane) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & h) continue;
      const float a = x[i], b = x[i + h];
      x[i] = __fadd_rn(a, b);
      x[i + h] = __fsub_rn(a, b);
    }
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float other = __shfl_xor_sync(0xffffffffu, x[i], m);
      x[i] = upper ? __fsub_rn(other, x[i]) : __fadd_rn(x[i], other);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(x[i], 0.0625f);
}

__device__ __forceinline__ void load8(const Args& p, int m, int sb, int lane, float (&x)[8]) {
  const size_t off = static_cast<size_t>(m) * p.K + sb * 256 + lane * 8;
  if (p.x_bf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        static_cast<const __nv_bfloat16*>(p.a) + off);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
  } else {
    const float* src = static_cast<const float*>(p.a) + off;
    const float4 x0 = *reinterpret_cast<const float4*>(src);
    const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
    x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
    x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
  }
}

__device__ __forceinline__ void load_eff(const Args& p, int g, int col0, float (&e)[4]) {
  const size_t off = static_cast<size_t>(g) * p.N + col0;
  if (p.eff_f32) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(p.eff) + off));
    e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
  } else {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p.eff) + off));
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int c = 0; c < 4; ++c) e[c] = __bfloat162float(h[c]);
  }
}

template <int M, int Pro>
__global__ void __launch_bounds__(kThreads)
gx2_kernel(const Args p) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* aq = reinterpret_cast<int8_t*>(smem);                      // [M][K]
  float* ascale = reinterpret_cast<float*>(smem + p.scale_off);      // [M][nsb], amax / 7
  float* red = reinterpret_cast<float*>(smem + p.red_off);           // [warps][M][kBN]

  const int K = p.K, N = p.N;
  const int nsb = K / 256;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (Pro == kGiven) {
    // the codes as given (16 bytes a thread per step) and amax / 7
    const uint4* src = static_cast<const uint4*>(p.a);
    for (int c = tid; c < M * K / 16; c += kThreads)
      reinterpret_cast<uint4*>(aq)[c] = src[c];
    for (int c = tid; c < M * nsb; c += kThreads)
      ascale[c] = __fmul_rn(p.a_scale[c], 1.0f / 7.0f);
  } else {
    // per (row, superblock) absmax int4 quantization, one warp each
    for (int q = warp; q < M * nsb; q += kWarps) {
      const int m = q / nsb, sb = q - m * nsb;
      float x[8];
      load8(p, m, sb, lane, x);
      if (Pro == kRotateQuantize) fwht256(x, lane);
      quantize8(x, aq + static_cast<size_t>(m) * K + sb * 256 + lane * 8,
                ascale + m * nsb + sb, lane);
    }
  }
  __syncthreads();

  const int tc = tid % kColThreads;
  const int ks = tid / kColThreads;
  const int col0 = blockIdx.x * kBN + tc * 4;
  float y[M][4];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[m][c] = 0.0f;

  if (col0 < N) {
    const int nunits = nsb * 4;
    for (int u = ks; u < nunits; u += kSlices) {
      const int sb = u >> 2, qq = u & 3;
      int acc_lo[M][4], acc_hi[M][4];
#pragma unroll
      for (int m = 0; m < M; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc_lo[m][c] = acc_hi[m][c] = 0;
      const uint8_t* wrow = p.qs + static_cast<size_t>(sb * 128 + qq * 32) * N + col0;
      const int8_t* arow = aq + sb * 256 + qq * 32;
#pragma unroll 8
      for (int r = 0; r < 32; ++r) {
        const uint32_t v = __ldg(reinterpret_cast<const uint32_t*>(wrow + static_cast<size_t>(r) * N));
        int wlo[4], whi[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          wlo[c] = rrs::nib_lo(v, c);
          whi[c] = rrs::nib_hi(v, c);
        }
#pragma unroll
        for (int m = 0; m < M; ++m) {
          const int alo = arow[m * K + r];
          const int ahi = arow[m * K + 128 + r];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc_lo[m][c] += alo * wlo[c];
            acc_hi[m][c] += ahi * whi[c];
          }
        }
      }
      const int g_lo = sb * 8 + qq, g_hi = g_lo + 4;
      float elo[4], ehi[4];
      load_eff(p, g_lo, col0, elo);
      load_eff(p, g_hi, col0, ehi);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float s = ascale[m * nsb + sb];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          y[m][c] = __fadd_rn(y[m][c], __fmul_rn(__fmul_rn(static_cast<float>(acc_lo[m][c]), s),
                                                 elo[c]));
          y[m][c] = __fadd_rn(y[m][c], __fmul_rn(__fmul_rn(static_cast<float>(acc_hi[m][c]), s),
                                                 ehi[c]));
        }
      }
    }
  }

  // The 4 K-slices of a warp sit in lane bits 3-4: fold them by shuffles,
  // then the 8 warps through shared memory.
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float v = y[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      y[m][c] = v;
    }
  if (lane < kColThreads) {
#pragma unroll
    for (int m = 0; m < M; ++m)
#pragma unroll
      for (int c = 0; c < 4; ++c) red[(warp * M + m) * kBN + tc * 4 + c] = y[m][c];
  }
  __syncthreads();
  for (int idx = tid; idx < M * kBN; idx += kThreads) {
    const int m = idx / kBN, col = idx - m * kBN;
    const int gc = blockIdx.x * kBN + col;
    if (gc >= N) continue;
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[(w * M + m) * kBN + col];
    p.out[static_cast<size_t>(m) * N + gc] = s;
  }
}

template <int M, int Pro>
int launch(Args p, cudaStream_t stream) {
  const Layout l = layout(M, p.K);
  if (l.bytes > 48 * 1024) return rrs::kBadArgs;
  p.scale_off = static_cast<int>(l.scale_off);
  p.red_off = static_cast<int>(l.red_off);
  const dim3 grid((p.N + kBN - 1) / kBN);
  gx2_kernel<M, Pro><<<grid, kThreads, l.bytes, stream>>>(p);
  return rrs::status();
}

template <int Pro>
int dispatch(const Args& p, int M, cudaStream_t s) {
  switch (M) {
    case 1: return launch<1, Pro>(p, s);
    case 2: return launch<2, Pro>(p, s);
    case 3: return launch<3, Pro>(p, s);
    case 4: return launch<4, Pro>(p, s);
    case 5: return launch<5, Pro>(p, s);
    case 6: return launch<6, Pro>(p, s);
    case 7: return launch<7, Pro>(p, s);
    default: return launch<8, Pro>(p, s);
  }
}

bool bad_shape(int M, int K, int N) { return K % 256 != 0 || N % 4 != 0 || M < 1 || M > 8; }

}  // namespace

// gx2 (B1): f32 rotated activations, bf16 eff.
RRS_EXPORT int rrs_tcq4_gx2(const void* a, const void* qs, const void* eff, void* out,
                            int M, int K, int N, void* stream) {
  if (bad_shape(M, K, N)) return rrs::kBadArgs;
  const Args p{a, nullptr, static_cast<const uint8_t*>(qs), eff, static_cast<float*>(out),
               K, N, 0, 0, 0, 0};
  return dispatch<kQuantize>(p, M, static_cast<cudaStream_t>(stream));
}

// gx (B14): int8 codes and f32 per-block absmax as given; bf16 or f32 eff.
RRS_EXPORT int rrs_tcq4_gx(const void* a_q, const void* a_scale, const void* qs, const void* eff,
                           int eff_f32, void* out, int M, int K, int N, void* stream) {
  if (bad_shape(M, K, N)) return rrs::kBadArgs;
  const Args p{a_q, static_cast<const float*>(a_scale), static_cast<const uint8_t*>(qs), eff,
               static_cast<float*>(out), K, N, 0, 0, 0, eff_f32 ? 1 : 0};
  return dispatch<kGiven>(p, M, static_cast<cudaStream_t>(stream));
}

// gx3 (B15): f32 or bf16 unrotated activations, bf16 eff.
RRS_EXPORT int rrs_tcq4_gx3(const void* x, int x_bf16, const void* qs, const void* eff, void* out,
                            int M, int K, int N, void* stream) {
  if (bad_shape(M, K, N)) return rrs::kBadArgs;
  const Args p{x, nullptr, static_cast<const uint8_t*>(qs), eff, static_cast<float*>(out),
               K, N, 0, 0, x_bf16 ? 1 : 0, 0};
  return dispatch<kRotateQuantize>(p, M, static_cast<cudaStream_t>(stream));
}
