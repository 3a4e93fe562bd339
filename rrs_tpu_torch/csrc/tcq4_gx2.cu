// W4A4 decode matmul with the activation quantization fused into the
// prologue.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:1262 tcq4_matmul_gx2 (_kernel_gx2 at
// :1194). C[m, n] = sum over 32-groups g of
//     (dot32(q_a[m, g], w_q[g, n]) * (amax[m, sb] / 7)) * eff[g, n]
// where q_a = clip(rint(a_rot * (7 / amax)), -7, 7) per 256-block, exactly
// as quantize_activations_rrs computes it; the group dots are int32-exact.
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

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 8;                       // threads across the N tile
constexpr int kBN = kColThreads * 4;                 // 32 columns per block
constexpr int kSlices = kThreads / kColThreads;      // 32 K-slices
constexpr int kWarps = kThreads / 32;

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

template <int M>
__global__ void __launch_bounds__(kThreads)
gx2_kernel(const float* __restrict__ a, const uint8_t* __restrict__ qs,
           const __nv_bfloat16* __restrict__ eff, float* __restrict__ out,
           int K, int N, int scale_off, int red_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* aq = reinterpret_cast<int8_t*>(smem);                    // [M][K]
  float* ascale = reinterpret_cast<float*>(smem + scale_off);      // [M][nsb]
  float* red = reinterpret_cast<float*>(smem + red_off);           // [warps][M][kBN]

  const int nsb = K / 256;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // Prologue: per (row, superblock) absmax int4 quantization, one warp each.
  for (int p = warp; p < M * nsb; p += kWarps) {
    const int m = p / nsb, sb = p - m * nsb;
    const float* src = a + static_cast<size_t>(m) * K + sb * 256 + lane * 8;
    const float4 x0 = *reinterpret_cast<const float4*>(src);
    const float4 x1 = *reinterpret_cast<const float4*>(src + 4);
    float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    float amax = 0.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
    amax = rrs::warp_max(amax);
    if (amax < 1e-10f) amax = 1.0f;
    const float rec = 7.0f / amax;
    int8_t* dst = aq + static_cast<size_t>(m) * K + sb * 256 + lane * 8;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float q = fminf(fmaxf(rintf(x[i] * rec), -7.0f), 7.0f);
      dst[i] = static_cast<int8_t>(q);
    }
    if (lane == 0) ascale[m * nsb + sb] = amax * (1.0f / 7.0f);
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
      const uint8_t* wrow = qs + static_cast<size_t>(sb * 128 + qq * 32) * N + col0;
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
      const uint2 elo_raw = __ldg(reinterpret_cast<const uint2*>(eff + static_cast<size_t>(g_lo) * N + col0));
      const uint2 ehi_raw = __ldg(reinterpret_cast<const uint2*>(eff + static_cast<size_t>(g_hi) * N + col0));
      const __nv_bfloat16* elo_h = reinterpret_cast<const __nv_bfloat16*>(&elo_raw);
      const __nv_bfloat16* ehi_h = reinterpret_cast<const __nv_bfloat16*>(&ehi_raw);
      float elo[4], ehi[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        elo[c] = __bfloat162float(elo_h[c]);
        ehi[c] = __bfloat162float(ehi_h[c]);
      }
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float s = ascale[m * nsb + sb];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          y[m][c] += (static_cast<float>(acc_lo[m][c]) * s) * elo[c];
          y[m][c] += (static_cast<float>(acc_hi[m][c]) * s) * ehi[c];
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
    out[static_cast<size_t>(m) * N + gc] = s;
  }
}

template <int M>
int launch(const float* a, const uint8_t* qs, const __nv_bfloat16* eff, float* out,
           int K, int N, cudaStream_t stream) {
  const Layout l = layout(M, K);
  if (l.bytes > 48 * 1024) return rrs::kBadArgs;
  const dim3 grid((N + kBN - 1) / kBN);
  gx2_kernel<M><<<grid, kThreads, l.bytes, stream>>>(
      a, qs, eff, out, K, N, static_cast<int>(l.scale_off), static_cast<int>(l.red_off));
  return rrs::status();
}

}  // namespace

RRS_EXPORT int rrs_tcq4_gx2(const void* a, const void* qs, const void* eff, void* out,
                            int M, int K, int N, void* stream) {
  if (K % 256 != 0 || N % 4 != 0 || M < 1 || M > 8) return rrs::kBadArgs;
  const float* ap = static_cast<const float*>(a);
  const uint8_t* qp = static_cast<const uint8_t*>(qs);
  const __nv_bfloat16* ep = static_cast<const __nv_bfloat16*>(eff);
  float* op = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (M) {
    case 1: return launch<1>(ap, qp, ep, op, K, N, s);
    case 2: return launch<2>(ap, qp, ep, op, K, N, s);
    case 3: return launch<3>(ap, qp, ep, op, K, N, s);
    case 4: return launch<4>(ap, qp, ep, op, K, N, s);
    case 5: return launch<5>(ap, qp, ep, op, K, N, s);
    case 6: return launch<6>(ap, qp, ep, op, K, N, s);
    case 7: return launch<7>(ap, qp, ep, op, K, N, s);
    default: return launch<8>(ap, qp, ep, op, K, N, s);
  }
}
