// Online-softmax GQA attention over [B, Hkv, S, D] bf16 KV caches.
//
// Replaces rrs_tpu/ops/flash_attention.py:343 flash_attention (_kernel at
// :175, _kernel_sink at :186, _flash_inner at :70), all its options included:
// the causal mask from per-row positions (-1 marks a padded row, which
// outputs 0), ring caches with a sliding window, logit softcap, ALiBi and
// per-head attention sinks. Masked scores contribute exactly 0.
//
// Bound on the H100: bytes at decode (the K/V slots up to the row's position
// are read once per step), operations at prefill (4 * D FLOPs per unmasked
// (query, slot) pair).
//
// Design: one block of 128 threads per (lane, kv head, query tile). The G
// query heads of the kv head and up to R_MAX / G query rows share every K/V
// tile staged in shared memory, so K/V are read once per query tile. Scores,
// the running max / denominator and the accumulator stay in f32 on the CUDA
// cores; the accumulator rows live in registers. Without a window the S loop
// stops after the tile holding the tile's largest position, since later slots
// are all masked and would add exactly 0. Decode runs only B * Hkv blocks,
// and a 64-row prefill chunk of qwen3-4b only 8 * 4 = 32, each with scalar
// f32 QK and PV loops, so neither comes near its bound. Splitting S across
// blocks (flash-decoding), more query tiles, and mma.sync bf16 tiles for QK
// and PV are left for the change that makes this kernel fast.

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;   // NEG_INF of the JAX kernel

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D>
struct Cfg {
  static constexpr int kBS = D <= 128 ? 64 : 32;        // KV slots per tile
  static constexpr int kRMax = D <= 128 ? 64 : 32;      // query rows (tq * G) per block
  static constexpr int kLdQK = D + 2;                   // bf16 row stride, bank-skewed
  static constexpr int kDC = D < kThreads ? D : kThreads;
  static constexpr int kRS = kThreads / kDC;            // row stride of a thread
  static constexpr int kCPT = D / kDC;                  // columns per thread
  static constexpr int kRowsPT = kRMax / kRS;           // accumulator rows per thread
  static constexpr size_t kQ = size_t(kRMax) * kLdQK * 2;
  static constexpr size_t kK = size_t(kBS) * kLdQK * 2;
  static constexpr size_t kV = size_t(kBS) * D * 2;
  static constexpr size_t kP = size_t(kRMax) * kBS * 4;
  static constexpr size_t kRows = size_t(kRMax) * 4 * 4;
  static constexpr size_t kBytes = kQ + kK + kV + kP + kRows;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ kc,
             const __nv_bfloat16* __restrict__ vc, const int* __restrict__ positions,
             const float* __restrict__ sinks, const float* __restrict__ slopes,
             __nv_bfloat16* __restrict__ out, int T, int H, int Hkv, int S, int tq, float scale,
             float softcap, int window) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + C::kQ);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + C::kQ + C::kK);
  float* Ps = reinterpret_cast<float*>(smem + C::kQ + C::kK + C::kV);
  float* row_m = reinterpret_cast<float*>(smem + C::kQ + C::kK + C::kV + C::kP);
  float* row_l = row_m + C::kRMax;
  float* row_corr = row_l + C::kRMax;
  int* row_pos = reinterpret_cast<int*>(row_corr + C::kRMax);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / Hkv, hk = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int q0 = blockIdx.y * tq;
  const int R = tq * G;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + hk) * S * D;

  // Stage the query rows (row r = query i * G + group gi) and their positions.
  for (int idx = tid; idx < R * (D / 2); idx += kThreads) {
    const int r = idx / (D / 2), dp = idx % (D / 2);
    const int qi = q0 + r / G, head = hk * G + r % G;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (qi < T)
      v = *reinterpret_cast<const __nv_bfloat162*>(
          q + ((static_cast<size_t>(b) * T + qi) * H + head) * D + 2 * dp);
    *reinterpret_cast<__nv_bfloat162*>(Qs + r * C::kLdQK + 2 * dp) = v;
  }
  for (int r = tid; r < R; r += kThreads) {
    const int qi = q0 + r / G;
    row_pos[r] = qi < T ? positions[static_cast<size_t>(b) * T + qi] : -1;
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }
  __syncthreads();

  int n_slots = S;
  if (window <= 0) {
    int maxpos = -1;
    for (int r = 0; r < R; ++r) maxpos = max(maxpos, row_pos[r]);
    n_slots = min(S, maxpos + 1);
  }

  const int dcol = tid % C::kDC;
  const int rbase = tid / C::kDC;
  float acc[C::kRowsPT][C::kCPT];
#pragma unroll
  for (int i = 0; i < C::kRowsPT; ++i)
#pragma unroll
    for (int c = 0; c < C::kCPT; ++c) acc[i][c] = 0.f;

  for (int s0 = 0; s0 < n_slots; s0 += C::kBS) {
    for (int idx = tid; idx < C::kBS * (D / 2); idx += kThreads) {
      const int s = idx / (D / 2), dp = idx % (D / 2);
      __nv_bfloat162 kv = __floats2bfloat162_rn(0.f, 0.f), vv = kv;
      if (s0 + s < S) {
        const size_t off = kv_base + static_cast<size_t>(s0 + s) * D + 2 * dp;
        kv = *reinterpret_cast<const __nv_bfloat162*>(kc + off);
        vv = *reinterpret_cast<const __nv_bfloat162*>(vc + off);
      }
      *reinterpret_cast<__nv_bfloat162*>(Ks + s * C::kLdQK + 2 * dp) = kv;
      *reinterpret_cast<__nv_bfloat162*>(Vs + s * D + 2 * dp) = vv;
    }
    __syncthreads();

    // Scores; a masked slot is stored as -inf, which gives exactly 0 after
    // exp and leaves the running max as the JAX kernel's NEG_INF fill does.
    for (int idx = tid; idx < R * C::kBS; idx += kThreads) {
      const int r = idx / C::kBS, s = idx % C::kBS;
      const int slot = s0 + s;
      const int pos = row_pos[r];
      bool valid;
      int real = slot;
      if (window > 0) {
        int off = (pos - slot) % S;
        if (off < 0) off += S;
        real = pos - off;
        valid = real >= 0 && real > pos - window;
      } else {
        valid = slot <= pos && pos >= 0;
      }
      valid = valid && slot < S;
      float sc = neg_inf();
      if (valid) {
        const __nv_bfloat162* qr = reinterpret_cast<const __nv_bfloat162*>(Qs + r * C::kLdQK);
        const __nv_bfloat162* kr = reinterpret_cast<const __nv_bfloat162*>(Ks + s * C::kLdQK);
        float dot = 0.f;
#pragma unroll 8
        for (int d = 0; d < D / 2; ++d) {
          const float2 a = __bfloat1622float2(qr[d]);
          const float2 k = __bfloat1622float2(kr[d]);
          dot += a.x * k.x;
          dot += a.y * k.y;
        }
        sc = dot * scale;
        if (softcap > 0.f) sc = tanhf(sc / softcap) * softcap;
        if (slopes != nullptr) sc += slopes[hk * G + r % G] * static_cast<float>(real - pos);
      }
      Ps[r * C::kBS + s] = sc;
    }
    __syncthreads();

    for (int r = warp; r < R; r += kThreads / 32) {
      float mx = neg_inf();
      for (int s = lane; s < C::kBS; s += 32) mx = fmaxf(mx, Ps[r * C::kBS + s]);
      mx = rrs::warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < C::kBS; s += 32) {
        const float e = expf(Ps[r * C::kBS + s] - m_new);
        Ps[r * C::kBS + s] = e;
        sum += e;
      }
      sum = rrs::warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        row_l[r] = row_l[r] * corr + sum;
        row_m[r] = m_new;
        row_corr[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < C::kRowsPT; ++i) {
      const int r = rbase + i * C::kRS;
      if (r < R) {
        const float corr = row_corr[r];
        const float* pr = Ps + r * C::kBS;
#pragma unroll
        for (int c = 0; c < C::kCPT; ++c) {
          const int d = dcol + c * C::kDC;
          float sacc = 0.f;
          for (int s = 0; s < C::kBS; ++s) sacc += pr[s] * __bfloat162float(Vs[s * D + d]);
          acc[i][c] = acc[i][c] * corr + sacc;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < C::kRowsPT; ++i) {
    const int r = rbase + i * C::kRS;
    const int qi = q0 + r / G, head = hk * G + r % G;
    if (r >= R || qi >= T) continue;
    float l = row_l[r];
    if (sinks != nullptr) l += expf(sinks[head] - row_m[r]);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < C::kCPT; ++c) {
      const int d = dcol + c * C::kDC;
      out[((static_cast<size_t>(b) * T + qi) * H + head) * D + d] = __float2bfloat16_rn(acc[i][c] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* pos, const float* sinks,
           const float* slopes, void* out, int B, int T, int H, int Hkv, int S, float scale,
           float softcap, int window, cudaStream_t s) {
  using C = Cfg<D>;
  const int G = H / Hkv;
  if (G > C::kRMax) return rrs::kBadArgs;
  const int tq = std::min(T, C::kRMax / G);
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(flash_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::kBytes)) != cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const dim3 grid(B * Hkv, (T + tq - 1) / tq);
  flash_kernel<D><<<grid, kThreads, C::kBytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), pos, sinks, slopes,
      static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, tq, scale, softcap, window);
  return rrs::status();
}

}  // namespace

RRS_EXPORT int rrs_flash_attention(const void* q, const void* k, const void* v, const void* pos,
                                   const void* sinks, const void* slopes, void* out, int B,
                                   int T, int H, int Hkv, int S, int D, float scale,
                                   float softcap, int window, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || S < 1) return rrs::kBadArgs;
  const int* p = static_cast<const int*>(pos);
  const float* sk = static_cast<const float*>(sinks);
  const float* sl = static_cast<const float*>(slopes);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return launch<64>(q, k, v, p, sk, sl, out, B, T, H, Hkv, S, scale, softcap, window, st);
    case 128: return launch<128>(q, k, v, p, sk, sl, out, B, T, H, Hkv, S, scale, softcap, window, st);
    case 256: return launch<256>(q, k, v, p, sk, sl, out, B, T, H, Hkv, S, scale, softcap, window, st);
    default: return rrs::kBadArgs;
  }
}
