// Online-softmax GQA attention over quantized KV caches: int8 rows (q8), and
// packed int4 in the head-pair (q4hp) and halves (q4) layouts, each with an
// f32 scale per (kv head, slot) in [B, Hkv, 1, S].
//
// Replaces three TPU kernels of rrs_tpu/ops/flash_attention.py:
//   B6 :398 flash_attention_q8   (_kernel_q8 :198, _kernel_q8_sink :291);
//   B7 :519 flash_attention_q4hp (_kernel_q4hp :262, _kernel_q4hp_sink :276,
//                                 _q4hp_kv :249);
//   B8 :457 flash_attention_q4   (_kernel_q4 :221, _kernel_q4_sink :235,
//                                 _unpack_kv4 :212).
// The function is dequantize, then attend (rrs_tpu_torch/runtime/kv_codec.py
// layouts), with every option of the bf16 kernel: the causal mask from
// per-row positions (-1 marks a padded row, which outputs exactly 0), ring
// caches with a sliding window, logit softcap, ALiBi and per-head sinks.
//
// Bound on the H100: bytes at decode (codes and scales up to each row's
// position, read once per step: a quarter (q4) or half (q8) of the bf16
// cache's), operations at prefill (4 * D FLOPs per unmasked (query, slot)
// pair).
//
// Design: the bf16 kernel's (csrc/flash_attention.cu), templated on the
// codec. One block of 128 threads per (lane, code plane, query tile); the
// query heads of the plane's kv heads share every staged tile. K/V tiles are
// staged in shared memory as raw codes, one byte per element for q8 and half
// a byte for q4 (rows skewed to an odd number of words, so the QK loop's
// row-per-thread reads are conflict-free), and decoded to f32 inside the QK
// and PV loops. The TPU kernels apply the scales and the head-pair +8 bias
// in an epilogue, a Mosaic layout workaround; here the nibble is decoded
// with its bias, the score is multiplied by scale * k_s[slot], and p by
// v_s[slot] before the PV loop (the running denominator sums p unscaled).
//
// Head pairs (B7): one block serves a whole plane, both kv heads of a pair
// and their 2G query rows, each row decoding its own nibble and reading its
// own head's scales. At decode the kernel is bound by bytes, and this reads
// every packed byte from device memory once; one block per kv head would
// read each byte twice (once per nibble) and stage half-used tiles. The cost
// is half as many blocks at decode (B * Hkv / 2), a grid already far too
// small to fill the card in the bf16 kernel: splitting S (flash-decoding),
// mma tiles and TMA are left for the change that makes these kernels fast.

#include <algorithm>

#include "common.cuh"

namespace {

enum Codec { kQ8 = 0, kQ4HeadPair = 1, kQ4Halves = 2 };

constexpr int kThreads = 128;
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;   // NEG_INF of the JAX kernel

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D, int C>
struct Cfg {
  static constexpr int kNH = C == kQ4HeadPair ? 2 : 1;         // kv heads per code plane
  static constexpr int kRowBytes = C == kQ4Halves ? D / 2 : D;  // code bytes of one slot
  static constexpr int kLdC = kRowBytes + 4;                    // odd word count per row
  static constexpr int kBS = D <= 128 ? 64 : 32;                // KV slots per tile
  static constexpr int kRMax = D <= 128 ? 64 : 32;              // query rows per block
  static constexpr int kLdQ = D + 2;                            // bf16 row stride
  static constexpr int kDC = D < kThreads ? D : kThreads;
  static constexpr int kRS = kThreads / kDC;                    // row stride of a thread
  static constexpr int kCPT = D / kDC;                          // columns per thread
  static constexpr int kRowsPT = kRMax / kRS;                   // accumulator rows per thread
  static constexpr size_t kQ = size_t(kRMax) * kLdQ * 2;
  static constexpr size_t kKV = size_t(kBS) * kLdC;             // K (or V) codes
  static constexpr size_t kSc = size_t(kNH) * kBS * 4;          // K (or V) scales
  static constexpr size_t kP = size_t(kRMax) * kBS * 4;
  static constexpr size_t kRows = size_t(kRMax) * 4 * 4;
  static constexpr size_t kBytes = kQ + 2 * kKV + 2 * kSc + kP + kRows;
  static_assert(kQ % 16 == 0 && kKV % 16 == 0, "shared memory carve-up alignment");
};

struct Args {
  const __nv_bfloat16* q;
  const uint8_t* kc;
  const float* ks;
  const uint8_t* vc;
  const float* vs;
  const int* positions;
  const float* sinks;
  const float* slopes;
  __nv_bfloat16* out;
  int T, H, Hkv, S, tq;
  float scale, softcap;
  int window;
};

// Code of byte `c` of a little-endian word: a signed byte (q8), the nibble
// of kv head `sub` less its +8 bias (q4hp), or the low nibble sign-extended
// (q4 halves; the high nibble is `hi_code`).
template <int C>
__device__ __forceinline__ float byte_code(uint32_t word, int c, int sub) {
  const uint32_t b = (word >> (8 * c)) & 0xffu;
  if constexpr (C == kQ8) {
    return static_cast<float>(static_cast<int8_t>(b));
  } else if constexpr (C == kQ4HeadPair) {
    return static_cast<float>(static_cast<int>((b >> (4 * sub)) & 15u) - 8);
  } else {
    return static_cast<float>(static_cast<int>((b & 15u) ^ 8u) - 8);
  }
}

__device__ __forceinline__ float hi_code(uint32_t word, int c) {
  return static_cast<float>(static_cast<int>(((word >> (8 * c + 4)) & 15u) ^ 8u) - 8);
}

// Code of element d of a staged slot row.
template <int D, int C>
__device__ __forceinline__ float code_at(const uint8_t* row, int d, int sub) {
  if constexpr (C == kQ4Halves) {
    return d < D / 2 ? byte_code<C>(row[d], 0, 0) : hi_code(row[d - D / 2], 0);
  } else {
    return byte_code<C>(row[d], 0, sub);
  }
}

// q . codes over D for one query row (bf16 in shared memory) and one staged
// slot row.
template <int D, int C>
__device__ __forceinline__ float qk_dot(const __nv_bfloat16* qr, const uint8_t* kr, int sub) {
  float dot = 0.f;
  if constexpr (C == kQ4Halves) {
#pragma unroll 4
    for (int w = 0; w < D / 8; ++w) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(kr + 4 * w);
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 4 * w));
      const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 4 * w + 2));
      const float2 b0 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + D / 2 + 4 * w));
      const float2 b1 =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + D / 2 + 4 * w + 2));
      dot += a0.x * byte_code<C>(word, 0, 0) + a0.y * byte_code<C>(word, 1, 0) +
             a1.x * byte_code<C>(word, 2, 0) + a1.y * byte_code<C>(word, 3, 0);
      dot += b0.x * hi_code(word, 0) + b0.y * hi_code(word, 1) + b1.x * hi_code(word, 2) +
             b1.y * hi_code(word, 3);
    }
  } else {
#pragma unroll 4
    for (int w = 0; w < D / 4; ++w) {
      const uint32_t word = *reinterpret_cast<const uint32_t*>(kr + 4 * w);
      const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 4 * w));
      const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 4 * w + 2));
      dot += a0.x * byte_code<C>(word, 0, sub) + a0.y * byte_code<C>(word, 1, sub) +
             a1.x * byte_code<C>(word, 2, sub) + a1.y * byte_code<C>(word, 3, sub);
    }
  }
  return dot;
}

template <int D, int C>
__global__ void __launch_bounds__(kThreads) kvq_kernel(const Args a) {
  using K = Cfg<D, C>;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* Ks = smem + K::kQ;
  uint8_t* Vs = Ks + K::kKV;
  float* KSs = reinterpret_cast<float*>(Vs + K::kKV);           // [kNH][kBS]
  float* VSs = KSs + K::kNH * K::kBS;
  float* Ps = VSs + K::kNH * K::kBS;
  float* row_m = Ps + K::kRMax * K::kBS;
  float* row_l = row_m + K::kRMax;
  float* row_corr = row_l + K::kRMax;
  int* row_pos = reinterpret_cast<int*>(row_corr + K::kRMax);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int planes = a.Hkv / K::kNH;
  const int b = blockIdx.x / planes, p = blockIdx.x % planes;
  const int G = a.H / a.Hkv;
  const int GG = K::kNH * G;                    // query heads of the plane
  const int q0 = blockIdx.y * a.tq;
  const int R = a.tq * GG;
  const int S = a.S, T = a.T;
  const size_t code_base = (static_cast<size_t>(b) * planes + p) * S * K::kRowBytes;
  const size_t scale_base = (static_cast<size_t>(b) * a.Hkv + p * K::kNH) * S;

  // Stage the query rows (row r = query i * GG + head gg of the plane).
  for (int idx = tid; idx < R * (D / 2); idx += kThreads) {
    const int r = idx / (D / 2), dp = idx % (D / 2);
    const int qi = q0 + r / GG, head = p * GG + r % GG;
    __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
    if (qi < T)
      v = *reinterpret_cast<const __nv_bfloat162*>(
          a.q + ((static_cast<size_t>(b) * T + qi) * a.H + head) * D + 2 * dp);
    *reinterpret_cast<__nv_bfloat162*>(Qs + r * K::kLdQ + 2 * dp) = v;
  }
  for (int r = tid; r < R; r += kThreads) {
    const int qi = q0 + r / GG;
    row_pos[r] = qi < T ? a.positions[static_cast<size_t>(b) * T + qi] : -1;
    row_m[r] = kNegInf;
    row_l[r] = 0.f;
  }
  __syncthreads();

  int n_slots = S;
  if (a.window <= 0) {
    int maxpos = -1;
    for (int r = 0; r < R; ++r) maxpos = max(maxpos, row_pos[r]);
    n_slots = min(S, maxpos + 1);
  }

  const int dcol = tid % K::kDC;
  const int rbase = tid / K::kDC;
  float acc[K::kRowsPT][K::kCPT];
#pragma unroll
  for (int i = 0; i < K::kRowsPT; ++i)
#pragma unroll
    for (int c = 0; c < K::kCPT; ++c) acc[i][c] = 0.f;

  constexpr int kChunks = K::kRowBytes / 16;     // 16-byte loads per slot row
  for (int s0 = 0; s0 < n_slots; s0 += K::kBS) {
    for (int idx = tid; idx < K::kBS * kChunks; idx += kThreads) {
      const int s = idx / kChunks, ch = idx % kChunks;
      uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
      if (s0 + s < S) {
        const size_t off = code_base + static_cast<size_t>(s0 + s) * K::kRowBytes + 16 * ch;
        kw = *reinterpret_cast<const uint4*>(a.kc + off);
        vw = *reinterpret_cast<const uint4*>(a.vc + off);
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(Ks + s * K::kLdC + 16 * ch);
      uint32_t* vd = reinterpret_cast<uint32_t*>(Vs + s * K::kLdC + 16 * ch);
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      vd[0] = vw.x; vd[1] = vw.y; vd[2] = vw.z; vd[3] = vw.w;
    }
    for (int idx = tid; idx < K::kNH * K::kBS; idx += kThreads) {
      const int sub = idx / K::kBS, s = idx % K::kBS;
      float kv = 0.f, vv = 0.f;
      if (s0 + s < S) {
        const size_t off = scale_base + static_cast<size_t>(sub) * S + s0 + s;
        kv = a.ks[off];
        vv = a.vs[off];
      }
      KSs[idx] = kv;
      VSs[idx] = vv;
    }
    __syncthreads();

    // Scores; a masked slot is stored as -inf, which gives exactly 0 after
    // exp and leaves the running max as the JAX kernel's NEG_INF fill does.
    for (int idx = tid; idx < R * K::kBS; idx += kThreads) {
      const int r = idx / K::kBS, s = idx % K::kBS;
      const int slot = s0 + s;
      const int pos = row_pos[r];
      const int gg = r % GG;
      const int sub = gg / G;
      bool valid;
      int real = slot;
      if (a.window > 0) {
        int off = (pos - slot) % S;
        if (off < 0) off += S;
        real = pos - off;
        valid = real >= 0 && real > pos - a.window;
      } else {
        valid = slot <= pos && pos >= 0;
      }
      valid = valid && slot < S;
      float sc = neg_inf();
      if (valid) {
        sc = qk_dot<D, C>(Qs + r * K::kLdQ, Ks + s * K::kLdC, sub) * a.scale *
             KSs[sub * K::kBS + s];
        if (a.softcap > 0.f) sc = tanhf(sc / a.softcap) * a.softcap;
        if (a.slopes != nullptr) sc += a.slopes[p * GG + gg] * static_cast<float>(real - pos);
      }
      Ps[r * K::kBS + s] = sc;
    }
    __syncthreads();

    // Online softmax per row; p is stored times its slot's V scale.
    for (int r = warp; r < R; r += kThreads / 32) {
      const float* vsc = VSs + ((r % GG) / G) * K::kBS;
      float mx = neg_inf();
      for (int s = lane; s < K::kBS; s += 32) mx = fmaxf(mx, Ps[r * K::kBS + s]);
      mx = rrs::warp_max(mx);
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int s = lane; s < K::kBS; s += 32) {
        const float e = expf(Ps[r * K::kBS + s] - m_new);
        Ps[r * K::kBS + s] = e * vsc[s];
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
    for (int i = 0; i < K::kRowsPT; ++i) {
      const int r = rbase + i * K::kRS;
      if (r < R) {
        const float corr = row_corr[r];
        const float* pr = Ps + r * K::kBS;
        const int sub = (r % GG) / G;
#pragma unroll
        for (int c = 0; c < K::kCPT; ++c) {
          const int d = dcol + c * K::kDC;
          float sacc = 0.f;
          for (int s = 0; s < K::kBS; ++s) sacc += pr[s] * code_at<D, C>(Vs + s * K::kLdC, d, sub);
          acc[i][c] = acc[i][c] * corr + sacc;
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < K::kRowsPT; ++i) {
    const int r = rbase + i * K::kRS;
    const int qi = q0 + r / GG, head = p * GG + r % GG;
    if (r >= R || qi >= T) continue;
    float l = row_l[r];
    if (a.sinks != nullptr) l += expf(a.sinks[head] - row_m[r]);
    const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
    for (int c = 0; c < K::kCPT; ++c) {
      const int d = dcol + c * K::kDC;
      a.out[((static_cast<size_t>(b) * T + qi) * a.H + head) * D + d] =
          __float2bfloat16_rn(acc[i][c] * inv);
    }
  }
}

template <int D, int C>
int launch(Args a, int B, cudaStream_t st) {
  using K = Cfg<D, C>;
  const int G = a.H / a.Hkv;
  if (a.Hkv % K::kNH != 0 || K::kNH * G > K::kRMax) return rrs::kBadArgs;
  a.tq = std::min(a.T, K::kRMax / (K::kNH * G));
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kvq_kernel<D, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(K::kBytes)) != cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const dim3 grid(B * (a.Hkv / K::kNH), (a.T + a.tq - 1) / a.tq);
  kvq_kernel<D, C><<<grid, kThreads, K::kBytes, st>>>(a);
  return rrs::status();
}

template <int C>
int launch_d(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64, C>(a, B, st);
    case 128: return launch<128, C>(a, B, st);
    case 256: return launch<256, C>(a, B, st);
    default: return rrs::kBadArgs;
  }
}

}  // namespace

RRS_EXPORT int rrs_flash_attention_kvq(int codec, const void* q, const void* kc, const void* ks,
                                       const void* vc, const void* vs, const void* pos,
                                       const void* sinks, const void* slopes, void* out, int B,
                                       int T, int H, int Hkv, int S, int D, float scale,
                                       float softcap, int window, void* stream) {
  if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || S < 1) return rrs::kBadArgs;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
         static_cast<const float*>(ks), static_cast<const uint8_t*>(vc),
         static_cast<const float*>(vs), static_cast<const int*>(pos),
         static_cast<const float*>(sinks), static_cast<const float*>(slopes),
         static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, 0, scale, softcap, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kQ8: return launch_d<kQ8>(a, B, D, st);
    case kQ4HeadPair: return launch_d<kQ4HeadPair>(a, B, D, st);
    case kQ4Halves: return launch_d<kQ4Halves>(a, B, D, st);
    default: return rrs::kBadArgs;
  }
}
