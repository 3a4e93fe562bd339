// Online-softmax GQA attention over an int8 KV cache (q8 rows of
// rrs_tpu_torch/runtime/kv_codec.py) with an f32 scale per (kv head, slot)
// in [B, Hkv, 1, S].
//
// Replaces B6 rrs_tpu/ops/flash_attention.py:398 flash_attention_q8
// (_kernel_q8 :198, _kernel_q8_sink :291). The function is dequantize, then
// attend, with every option of the bf16 kernel: the causal mask from
// per-row positions (-1 marks a padded row, which outputs exactly 0), ring
// caches with a sliding window, logit softcap, ALiBi and per-head sinks.
// The packed int4 caches (B7, B8) have their own bodies in
// csrc/flash_attention_q4.cu.
//
// Bound on the H100: bytes at decode (codes and scales up to each row's
// position, read once per step: half the bf16 cache's), operations at
// prefill (4 * D FLOPs per unmasked (query, slot) pair).
//
// Design: the bf16 kernel's (csrc/flash_attention.cu). One block of 128
// threads per (lane, kv head, query tile); the G query heads of the kv head
// share every staged tile. K/V tiles are staged in shared memory as raw
// int8 codes (rows skewed to an odd number of words, so the QK loop's
// row-per-thread reads are conflict-free) and converted to f32 inside the
// QK and PV loops; the score is multiplied by scale * k_s[slot], and p by
// v_s[slot] before the PV loop (the running denominator sums p unscaled).
// At decode the grid (B * Hkv blocks) is far too small to fill the card and
// the loops are scalar: the split-S and tensor-core bodies of
// flash_attention_q4.cu, given an int8 loader, are its redesign (ROADMAP
// queue R).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -0.7f * 3.4028234663852886e38f;   // NEG_INF of the JAX kernel

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D>
struct Cfg {
  static constexpr int kNH = 1;                                 // kv heads per code plane
  static constexpr int kRowBytes = D;                           // code bytes of one slot
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

// Code of byte `c` of a little-endian word (a signed byte).
__device__ __forceinline__ float byte_code(uint32_t word, int c) {
  return static_cast<float>(static_cast<int8_t>((word >> (8 * c)) & 0xffu));
}

// q . codes over D for one query row (bf16 in shared memory) and one staged
// slot row.
template <int D>
__device__ __forceinline__ float qk_dot(const __nv_bfloat16* qr, const uint8_t* kr) {
  float dot = 0.f;
#pragma unroll 4
  for (int w = 0; w < D / 4; ++w) {
    const uint32_t word = *reinterpret_cast<const uint32_t*>(kr + 4 * w);
    const float2 a0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 4 * w));
    const float2 a1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qr + 4 * w + 2));
    dot += a0.x * byte_code(word, 0) + a0.y * byte_code(word, 1) + a1.x * byte_code(word, 2) +
           a1.y * byte_code(word, 3);
  }
  return dot;
}

template <int D>
__global__ void __launch_bounds__(kThreads) kvq_kernel(const Args a) {
  using K = Cfg<D>;
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
        sc = qk_dot<D>(Qs + r * K::kLdQ, Ks + s * K::kLdC) * a.scale *
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
#pragma unroll
        for (int c = 0; c < K::kCPT; ++c) {
          const int d = dcol + c * K::kDC;
          float sacc = 0.f;
          for (int s = 0; s < K::kBS; ++s) sacc += pr[s] * static_cast<float>(
              static_cast<int8_t>(Vs[s * K::kLdC + d]));
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

template <int D>
int launch(Args a, int B, cudaStream_t st) {
  using K = Cfg<D>;
  const int G = a.H / a.Hkv;
  if (a.Hkv % K::kNH != 0 || K::kNH * G > K::kRMax) return rrs::kBadArgs;
  a.tq = std::min(a.T, K::kRMax / (K::kNH * G));
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kvq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(K::kBytes)) != cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const dim3 grid(B * (a.Hkv / K::kNH), (a.T + a.tq - 1) / a.tq);
  kvq_kernel<D><<<grid, kThreads, K::kBytes, st>>>(a);
  return rrs::status();
}

int launch_d(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64>(a, B, st);
    case 128: return launch<128>(a, B, st);
    case 256: return launch<256>(a, B, st);
    default: return rrs::kBadArgs;
  }
}

}  // namespace

RRS_EXPORT int rrs_flash_attention_kvq(int codec, const void* q, const void* kc, const void* ks,
                                       const void* vc, const void* vs, const void* pos,
                                       const void* sinks, const void* slopes, void* out, int B,
                                       int T, int H, int Hkv, int S, int D, float scale,
                                       float softcap, int window, void* stream) {
  if (codec != 0 || B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || S < 1) return rrs::kBadArgs;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
         static_cast<const float*>(ks), static_cast<const uint8_t*>(vc),
         static_cast<const float*>(vs), static_cast<const int*>(pos),
         static_cast<const float*>(sinks), static_cast<const float*>(slopes),
         static_cast<__nv_bfloat16*>(out), T, H, Hkv, S, 0, scale, softcap, window};
  return launch_d(a, B, D, static_cast<cudaStream_t>(stream));
}
