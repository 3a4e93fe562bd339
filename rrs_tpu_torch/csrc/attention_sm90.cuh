// Online-softmax GQA attention over the KV cache for the H100: one kernel
// template for the four cache codecs of rrs_tpu_torch/runtime/kv_codec.py,
//   bf16  rows of D bf16, no scales                     (flash_attention.cu)
//   q8    rows of D int8 codes                          (flash_attention_q8.cu)
//   q4hp  head-pair int4: one byte holds d of two heads (flash_attention_q4.cu)
//   q4    halves int4: byte d holds d and d + D / 2     (flash_attention_q4.cu)
// the quantized ones with an f32 scale per (kv head, slot) in [B, Hkv, 1, S].
// Each codec's translation unit instantiates its bodies; the one C entry,
// rrs_flash_attention, is in flash_attention.cu.
//
// Replaces four TPU kernels of rrs_tpu/ops/flash_attention.py:
//   B3 :343 flash_attention      (_kernel :175, _kernel_sink :186, _flash_inner :70);
//   B6 :398 flash_attention_q8   (_kernel_q8 :198, _kernel_q8_sink :291);
//   B7 :519 flash_attention_q4hp (_kernel_q4hp :262, _kernel_q4hp_sink :276, _q4hp_kv :249);
//   B8 :457 flash_attention_q4   (_kernel_q4 :221, _kernel_q4_sink :235, _unpack_kv4 :212).
// The function (over a quantized cache: dequantize, then attend) has every
// option: GQA, the causal mask from per-row positions (-1 marks a padded
// row, which outputs exactly 0), ring caches with a sliding window, logit
// softcap, ALiBi and per-head sinks that join only the denominator.
//
// Bounds on the H100. Decode (a few query rows per kv head) is bound by
// bytes: the rows and scales up to each lane's position. A 4 x 1,024 prefill
// chunk is bound by operations (4 * D FLOPs per unmasked (query, slot)
// pair). So there are two bodies (ops/attn_split.py plans the grid):
//
// 1. Decode, T * G <= 16 (kDec): split over S ("flash-decoding"). The grid
//    is (lane, code plane) x n_split; split i owns whole 64-slot tiles, and
//    a block clips its range on the device at its lane's last live slot
//    (the largest of the lane's positions; a ring with a window keeps all
//    S), so a split past the live length writes an empty partial at once.
//    n_split comes from shapes only (about 264 blocks, two waves), so the
//    wrapper needs no host sync. Each block keeps every cache byte once:
//    for q4hp one block serves both kv heads of the plane (warps 0-1 read
//    one nibble, 2-3 the other); elsewhere the four warps split each tile's
//    slots. At the end the warps merge in warp order through shared memory,
//    and with more than one split every block writes its rows' (max,
//    denominator, sums) in f32 and the plane's last block (an integer
//    counter, reset by that block) merges the splits in split order. No
//    float atomics, one launch: the result is the same bits on every run.
// 2. Prefill (the rest): tensor-core tiles, bound by operations. One block
//    per (lane, kv head, 64 query rows), the longest rows first, four warps
//    of 16 rows in the FlashAttention-2 layout over K/V tiles of
//    kPrefillTile slots, as many blocks an SM as shared memory holds, at
//    most three. A tile whose first slot is past a warp's largest position
//    is not computed, a tile below every row of a warp skips the mask, and
//    the block stops at its largest position.
//
// Both bodies stream raw tiles and their scales through a cp.async ring
// (rows padded by 16 bytes, so 32-bit code reads and ldmatrix rows are free
// of bank conflicts) and run mma.sync m16n8k16 in bf16 with f32 sums. The
// loaders differ only in how a row reaches bf16:
// - bf16: it is bf16. K is read with ldmatrix and V with ldmatrix.trans
//   straight from the staged tile; nothing is dequantized.
// - q8: a code is exact in bf16. Four codes of a 32-bit word become exact
//   f32 under the 2^23 magic (gemm_sm90.cuh s8_f32) and pack to two bf16
//   pairs.
// - q4hp / q4: a byte permute puts the +8-biased nibble u under 0x43 (bf16
//   128 + u) and one bf16x2 fma takes 136 off (u ^ 8 first for halves).
// - Scores: q, staged once in bf16, times K. The decode body of a quantized
//   codec builds a warp's K operand in registers from one 32-bit word of 4
//   codes per n8 tile (q's 16-column groups permuted so that a thread's A
//   operand holds the 4 d of that word); its warps own disjoint slots, so
//   each code is converted once. bf16 rows need no conversion, so the bf16
//   decode body reads K with ldmatrix and keeps q unpermuted. The prefill
//   body's four warps share every K tile, so a quantized one is dequantized
//   once into shared memory and read with ldmatrix. Then times
//   scale * k_s[slot] (scale alone for bf16), softcap, ALiBi and the mask in
//   registers; the online softmax per row reduces over the thread quad with
//   shuffles.
// - P.V: a quantized V tile is dequantized to exact bf16 codes in shared
//   memory once per stage; V is read with ldmatrix.trans; P times v_s[slot]
//   (P alone for bf16) is rounded to bf16 as the A operand, and the
//   denominator sums P unscaled in f32. That rounding is the only one beyond
//   the f32 plain version's: codes are exact, and q and bf16 rows are bf16
//   already.
// What is left: by a count of instructions a tile, the prefill body of a
// quantized codec issues more for the dequantize passes and the softmax
// than for its mma, and each head pair's bytes are read by two prefill
// blocks (one per nibble); wgmma on shared-memory tiles, and a block that
// serves both heads of a pair, are the next steps.
#pragma once

#include <climits>

#include "gemm_sm90.cuh"

// The prefill body's K/V tile (slots) and ring stages, for every codec: 32
// slots at three stages, the fastest on a 4 x 1,024 chunk of those that
// tools/attn_ab.py --sweep builds (-DRRS_ATTN_PREFILL_TILE=64 ...) and times.
#ifndef RRS_ATTN_PREFILL_TILE
#define RRS_ATTN_PREFILL_TILE 32
#endif
#ifndef RRS_ATTN_PREFILL_STAGES
#define RRS_ATTN_PREFILL_STAGES 3
#endif

namespace rrs {
namespace attn {

enum Codec { kQ8 = 0, kQ4HeadPair = 1, kQ4Halves = 2, kBF16 = 3 };   // ops/flash_attention.py

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kDecodeRows = 16;                  // ops/attn_split.py DECODE_ROWS
constexpr int kTile = 64;                        // ops/attn_split.py TILE
constexpr int kPrefillRows = kWarps * 16;        // query rows of a prefill block
constexpr int kMaxPartials = 2048;               // ops/attn_split.py MAX_PARTIALS
constexpr int kPrefillTile = RRS_ATTN_PREFILL_TILE;
constexpr int kPrefillStages = RRS_ATTN_PREFILL_STAGES;
constexpr int kSmemPerSM = 233472;               // bytes of shared memory an SM

// kv heads per code plane (ops/attn_split.py HEADS_PER_PLANE)
constexpr int heads_per_plane(int c) { return c == kQ4HeadPair ? 2 : 1; }

struct Args {
  const __nv_bfloat16* q;
  const uint8_t* kc;      // K rows (bf16 or codes)
  const float* ks;        // K scales (null for bf16)
  const uint8_t* vc;
  const float* vs;
  const int* positions;
  const float* sinks;
  const float* slopes;
  __nv_bfloat16* out;
  float* scratch;         // decode with n_split > 1: f32 sums, then (max, denominator) pairs
  int* counters;          // one per (lane, plane), zero and left zero
  int T, H, Hkv, S;
  float scale, softcap;
  int window, n_split, split_tiles;
};

// Each codec's launcher, in its own translation unit (decode: the split-S
// body, else the prefill body).
int launch_bf16(const Args& a, int B, int D, bool decode, cudaStream_t st);
int launch_q8(const Args& a, int B, int D, bool decode, cudaStream_t st);
int launch_q4(int codec, const Args& a, int B, int D, bool decode, cudaStream_t st);

}  // namespace attn
}  // namespace rrs

namespace {

using rrs::attn::Args;
using rrs::attn::kBF16;
using rrs::attn::kDecodeRows;
using rrs::attn::kMaxPartials;
using rrs::attn::kPrefillRows;
using rrs::attn::kQ4Halves;
using rrs::attn::kQ4HeadPair;
using rrs::attn::kQ8;
using rrs::attn::kThreads;
using rrs::attn::kTile;
using rrs::attn::kWarps;
using rrs::sm90::cp_async16;
using rrs::sm90::cp_async_commit;
using rrs::sm90::cp_async_wait;
using rrs::sm90::copy_chunk;
using rrs::sm90::fma_bf16x2;
using rrs::sm90::ldsm_x4;
using rrs::sm90::ldsm_x4_trans;
using rrs::sm90::mma16816;
using rrs::sm90::pack_bf16;
using rrs::sm90::s8_f32;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <int D, int C, bool kDec>
struct Cfg {
  static constexpr bool kBF = C == kBF16;                       // no dequantize, no scales
  static constexpr bool kRegK = kDec && !kBF;                   // K operand from code words
  static constexpr int kNH = rrs::attn::heads_per_plane(C);     // kv heads per code plane
  static constexpr int kRowBytes = kBF ? 2 * D : (C == kQ4Halves ? D / 2 : D);   // of one slot
  static constexpr int kLdC = kRowBytes + 16;                   // staged row stride, bytes
  static constexpr int kBS = kDec ? kTile : rrs::attn::kPrefillTile;      // slots per tile
  static constexpr int kStages = kDec ? 3 : rrs::attn::kPrefillStages;
  static constexpr int kParts = kDec ? kWarps / kNH : 1;        // warps sharing a tile's slots
  static constexpr int kSW = kBS / kParts;                      // slots of a warp per tile
  static constexpr int kNT = kSW / 8;                           // n8 score tiles of a warp
  static constexpr int kMT = kDec ? kNH : kWarps;               // 16-row Q tiles of a block
  static constexpr int kVSub = kBF ? 0 : (kDec ? kNH : 1);      // dequantized V tiles
  static constexpr int kKSub = kBF || kDec ? 0 : 1;             // dequantized K tiles
  static constexpr int kLdQ = D + 8;                            // bf16 row strides
  static constexpr int kLdV = D + 8;
  static constexpr int kLdW = D + 4;                            // f32 merge rows
  static constexpr size_t kQBytes = size_t(kMT) * 16 * kLdQ * 2;
  static constexpr size_t kCodes = size_t(kBS) * kLdC;
  static constexpr size_t kScales = kBF ? 0 : 2 * size_t(kNH) * kBS * 4;
  static constexpr size_t kStage = 2 * kCodes + kScales;
  static constexpr size_t kMain = kStages * kStage + size_t(kVSub + kKSub) * kBS * kLdV * 2;
  static constexpr size_t kMerge = kDec ? size_t(kWarps) * 16 * (kLdW + 2) * 4 : 0;
  static constexpr size_t kBytes = kQBytes + (kMain > kMerge ? kMain : kMerge);
  // prefill blocks an SM: as many as shared memory holds, at most three (at
  // most 170 registers a thread)
  static constexpr int kFit = int(rrs::attn::kSmemPerSM / (kBytes + 1024));
  static constexpr int kMinBlocks = kDec ? 1 : (kFit < 1 ? 1 : (kFit > 3 ? 3 : kFit));
  static_assert(kSW % 16 == 0, "a warp's slots form whole k16 steps of P.V");
  static_assert(kNT % 2 == 0, "ldmatrix reads K for two n8 tiles");
  static_assert(!kDec || kBS == kTile, "decode splits are whole tiles");
  static_assert(kStages >= 2, "the ring overlaps a tile's copy with the last one's mma");
  static_assert(!kBF || kLdC == 2 * kLdV, "bf16 rows are staged in the ldmatrix layout");
  static_assert(kQBytes % 16 == 0 && kCodes % 16 == 0 && kStage % 16 == 0, "16-byte carve-up");
  static_assert(!kDec || kMain >= 2 * kMaxPartials * 4, "the combine's (max, denominator)");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

// Four codes of one 32-bit word as two exact bf16 pairs, bytes 0-1 and
// bytes 2-3. q8: each int8 byte (biased by 128) becomes the low byte of
// the f32 2^23 + 128 + q, and 2^23 + 128 comes off exactly. q4hp / q4:
// nibbles `shift` (0 or 4) of the bytes; each +8-biased nibble u becomes
// the low byte under 0x43 (bf16 128 + u, one byte permute a pair), and 136
// comes off exactly.
template <int C>
__device__ __forceinline__ void codes4(uint32_t word, int shift, uint32_t& lo, uint32_t& hi) {
  if constexpr (C == kQ8) {
    const uint32_t x = word ^ 0x80808080u;
    lo = pack_bf16(s8_f32(x, 0), s8_f32(x, 1));
    hi = pack_bf16(s8_f32(x, 2), s8_f32(x, 3));
  } else {
    uint32_t x = (word >> shift) & 0x0F0F0F0Fu;
    if constexpr (C == kQ4Halves) x ^= 0x08080808u;      // two's complement -> +8 bias
    lo = fma_bf16x2(__byte_perm(x, 0x43434343u, 0x5140), 0x3F803F80u, 0xC308C308u);
    hi = fma_bf16x2(__byte_perm(x, 0x43434343u, 0x7362), 0x3F803F80u, 0xC308C308u);
  }
}

__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v, float inv) {
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16(v.x * inv, v.y * inv), pack_bf16(v.z * inv, v.w * inv));
}

__device__ __forceinline__ void fma4(float4& acc, float f, float4 v) {
  acc.x += f * v.x;
  acc.y += f * v.y;
  acc.z += f * v.z;
  acc.w += f * v.w;
}

// 1 / (l + exp(sink - m)) for a row whose running max is m (0 for a row
// that attends no slot, which then outputs exactly 0).
__device__ __forceinline__ float row_inv(const Args& a, int head, float m, float l) {
  if (m == neg_inf()) return 0.f;
  if (a.sinks != nullptr) l += expf(a.sinks[head] - m);
  return 1.f / fmaxf(l, 1e-30f);
}

template <int D, int C, bool kDec>
__global__ void __launch_bounds__(kThreads, (Cfg<D, C, kDec>::kMinBlocks))
attention_kernel(const Args a) {
  using K = Cfg<D, C, kDec>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned char* ring = smem + K::kQBytes;
  __nv_bfloat16* Vb = reinterpret_cast<__nv_bfloat16*>(ring + K::kStages * K::kStage);
  __nv_bfloat16* Kb = Vb + K::kVSub * K::kBS * K::kLdV;   // prefill: K codes [slot][d]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int S = a.S, T = a.T, G = a.H / a.Hkv, TG = T * G;
  const int planes = a.Hkv / K::kNH;
  const float ninf = neg_inf();

  // block and warp roles
  int b, p, sub0 = 0, rho0 = 0, split = 0;
  if constexpr (kDec) {
    split = blockIdx.x % a.n_split;
    const int bp = blockIdx.x / a.n_split;
    b = bp / planes;
    p = bp % planes;
  } else {
    b = blockIdx.x / a.Hkv;
    p = (blockIdx.x % a.Hkv) / K::kNH;
    sub0 = blockIdx.x % K::kNH;
    rho0 = (gridDim.y - 1 - blockIdx.y) * kPrefillRows;   // the longest rows first
  }
  const int bp = b * planes + p;
  const int sub = kDec ? warp / K::kParts : sub0;          // this warp's kv head in the plane
  const int part = kDec ? warp % K::kParts : 0;
  const int mt = kDec ? sub : warp;                        // this warp's Q tile
  const int vsub = kDec ? sub : 0;                         // this warp's dequantized V tile
  const int rho_w = kDec ? 0 : rho0 + 16 * warp;           // row of the Q tile's first line
  const int* lane_pos = a.positions + static_cast<size_t>(b) * T;

  // The live slots: up to the largest position of the block's queries.
  int n_slots = S;
  if (a.window <= 0) {
    int q_lo = 0, q_hi = T;
    if constexpr (!kDec) {
      q_lo = rho0 / G;
      q_hi = min(T, (rho0 + kPrefillRows + G - 1) / G);
    }
    int maxpos = -1;
    for (int i = q_lo; i < q_hi; ++i) maxpos = max(maxpos, lane_pos[i]);
    n_slots = min(S, maxpos + 1);
  }
  int s_lo = 0, s_hi = n_slots;
  if constexpr (kDec) {
    s_lo = split * a.split_tiles * kTile;
    s_hi = min(s_hi, s_lo + a.split_tiles * kTile);
  }
  const int R = K::kNH * TG;                               // decode rows of the plane
  float* part_acc = a.scratch;
  float* part_ml = a.scratch + static_cast<size_t>(gridDim.x) * R * D;

  if (kDec && a.n_split > 1 && s_lo >= s_hi) {
    // past the lane's live length: an empty partial
    for (int r = tid; r < R; r += kThreads) {
      float* ml = part_ml + (static_cast<size_t>(blockIdx.x) * R + r) * 2;
      ml[0] = ninf;
      ml[1] = 0.f;
    }
  } else {
    // Stage q: row i of Q tile m is row rho of kv head (p * kNH + sub'),
    // rho = query (rho / G) x head (rho % G). Where the decode body builds
    // K from code words, each 16-column group is permuted so that ldmatrix
    // hands thread t columns 4t .. 4t + 3, the d of one 32-bit word.
    for (int idx = tid; idx < K::kMT * 16 * (D / 2); idx += kThreads) {
      const int row = idx / (D / 2), d = 2 * (idx % (D / 2));
      const int m = row / 16;
      const int sub_m = kDec ? m : sub0;
      const int rho = (kDec ? 0 : rho0 + 16 * m) + row % 16;
      uint32_t v = 0u;
      if (rho < TG) {
        const int head = (p * K::kNH + sub_m) * G + rho % G;
        v = *reinterpret_cast<const uint32_t*>(
            a.q + ((static_cast<size_t>(b) * T + rho / G) * a.H + head) * D + d);
      }
      const int w = d & 15;
      const int col = K::kRegK ? (d & ~15) + ((w >> 1) & 1) * 8 + 2 * (w >> 2) : d;
      *reinterpret_cast<uint32_t*>(Qs + row * K::kLdQ + col) = v;
    }

    // this thread's two rows (g and g + 8 of the warp's Q tile)
    int pos[2];
    float slope[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rho = rho_w + g + 8 * e;
      pos[e] = rho < TG ? lane_pos[rho / G] : -1;
      slope[e] = a.slopes != nullptr ? a.slopes[(p * K::kNH + sub) * G + rho % G] : 0.f;
    }
    const int warp_max = __reduce_max_sync(0xffffffffu, max(pos[0], pos[1]));
    // the least position of the warp's rows that are outputs (padding rows
    // past T * G are never written, so they need no mask)
    const int warp_min = __reduce_min_sync(
        0xffffffffu, min(rho_w + g < TG ? pos[0] : INT_MAX, rho_w + g + 8 < TG ? pos[1] : INT_MAX));

    const int n_tiles = s_hi > s_lo ? (s_hi - s_lo + K::kBS - 1) / K::kBS : 0;
    const size_t code_base = static_cast<size_t>(bp) * S * K::kRowBytes;
    constexpr int kChunks = K::kRowBytes / 16;
    auto stage = [&](int u) { return ring + (u % K::kStages) * K::kStage; };
    auto issue = [&](int u) {
      if (u < n_tiles) {
        unsigned char* st = stage(u);
        const int s0 = s_lo + u * K::kBS;
        for (int idx = tid; idx < K::kBS * kChunks; idx += kThreads) {
          const int s = idx / kChunks, ch = idx % kChunks;
          const bool in = s0 + s < S;
          const size_t off = code_base + static_cast<size_t>(in ? s0 + s : 0) * K::kRowBytes +
                             16 * ch;
          cp_async16(st + s * K::kLdC + 16 * ch, a.kc + off, in ? 16 : 0);
          cp_async16(st + K::kCodes + s * K::kLdC + 16 * ch, a.vc + off, in ? 16 : 0);
        }
        if constexpr (!K::kBF) {
          float* sc = reinterpret_cast<float*>(st + 2 * K::kCodes);
          for (int idx = tid; idx < 2 * K::kNH * (K::kBS / 4); idx += kThreads) {
            const int kv = idx / (K::kNH * (K::kBS / 4)), rest = idx % (K::kNH * (K::kBS / 4));
            const int sh = rest / (K::kBS / 4), c4 = rest % (K::kBS / 4);
            const float* row =
                (kv ? a.vs : a.ks) + (static_cast<size_t>(b) * a.Hkv + p * K::kNH + sh) * S;
            copy_chunk(sc + (kv * K::kNH + sh) * K::kBS + 4 * c4, row, s0 + 4 * c4, S);
          }
        }
      }
      cp_async_commit();
    };

    float acc[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
    float m_row[2] = {ninf, ninf}, l_row[2] = {0.f, 0.f};

#pragma unroll
    for (int u = 0; u < K::kStages - 1; ++u) issue(u);
    for (int u = 0; u < n_tiles; ++u) {
      cp_async_wait<K::kStages - 2>();   // this thread's copies of tile u have landed
      __syncthreads();                   // ... everyone's; tile u - 1's mma is done
      issue(u + K::kStages - 1);         // into tile u - 1's stage
      const unsigned char* st = stage(u);
      const float* KS = reinterpret_cast<const float*>(st + 2 * K::kCodes);
      const float* VS = KS + K::kNH * K::kBS;
      if constexpr (!K::kBF) {
        // V codes of tile u -> exact bf16 [slot][d], one tile per kv head
        // used; at prefill also the K codes, which all four warps read
        for (int idx = tid; idx < K::kVSub * K::kBS * (K::kRowBytes / 4); idx += kThreads) {
          const int vt = idx / (K::kBS * (K::kRowBytes / 4));
          const int rest = idx % (K::kBS * (K::kRowBytes / 4));
          const int s = rest / (K::kRowBytes / 4), wi = rest % (K::kRowBytes / 4);
          const uint32_t word =
              *reinterpret_cast<const uint32_t*>(st + K::kCodes + s * K::kLdC + 4 * wi);
          __nv_bfloat16* vrow = Vb + (vt * K::kBS + s) * K::kLdV;
          uint32_t lo, hi;
          if constexpr (C == kQ4Halves) {
            codes4<C>(word, 0, lo, hi);
            *reinterpret_cast<uint2*>(vrow + 4 * wi) = make_uint2(lo, hi);
            codes4<C>(word, 4, lo, hi);
            *reinterpret_cast<uint2*>(vrow + D / 2 + 4 * wi) = make_uint2(lo, hi);
          } else {
            codes4<C>(word, 4 * (kDec ? vt : sub0), lo, hi);
            *reinterpret_cast<uint2*>(vrow + 4 * wi) = make_uint2(lo, hi);
          }
          if constexpr (!kDec) {
            const uint32_t kword = *reinterpret_cast<const uint32_t*>(st + s * K::kLdC + 4 * wi);
            __nv_bfloat16* krow = Kb + s * K::kLdV;
            if constexpr (C == kQ4Halves) {
              codes4<C>(kword, 0, lo, hi);
              *reinterpret_cast<uint2*>(krow + 4 * wi) = make_uint2(lo, hi);
              codes4<C>(kword, 4, lo, hi);
              *reinterpret_cast<uint2*>(krow + D / 2 + 4 * wi) = make_uint2(lo, hi);
            } else {
              codes4<C>(kword, 4 * sub0, lo, hi);
              *reinterpret_cast<uint2*>(krow + 4 * wi) = make_uint2(lo, hi);
            }
          }
        }
        __syncthreads();
      }

      const int s0 = s_lo + u * K::kBS;
      if (a.window <= 0 && s0 > warp_max) continue;        // past every row of the warp

      // K and V as bf16 [slot][d] in shared memory: the staged rows, or the
      // dequantized tiles
      const __nv_bfloat16* Kt = K::kBF ? reinterpret_cast<const __nv_bfloat16*>(st) : Kb;
      const __nv_bfloat16* Vt =
          K::kBF ? reinterpret_cast<const __nv_bfloat16*>(st + K::kCodes) : Vb;

      // scores of the warp's 16 rows x kSW slots
      float sc[K::kNT][4];
#pragma unroll
      for (int j = 0; j < K::kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[j][c] = 0.f;
      const unsigned char* kw = st + (part * K::kSW + g) * K::kLdC + 4 * t;
      const __nv_bfloat16* kb = Kt + (part * K::kSW + (lane & 7) + ((lane >> 4) & 1) * 8) *
                                         K::kLdV + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t af[4];
        ldsm_x4(af, Qs + (mt * 16 + (lane & 15)) * K::kLdQ + kk * 16 + (lane >> 4) * 8);
        if constexpr (K::kRegK) {
          // each warp builds its own slots' K operand from the raw words
          const int off = C == kQ4Halves ? (16 * kk) % (D / 2) : 16 * kk;
          const int shift = C == kQ4Halves ? (16 * kk >= D / 2 ? 4 : 0) : 4 * sub;
#pragma unroll
          for (int j = 0; j < K::kNT; ++j) {
            uint32_t b0, b1;
            codes4<C>(*reinterpret_cast<const uint32_t*>(kw + 8 * j * K::kLdC + off), shift,
                      b0, b1);
            mma16816(sc[j], af[0], af[1], af[2], af[3], b0, b1);
          }
        } else {
#pragma unroll
          for (int j = 0; j < K::kNT; j += 2) {
            uint32_t bk[4];
            ldsm_x4(bk, kb + 8 * j * K::kLdV + 16 * kk);
            mma16816(sc[j], af[0], af[1], af[2], af[3], bk[0], bk[1]);
            mma16816(sc[j + 1], af[0], af[1], af[2], af[3], bk[2], bk[3]);
          }
        }
      }

      // scale, softcap, ALiBi, mask; the online softmax. A causal tile below
      // every row of the warp needs no mask.
      const bool all_valid = a.window <= 0 && s0 + K::kBS <= S && s0 + K::kBS - 1 <= warp_min;
      float mx[2] = {ninf, ninf};
#pragma unroll
      for (int j = 0; j < K::kNT; ++j) {
        float2 ks2 = make_float2(1.f, 1.f);
        if constexpr (!K::kBF)
          ks2 = *reinterpret_cast<const float2*>(KS + sub * K::kBS + part * K::kSW + 8 * j + 2 * t);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int slot = s0 + part * K::kSW + 8 * j + 2 * t + (c & 1);
          const int e = c >> 1;
          const int ps = pos[e];
          bool valid = true;
          int real = slot;
          if (!all_valid) {
            if (a.window > 0) {
              int off = (ps - slot) % S;
              if (off < 0) off += S;
              real = ps - off;
              valid = real >= 0 && real > ps - a.window;
            } else {
              valid = slot <= ps;
            }
            valid = valid && slot < S;
          }
          float v = ninf;
          if (valid) {
            v = sc[j][c] * a.scale;
            if constexpr (!K::kBF) v *= (c & 1) ? ks2.y : ks2.x;
            if (a.softcap > 0.f) v = tanhf(v / a.softcap) * a.softcap;
            if (a.slopes != nullptr) v += slope[e] * static_cast<float>(real - ps);
          }
          sc[j][c] = v;
          mx[e] = fmaxf(mx[e], v);
        }
      }
      float corr[2], m_use[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 1));
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], 2));
        const float m_new = fmaxf(m_row[e], mx[e]);
        m_use[e] = m_new == ninf ? 0.f : m_new;            // no slot yet: exp(-inf) = 0
        corr[e] = expf(m_row[e] - m_use[e]);
        m_row[e] = m_new;
      }
      float lsum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < K::kNT; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[j][c] = __expf(sc[j][c] - m_use[c >> 1]);
          lsum[c >> 1] += sc[j][c];
        }
#pragma unroll
      for (int e = 0; e < 2; ++e) l_row[e] = l_row[e] * corr[e] + lsum[e];
#pragma unroll
      for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] *= corr[c >> 1];

      // acc += bf16(P v_s) . V
      const float* vsc = VS + sub * K::kBS + part * K::kSW + 2 * t;
#pragma unroll
      for (int ks = 0; ks < K::kSW / 16; ++ks) {
        float2 v0 = make_float2(1.f, 1.f), v8 = make_float2(1.f, 1.f);
        if constexpr (!K::kBF) {
          v0 = *reinterpret_cast<const float2*>(vsc + 16 * ks);
          v8 = *reinterpret_cast<const float2*>(vsc + 16 * ks + 8);
        }
        const uint32_t a0 = pack_bf16(sc[2 * ks][0] * v0.x, sc[2 * ks][1] * v0.y);
        const uint32_t a1 = pack_bf16(sc[2 * ks][2] * v0.x, sc[2 * ks][3] * v0.y);
        const uint32_t a2 = pack_bf16(sc[2 * ks + 1][0] * v8.x, sc[2 * ks + 1][1] * v8.y);
        const uint32_t a3 = pack_bf16(sc[2 * ks + 1][2] * v8.x, sc[2 * ks + 1][3] * v8.y);
        const __nv_bfloat16* vrow =
            Vt + (vsub * K::kBS + part * K::kSW + 16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) *
                     K::kLdV + (lane >> 4) * 8;
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t bf[4];
          ldsm_x4_trans(bf, vrow + 16 * dn);
          mma16816(acc[2 * dn], a0, a1, a2, a3, bf[0], bf[1]);
          mma16816(acc[2 * dn + 1], a0, a1, a2, a3, bf[2], bf[3]);
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      l_row[e] += __shfl_xor_sync(0xffffffffu, l_row[e], 1);
      l_row[e] += __shfl_xor_sync(0xffffffffu, l_row[e], 2);
    }

    if constexpr (!kDec) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int rho = rho_w + g + 8 * e;
        if (rho >= TG) continue;
        const int head = (p * K::kNH + sub) * G + rho % G;
        const float inv = row_inv(a, head, m_row[e], l_row[e]);
        __nv_bfloat16* o = a.out + ((static_cast<size_t>(b) * T + rho / G) * a.H + head) * D;
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<uint32_t*>(o + 8 * i + 2 * t) =
              pack_bf16(acc[i][2 * e] * inv, acc[i][2 * e + 1] * inv);
      }
      return;
    } else {
      // merge the warps that share a kv head, in warp order
      __syncthreads();                                     // the ring is free
      float* Wacc = reinterpret_cast<float*>(ring);        // [warp][16][kLdW]
      float* Wm = Wacc + kWarps * 16 * K::kLdW;
      float* Wl = Wm + kWarps * 16;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = warp * 16 + g + 8 * e;
        if (t == 0) {
          Wm[r] = m_row[e];
          Wl[r] = l_row[e];
        }
#pragma unroll
        for (int i = 0; i < D / 8; ++i)
          *reinterpret_cast<float2*>(Wacc + r * K::kLdW + 8 * i + 2 * t) =
              make_float2(acc[i][2 * e], acc[i][2 * e + 1]);
      }
      __syncthreads();
      for (int idx = tid; idx < K::kNH * TG * (D / 4); idx += kThreads) {
        const int r = idx / (D / 4), d4 = idx % (D / 4);   // r = sub' * TG + rho
        const int sh = r / TG, rho = r % TG;
        float M = ninf;
#pragma unroll
        for (int q = 0; q < K::kParts; ++q) M = fmaxf(M, Wm[(sh * K::kParts + q) * 16 + rho]);
        float L = 0.f;
        float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
        if (M != ninf) {
#pragma unroll
          for (int q = 0; q < K::kParts; ++q) {
            const int wr = (sh * K::kParts + q) * 16 + rho;
            if (Wm[wr] == ninf) continue;
            const float f = expf(Wm[wr] - M);
            L += Wl[wr] * f;
            fma4(A, f, *reinterpret_cast<const float4*>(Wacc + wr * K::kLdW + 4 * d4));
          }
        }
        if (a.n_split == 1) {
          const int head = (p * K::kNH + sh) * G + rho % G;
          store_bf16x4(a.out + ((static_cast<size_t>(b) * T + rho / G) * a.H + head) * D +
                           4 * d4,
                       A, row_inv(a, head, M, L));
        } else {
          const size_t row = static_cast<size_t>(blockIdx.x) * R + r;
          *reinterpret_cast<float4*>(part_acc + row * D + 4 * d4) = A;
          if (d4 == 0) {
            part_ml[2 * row] = M;
            part_ml[2 * row + 1] = L;
          }
        }
      }
    }
  }

  if constexpr (kDec) {
    if (a.n_split == 1) return;
    // The plane's last block to arrive merges the splits in split order.
    __shared__ int last;
    __shared__ float row_m[2 * kDecodeRows], row_iv[2 * kDecodeRows];
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.counters + bp, 1) == a.n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    // every split's (max, denominator) of every row into shared memory (the
    // ring is free), then per row the merged max, each split's weight
    // exp(m_i - max) and the denominator in split order
    const int NP = a.n_split * R;
    float* cm = reinterpret_cast<float*>(ring);                // [split][row]
    float* cl = cm + kMaxPartials;
    const float2* ml = reinterpret_cast<const float2*>(part_ml) + static_cast<size_t>(bp) * NP;
    for (int i = tid; i < NP; i += kThreads) {
      const float2 v = __ldcg(ml + i);
      cm[i] = v.x;
      cl[i] = v.y;
    }
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      float M = ninf;
      for (int i = 0; i < a.n_split; ++i) M = fmaxf(M, cm[i * R + r]);
      row_m[r] = M;
    }
    __syncthreads();
    for (int i = tid; i < NP; i += kThreads)
      cm[i] = cm[i] == ninf ? 0.f : expf(cm[i] - row_m[i % R]);
    __syncthreads();
    for (int r = tid; r < R; r += kThreads) {
      float L = 0.f;
      for (int i = 0; i < a.n_split; ++i) L += cl[i * R + r] * cm[i * R + r];
      row_iv[r] = row_inv(a, (p * K::kNH + r / TG) * G + (r % TG) % G, row_m[r], L);
    }
    __syncthreads();
    const float* acc0 = part_acc + static_cast<size_t>(bp) * NP * D;
    for (int idx = tid; idx < R * (D / 4); idx += kThreads) {
      const int r = idx / (D / 4), d4 = idx % (D / 4);
      float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int i = 0; i < a.n_split; ++i) {
        const float w = cm[i * R + r];
        if (w != 0.f)
          fma4(A, w, __ldcg(reinterpret_cast<const float4*>(acc0 + (i * R + r) * D + 4 * d4)));
      }
      const int rho = r % TG;
      const int head = (p * K::kNH + r / TG) * G + rho % G;
      store_bf16x4(a.out + ((static_cast<size_t>(b) * T + rho / G) * a.H + head) * D + 4 * d4,
                   A, row_iv[r]);
    }
    if (tid == 0) a.counters[bp] = 0;
  }
}

template <int D, int C, bool kDec>
int launch(const Args& a, int B, cudaStream_t st) {
  using K = Cfg<D, C, kDec>;
  auto kernel = attention_kernel<D, C, kDec>;
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(K::kBytes)) != cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const int G = a.H / a.Hkv;
  dim3 grid;
  if (kDec)
    grid = dim3(B * (a.Hkv / K::kNH) * a.n_split);
  else
    grid = dim3(B * a.Hkv, (a.T * G + kPrefillRows - 1) / kPrefillRows);
  if (grid.y > 65535) return rrs::kBadArgs;
  kernel<<<grid, kThreads, K::kBytes, st>>>(a);
  return rrs::status();
}

template <int C, bool kDec>
int launch_d(const Args& a, int B, int D, cudaStream_t st) {
  switch (D) {
    case 64: return launch<64, C, kDec>(a, B, st);
    case 128: return launch<128, C, kDec>(a, B, st);
    case 256: return launch<256, C, kDec>(a, B, st);
    default: return rrs::kBadArgs;
  }
}

// One codec's six instantiations: decode and prefill at D = 64, 128, 256.
template <int C>
int launch_codec(const Args& a, int B, int D, bool decode, cudaStream_t st) {
  return decode ? launch_d<C, true>(a, B, D, st) : launch_d<C, false>(a, B, D, st);
}

}  // namespace
