// B3 flash_attention: attention over bf16 KV caches [B, Hkv, S, D] on the
// bodies of attention_sm90.cuh (rows staged as they are, no scales), and the
// one C entry of all four attention kernels (B3, B6 flash_attention_q8.cu,
// B7 / B8 flash_attention_q4.cu).

#include "attention_sm90.cuh"

int rrs::attn::launch_bf16(const Args& a, int B, int D, bool decode, cudaStream_t st) {
  return launch_codec<kBF16>(a, B, D, decode, st);
}

// codec: rrs::attn::Codec (0 q8, 1 q4 head-pair, 2 q4 halves, 3 bf16; the ids
// of ops/flash_attention.py). kc / vc: the K / V rows (bf16 or codes); ks /
// vs: their f32 scales [B, Hkv, 1, S], null for bf16. n_split / split_tiles:
// the plan of ops/attn_split.py (decode body only; the prefill body takes
// n_split = 1). scratch and counters are needed with n_split > 1.
RRS_EXPORT int rrs_flash_attention(int codec, const void* q, const void* kc, const void* ks,
                                   const void* vc, const void* vs, const void* pos,
                                   const void* sinks, const void* slopes, void* out, int B, int T,
                                   int H, int Hkv, int S, int D, float scale, float softcap,
                                   int window, int n_split, int split_tiles, void* scratch,
                                   void* counters, void* stream) {
  using namespace rrs::attn;
  if (B < 1 || T < 1 || Hkv < 1 || H % Hkv != 0 || S < 1 || n_split < 1 || split_tiles < 1)
    return rrs::kBadArgs;
  if (codec < kQ8 || codec > kBF16 || (codec == kQ4HeadPair && Hkv % 2 != 0) ||
      (codec == kBF16) != (ks == nullptr) || (ks == nullptr) != (vs == nullptr))
    return rrs::kBadArgs;
  const bool decode = T * (H / Hkv) <= kDecodeRows;
  const int tiles = (S + kTile - 1) / kTile;
  if (decode ? (static_cast<long>(n_split) * split_tiles < tiles ||
                (n_split - 1) * split_tiles >= tiles ||
                (n_split > 1 && (scratch == nullptr || counters == nullptr ||
                                 n_split * heads_per_plane(codec) * T * (H / Hkv) >
                                     kMaxPartials)))
             : n_split != 1)
    return rrs::kBadArgs;
  Args a{static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
         static_cast<const float*>(ks), static_cast<const uint8_t*>(vc),
         static_cast<const float*>(vs), static_cast<const int*>(pos),
         static_cast<const float*>(sinks), static_cast<const float*>(slopes),
         static_cast<__nv_bfloat16*>(out), static_cast<float*>(scratch),
         static_cast<int*>(counters), T, H, Hkv, S, scale, softcap, window, n_split,
         split_tiles};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (codec) {
    case kBF16: return launch_bf16(a, B, D, decode, st);
    case kQ8: return launch_q8(a, B, D, decode, st);
    default: return launch_q4(codec, a, B, D, decode, st);
  }
}
