// B7 flash_attention_q4hp and B8 flash_attention_q4: attention over packed
// int4 KV caches, head-pair codes [B, Hkv / 2, S, D] and halves codes
// [B, Hkv, S, D / 2] with f32 scales [B, Hkv, 1, S], on the bodies of
// attention_sm90.cuh. The entry is rrs_flash_attention (flash_attention.cu).

#include "attention_sm90.cuh"

int rrs::attn::launch_q4(int codec, const Args& a, int B, int D, bool decode, cudaStream_t st) {
  return codec == kQ4HeadPair ? launch_codec<kQ4HeadPair>(a, B, D, decode, st)
                              : launch_codec<kQ4Halves>(a, B, D, decode, st);
}
