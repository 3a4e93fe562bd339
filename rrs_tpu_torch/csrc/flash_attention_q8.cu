// B6 flash_attention_q8: attention over int8 KV caches (codes [B, Hkv, S, D],
// f32 scales [B, Hkv, 1, S]) on the bodies of attention_sm90.cuh. The entry
// is rrs_flash_attention (flash_attention.cu).

#include "attention_sm90.cuh"

int rrs::attn::launch_q8(const Args& a, int B, int D, bool decode, cudaStream_t st) {
  return launch_codec<kQ8>(a, B, D, decode, st);
}
