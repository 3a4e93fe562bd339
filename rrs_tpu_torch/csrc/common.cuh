// Shared helpers for the rrs_tpu_torch Hopper kernels.
//
// Every C entry point of this library takes raw device pointers and a
// cudaStream_t (PyTorch's current stream), launches, allocates nothing, and
// returns cudaGetLastError() so a refused launch reaches the Python wrapper.
// A negative return means the arguments were refused before any launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RRS_EXPORT extern "C" __attribute__((visibility("default")))

namespace rrs {

constexpr int kBadArgs = -1;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sign-extended int4 from byte `c` of a little-endian word: the low nibble
// holds k = j and the high nibble k = j + 128 of a TCQ4 superblock.
__device__ __forceinline__ int nib_lo(uint32_t v, int c) {
  return static_cast<int>(v << (28 - 8 * c)) >> 28;
}
__device__ __forceinline__ int nib_hi(uint32_t v, int c) {
  return static_cast<int>(v << (24 - 8 * c)) >> 28;
}

inline int status() { return static_cast<int>(cudaGetLastError()); }

inline size_t round_up(size_t x, size_t m) { return (x + m - 1) / m * m; }

}  // namespace rrs
