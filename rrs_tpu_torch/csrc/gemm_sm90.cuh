// The two bodies of the quantized weight matmuls C[M, N] = bf16(A) @ bf16(W)
// with f32 sums, shared by B2 (q8_matmul.cu), B4 (tcq4_matmul.cu, and B17
// through it), B11 (mxfp4_matmul.cu) and B18 (tcq4_pb.cu); the first also runs with the
// selected rows of an expert matmul on the grid for B9 (tcq4_experts.cu,
// through tcq4_rows below) and B12 (mxfp4_matmul.cu), the second on an
// expert grid for B10 and B19 (tcq4_experts.cu, through tcq4_experts below)
// and B13 (mxfp4_matmul.cu). Each body is templated on a weight loader,
// which knows its format's bytes and how to round a weight to bf16; the
// bodies know tiles, pipelines, the tensor-core instruction and the
// reduction.
//
// 1. splitk_kernel, M <= 16 (decode): a weight stream, bound by bytes.
//    The grid is (column strips of 128) x (K slices of whole slice units: a
//    Q8 group of 32, a TCQ4 superblock of 256), enough blocks for two waves
//    on 132 SMs; the wrapper picks the slice length (ops/splitk.py) and
//    allocates the scratch. A block is 4 warps over one strip; warp w takes
//    the slice's inner units w, w + 4, ... and keeps the next unit's 16-byte
//    loads in flight in registers while it computes this one. Weights go
//    from registers to bf16 in registers (no shared-memory round trip) and
//    into mma.sync m16n8k16 with the roles swapped: the weights are the A
//    operand (16 output columns x 16 k), the activations the B operand (8
//    rows of M, padded; two n8 tiles at M > 8). Thread (g, t) of a warp
//    holds 16 contiguous columns (16 g .. 16 g + 15) of 4 consecutive k
//    rows (4 t .. 4 t + 3) of each 16-row step, which fixes which k goes to
//    which slot of the instruction: slots 2t, 2t + 1, 2t + 8, 2t + 9 hold
//    k = 4t .. 4t + 3, the same for the activation operand.
//    Sums: each warp in unit order; the 4 warps in order (w0 + w1 + w2 +
//    w3) through shared memory; the slices in order by the last block of
//    the strip to arrive (an integer counter per strip, reset by that
//    block), which reads every slice's partial from the scratch. No float
//    atomics, one launch: the result is the same bits on every run. One
//    block's work is splitk_block; rows_kernel runs it at M = 1 with the
//    selected rows on the grid's z axis (each block its row's activations
//    and the weights of the expert its id names, read on the device), a
//    flag that splitk_kernel's instantiations do not take.
// 2. gemm_kernel, M > 16 (prefill): a pipelined tensor-core GEMM, bound by
//    operations at large M. Block tile BM x 128 x 64 k (BM = 64 below M =
//    128, else 128), 8 warps (2 x 4; warp tile BM/2 x 32). A cp.async ring
//    holds raw tiles: bf16 activations (the wrappers round f32 ones first,
//    as the kernel would) and the loader's raw weight bytes with their scale
//    rows; 3 stages, and two blocks an SM. Each k step, after one barrier,
//    the block issues the stage two ahead, dequantizes the next stage's raw
//    weights into the other of two bf16 B tiles, and runs the mma on this
//    stage. Both operands reach the tensor cores through ldmatrix (B
//    transposed). Where the output tiles are fewer than the SMs the grid
//    splits K too, reduced as in the decode body. One block's work is
//    gemm_block; experts_kernel runs it with the experts on the grid's z
//    axis (one K slice, each block its own expert's weights and
//    activations), a flag that gemm_kernel's instantiations do not take.
//    A loader with kBiasDot (B18's PB) also has a bias dot folded into the
//    k walk: with the first stage of each 256-k unit the block copies the
//    unit's 16 bias activations of its rows and 8 weight rows of its strip
//    into a tile of their own (two, by unit parity), and after the unit's
//    last stage runs one more m16n8k16 step on them (BiasTile below).
//
// A loader supplies (see q8_matmul.cu, tcq4_matmul.cu and mxfp4_matmul.cu):
//   kUnitK, kInner       slice unit in k, and inner units (a warp's grain) in it
//   Raw, load, compute   the decode body's registers, their loads, and the
//                        dequantize + mma of one inner unit
//   kRawBytes, runs,     the prefill body's raw weight bytes per 64-k stage,
//   issue, dequant       the two 32-wide k runs of a stage, its cp.async
//                        copies, and its dequantize into the bf16 B tile
//   expert               (rows and expert grids) the Params of expert e of a stack
//   kBiasDot, bias_issue (the prefill bias dot, optional) the flag, and the
//                        cp.async copies of a unit's bias tile
#pragma once

#include <type_traits>

#include "common.cuh"

namespace rrs {
namespace sm90 {

constexpr int kStrip = 128;         // decode: output columns per block
constexpr int kDecodeWarps = 4;
constexpr int kBN = 128;            // prefill: block tile in N and k
constexpr int kBK = 64;
constexpr int kPrefillThreads = 256;
constexpr int kLdB = kBN + 8;       // bf16; conflict-free ldmatrix rows

// ---------------------------------------------------------------------------
// Instructions
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (nearest even), lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a * b + c on bf16 pairs, rounded once (nearest even).
__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// An int8 held as byte `sel` of w ^ 0x80808080, as an exact f32: the byte
// becomes the low mantissa bits of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float s8_f32(uint32_t w_biased, int sel) {
  return __uint_as_float(__byte_perm(w_biased, 0x4B000000u, sel | 0x7650)) - 8388736.f;
}

// Two int4 codes (u = q + 8) in bits 0-3 and 16-19 of `nib` -> the exact bf16
// pair (q_lo, q_hi): 0x4300 | u is 128 + u; fma(x, 1, -136) subtracts exactly.
__device__ __forceinline__ uint32_t s4x2_bf16(uint32_t nib) {
  return fma_bf16x2((nib & 0x000F000Fu) | 0x43004300u, 0x3F803F80u, 0xC308C308u);
}

// bf16(q * e) for a pair of exact bf16 codes: with a bf16 scale the product
// is exact in f32, so one bf16 rounding gives bf16(f32(q * e)); with an f32
// scale the product is rounded to f32 first, as the plain version does.
__device__ __forceinline__ uint32_t scale_pair(uint32_t q2, uint32_t e2) {
  return fma_bf16x2(q2, e2, 0x80008000u);
}
__device__ __forceinline__ uint32_t scale_pair(uint32_t q2, float e_lo, float e_hi) {
  return pack_bf16(__uint_as_float(q2 << 16) * e_lo, __uint_as_float(q2 & 0xFFFF0000u) * e_hi);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// 16 bytes of row `row` (a row of N elements of T) from column `col` into
// shared memory: cp.async when the rows are 16-byte aligned and the chunk is
// inside N, zero-filled past N, element by element at a ragged edge.
template <typename T>
__device__ __forceinline__ void copy_chunk(void* dst, const T* __restrict__ row, int col, int N) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  if (N % kE == 0 && col + kE <= N) {
    cp_async16(dst, row + col, 16);
  } else if (col >= N) {
    cp_async16(dst, row, 0);
  } else {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(row + col);
    const int valid = (N - col) * static_cast<int>(sizeof(T));
    uint8_t* d = static_cast<uint8_t*>(dst);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = i < valid ? src[i] : 0;
  }
}

// 16 bytes at column `col` of a global row of N elements of T, through the
// read-only path; zero past N.
template <typename T>
__device__ __forceinline__ uint4 load16(const T* __restrict__ row, int col, int N) {
  constexpr int kE = 16 / static_cast<int>(sizeof(T));
  if (N % kE == 0 && col + kE <= N) return __ldg(reinterpret_cast<const uint4*>(row + col));
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (col < N) {
    const uint8_t* src = reinterpret_cast<const uint8_t*>(row + col);
    const int valid = (N - col) * static_cast<int>(sizeof(T));
    uint8_t* d = reinterpret_cast<uint8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 16; ++i) d[i] = i < valid ? src[i] : 0;
  }
  return v;
}

// The decode body's activation operand: a[m][k .. k + 3] as two bf16 pairs
// (slots 2t, 2t + 1 and 2t + 8, 2t + 9), zero for a padding row m >= M.
__device__ __forceinline__ void act4(const float* __restrict__ a, int M, int K, int m, int k,
                                     uint32_t& lo, uint32_t& hi) {
  lo = hi = 0u;
  if (m < M) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(a + static_cast<size_t>(m) * K + k));
    lo = pack_bf16(v.x, v.y);
    hi = pack_bf16(v.z, v.w);
  }
}
__device__ __forceinline__ void act4(const __nv_bfloat16* __restrict__ a, int M, int K, int m,
                                     int k, uint32_t& lo, uint32_t& hi) {
  lo = hi = 0u;
  if (m < M) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(a + static_cast<size_t>(m) * K + k));
    lo = v.x;
    hi = v.y;
  }
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// The end of a split-K launch, called by every thread of every block after
// the block wrote its partial sums of rows m0 .. m0 + rows - 1, columns n0 ..
// n0 + cols - 1 to slice `slice` of scratch [S, M, npad]: the tile's last
// block to arrive (an integer counter, left zero) adds the S partials in
// slice order, rounds once to OutT and stores them.
template <typename OutT>
__device__ __forceinline__ void finish_slices(const float* __restrict__ scratch,
                                              OutT* __restrict__ out, int* counter, int S, int M,
                                              int N, int npad, int m0, int rows, int n0,
                                              int cols) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter, 1) == S - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int nthreads = blockDim.x * blockDim.y * blockDim.z;
  for (int idx = threadIdx.x; idx < rows * cols; idx += nthreads) {
    const int m = m0 + idx / cols, gc = n0 + idx % cols;
    if (m >= M || gc >= N) continue;
    const float* src = scratch + static_cast<size_t>(m) * npad + gc;
    float v = __ldcg(src);
    for (int r = 1; r < S; ++r) v += __ldcg(src + static_cast<size_t>(r) * M * npad);
    store1(out + static_cast<size_t>(m) * N + gc, v);
  }
  if (threadIdx.x == 0) *counter = 0;
}

// ---------------------------------------------------------------------------
// 1. Decode: the split-K weight stream
// ---------------------------------------------------------------------------

// Row m's 16 values of a thread (columns 16 g .. 16 g + 15 of the strip) from
// its accumulators: tile j holds columns 2j (c0 / c1 for m = 2t / 2t + 1) and
// 2j + 1 (c2 / c3).
template <int MT>
__device__ __forceinline__ void row16(const float (&acc)[MT][8][4], int mt, int e, float* v) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[2 * j] = acc[mt][j][e];
    v[2 * j + 1] = acc[mt][j][2 + e];
  }
}

// One block of the split-K stream, the body of splitk_kernel and, with
// kRows, of rows_kernel (below). Without kRows: grid (strips, slices); MT:
// n8 tiles of M (1: M <= 8, 2: M <= 16); scratch [slices, M, strips *
// kStrip] f32 and counters [strips] (zero, and left zero) are needed only
// with more than one slice. With kRows: grid z is the
// selected row, M = 1; block (strip, s, z) takes expert e = ids[z] clamped
// to [0, n_exp), its weights at the loader's offset for e (L::expert), its
// activations at row z of a [n_sel, K], its output at row z of out [n_sel,
// N], and row z's own scratch [slices, 1, npad] (of [n_sel, slices, npad])
// and counters [strips] (of [n_sel, strips]).
template <class L, int MT, bool kRows>
__device__ __forceinline__ void splitk_block(typename L::Params p, float* __restrict__ out, int M,
                                             int K, int N, int slice_units,
                                             float* __restrict__ scratch,
                                             int* __restrict__ counters,
                                             const int* __restrict__ ids, int n_exp) {
  if constexpr (kRows) {
    const size_t z = blockIdx.z;
    p = L::expert(p, static_cast<size_t>(min(max(ids[z], 0), n_exp - 1)), K, N);
    p.a += z * K;
    out += z * N;
    if (gridDim.y > 1) {
      scratch += z * gridDim.y * gridDim.x * kStrip;
      counters += z * gridDim.x;
    }
  }
  __shared__ float red[kDecodeWarps - 1][MT * 32][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int strip = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  const int col = strip * kStrip + 16 * g;

  float acc[MT][8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][j][c] = 0.f;

  const int units = K / L::kUnitK;
  const int i1 = min(units, (s + 1) * slice_units) * L::kInner;
  int i = s * slice_units * L::kInner + warp;
  typename L::Raw cur, nxt;
  if (i < i1) L::load(cur, p, i, col, t, N);
  for (; i < i1; i += kDecodeWarps) {
    const bool more = i + kDecodeWarps < i1;
    if (more) L::load(nxt, p, i + kDecodeWarps, col, t, N);
    L::template compute<MT>(cur, acc, p, i, g, t, M, K);
    if (more) cur = nxt;
  }

  // the block's sum, warps in order
  float* flat = &acc[0][0][0];
  if (warp > 0) {
#pragma unroll
    for (int v = 0; v < MT * 32; ++v) red[warp - 1][v][lane] = flat[v];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < kDecodeWarps - 1; ++w)
#pragma unroll
      for (int v = 0; v < MT * 32; ++v) flat[v] += red[w][v][lane];
    const int npad = gridDim.x * kStrip;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mt * 8 + 2 * t + e;
        if (m >= M) continue;
        float v[16];
        row16<MT>(acc, mt, e, v);
        if (S > 1) {
          float4* dst = reinterpret_cast<float4*>(
              scratch + (static_cast<size_t>(s) * M + m) * npad + col);
#pragma unroll
          for (int q = 0; q < 4; ++q) dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                                                           v[4 * q + 3]);
        } else {
          float* dst = out + static_cast<size_t>(m) * N + col;
          if (N % 4 == 0 && col + 16 <= N) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              reinterpret_cast<float4*>(dst)[q] = make_float4(v[4 * q], v[4 * q + 1],
                                                              v[4 * q + 2], v[4 * q + 3]);
          } else {
#pragma unroll
            for (int c = 0; c < 16; ++c)
              if (col + c < N) dst[c] = v[c];
          }
        }
      }
  }
  if (S > 1)
    finish_slices(scratch, out, counters + strip, S, M, N, gridDim.x * kStrip, 0, M,
                  strip * kStrip, kStrip);
}

// grid (strips, slices), kDecodeWarps warps; splitk_block without kRows.
template <class L, int MT>
__global__ void __launch_bounds__(kDecodeWarps * 32, MT == 1 ? 3 : 2)
splitk_kernel(typename L::Params p, float* __restrict__ out, int M, int K, int N,
              int slice_units, float* __restrict__ scratch, int* __restrict__ counters) {
  splitk_block<L, MT, false>(p, out, M, K, N, slice_units, scratch, counters, nullptr, 0);
}

template <class L>
int launch_splitk(const typename L::Params& p, float* out, int M, int K, int N, int slice_units,
                  float* scratch, int* counters, cudaStream_t stream) {
  const int units = K / L::kUnitK;
  if (M < 1 || M > 16 || slice_units < 1) return kBadArgs;
  const int slices = (units + slice_units - 1) / slice_units;
  if (slices > 65535 || (slices > 1 && (scratch == nullptr || counters == nullptr)))
    return kBadArgs;
  const dim3 grid((N + kStrip - 1) / kStrip, slices);
  if (M <= 8)
    splitk_kernel<L, 1><<<grid, kDecodeWarps * 32, 0, stream>>>(p, out, M, K, N, slice_units,
                                                               scratch, counters);
  else
    splitk_kernel<L, 2><<<grid, kDecodeWarps * 32, 0, stream>>>(p, out, M, K, N, slice_units,
                                                               scratch, counters);
  return status();
}

// The selected rows (B9, B12): out[z] = bf16(a[z]) @ W[e(z)] for z < n_sel,
// out f32 [n_sel, N], a [n_sel, K], e(z) = ids[z] clamped to [0, n_exp),
// read on the device. grid (strips, slices, n_sel), kDecodeWarps warps and
// three blocks an SM, as splitk_kernel's at MT = 1 (ops/splitk.py
// ROWS_SLOTS plans for them), each block splitk_block with kRows at M = 1;
// with more than one slice, scratch [n_sel, slices, strips * kStrip] f32
// and counters [n_sel, strips] (zero, and left zero), so each (row, strip)
// tile sums its slices in slice order through its own counter. Its own
// name, so profiles tell B9 from B4 and B12 from B11.
template <class L, int MT>
__global__ void __launch_bounds__(kDecodeWarps * 32, MT == 1 ? 3 : 2)
rows_kernel(typename L::Params p, const int* __restrict__ ids, int n_exp, float* __restrict__ out,
            int K, int N, int slice_units, float* __restrict__ scratch,
            int* __restrict__ counters) {
  splitk_block<L, MT, true>(p, out, 1, K, N, slice_units, scratch, counters, ids, n_exp);
}

// slice_units: the loader's slice units per K slice (ops/splitk.py rows_plan).
template <class L>
int launch_rows(const typename L::Params& p, const int* ids, int n_exp, float* out, int n_sel,
                int K, int N, int slice_units, float* scratch, int* counters,
                cudaStream_t stream) {
  const int units = K / L::kUnitK;
  if (n_sel < 1 || n_sel > 65535 || n_exp < 1 || slice_units < 1) return kBadArgs;
  const int slices = (units + slice_units - 1) / slice_units;
  if (slices > 65535 || (slices > 1 && (scratch == nullptr || counters == nullptr)))
    return kBadArgs;
  const dim3 grid((N + kStrip - 1) / kStrip, slices, n_sel);
  rows_kernel<L, 1><<<grid, kDecodeWarps * 32, 0, stream>>>(p, ids, n_exp, out, K, N,
                                                           slice_units, scratch, counters);
  return status();
}

// ---------------------------------------------------------------------------
// 2. Prefill: the pipelined tensor-core GEMM
// ---------------------------------------------------------------------------

// Whether loader L folds a bias dot into the prefill k walk (its kBiasDot).
template <class L, class = void>
struct BiasDot : std::false_type {};
template <class L>
struct BiasDot<L, std::void_t<decltype(L::kBiasDot)>> : std::bool_constant<L::kBiasDot> {};

// A unit's bias tile: the A operand, BM rows x 16 bf16 (the two 16-byte
// chunks of row r at chunk c ^ ((r >> 2) & 1), so ldmatrix's 8 rows meet 32
// banks), then the B operand's 8 weight rows of the strip (rows 8-15 of the
// 16-deep step read rows 0-7 again).
template <int BM>
struct BiasTile {
  static constexpr int kABytes = BM * 16 * 2;
  static constexpr int kBytes = kABytes + 8 * kLdB * 2;
};

// The ring: kStages raw stages (bf16 A rows of 64, their eight 16-byte
// chunks swizzled by the row (chunk c of row r at c ^ (r & 7)) so that
// ldmatrix reads 8 rows without bank conflicts; then the loader's raw bytes)
// and two bf16 B tiles, small enough for two blocks an SM: one block's
// barrier and copy waits are the other's issue slots.
template <class L, int BM>
struct PrefillSmem {
  static constexpr int kStages = 3;
  static constexpr int kABytes = BM * kBK * 2;
  static constexpr int kStageBytes = kABytes + L::kRawBytes;
  static constexpr int kBiasBytes = BiasDot<L>::value ? 2 * BiasTile<BM>::kBytes : 0;
  static constexpr int kBytes = kStages * kStageBytes + 2 * kBK * kLdB * 2 + kBiasBytes;
  static_assert(kABytes % 16 == 0 && L::kRawBytes % 16 == 0, "16-byte aligned stages");
  static_assert(kBytes <= 232448 / 2 - 1024, "two blocks an SM (the SM keeps 1 KB a block)");
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* smem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ void store2(float* out, int M, int N, int r, int c, float v0, float v1) {
  if (r >= M) return;
  float* p = out + static_cast<size_t>(r) * N + c;
  if (c + 1 < N && N % 2 == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    if (c < N) p[0] = v0;
    if (c + 1 < N) p[1] = v1;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* out, int M, int N, int r, int c, float v0,
                                       float v1) {
  if (r >= M) return;
  __nv_bfloat16* p = out + static_cast<size_t>(r) * N + c;
  if (c + 1 < N && N % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    if (c < N) p[0] = __float2bfloat16_rn(v0);
    if (c + 1 < N) p[1] = __float2bfloat16_rn(v1);
  }
}

// One block of the pipelined GEMM, the body of gemm_kernel and, with
// kExperts, of experts_kernel (below). Without kExperts: grid (ceil(N /
// 128), ceil(M / BM), slices); slice z sums k steps [z * slice_steps, (z +
// 1) * slice_steps), and with more than one slice scratch [slices, M,
// gridDim.x * 128] and counters [gridDim.x * gridDim.y] take the partials
// as in splitk_kernel. With kExperts: grid z is the output z of the expert
// grid, whose block takes expert e = z (ids null) or ids[z] clamped to [0,
// n_exp), its activations at a + z * a_stride, its weights at the loader's
// offset for expert e (L::expert) and its output at out + z * M * N, over
// all of K (one slice).
template <class L, int BM, typename OutT, bool kExperts>
__device__ __forceinline__ void gemm_block(typename L::Params p,
                                           const __nv_bfloat16* __restrict__ a,
                                           OutT* __restrict__ out, int M, int K, int N,
                                           int slice_steps, float* __restrict__ scratch,
                                           int* __restrict__ counters, size_t a_stride,
                                           const int* __restrict__ ids, int n_exp) {
  if constexpr (kExperts) {
    const size_t z = blockIdx.z;
    const size_t e = ids ? static_cast<size_t>(min(max(ids[z], 0), n_exp - 1)) : z;
    p = L::expert(p, e, K, N);
    a += z * a_stride;
    out += z * M * static_cast<size_t>(N);
  }
  using SM = PrefillSmem<L, BM>;
  constexpr int kS = SM::kStages;
  constexpr int kWarpM = BM / 2, kMF = kWarpM / 16, kNF = 4;
  constexpr int kChunksA = kBK / 8;                                    // 16-byte chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + kS * SM::kStageBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;
  const int u0 = kExperts ? 0 : blockIdx.z * slice_steps;       // this slice's k steps
  const int units = min(K / kBK - u0, slice_steps);

  auto stage = [&](int u) { return smem + (u % kS) * SM::kStageBytes; };
  auto issue = [&](int u) {
    if (u < units) {
      unsigned char* st = stage(u);
      __nv_bfloat16* sa = reinterpret_cast<__nv_bfloat16*>(st);
      int k0, k1;
      L::runs(u0 + u, k0, k1);
      for (int c = tid; c < BM * kChunksA; c += kPrefillThreads) {
        const int row = c / kChunksA, cc = c % kChunksA;
        const int gk = (cc < kChunksA / 2 ? k0 : k1) + (cc % (kChunksA / 2)) * 8;
        const int gr = m0 + row;
        cp_async16(sa + row * kBK + ((cc ^ (row & 7)) * 8),
                   a + static_cast<size_t>(gr < M ? gr : 0) * K + gk, gr < M ? 16 : 0);
      }
      L::issue(st + SM::kABytes, p, u0 + u, n0, N, tid);
      if constexpr (BiasDot<L>::value) {
        // a unit's first stage (slices are whole units) also copies its bias tile
        if ((u & 3) == 0)
          L::template bias_issue<BM>(smem + kS * SM::kStageBytes + 2 * kBK * kLdB * 2 +
                                         ((u >> 2) & 1) * BiasTile<BM>::kBytes,
                                     p, (u0 + u) >> 2, m0, M, n0, N, tid);
      }
    }
    cp_async_commit();
  };
  auto dequant = [&](int u) {
    L::dequant(stage(u) + SM::kABytes, bs + (u & 1) * (kBK * kLdB), tid);
  };

  float acc[kMF][kNF][4];
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

#pragma unroll
  for (int u = 0; u < kS - 1; ++u) issue(u);
  cp_async_wait<kS - 2>();
  __syncthreads();
  dequant(0);

  for (int u = 0; u < units; ++u) {
    cp_async_wait<kS - 3>();   // stages up to u + 1 have landed (this thread's copies)
    __syncthreads();           // ... everyone's; B tile u is written; mma u - 1 is done
    issue(u + kS - 1);         // into the slot of stage u - 1
    if (u + 1 < units) dequant(u + 1);
    const __nv_bfloat16* sa = reinterpret_cast<const __nv_bfloat16*>(stage(u));
    const __nv_bfloat16* sb = bs + (u & 1) * (kBK * kLdB);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t af[kMF][4];
#pragma unroll
      for (int i = 0; i < kMF; ++i) {
        const int r = wm * kWarpM + i * 16 + (lane & 15);
        ldsm_x4(af[i], sa + r * kBK + (((kk >> 3) + (lane >> 4)) ^ (r & 7)) * 8);
      }
      uint32_t bf[kNF / 2][4];
#pragma unroll
      for (int j = 0; j < kNF / 2; ++j)
        ldsm_x4_trans(bf[j], sb + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdB +
                                 wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < kMF; ++i)
#pragma unroll
        for (int j = 0; j < kNF; ++j)
          mma16816(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j / 2][(j & 1) * 2],
                   bf[j / 2][(j & 1) * 2 + 1]);
    }
    if constexpr (BiasDot<L>::value) {
      // after a unit's last stage, its bias step, the A operand negated (exact
      // in bf16); the tile was copied with the unit's first stage, three steps
      // back, and the other parity's tile is the next unit's
      if ((u & 3) == 3) {
        const unsigned char* bt = smem + kS * SM::kStageBytes + 2 * kBK * kLdB * 2 +
                                  ((u >> 2) & 1) * BiasTile<BM>::kBytes;
        const __nv_bfloat16* ba = reinterpret_cast<const __nv_bfloat16*>(bt);
        const __nv_bfloat16* bb =
            reinterpret_cast<const __nv_bfloat16*>(bt + BiasTile<BM>::kABytes);
        uint32_t af[kMF][4];
#pragma unroll
        for (int i = 0; i < kMF; ++i) {
          const int r = wm * kWarpM + i * 16 + (lane & 15);
          ldsm_x4(af[i], ba + r * 16 + (((lane >> 4) ^ ((r >> 2) & 1)) * 8));
#pragma unroll
          for (int q = 0; q < 4; ++q) af[i][q] ^= 0x80008000u;
        }
        uint32_t bf[kNF / 2][4];
#pragma unroll
        for (int j = 0; j < kNF / 2; ++j)
          ldsm_x4_trans(bf[j], bb + (lane & 7) * kLdB + wn * 32 + j * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < kMF; ++i)
#pragma unroll
          for (int j = 0; j < kNF; ++j)
            mma16816(acc[i][j], af[i][0], af[i][1], af[i][2], af[i][3], bf[j / 2][(j & 1) * 2],
                     bf[j / 2][(j & 1) * 2 + 1]);
      }
    }
  }
  cp_async_wait<0>();

  const int S = kExperts ? 1 : gridDim.z, npad = gridDim.x * kBN;
  float* part = scratch + static_cast<size_t>(blockIdx.z) * M * npad;
#pragma unroll
  for (int i = 0; i < kMF; ++i)
#pragma unroll
    for (int j = 0; j < kNF; ++j) {
      const int r = m0 + wm * kWarpM + i * 16 + g;
      const int c = n0 + wn * 32 + j * 8 + 2 * t;
      if (S == 1) {
        store2(out, M, N, r, c, acc[i][j][0], acc[i][j][1]);
        store2(out, M, N, r + 8, c, acc[i][j][2], acc[i][j][3]);
      } else {
        store2(part, M, npad, r, c, acc[i][j][0], acc[i][j][1]);
        store2(part, M, npad, r + 8, c, acc[i][j][2], acc[i][j][3]);
      }
    }
  if (S > 1)
    finish_slices(scratch, out, counters + blockIdx.y * gridDim.x + blockIdx.x, S, M, N, npad,
                  m0, BM, n0, kBN);
}

// grid (ceil(N / 128), ceil(M / BM), slices), kPrefillThreads threads,
// dynamic shared memory PrefillSmem<L, BM>::kBytes. a bf16 [M, K] (the
// wrappers round f32 activations to bf16 first, as the kernel would); K a
// multiple of kBK; scratch and counters as gemm_block takes them.
template <class L, int BM, typename OutT>
__global__ void __launch_bounds__(kPrefillThreads, 2)
gemm_kernel(typename L::Params p, const __nv_bfloat16* __restrict__ a, OutT* __restrict__ out,
            int M, int K, int N, int slice_steps, float* __restrict__ scratch,
            int* __restrict__ counters) {
  gemm_block<L, BM, OutT, false>(p, a, out, M, K, N, slice_steps, scratch, counters, 0, nullptr,
                                 0);
}

template <class L, int BM, typename OutT>
int launch_gemm_bm(const typename L::Params& p, const __nv_bfloat16* a, OutT* out, int M, int K,
                   int N, int slice_steps, float* scratch, int* counters, cudaStream_t stream) {
  constexpr int bytes = PrefillSmem<L, BM>::kBytes;
  auto kernel = gemm_kernel<L, BM, OutT>;
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
        cudaSuccess)
      return status();
    configured = true;
  }
  const int steps = K / kBK;
  if (slice_steps < 1) return kBadArgs;
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM,
                  (steps + slice_steps - 1) / slice_steps);
  if (grid.y > 65535 || grid.z > 65535 || (grid.z > 1 && (scratch == nullptr || counters == nullptr)))
    return kBadArgs;
  kernel<<<grid, kPrefillThreads, bytes, stream>>>(p, a, out, M, K, N, slice_steps, scratch,
                                                   counters);
  return status();
}

// slice_units: K slice length in the loader's slice units (ops/splitk.py).
template <class L, typename OutT>
int launch_gemm(const typename L::Params& p, const __nv_bfloat16* a, OutT* out, int M, int K,
                int N, int slice_units, float* scratch, int* counters, cudaStream_t stream) {
  const int slice_steps = slice_units * L::kUnitK / kBK;
  if (M < 128)
    return launch_gemm_bm<L, 64, OutT>(p, a, out, M, K, N, slice_steps, scratch, counters, stream);
  return launch_gemm_bm<L, 128, OutT>(p, a, out, M, K, N, slice_steps, scratch, counters, stream);
}

// The expert grid (B10, B13, B19): out[z] = a[z] @ W[e(z)] for z < Z, each
// f32 [M, N]. grid (ceil(N / 128), ceil(M / BM), Z), one K slice: at every
// model shape the grid already has several blocks for each of the 264 block
// slots. Block z as gemm_block takes it with kExperts (a_stride 0: the
// activations are shared by every z).
template <class L, int BM>
__global__ void __launch_bounds__(kPrefillThreads, 2)
experts_kernel(typename L::Params p, const __nv_bfloat16* __restrict__ a, size_t a_stride,
               const int* __restrict__ ids, int n_exp, float* __restrict__ out, int M, int K,
               int N) {
  gemm_block<L, BM, float, true>(p, a, out, M, K, N, K / kBK, nullptr, nullptr, a_stride, ids,
                                 n_exp);
}

template <class L, int BM>
int launch_experts_bm(const typename L::Params& p, const __nv_bfloat16* a, size_t a_stride,
                      const int* ids, int n_exp, float* out, int Z, int M, int K, int N,
                      cudaStream_t stream) {
  constexpr int bytes = PrefillSmem<L, BM>::kBytes;
  auto kernel = experts_kernel<L, BM>;
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) !=
        cudaSuccess)
      return status();
    configured = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, Z);
  kernel<<<grid, kPrefillThreads, bytes, stream>>>(p, a, a_stride, ids, n_exp, out, M, K, N);
  return status();
}

// row_tile: BM, 64 or 128 (ops/splitk.py experts_grid); ids null: Z = E.
template <class L>
int launch_experts(const typename L::Params& p, const __nv_bfloat16* a, size_t a_stride,
                   const int* ids, int n_exp, float* out, int Z, int M, int K, int N,
                   int row_tile, cudaStream_t stream) {
  if (M < 1 || K % kBK || Z < 1 || Z > 65535 || n_exp < 1 ||
      (row_tile != 64 && row_tile != 128) || (M + row_tile - 1) / row_tile > 65535)
    return kBadArgs;
  if (row_tile == 64)
    return launch_experts_bm<L, 64>(p, a, a_stride, ids, n_exp, out, Z, M, K, N, stream);
  return launch_experts_bm<L, 128>(p, a, a_stride, ids, n_exp, out, Z, M, K, N, stream);
}

}  // namespace sm90

// B4's body for any caller in the library (B17 runs its dot through it):
// the split-K stream at M <= 16 (a f32 or bf16), else the pipelined GEMM (a
// bf16); eff bf16 or f32.
int tcq4_gemm(const void* a, bool a_bf16, const uint8_t* qs, const void* eff, bool eff_f32,
              void* out, bool out_bf16, int M, int K, int N, int slice_units, float* scratch,
              int* counters, cudaStream_t stream);

// B4's decode body with the selected rows on the grid, for B9 (tcq4_experts.cu):
// out[z] = a[z] @ W[ids[z]] (sm90::rows_kernel), a bf16 [n_sel, K], qs
// [E][K/2][N] and eff [E][K/32][N] bf16.
int tcq4_rows(const __nv_bfloat16* a, const uint8_t* qs, const __nv_bfloat16* eff,
              const int* ids, int n_exp, float* out, int n_sel, int K, int N, int slice_units,
              float* scratch, int* counters, cudaStream_t stream);

// B4's prefill body on the expert grid, for the expert matmuls (tcq4_experts.cu):
// out[z] = bf16 a[z] @ W[e(z)] (sm90::experts_kernel), qs [E][K/2][N] and eff
// [E][K/32][N] bf16 or f32.
int tcq4_experts(const __nv_bfloat16* a, size_t a_stride, const uint8_t* qs, const void* eff,
                 bool eff_f32, const int* ids, int n_exp, float* out, int Z, int M, int K, int N,
                 int row_tile, cudaStream_t stream);

}  // namespace rrs
