// W4A4 decode matmuls over int8 group dots: the pre-quantized one (gx), the
// one with the activation quantization fused into its prologue (gx2), the
// one that also fuses the 256-point Walsh-Hadamard rotation (gx3), and the
// integer oracle (a8). The four share one body and differ only in the
// prologue that fills shared memory with the int4 activation codes and their
// per-superblock scales, and a8 in its epilogue and its rows.
//
// Replaces rrs_tpu/ops/tcq4_matmul.py:1262 tcq4_matmul_gx2 (_kernel_gx2 at
// :1194), :272 tcq4_matmul_gx (_kernel_gx at :160), :1394 tcq4_matmul_gx3
// (_kernel_gx3 at :1332) and :89 tcq4_matmul_a8 (_kernel_a8 at :64).
// C[m, n] = sum over 32-groups g of
//     (dot32(q_a[m, g], w_q[g, n]) * (amax[m, sb] / 7)) * eff[g, n]
// where, for gx2, q_a = clip(rint(a_rot * (7 / amax)), -7, 7) per 256-block,
// exactly as quantize_activations_rrs computes it; gx3 first rotates the raw
// activations, x_rot = FWHT256(x) / 16; gx takes q_a and amax as given. The
// group dots are int32-exact. a8 takes the codes as given too (M <= 32, f32
// eff) and sums in the JAX kernel's order: per superblock sb, sbacc = sum
// over its groups of f32(dot) * eff, then acc += sbacc * (amax[m, sb] / 7).
//
// Bound on the H100: bytes. At M = 1 each weight byte feeds two int8 MACs,
// far below the card's ops/byte balance, so the time is the qs
// (K/2 * N bytes) plus eff (K/32 * N * 2 or 4 bytes) stream.
//
// Design: a split-K integer weight stream. The grid is (column strips of
// 128) x (K slices of whole superblocks; ops/splitk.py gx_plan picks the
// slice length). A superblock is 256 k, one activation scale block, so a
// block quantizes (and for gx3 rotates) only the superblocks of its own
// slice, and its codes are those of whole-row quantization bit for bit.
// 1. Bytes in flight: before the prologue, the block issues 16-byte
//    cp.async copies of its slice's activations (to be quantized: at most
//    kMaxTasks rows x superblocks, 16 KB of f32; given codes go straight
//    into place) and then of its first kStages superblocks
//    of weights (each 128 byte rows x 128 columns of qs and 8 eff rows, 18
//    KB with bf16 eff) into a shared-memory ring; the weights do not depend
//    on the activations, and the activations, issued first, do not queue
//    behind them. The prologue (one warp per (row, superblock)) runs from
//    shared memory while the weights land; each consumed superblock's stage
//    is refilled with the one kStages ahead. The plan keeps a block within
//    a third of the SM's shared memory, so three blocks share each SM (a
//    fourth ring stage, or a 16-warp block, timed no faster).
// 2. Group dots on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32,
//    roles swapped: the weights are the A operand (16 output columns x 32
//    k), the activation codes the B operand (8 rows of M, zero past M), so
//    M = 8 costs what M = 1 does. Warp w takes columns 32 w .. 32 w + 31 of
//    the strip; thread (g, t) reads four 32-bit words (columns 4 g .. 4 g +
//    3) of byte rows 4 t .. 4 t + 3 and 16 + 4 t .. 16 + 4 t + 3 of each
//    quarter superblock, transposes them with byte permutes into words of
//    one column and four k, and masks out the nibbles in place: x & 0xF0 is
//    the high nibble times 16 as an s8, (x << 4) & 0xF0 the low one. One
//    quarter (32 byte rows) holds the low-nibble group qq and the
//    high-nibble group qq + 4 of its superblock, so it ends in four mma
//    (two 16-column tiles x two groups), each an exact 16 x dot. The
//    strip's 16-byte chunks are XOR-swizzled by the row (chunk c of row r
//    at c ^ 2 ((r >> 2) & 3)), so the 32 lanes' words meet 32 banks.
// 3. Epilogue per group, in a fixed order (superblocks, quarters, then
//    low before high, so groups 0, 4, 1, 5, 2, 6, 3, 7 of a superblock):
//    y += (f32(16 dot) * (amax / 7 / 16)) * eff with
//    explicit round-to-nearest products and sums, the order that
//    ops/tcq4_matmul.py tcq4_matmul_gx_splitk_plain emulates. Scaling by
//    16 and 1/16 is exact, so each term is (f32(dot) * (amax / 7)) * eff
//    bit for bit, and every instantiation rounds alike: gx is bit-equal to
//    gx2 given gx2's own codes, and gx3 to gx on gx3's. The int32
//    accumulator starts at the bits of 1.5 * 2^23, so |16 dot| < 2^22
//    lands in the f32 mantissa and f32(16 dot) is a reinterpretation and
//    one exact subtraction on the FMA pipe, not a quarter-rate
//    integer-to-float conversion. a8's epilogue (kGivenA8) sums the same
//    group terms f32(16 dot) * eff into sbacc over the superblock, in that
//    order, then y += sbacc * (amax / 7 / 16): 16 x sbacc and amax / 7 / 16
//    are exact, so that is JAX's sbacc * (amax / 7) bit for bit
//    (ops/tcq4_matmul.py tcq4_matmul_a8_splitk_plain). Its rows are MT n8
//    tiles of M (1, 2 or 4; M <= 32): each weight fragment, decoded once,
//    feeds every tile's mma. (JAX's group order, 0 .. 7, would read each
//    quarter's words twice; a variant in that order timed no faster at M =
//    1 and slower at M = 32.)
// 4. With more than one slice, a strip's slices are one thread-block
//    cluster (1 x slices, at most kMaxSlices): each block leaves its partial
//    sums in its own shared memory, and after a cluster barrier the slice-0
//    block (for a8, every block, a share of the rows each) reads every
//    slice's partials through distributed shared memory and adds them in
//    slice order, a thread a column. No global scratch, no fence, no atomic
//    counter; one launch, the same bits on every run.
//
// gx3's rotation: the quantizing prologue gives one warp per (row,
// superblock) with 8 consecutive elements per lane, which is the layout of a
// 256-point butterfly: stages h = 1, 2, 4 run inside the lane's registers and
// h = 8 ... 128 exchange with lane ^ (h / 8) by __shfl_xor_sync (the lower
// index keeps a + b, the upper a - b), then the result is scaled by 1/16,
// which is exact. That is the Sylvester (natural) order of
// formats/fwht.py hadamard_matrix, about 2k adds per (row, superblock) in
// place of JAX's in-kernel 256 x 256 dot.

#include <cooperative_groups.h>

#include "gemm_sm90.cuh"

namespace {

using rrs::sm90::copy_chunk;
using rrs::sm90::cp_async16;
using rrs::sm90::cp_async_commit;
using rrs::sm90::cp_async_wait;

constexpr int kStrip = 128;                  // output columns a block (ops/splitk.py STRIP)
constexpr int kWarps = 4;                    // 32 columns each
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 4;                   // superblocks in flight a block
constexpr int kMaxSlices = 16;               // a cluster's blocks (ops/splitk.py GX_MAX_SLICES)
constexpr int kQsBytes = 128 * kStrip;       // a superblock's byte rows of the strip
constexpr int kMaxTasks = 16;                // (row, superblock) pairs a block (GX_MAX_TASKS)
constexpr int kMaxSmem = 200 * 1024;         // above any smem_bytes gx_viable allows
constexpr int kBias = 0x4B400000;            // 1.5 * 2^23 as f32 bits
constexpr float kBiasF = 12582912.0f;

// The prologue: what fills the codes and scales in shared memory; kGivenA8
// is kGiven's with the a8 epilogue.
enum Prologue { kGiven = 0, kQuantize = 1, kRotateQuantize = 2, kGivenA8 = 3 };

// A stage: a superblock's qs rows of the strip, then its 8 eff rows.
template <typename EffT>
constexpr int kStageBytes = kQsBytes + 8 * kStrip * static_cast<int>(sizeof(EffT));

// The ring's stages: the slice's superblocks, at most kStages.
inline __host__ __device__ int ring(int slice_units) {
  return slice_units < kStages ? slice_units : kStages;
}

// A code row: the slice's codes and 16 bytes, so the 8 rows' words of one
// B fragment meet distinct banks.
inline __host__ __device__ int code_stride(int slice_units) { return slice_units * 256 + 16; }

// The scales [M][slice_units], padded to 16 bytes.
inline __host__ __device__ int scale_bytes(int M, int slice_units) {
  return (M * slice_units * 4 + 15) / 16 * 16;
}

// A full ring stages the activations in its last stage, whose weights are
// copied once the prologue has read them; a shorter one after the scales.
inline __host__ __device__ bool late_stage(int slice_units) {
  return ring(slice_units) == kStages;
}

// The ring, the codes [M][code_stride], the scales [M][slice_units] and,
// for a quantizing prologue under a shorter ring, the slice's activations
// [M][slice_units * 256] as given (f32 or bf16).
template <typename EffT>
size_t smem_bytes(int M, int slice_units, int x_bytes) {
  return static_cast<size_t>(ring(slice_units)) * kStageBytes<EffT> +
         static_cast<size_t>(M) * code_stride(slice_units) +
         static_cast<size_t>(scale_bytes(M, slice_units)) +
         (late_stage(slice_units) ? 0 : static_cast<size_t>(M) * slice_units * 256 * x_bytes);
}

struct Args {
  const void* a;           // f32 / bf16 activations [M, K], or int8 codes (kGiven)
  const float* a_scale;    // kGiven: f32 [M, K/256] per-block absmax
  const uint8_t* qs;       // [K/2, N]
  const void* eff;         // bf16 or f32 [K/32, N]
  float* out;              // f32 [M, N]
  int M, K, N, slice_units;
  int x_bf16;
};

// Quantize one lane's 8 rotated values of a (row, superblock): the codes go
// to dst as 8 bytes, the block's scale (amax / 7) / 16 to *scale.
__device__ __forceinline__ void quantize8(const float (&x)[8], int8_t* dst, float* scale,
                                          int lane) {
  float amax = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) amax = fmaxf(amax, fabsf(x[i]));
  amax = rrs::warp_max(amax);
  if (amax < 1e-10f) amax = 1.0f;
  const float rec = 7.0f / amax;                     // a true division
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float q = fminf(fmaxf(rintf(__fmul_rn(x[i], rec)), -7.0f), 7.0f);
    w[i >> 2] |= (static_cast<uint32_t>(static_cast<int>(q)) & 0xffu) << (8 * (i & 3));
  }
  *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
  if (lane == 0) *scale = __fmul_rn(__fmul_rn(amax, 1.0f / 7.0f), 0.0625f);
}

// In-place natural-order 256-point Walsh-Hadamard transform over a warp, 8
// consecutive elements per lane, scaled by 1/16.
__device__ __forceinline__ void fwht256(float (&x)[8], int lane) {
#pragma unroll
  for (int h = 1; h < 8; h <<= 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i & h) continue;
      const float a = x[i], b = x[i + h];
      x[i] = __fadd_rn(a, b);
      x[i + h] = __fsub_rn(a, b);
    }
  }
#pragma unroll
  for (int m = 1; m < 32; m <<= 1) {
    const bool upper = lane & m;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float other = __shfl_xor_sync(0xffffffffu, x[i], m);
      x[i] = upper ? __fsub_rn(other, x[i]) : __fadd_rn(x[i], other);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = __fmul_rn(x[i], 0.0625f);
}

// A lane's 8 staged activations (element off of the staging area) as f32.
__device__ __forceinline__ void load8(const unsigned char* xs, int x_bf16, int off,
                                      float (&x)[8]) {
  if (x_bf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(xs + off * 2);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = __bfloat162float(h[i]);
  } else {
    const float4 x0 = *reinterpret_cast<const float4*>(xs + off * 4);
    const float4 x1 = *reinterpret_cast<const float4*>(xs + off * 4 + 16);
    x[0] = x0.x; x[1] = x0.y; x[2] = x0.z; x[3] = x0.w;
    x[4] = x1.x; x[5] = x1.y; x[6] = x1.z; x[7] = x1.w;
  }
}

// 16-byte chunk c of byte row r of a stage sits at chunk c ^ swizzle(r).
__device__ __forceinline__ int swizzle(int r) { return ((r >> 2) & 3) << 1; }

// The words of rows r .. r + 3 (bytes: 4 columns) as words of columns c ..
// c + 3 (bytes: 4 rows, r first).
__device__ __forceinline__ void transpose4(const uint32_t (&r)[4], uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// The low (hi = 0) or high nibbles of 4 packed bytes, each times 16 as an s8.
__device__ __forceinline__ uint32_t nib16(uint32_t x, int hi) {
  return (hi ? x : x << 4) & 0xF0F0F0F0u;
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void eff4(const __nv_bfloat16* e, float (&v)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(e);
  v[0] = __uint_as_float(raw.x << 16);
  v[1] = __uint_as_float(raw.x & 0xFFFF0000u);
  v[2] = __uint_as_float(raw.y << 16);
  v[3] = __uint_as_float(raw.y & 0xFFFF0000u);
}
__device__ __forceinline__ void eff4(const float* e, float (&v)[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(e);
  v[0] = raw.x; v[1] = raw.y; v[2] = raw.z; v[3] = raw.w;
}

// Superblock sb's qs rows and eff rows of the block's strip into stage st.
template <typename EffT>
__device__ __forceinline__ void issue(const Args& p, unsigned char* st, int sb, int col0) {
  const uint8_t* qs = p.qs + static_cast<size_t>(sb) * 128 * p.N;
  for (int q = threadIdx.x; q < 128 * 8; q += kThreads) {
    const int r = q >> 3, c = q & 7;
    copy_chunk(st + r * kStrip + ((c ^ swizzle(r)) << 4), qs + static_cast<size_t>(r) * p.N,
               col0 + c * 16, p.N);
  }
  constexpr int kPerRow = kStrip * static_cast<int>(sizeof(EffT)) / 16;
  const EffT* eff = static_cast<const EffT*>(p.eff) + static_cast<size_t>(sb) * 8 * p.N;
  for (int q = threadIdx.x; q < 8 * kPerRow; q += kThreads) {
    const int r = q / kPerRow, c = q - r * kPerRow;
    copy_chunk(st + kQsBytes + r * kStrip * static_cast<int>(sizeof(EffT)) + c * 16,
               eff + static_cast<size_t>(r) * p.N, col0 + c * (16 / static_cast<int>(sizeof(EffT))),
               p.N);
  }
}

// The end of a split launch, after every warp is past the main loop: the
// block's partial sums go to its shared memory [M][kStrip]; the slice-0
// block of the strip's cluster adds the S partials of each output in slice
// order, thread c taking column c in all M rows, and stores them. With
// kSpread (a8, up to 32 rows) block s of the cluster takes rows s, s + S,
// ... instead, so no block reads more than a share of the M x S partials
// through distributed shared memory. The second barrier keeps every block's
// shared memory alive until it has been read.
template <int MT, bool kSpread>
__device__ __forceinline__ void finish_cluster(const Args& p, const float (&y)[MT][4][2],
                                               float* part, int wcol, int t, int S, int col0) {
  static_assert(kThreads == kStrip, "a thread a column");
  namespace cg = cooperative_groups;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (mt * 8 + 2 * t + r < p.M)
        *reinterpret_cast<float4*>(part + (mt * 8 + 2 * t + r) * kStrip + wcol) =
            make_float4(y[mt][0][r], y[mt][1][r], y[mt][2][r], y[mt][3][r]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int c = threadIdx.x;
  if ((kSpread || blockIdx.y == 0) && col0 + c < p.N) {
    for (int m = kSpread ? blockIdx.y : 0; m < p.M; m += kSpread ? S : 1) {
      float x[kMaxSlices];
#pragma unroll
      for (int s = 0; s < kMaxSlices; ++s)
        x[s] = s < S ? cluster.map_shared_rank(part, s)[m * kStrip + c] : 0.0f;
      float v = x[0];
#pragma unroll
      for (int s = 1; s < kMaxSlices; ++s)
        if (s < S) v += x[s];
      p.out[static_cast<size_t>(m) * p.N + col0 + c] = v;
    }
  }
  cluster.sync();
}

// grid (strips, slices), kThreads threads, dynamic shared memory
// smem_bytes<EffT>(M, slice_units, x_bytes): the ring, then the codes
// [M][code_stride], the scales [M][slice_units] and the staged activations
// of the slice. MT: n8 tiles of rows (more than one for kGivenA8 alone).
template <int Pro, typename EffT, int MT = 1>
__global__ void __launch_bounds__(kThreads)
gx_sm90_kernel(const Args p) {
  constexpr bool kA8 = Pro == kGivenA8;
  constexpr bool kCodes = Pro == kGiven || kA8;                  // the codes as given
  static_assert(MT == 1 || kA8, "more than 8 rows: the a8 kernel alone");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kStage = kStageBytes<EffT>;
  const int M = p.M, K = p.K, nsb = K / 256, units = p.slice_units;
  const int strip = blockIdx.x, S = gridDim.y;
  const int sb0 = blockIdx.y * units;
  const int per = min(nsb, sb0 + units) - sb0;
  const int col0 = strip * kStrip;
  const int astride = code_stride(units);
  int8_t* aq = reinterpret_cast<int8_t*>(smem + ring(units) * kStage);        // [M][astride]
  float* ascale = reinterpret_cast<float*>(aq + M * astride);                 // [M][units]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // The activations first, as their own cp.async group (the codes as given,
  // straight into place; or the raw rows of the slice into the staging
  // area), then the weights, so that the prologue's bytes are not queued
  // behind the slice's weight bytes. A full ring stages them in its last
  // stage and copies that stage's weights after the prologue: the groups
  // still complete in stage order.
  const int x_bytes = kCodes ? 0 : (p.x_bf16 ? 2 : 4);
  const bool late = !kCodes && late_stage(units);
  unsigned char* xs = late ? smem + (kStages - 1) * kStage
                           : reinterpret_cast<unsigned char*>(ascale) + scale_bytes(M, units);
  {
    const int row_bytes = per * 256 * (kCodes ? 1 : x_bytes);
    const int chunks = row_bytes / 16;
    for (int c = tid; c < M * chunks; c += kThreads) {
      const int m = c / chunks, i = c - m * chunks;
      const unsigned char* src = static_cast<const unsigned char*>(p.a) +
                                 (static_cast<size_t>(m) * K + sb0 * 256) *
                                     (kCodes ? 1 : x_bytes);
      unsigned char* dst = kCodes ? reinterpret_cast<unsigned char*>(aq + m * astride)
                                  : xs + m * units * 256 * x_bytes;
      cp_async16(dst + i * 16, src + i * 16, 16);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < per) issue<EffT>(p, smem + j * kStage, sb0 + j, col0);
    cp_async_commit();
  }
  if (late) {
    cp_async_wait<kStages - 1>();                       // the activations' group
  } else {
    if (kStages - 1 < per) issue<EffT>(p, smem + (kStages - 1) * kStage, sb0 + kStages - 1, col0);
    cp_async_commit();
    cp_async_wait<kStages>();                           // the activations' group
  }
  __syncthreads();

  if (kCodes) {
    // (amax / 7) / 16 of the given absmax
    for (int c = tid; c < M * per; c += kThreads) {
      const int m = c / per, j = c - m * per;
      ascale[m * units + j] = __fmul_rn(__fmul_rn(p.a_scale[m * nsb + sb0 + j], 1.0f / 7.0f),
                                        0.0625f);
    }
  } else {
    // per (row, superblock) absmax int4 quantization, one warp each
    for (int q = warp; q < M * per; q += kWarps) {
      const int m = q / per, j = q - m * per;
      float x[8];
      load8(xs, p.x_bf16, m * units * 256 + j * 256 + lane * 8, x);
      if (Pro == kRotateQuantize) fwht256(x, lane);
      quantize8(x, aq + m * astride + j * 256 + lane * 8, ascale + m * units + j, lane);
    }
  }
  if (late) {
    __syncthreads();                                    // the staged activations are read
    if (kStages - 1 < per) issue<EffT>(p, smem + (kStages - 1) * kStage, sb0 + kStages - 1, col0);
    cp_async_commit();
  }

  const int g = lane >> 2, t = lane & 3;
  const int wcol = warp * 32 + 4 * g;                    // the thread's 4 columns in the strip
  const int8_t* arow[MT];                                // its B operand rows, m = 8 mt + g
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) arow[mt] = aq + (mt * 8 + g < M ? mt * 8 + g : 0) * astride;
  float y[MT][4][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int c = 0; c < 4; ++c) y[mt][c][0] = y[mt][c][1] = 0.0f;

  for (int j = 0; j < per; ++j) {
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const unsigned char* st = smem + (j % kStages) * kStage;
    const EffT* est = reinterpret_cast<const EffT*>(st + kQsBytes) + wcol;
    float s16[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = mt * 8 + 2 * t + e;
        s16[mt][e] = m < M ? ascale[m * units + j] : 0.0f;
      }
    float sb[MT][4][2];                                  // kA8: the superblock's sbacc
    if constexpr (kA8) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c) sb[mt][c][0] = sb[mt][c][1] = 0.0f;
    }
#pragma unroll
    for (int qq = 0; qq < 4; ++qq) {
      uint32_t rw[2][4], cw[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = qq * 32 + 16 * h + 4 * t + i;
          rw[h][i] = *reinterpret_cast<const uint32_t*>(
              st + r * kStrip + ((((wcol >> 4) ^ swizzle(r))) << 4) + (wcol & 15));
        }
      transpose4(rw[0], cw[0]);
      transpose4(rw[1], cw[1]);
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {       // the low-nibble group qq, then the high qq + 4
        uint32_t b[MT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          b[mt][0] = b[mt][1] = 0u;
          if (mt * 8 + g < M) {
            const int8_t* ak = arow[mt] + j * 256 + hi * 128 + qq * 32 + 4 * t;
            b[mt][0] = *reinterpret_cast<const uint32_t*>(ak);
            b[mt][1] = *reinterpret_cast<const uint32_t*>(ak + 16);
          }
        }
        float e[4];
        eff4(est + (qq + 4 * hi) * kStrip, e);
#pragma unroll
        for (int tile = 0; tile < 2; ++tile) {
          const uint32_t a[4] = {nib16(cw[0][2 * tile], hi), nib16(cw[0][2 * tile + 1], hi),
                                 nib16(cw[1][2 * tile], hi), nib16(cw[1][2 * tile + 1], hi)};
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            int d[4] = {kBias, kBias, kBias, kBias};
            mma_s8(d, a, b[mt]);
            // d[0] / d[1]: column 2 tile, rows 2t / 2t + 1; d[2] / d[3]: column 2 tile + 1
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              if (mt * 8 + 2 * t + r >= M) continue;
#pragma unroll
              for (int c = 0; c < 2; ++c) {
                const int col = 2 * tile + c;
                const float dot16 = __fsub_rn(__int_as_float(d[2 * c + r]), kBiasF);   // exact
                if constexpr (kA8)
                  sb[mt][col][r] = __fadd_rn(sb[mt][col][r], __fmul_rn(dot16, e[col]));
                else
                  y[mt][col][r] = __fadd_rn(y[mt][col][r],
                                            __fmul_rn(__fmul_rn(dot16, s16[mt][r]), e[col]));
              }
            }
          }
        }
      }
    }
    if constexpr (kA8) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            y[mt][c][r] = __fadd_rn(y[mt][c][r], __fmul_rn(sb[mt][c][r], s16[mt][r]));
    }
    __syncthreads();
    if (j + kStages < per) issue<EffT>(p, smem + (j % kStages) * kStage, sb0 + j + kStages, col0);
    cp_async_commit();
  }

  if (S > 1) {
    // stage 0 is free
    finish_cluster<MT, kA8>(p, y, reinterpret_cast<float*>(smem), wcol, t, S, col0);
    return;
  }
  const int col = col0 + wcol;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (mt * 8 + 2 * t + r < M && col < p.N)
        *reinterpret_cast<float4*>(p.out + static_cast<size_t>(mt * 8 + 2 * t + r) * p.N + col) =
            make_float4(y[mt][0][r], y[mt][1][r], y[mt][2][r], y[mt][3][r]);
}

// grid (strips, slices), clusters of (1, slices) blocks. A quantizing
// prologue stages at most kMaxTasks (row, superblock) activations; given
// codes go straight into place, so only the shared memory bounds them.
template <int Pro, typename EffT, int MT = 1>
int launch(const Args& p, cudaStream_t stream) {
  auto kernel = gx_sm90_kernel<Pro, EffT, MT>;
  static bool configured = false;
  if (!configured) {
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem) !=
            cudaSuccess ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) !=
            cudaSuccess)
      return rrs::status();
    configured = true;
  }
  const int nsb = p.K / 256;
  const int slices = (nsb + p.slice_units - 1) / p.slice_units;
  const bool codes = Pro == kGiven || Pro == kGivenA8;
  const int x_bytes = codes ? 0 : (p.x_bf16 ? 2 : 4);
  const size_t bytes = smem_bytes<EffT>(p.M, p.slice_units, x_bytes);
  if (bytes > kMaxSmem || slices > kMaxSlices || (!codes && p.M * p.slice_units > kMaxTasks) ||
      p.M > 8 * MT)
    return rrs::kBadArgs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + kStrip - 1) / kStrip, slices);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = slices;
  cluster.val.clusterDim.z = 1;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, kernel, p);
  return rrs::status();
}

bool bad_shape(int M, int K, int N, int slice_units) {
  return K % 256 != 0 || N % 4 != 0 || M < 1 || M > 8 || slice_units < 1;
}

Args args(const void* a, const float* a_scale, const void* qs, const void* eff, void* out,
          int M, int K, int N, int slice_units, int x_bf16) {
  return Args{a, a_scale, static_cast<const uint8_t*>(qs), eff, static_cast<float*>(out), M, K, N,
              slice_units, x_bf16};
}

}  // namespace

// gx2 (B1): f32 rotated activations, bf16 eff. slice_units: superblocks a K
// slice (ops/splitk.py gx_plan), at most kMaxSlices slices.
RRS_EXPORT int rrs_tcq4_gx2(const void* a, const void* qs, const void* eff, void* out, int M,
                            int K, int N, int slice_units, void* stream) {
  if (bad_shape(M, K, N, slice_units)) return rrs::kBadArgs;
  return launch<kQuantize, __nv_bfloat16>(args(a, nullptr, qs, eff, out, M, K, N, slice_units, 0),
                                          static_cast<cudaStream_t>(stream));
}

// gx (B14): int8 codes and f32 per-block absmax as given; bf16 or f32 eff.
RRS_EXPORT int rrs_tcq4_gx(const void* a_q, const void* a_scale, const void* qs, const void* eff,
                           int eff_f32, void* out, int M, int K, int N, int slice_units,
                           void* stream) {
  if (bad_shape(M, K, N, slice_units)) return rrs::kBadArgs;
  const Args p = args(a_q, static_cast<const float*>(a_scale), qs, eff, out, M, K, N,
                      slice_units, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return eff_f32 ? launch<kGiven, float>(p, s) : launch<kGiven, __nv_bfloat16>(p, s);
}

// gx3 (B15): f32 or bf16 unrotated activations, bf16 eff.
RRS_EXPORT int rrs_tcq4_gx3(const void* x, int x_bf16, const void* qs, const void* eff, void* out,
                            int M, int K, int N, int slice_units, void* stream) {
  if (bad_shape(M, K, N, slice_units)) return rrs::kBadArgs;
  return launch<kRotateQuantize, __nv_bfloat16>(
      args(x, nullptr, qs, eff, out, M, K, N, slice_units, x_bf16 ? 1 : 0),
      static_cast<cudaStream_t>(stream));
}

// a8 (B16): int8 codes and f32 per-block absmax as given, f32 eff, M <= 32
// in n8 tiles of rows. slice_units: superblocks a K slice (ops/splitk.py
// a8_plan).
RRS_EXPORT int rrs_tcq4_a8(const void* a_q, const void* a_scale, const void* qs, const void* eff,
                           void* out, int M, int K, int N, int slice_units, void* stream) {
  if (K % 256 != 0 || N % 8 != 0 || M < 1 || M > 32 || slice_units < 1) return rrs::kBadArgs;
  const Args p = args(a_q, static_cast<const float*>(a_scale), qs, eff, out, M, K, N,
                      slice_units, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<kGivenA8, float, 1>(p, s);
  if (M <= 16) return launch<kGivenA8, float, 2>(p, s);
  return launch<kGivenA8, float, 4>(p, s);
}
