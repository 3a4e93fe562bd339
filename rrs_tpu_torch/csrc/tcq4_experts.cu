// W4A4 mixture-of-experts matmuls over stacked TCQ4 expert weights, f32 out:
//
//   B9  rrs_tcq4_experts_rows  out[i] = bf16(a[i]) @ W[ids[i]]         (decode)
//   B10 rrs_tcq4_all_experts   out[e] = bf16(a or a[e]) @ W[e]         (capacity)
//   B19 rrs_tcq4_experts_sel   out[i] = bf16(a) @ W[ids[i]]            (selected)
//
// Replace rrs_tpu/ops/tcq4_matmul.py:654 tcq4_matmul_experts_rows
// (_kernel_experts_rows at :638), :595 tcq4_matmul_all_experts
// (_kernel_all_experts at :577) and :536 tcq4_matmul_experts
// (_kernel_experts at :519). All compute as the TPU kernels do: the int4
// weight times its f32 group scale, rounded to bf16, against the activations
// rounded to bf16, with f32 sums; only the order of the sums differs from
// the plain versions.
//
// Layout (ops/tcq4_matmul.py): qs uint8 [E][K/2][N], byte row r of
// superblock s holding k = 256 s + r in its low nibble and k = 256 s + 128 + r
// in its high nibble; eff bf16 [E][K/32][N] (B19 also takes f32 eff, as its
// TPU kernel does). K is a multiple of 256, N of 8. Every weight byte is
// decoded on chip; no dequantized expert reaches memory.
//
// Bound on the H100: bytes for B9 and B19 at decode M (the selected experts'
// 4.625-bit weights, 0.88 MB per expert matrix at Qwen3-30B-A3B) and for B10
// at the capacities the model gives it (C = 24 .. 64: every expert's
// weights, 113 MB per projection at E = 128; with the per-expert
// activations and f32 outputs 0.051 ms at 3.35 TB/s against 0.026 ms of
// bf16 tensor-core work at C = 64); operations for B10 from about C = 250
// (gate / up) and C = 1,000 (down) rows on.
//
// Design. B10 and B19 run the pipelined prefill body of gemm_sm90.cuh on its
// expert grid (sm90::experts_kernel, through rrs::tcq4_experts and B4's TCQ4
// loader in tcq4_matmul.cu): block (strip, row tile, z) streams expert
// e(z)'s quarter superblocks through a 3-stage cp.async ring, dequantizing
// the next stage while it multiplies this one (ldmatrix into mma.sync
// m16n8k16), 64 x 128 tiles below 128 rows (the wrapper picks
// the row tile, ops/splitk.py experts_grid), two blocks an SM. At the model's
// capacities the grid has at least 768 blocks for the 264 block slots, so
// no K split is needed, and each weight byte is read once per row tile. The
// activations are bf16 (the wrappers round f32 ones first, as the kernel
// would). B10 takes e(z) = z, with a zero activation stride for shared
// activations; B19 is the same kernel over shared activations with z running
// over the selected experts, e(z) = ids[z] read on the device and clamped to
// [0, E), as B9 does, so with bf16 eff its out[i] is B10's out[ids[i]] bit
// for bit (same body, tile and K order at every M); with f32 eff it takes
// B17's f32-eff loader. B9 runs B4's decode body, the split-K weight stream
// of gemm_sm90.cuh, with the selected rows on the grid (sm90::rows_kernel,
// through rrs::tcq4_rows and the same TCQ4 loader): block (strip, K slice,
// row) reads its row's expert id on the device, streams that expert's
// superblocks of its slice with 16-byte loads (the next unit's in flight),
// decodes them in registers into the A operand of mma.sync m16n8k16 against
// its row of bf16 activations (the wrapper rounds f32 ones first, as the
// kernel would), and each (row, strip) tile's last block sums the slices in
// slice order (ops/splitk.py rows_plan picks them: the most that fit one
// wave of resident blocks, at least 264 blocks where K allows).

#include "gemm_sm90.cuh"

namespace {

bool bad_shape(int M, int K, int N) { return M < 1 || K < 256 || K % 256 || N < 8 || N % 8; }

}  // namespace

// a bf16 [n_sel, K] (the wrapper rounds f32 rows first); slice_units:
// superblocks per K slice (ops/splitk.py rows_plan); scratch [n_sel,
// slices, strips * 128] f32 and counters [n_sel, strips] with more than one
// slice, else unused.
RRS_EXPORT int rrs_tcq4_experts_rows(const void* a, const void* qs, const void* eff,
                                     const void* ids, void* out, int n_sel, int K, int N,
                                     int n_exp, int slice_units, void* scratch, void* counters,
                                     void* stream) {
  if (bad_shape(n_sel, K, N)) return rrs::kBadArgs;
  return rrs::tcq4_rows(static_cast<const __nv_bfloat16*>(a), static_cast<const uint8_t*>(qs),
                        static_cast<const __nv_bfloat16*>(eff), static_cast<const int*>(ids),
                        n_exp, static_cast<float*>(out), n_sel, K, N, slice_units,
                        static_cast<float*>(scratch), static_cast<int*>(counters),
                        static_cast<cudaStream_t>(stream));
}

// a bf16 (the wrapper rounds f32 activations first); row_tile 64 or 128
// (ops/splitk.py experts_grid).
RRS_EXPORT int rrs_tcq4_all_experts(const void* a, int per_expert, const void* qs, const void* eff,
                                    void* out, int E, int T, int K, int N, int row_tile,
                                    void* stream) {
  if (bad_shape(T, K, N) || E < 1) return rrs::kBadArgs;
  const size_t a_stride = per_expert ? static_cast<size_t>(T) * K : 0;
  return rrs::tcq4_experts(static_cast<const __nv_bfloat16*>(a), a_stride,
                           static_cast<const uint8_t*>(qs), eff, false, nullptr, E,
                           static_cast<float*>(out), E, T, K, N, row_tile,
                           static_cast<cudaStream_t>(stream));
}

RRS_EXPORT int rrs_tcq4_experts_sel(const void* a, const void* qs, const void* eff,
                                    int eff_is_f32, const void* ids, void* out, int n_sel, int M,
                                    int K, int N, int n_exp, int row_tile, void* stream) {
  if (bad_shape(M, K, N) || n_exp < 1 || n_sel < 1) return rrs::kBadArgs;
  return rrs::tcq4_experts(static_cast<const __nv_bfloat16*>(a), 0,
                           static_cast<const uint8_t*>(qs), eff, eff_is_f32 != 0,
                           static_cast<const int*>(ids), n_exp, static_cast<float*>(out), n_sel,
                           M, K, N, row_tile, static_cast<cudaStream_t>(stream));
}
