"""The split-K plan of the weight matmuls B2 (``q8_matmul``), B4
(``tcq4_matmul``, and B17 ``tcq4_matmul_fused`` through B4), B11
(``mxfp4_matmul``) and B5 (``tcq4_matmul_i8p``), and their scratch.

The kernels (``csrc/gemm_sm90.cuh``, and B5's ``csrc/tcq4_i8p.cu``) cover
C[M, N] with a grid of output tiles (column strips of STRIP; at M > MAX_M
also row tiles of 64 rows below M = 128, else 128; B5's are always 128) times
K slices. A slice is ``slice_units`` whole units of K (a Q8 or MXFP4 scale
group of 32, a TCQ4 superblock of 256; at M > MAX_M a slice of 32-wide groups
is a whole number of the prefill body's 64-deep steps). The plan gives the
grid at least MIN_BLOCKS blocks at M <= MAX_M (two waves on the H100's 132
SMs) and PREFILL_MIN_BLOCKS above it (one block on every SM; more slices
there cost more in partial sums than they gain), wherever K allows it. With more than one slice, each block writes its partial sums to
``scratch`` [slices, M, strips * STRIP] f32, and the tile's last block to
finish adds the partials in slice order, so the result does not depend on
which block ends first. ``counters`` holds one int32 per tile: zero before a
launch and left zero by it, so one buffer per device serves every call on
its stream.

The decode expert matmuls B9 (``tcq4_matmul_experts_rows``) and B12
(``mxfp4_matmul_experts_rows``) run the decode body with the selected rows
on the grid (``rows_plan``): strips times K slices times rows, each row at
M = 1 with its own scratch and counters. The expert matmuls B10
(``tcq4_matmul_all_experts``), B13 (``mxfp4_matmul_all_experts``) and B19
(``tcq4_matmul_experts``) run the prefill body on an expert grid instead
(``experts_grid``): output tiles times experts, one K slice.

The integer decode matmuls B1 (``tcq4_matmul_gx2``), B14 (``tcq4_matmul_gx``)
and B15 (``tcq4_matmul_gx3``, ``csrc/tcq4_gx2.cu``) take ``gx_plan``: column
strips of STRIP times K slices of whole superblocks, so that each block
quantizes (and for B15 rotates) only its own slice's superblocks; a strip's
slices form one thread-block cluster and add their partials through
distributed shared memory, so these launches take no scratch or counters.
B16 (``tcq4_matmul_a8``) runs the same body on given codes at M <= 32 with
f32 eff, under ``a8_plan``.

B18 (``tcq4_matmul_pb``) takes ``plan`` with a TCQ4 superblock's unit, as B4
does: its loader walks K in units of 8 groups (256 k).
"""

from __future__ import annotations

import dataclasses

import torch

STRIP = 128
MIN_BLOCKS = 264            # decode: two waves of one-strip blocks
SMS = 132                   # the H100 SXM's streaming multiprocessors
PREFILL_MIN_BLOCKS = SMS    # prefill: one block on every SM
ROWS_SLOTS = 3 * SMS        # the rows kernel's resident blocks (its launch bounds: 3 an SM)
MAX_M = 16
PREFILL_BK = 64


@dataclasses.dataclass(frozen=True)
class Plan:
    strips: int
    slices: int
    slice_units: int            # units of K per slice (the last may be shorter)
    scratch_elems: int          # f32 elements of the partial sums (0: one slice)


def plan(m: int, k: int, n: int, unit: int, row_tile: int = 0, split_steps: int = 0) -> Plan:
    """The grid of the weight matmul at (M, K, N) with K in units of ``unit``.

    By default (B2, B4): at least MIN_BLOCKS / PREFILL_MIN_BLOCKS blocks.
    With ``split_steps`` (B11, B5; M > MAX_M): the slice count that takes the
    fewest steps on the busiest SM, ceil(blocks / SMS) blocks of ceil(steps /
    slices) steps each, where a block of a split grid takes ``split_steps``
    steps more (its partial sums written, and read and added by the tile's
    last block); ``row_tile`` is the kernel's (0: 64 below M = 128, else
    128)."""
    strips = -(-n // STRIP)
    if m <= MAX_M:
        return _decode_plan(strips, strips, m, k // unit)
    tiles = strips * -(-m // (row_tile or (64 if m < 128 else 128)))
    step = max(unit, PREFILL_BK)
    units = k // step
    if split_steps:
        def cost(s: int) -> tuple[int, int]:
            per = -(-units // s)
            n_slices = -(-units // per)
            waves = -(-tiles * n_slices // SMS)
            return waves * (per + (split_steps if n_slices > 1 else 0)), n_slices
        per = -(-units // min(range(1, units + 1), key=cost))
    else:
        need = -(-PREFILL_MIN_BLOCKS // tiles)
        per = units if need <= 1 else max(1, units // need)
    slices = -(-units // per)
    per_units = per * (step // unit)
    return Plan(strips, slices, per_units, slices * m * strips * STRIP if slices > 1 else 0)


def _decode_plan(strips: int, tiles: int, rows: int, units: int) -> Plan:
    """The decode rule: ``units`` slice units of K split evenly enough that
    ``tiles`` output tiles times the slices reach MIN_BLOCKS, wherever K
    allows it; scratch for ``rows`` rows of the strips."""
    need = -(-MIN_BLOCKS // tiles)
    per = units if need <= 1 else max(1, units // need)
    slices = -(-units // per)
    return Plan(strips, slices, per, slices * rows * strips * STRIP if slices > 1 else 0)


def rows_plan(n_sel: int, k: int, n: int, unit: int) -> Plan:
    """The grid of the selected-rows matmuls B9 and B12 (csrc/gemm_sm90.cuh
    ``rows_kernel``) for ``n_sel`` rows of [1, K] @ [K, N], K in units of
    ``unit`` (a TCQ4 superblock, an MXFP4 scale group), over the rows'
    tiles, strips x n_sel: the most even slices whose blocks still fit one
    wave of resident blocks (ROWS_SLOTS) and number at least MIN_BLOCKS;
    where no slice count gives that, ``plan``'s decode rule (at least
    MIN_BLOCKS blocks wherever K allows it). The scratch is [n_sel, slices,
    strips * STRIP] (each row's own slices) and the counters one a (row,
    strip) tile."""
    strips = -(-n // STRIP)
    tiles, units = strips * n_sel, k // unit
    for want in range(min(units, ROWS_SLOTS // tiles), 0, -1):
        per = -(-units // want)
        slices = -(-units // per)
        if tiles * slices >= MIN_BLOCKS:
            return Plan(strips, slices, per,
                        slices * n_sel * strips * STRIP if slices > 1 else 0)
    return _decode_plan(strips, tiles, n_sel, units)


GX_MAX_SLICES = 16          # csrc/tcq4_gx2.cu kMaxSlices: a strip's slices are one cluster
GX_MAX_TASKS = 16           # kMaxTasks: M x slice_units, the activation rows a block stages
GX_PROLOGUE_TASKS = 8       # two (row, superblock) quantizations for each of a block's 4 warps
GX_STAGES = 4               # kStages: the weight ring's superblocks
GX_BLOCK_SMEM = 76800       # a third of the SM's 228 KB, less 1 KB each: three blocks an SM


def gx_smem(m: int, slice_units: int, eff_bytes: int = 2, x_bytes: int = 4) -> int:
    """csrc/tcq4_gx2.cu smem_bytes: the ring of min(slice_units, GX_STAGES)
    superblocks (128 qs rows and 8 eff rows of a strip), the codes (rows of
    slice_units * 256 + 16 bytes), the scales (16-byte padded) and, unless a
    full ring stages them in its last stage, the staged activations."""
    ring = min(slice_units, GX_STAGES)
    return (ring * (128 * STRIP + 8 * STRIP * eff_bytes)
            + m * (slice_units * 256 + 16) + -(-m * slice_units * 4 // 16) * 16
            + (0 if ring == GX_STAGES else m * slice_units * 256 * x_bytes))


GX_MAX_SMEM = 200 * 1024    # kMaxSmem
A8_MAX_M = 32
SM_SMEM = 233472            # an H100 SM's 228 KB of shared memory (1 KB of it kept a block)
GPCS, GPC_SMS = 8, 16       # the H100 SXM's 132 SMs in 8 GPCs, counted at 16 SMs each
A8_BLOCKS_BY_REGS = {1: 8, 2: 5, 4: 3}   # B16's blocks an SM by registers (ptxas: 59, 88, 141)
A8_SPLIT_COST = 3           # a B16 block's fixed cost, in superblocks streamed


def a8_cost(m: int, k: int, n: int, slices: int):
    """B16's cost under an even split of K into ``slices`` slices, in
    superblocks streamed by the busiest SM: waves x (slice_units +
    A8_SPLIT_COST), where a strip's slices are one cluster, whose blocks
    share a GPC, so a wave is GPCS x (GPC_SMS x blocks an SM // slices)
    strips. None where a block's shared memory (f32 eff, given codes)
    passes GX_MAX_SMEM or no cluster fits a GPC."""
    strips, units = -(-n // STRIP), k // 256
    per = -(-units // slices)
    smem = gx_smem(m, per, 4, 0)
    if slices > GX_MAX_SLICES or smem > GX_MAX_SMEM:
        return None
    tiles = 1 if m <= 8 else 2 if m <= 16 else 4
    per_sm = min(A8_BLOCKS_BY_REGS[tiles], SM_SMEM // (smem + 1024))
    clusters = GPCS * (GPC_SMS * per_sm // slices)
    return -(-strips // clusters) * (per + A8_SPLIT_COST) if clusters else None


def a8_plan(m: int, k: int, n: int) -> Plan:
    """The grid of B16 (csrc/tcq4_gx2.cu, the a8 epilogue) at (M, K, N), M
    <= A8_MAX_M: B1's column strips and whole-superblock K slices. Its
    prologue copies int8 codes, 256 bytes a (row, superblock), straight into
    place, so only the shared memory bounds a slice; of the even splits, the
    one of least ``a8_cost`` (the fewer slices on a tie). The cost's terms
    come from the K-slice sweep of ``tools/gemm_ab.py --subjects b18,b16``:
    a split whose clusters overflow the GPCs takes a second wave."""
    if not 1 <= m <= A8_MAX_M:
        raise ValueError(f"a8_plan: M={m} is outside 1..{A8_MAX_M}")
    strips, units = -(-n // STRIP), k // 256
    costs = {s: a8_cost(m, k, n, s) for s in {-(-units // per) for per in range(1, units + 1)}}
    costs = {s: c for s, c in costs.items() if c is not None}
    if not costs:
        raise ValueError(f"a8_plan: no K split of K={k} at M={m} fits the kernel")
    slices = min(costs, key=lambda s: (costs[s], s))
    return Plan(strips, slices, -(-units // slices), 0)


def gx_plan(m: int, k: int, n: int) -> Plan:
    """The grid of the integer decode kernel (csrc/tcq4_gx2.cu) at (M, K, N),
    M <= 8 and K in superblocks of 256: of the even splits into at most
    GX_MAX_SLICES slices (a strip's slices are one thread-block cluster and
    add their partials through distributed shared memory: no scratch, no
    counters) whose blocks stage at most GX_MAX_TASKS activation rows of a
    superblock and fit three to an SM (GX_BLOCK_SMEM, with f32 activations),
    preferably those whose prologue is at most GX_PROLOGUE_TASKS
    quantizations, the slice count whose blocks come nearest MIN_BLOCKS, two
    on each SM (the fewer slices on a tie). The K-slice sweep of
    ``tools/gemm_ab.py --subjects b1,b15`` chose these rules."""
    strips, units = -(-n // STRIP), k // 256
    counts = {-(-units // per) for per in range(1, units + 1)
              if -(-units // per) <= GX_MAX_SLICES and m * per <= GX_MAX_TASKS
              and gx_smem(m, per) <= GX_BLOCK_SMEM}
    if not counts:
        raise ValueError(f"gx_plan: no K split of K={k} at M={m} fits the kernel")
    slices = min(counts, key=lambda s: (m * -(-units // s) > GX_PROLOGUE_TASKS,
                                        abs(strips * s - MIN_BLOCKS), s))
    return Plan(strips, slices, -(-units // slices), 0)


@dataclasses.dataclass(frozen=True)
class ExpertsGrid:
    strips: int
    row_tiles: int
    experts: int                # grid z: every expert (B10, B13) or each selected one (B19)
    row_tile: int               # the kernel's BM

    @property
    def blocks(self) -> int:
        return self.strips * self.row_tiles * self.experts


def experts_grid(z: int, m: int, n: int) -> ExpertsGrid:
    """The grid of the expert kernel (csrc/gemm_sm90.cuh ``experts_kernel``)
    for ``z`` outputs of [M, N]: strips of STRIP columns, row tiles of 64
    rows below M = 128, else 128 (rows past M are zero), and one K slice,
    since at every model shape the grid already holds several blocks for
    each of the card's 2 x SMS block slots. B19 takes the grid B10 takes at
    the same M, so its outputs are B10's bit for bit."""
    row_tile = 64 if m < 128 else 128
    return ExpertsGrid(-(-n // STRIP), -(-m // row_tile), z, row_tile)


_COUNTERS: dict[torch.device, torch.Tensor] = {}


def counters(device: torch.device, n: int) -> torch.Tensor:
    """The device's int32 arrival counters, at least ``n``: grown here,
    zeroed once, and left zero by every kernel that counts on them (the
    split-K matmuls here, the split-S attention of ``ops/attn_split.py``),
    so launches in stream order share them."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 4096),), dtype=torch.int32, device=device)
        _COUNTERS[device] = buf
    return buf


def buffers(p: Plan, device: torch.device):
    """(scratch, counters) for a launch under plan ``p``: the partial sums,
    fresh from the caching allocator, and the device's tile counters. Both
    None with one slice."""
    if p.slices == 1:
        return None, None
    scratch = torch.empty((p.scratch_elems,), dtype=torch.float32, device=device)
    tiles = p.scratch_elems // (p.slices * STRIP)          # strips x rows, an upper bound
    return scratch, counters(device, tiles)


def ptr(t) -> int:
    """A buffer's address for the C entry points (0 for None)."""
    return 0 if t is None else t.data_ptr()
