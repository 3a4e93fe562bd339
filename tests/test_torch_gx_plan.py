"""The split-K grid of the integer decode kernels B1 (``tcq4_matmul_gx2``),
B14 (``tcq4_matmul_gx``) and B15 (``tcq4_matmul_gx3``) on the CPU: the K
slices ``splitk.gx_plan`` gives ``csrc/tcq4_gx2.cu`` at every gx-viable call
of qwen3-4b, Qwen3-30B-A3B and the 2-layer test models (whole superblocks
covering K once in at most a cluster's slices, the blocks the plan
promises, no scratch, the shared memory the kernel asks for); a CPU emulation
of the kernel (each slice quantized and rotated on its own, its group terms
summed in the kernel's order, the slices in plan order) against the whole
row's codes, the unsplit plain versions and the JAX kernels in interpret
mode; the C entries' arity against their bindings; the profile labels; and
the wrappers launching nothing on the CPU. Limits: rel 1e-5 for gx2 / gx
(f32 sums in another order), atol 1e-4 for gx3 against JAX's, the limits of
tests/test_torch_tcq4_int.py."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rrs_tpu.formats.fwht import hadamard_matrix
from rrs_tpu.ops import tcq4_matmul as jtm
from rrs_tpu_torch import kernels
from rrs_tpu_torch.formats.tcq4 import quantize_activations_rrs
from rrs_tpu_torch.models.config import PRESETS, ModelConfig
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import SMALL, rel_err

TOL = 1e-5
GX3_ATOL = 1e-4
SB = tm.TILE_K

CONFIGS = {
    "qwen3-4b": PRESETS["qwen3-4b"],
    "Qwen3-30B-A3B": ModelConfig.from_gguf(chip_smoke.QWEN3_30B_A3B_GGUF),
    "dense 2-layer": ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=16,
                                 n_kv_heads=8, head_dim=128, n_ff=3072, vocab_size=4096,
                                 context_length=4096, qk_norm=True),
    "odd-kv 2-layer": ModelConfig(arch="qwen3", n_layers=2, n_embd=1024, n_heads=12,
                                  n_kv_heads=3, head_dim=128, n_ff=3072, vocab_size=4096,
                                  context_length=4096, qk_norm=True),
    "qwen3moe 2-layer": chip_smoke.qwen3moe_small_cfg(),
    "test-suite 2-layer": ModelConfig(**SMALL),
}
FULL = {"qwen3-4b", "Qwen3-30B-A3B"}


def _gx_calls(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """(label, M, K, N) of every gx-viable TCQ4 linear of a decode or served
    step of 1-8 rows: the fused qkv and o projections, and for a dense model
    the fused gate-up and down ones (``models/llama.py``; an MoE layer's
    experts run B9 / B10)."""
    e = cfg.n_embd
    shapes = {"qkv": (e, cfg.n_q_dim + 2 * cfg.n_kv_dim), "o": (cfg.n_q_dim, e)}
    if not cfg.n_experts:
        shapes.update(gate_up=(e, 2 * cfg.n_ff), down=(cfg.n_ff, e))
    return [(f"{name} M={m}", m, k, n) for m in range(1, 9) for name, (k, n) in shapes.items()
            if tm.gx_viable(m, k, n)]


def _slice_bounds(p: splitk.Plan, k: int) -> list[tuple[int, int]]:
    """[k0, k1) of each slice of plan ``p`` in the order the kernel sums
    them (slice s covers superblocks s * slice_units ...)."""
    step = p.slice_units * SB
    return [(k0, min(k, k0 + step)) for k0 in range(0, k, step)]


def _smem_bytes(m: int, slice_units: int, eff_bytes: int = 2, x_bytes: int = 4) -> int:
    """csrc/tcq4_gx2.cu smem_bytes: the ring of min(slice_units, kStages)
    superblock stages (128 qs rows and 8 eff rows of a 128-column strip),
    the slice's codes (rows padded by 16 bytes), its scales and its staged
    activations."""
    stages = min(slice_units, _const("kStages"))
    staged = 0 if stages == _const("kStages") else m * slice_units * 256 * x_bytes
    return (stages * (128 * 128 + 8 * 128 * eff_bytes) + m * (slice_units * 256 + 16)
            + -(-m * slice_units * 4 // 16) * 16 + staged)


def _src() -> str:
    return (kernels.CSRC / "tcq4_gx2.cu").read_text()


def _const(name: str) -> int:
    value = re.search(rf"constexpr int {name} = ([0-9 *]+);", _src()).group(1)
    return int(eval(value))                                    # a product of literals


def _check_plan(p: splitk.Plan, m: int, k: int, n: int, full: bool, label, picked=True):
    units = k // SB
    bounds = _slice_bounds(p, k)
    assert len(bounds) == p.slices, label
    assert bounds[0][0] == 0 and bounds[-1][1] == k, label
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:])), label
    assert all(k0 % SB == 0 and k0 < k1 for k0, k1 in bounds), label
    assert p.strips == -(-n // splitk.STRIP), label
    # a strip's slices are one cluster of at most kMaxSlices blocks, and a
    # block stages at most kMaxTasks (row, superblock) activations
    assert 1 <= p.slices <= splitk.GX_MAX_SLICES == _const("kMaxSlices"), label
    assert m * p.slice_units <= splitk.GX_MAX_TASKS == _const("kMaxTasks"), label
    assert p.slice_units == -(-units // p.slices), label          # an even split
    # three blocks fit an SM, with f32 activations; the plan's formula is the
    # kernel's
    assert _smem_bytes(m, p.slice_units) == splitk.gx_smem(m, p.slice_units), label
    if picked:
        assert splitk.gx_smem(m, p.slice_units) <= splitk.GX_BLOCK_SMEM, label
    # no other even split within those limits comes nearer two blocks an SM,
    # among those whose prologue is as short
    light = m * p.slice_units <= splitk.GX_PROLOGUE_TASKS
    for per in range(1, min(units, splitk.GX_MAX_TASKS // m) + 1 if picked else 0):
        s = -(-units // per)
        if s <= splitk.GX_MAX_SLICES and splitk.gx_smem(m, per) <= splitk.GX_BLOCK_SMEM:
            assert light or m * per > splitk.GX_PROLOGUE_TASKS, (label, s)
            if light == (m * per <= splitk.GX_PROLOGUE_TASKS):
                assert (abs(p.strips * p.slices - splitk.MIN_BLOCKS)
                        <= abs(p.strips * s - splitk.MIN_BLOCKS)), (label, s)
    # the slices add their partials in the cluster: no scratch, no counters
    assert p.scratch_elems == 0, label
    # the kernel's shared memory, with f32 eff and f32 activations, within
    # what it asks for
    assert _smem_bytes(m, p.slice_units, 4) <= _const("kMaxSmem"), label
    if full:
        # at the model widths, at least 256 blocks: two an SM, near enough
        assert p.strips * p.slices >= 240, label


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_gx_plan_covers_k_and_fills_the_card(name):
    calls = _gx_calls(CONFIGS[name])
    assert calls, name
    for label, m, k, n in calls:
        assert k % SB == 0 and n % 4 == 0, label
        _check_plan(tm.gx_plan(m, k, n), m, k, n, name in FULL, (name, label))


@pytest.mark.parametrize("m", range(1, 9))
def test_gx_plan_exists_at_every_gx_viable_k(m):
    """Every K that gx_viable admits at this M (up to K = 11,520 at M = 1,
    4,096 at M = 8) has a plan within the cluster and staging limits, at
    the widest N and the narrowest, and its shared memory fits."""
    assert tm.gx_viable(8, 4096) and not tm.gx_viable(8, 4352)
    assert tm.gx_viable(1, 11520) and not tm.gx_viable(1, 11776)
    for k in range(256, 12288, 256):
        if not tm.gx_viable(m, k):
            continue
        for n in (128, 200, 19456):
            p = tm.gx_plan(m, k, n)
            _check_plan(p, m, k, n, False, (m, k, n))


@pytest.mark.parametrize("m,k,n,slices,per", [
    (1, 2560, 6144, 5, 2),        # qwen3-4b qkv: 240 blocks
    (1, 4096, 2560, 16, 1),       # o: 320
    (1, 2560, 19456, 2, 5),       # gate_up: 304
    (1, 9728, 2560, 13, 3),       # down: 260
    (4, 2560, 19456, 5, 2),       # gate_up, a 4-lane served step: 760 (8 tasks a prologue)
    (8, 4096, 2560, 16, 1),       # o at M = 8
    (8, 2560, 19456, 10, 1),      # gate_up at M = 8: 1,520
    (1, 2048, 5120, 8, 1),        # Qwen3-30B-A3B qkv
    (1, 4096, 2048, 16, 1),       # Qwen3-30B-A3B o
], ids=["qkv", "o", "gate_up", "down", "gate_up M=4", "o M=8", "gate_up M=8", "30B qkv",
        "30B o"])
def test_gx_plan_at_the_headline_shapes(m, k, n, slices, per):
    p = tm.gx_plan(m, k, n)
    assert (p.slices, p.slice_units) == (slices, per)


# ---------------------------------------------------------------------------
# The kernel emulated on the CPU: per-slice codes, the order of sums
# ---------------------------------------------------------------------------

def _weights(rng, k, n):
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    eff = np.asarray(jnp.asarray(rng.random((k // 32, n), dtype=np.float32) * 0.01 + 1e-3,
                                 jnp.bfloat16))
    return qs, eff, (torch.from_numpy(qs),
                     torch.from_numpy(eff.view(np.uint16).copy()).view(torch.bfloat16))


def _slice_codes(x: torch.Tensor, p: splitk.Plan, rotate: bool):
    """Each slice's codes and absmax as its block computes them: only the
    slice's superblocks, rotated first for gx3; concatenated in K order."""
    parts = [quantize_activations_rrs(tm.fwht256(x[:, k0:k1]) if rotate else x[:, k0:k1])
             for k0, k1 in _slice_bounds(p, x.shape[1])]
    return torch.cat([q for q, _ in parts], 1), torch.cat([s for _, s in parts], 1)


# (M, K, N): plans of 10, 4 and 8 slices (the second with a ragged N), and
# one slice of a superblock at M = 8
SPLITS = [(1, 2560, 384), (4, 1024, 200), (2, 2048, 128), (8, 256, 256)]


@pytest.mark.parametrize("rotate", [False, True], ids=["gx2", "gx3"])
@pytest.mark.parametrize("m,k,n", SPLITS)
def test_slice_codes_are_the_whole_rows(m, k, n, rotate):
    """A superblock is one scale block and one butterfly, so a block that
    quantizes (and rotates) only its slice gets the whole row's codes and
    absmax bit for bit."""
    x = torch.from_numpy(np.random.default_rng(m * k + n).standard_normal((m, k))
                         .astype(np.float32) * 3.0)
    p = tm.gx_plan(m, k, n)
    a_q, a_s = _slice_codes(x, p, rotate)
    w_q, w_s = quantize_activations_rrs(tm.fwht256(x) if rotate else x)
    assert torch.equal(a_q, w_q) and torch.equal(a_s, w_s)


def _split_sum(p, a_q, a_s, qs, eff):
    """``tcq4_matmul_gx_plain`` over each slice of plan ``p``, summed in slice
    order: qs byte rows k0 / 2 .. and eff rows k0 / 32 .. hold exactly the
    slice's k."""
    acc = None
    for k0, k1 in _slice_bounds(p, a_q.shape[1]):
        part = tm.tcq4_matmul_gx_plain(a_q[:, k0:k1], a_s[:, k0 // SB:k1 // SB],
                                       qs[k0 // 2:k1 // 2], eff[k0 // 32:k1 // 32])
        acc = part if acc is None else acc + part
    return acc


@pytest.mark.parametrize("m,k,n", SPLITS)
def test_gx2_slices_sum_to_plain_and_jax(m, k, n):
    rng = np.random.default_rng(7 * m + k + n)
    qs, eff, (qs_t, eff_t) = _weights(rng, k, n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    a_t = torch.from_numpy(a)
    p = tm.gx_plan(m, k, n)
    a_q, a_s = _slice_codes(a_t, p, rotate=False)
    got = tm.tcq4_matmul_gx_splitk_plain(a_q, a_s, qs_t, eff_t, p)
    ref = tm.tcq4_matmul_gx2_plain(a_t, qs_t, eff_t)
    assert rel_err(got.numpy(), ref.numpy()) < TOL
    assert rel_err(_split_sum(p, a_q, a_s, qs_t, eff_t).numpy(), ref.numpy()) < TOL
    jax_ref = np.asarray(jtm.tcq4_matmul_gx2(jnp.asarray(a), jnp.asarray(qs),
                                             jnp.asarray(eff, jnp.bfloat16), interpret=True))
    assert rel_err(got.numpy(), jax_ref) < TOL
    assert rel_err(tm.tcq4_matmul_gx2(a_t, qs_t, eff_t).numpy(), jax_ref) < TOL


@pytest.mark.parametrize("eff_f32", [False, True], ids=["bf16 eff", "f32 eff"])
@pytest.mark.parametrize("m,k,n", SPLITS)
def test_gx_slices_sum_to_plain_jax_and_the_oracle(m, k, n, eff_f32):
    rng = np.random.default_rng(3 * m + k + n)
    qs, eff, (qs_t, eff_t) = _weights(rng, k, n)
    if eff_f32:
        eff_t = eff_t.float()
    a_q = rng.integers(-7, 8, (m, k)).astype(np.int8)
    a_s = (rng.random((m, k // SB)) + 0.5).astype(np.float32)
    a_q_t, a_s_t = torch.from_numpy(a_q), torch.from_numpy(a_s)
    p = tm.gx_plan(m, k, n)
    got = tm.tcq4_matmul_gx_splitk_plain(a_q_t, a_s_t, qs_t, eff_t, p)
    assert rel_err(got.numpy(), tm.tcq4_matmul_gx_plain(a_q_t, a_s_t, qs_t, eff_t).numpy()) < TOL
    oracle = tm.tcq4_matmul_ref(a_q_t, a_s_t, qs_t, eff_t).numpy()
    assert rel_err(got.numpy(), oracle) < TOL
    eff_j = jnp.asarray(eff, jnp.float32 if eff_f32 else jnp.bfloat16)
    jax_ref = np.asarray(jtm.tcq4_matmul_gx(jnp.asarray(a_q), jnp.asarray(a_s), jnp.asarray(qs),
                                            eff_j, interpret=True))
    assert rel_err(got.numpy(), jax_ref) < TOL


@pytest.mark.parametrize("m,k,n", SPLITS)
def test_gx3_slices_sum_to_plain_and_jax(m, k, n):
    """The rotation per slice, then the same sums: B14 on those codes is the
    same function, so the card holds B15 to B14 bit for bit."""
    rng = np.random.default_rng(11 * m + k + n)
    qs, eff, (qs_t, eff_t) = _weights(rng, k, n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    p = tm.gx_plan(m, k, n)
    a_q, a_s = _slice_codes(xb.float(), p, rotate=True)
    got = tm.tcq4_matmul_gx_splitk_plain(a_q, a_s, qs_t, eff_t, p)
    assert rel_err(got.numpy(), tm.tcq4_matmul_gx3_plain(xb, qs_t, eff_t).numpy()) < TOL
    had = jnp.asarray(hadamard_matrix(256), jnp.float32)
    jax_ref = np.asarray(jtm.tcq4_matmul_gx3(jnp.asarray(xb.float().numpy()), had,
                                             jnp.asarray(qs), jnp.asarray(eff, jnp.bfloat16),
                                             interpret=True))
    np.testing.assert_allclose(got.numpy(), jax_ref, atol=GX3_ATOL)


@pytest.mark.parametrize("slices", [1, 3, 10])
def test_emulation_orders_only_the_sums(slices):
    """Any slice count gives the plain product within the limit; one slice
    and one superblock a slice differ only in the f32 sums' order."""
    rng = np.random.default_rng(slices)
    _, _, (qs_t, eff_t) = _weights(rng, 2560, 128)
    a_q = torch.from_numpy(rng.integers(-7, 8, (3, 2560)).astype(np.int8))
    a_s = torch.from_numpy((rng.random((3, 10)) + 0.5).astype(np.float32))
    per = -(-10 // slices)
    p = splitk.Plan(1, -(-10 // per), per, 0)
    got = tm.tcq4_matmul_gx_splitk_plain(a_q, a_s, qs_t, eff_t, p)
    assert rel_err(got.numpy(), tm.tcq4_matmul_gx_plain(a_q, a_s, qs_t, eff_t).numpy()) < TOL


# ---------------------------------------------------------------------------
# The sources, the bindings and the labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["rrs_tcq4_gx2", "rrs_tcq4_gx", "rrs_tcq4_gx3"])
def test_gx_entry_arity_matches_the_binding(entry):
    params = re.search(rf"int {entry}\(([^)]*)\)", _src()).group(1)
    assert len(params.split(",")) == len(kernels.SIGNATURES[entry])
    assert "int slice_units" in params and "scratch" not in params


def test_source_is_the_split_k_body():
    """One kernel template for the three entries, on the strip the plan
    assumes, the int8 tensor cores and a cp.async ring; the old one-tile
    body is gone."""
    src = _src()
    assert _const("kStrip") == splitk.STRIP
    assert _const("kStages") == splitk.GX_STAGES >= 3
    # the staged activations (kMaxTasks rows of a superblock, f32) fit the
    # ring stage that holds them under a full ring
    assert splitk.GX_MAX_TASKS * 256 * 4 <= 128 * 128 + 8 * 128 * 2
    # three blocks of GX_BLOCK_SMEM (and the 1 KB the SM keeps for each) fill
    # the H100 SM's 228 KB of shared memory
    assert 3 * (splitk.GX_BLOCK_SMEM + 1024) == 228 * 1024
    assert "gx2_kernel" not in src and "template <int M, int Pro>" not in src
    assert src.count("__global__") == 1 and "gx_sm90_kernel" in src
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32" in src
    assert "cp_async_commit()" in src and "copy_chunk(" in src
    assert "cudaLaunchAttributeClusterDimension" in src and "map_shared_rank" in src
    # the activations are copied before the weights, as a cp.async group of their own
    assert src.index("cp_async16(dst + i * 16") < src.index("issue<EffT>(p, smem + j * kStage")
    assert "atomicAdd" not in src and "__threadfence" not in src
    for pro in ("kGiven", "kQuantize", "kRotateQuantize"):
        assert f"launch<{pro}," in src, pro


def test_profile_labels_name_the_gx_kernels():
    """Decode profiles charge each instantiation of the one template to its
    entry: the prologue id picks B14, B1 or B15."""
    label, anon = chip_smoke.kernel_label, "(anonymous namespace)"
    assert label(f"void {anon}::gx_sm90_kernel<1, __nv_bfloat16>({anon}::Args)") \
        == "tcq4_matmul_gx2"
    assert label(f"void {anon}::gx_sm90_kernel<2, __nv_bfloat16>({anon}::Args)") \
        == "tcq4_matmul_gx3"
    assert label(f"void {anon}::gx_sm90_kernel<0, float>({anon}::Args)") == "tcq4_matmul_gx"
    assert label(f"void {anon}::gx_sm90_kernel<0, __nv_bfloat16>({anon}::Args)") \
        == "tcq4_matmul_gx"
    assert not any("gx2_kernel" in key for key in chip_smoke.KERNEL_NAMES)


def test_gx_wrappers_launch_nothing_on_the_cpu():
    rng = np.random.default_rng(5)
    _, _, (qs_t, eff_t) = _weights(rng, 512, 64)
    a = torch.from_numpy(rng.standard_normal((2, 512)).astype(np.float32))
    a_q, a_s = quantize_activations_rrs(a)
    kernels.reset_launches()
    tm.tcq4_matmul_gx2(a, qs_t, eff_t)
    tm.tcq4_matmul_gx(a_q, a_s, qs_t, eff_t)
    tm.tcq4_matmul_gx(a_q, a_s, qs_t, eff_t.float())
    tm.tcq4_matmul_gx3(a.to(torch.bfloat16), qs_t, eff_t)
    assert not any(kernels.LAUNCHES.values())


def test_gemm_ab_forces_even_slices_and_restores_the_plan():
    """``tools/gemm_ab.py``'s b1,b15 sweep times the wrappers under other
    slice counts by replacing ``tcq4_matmul.gx_plan`` while its context is
    open."""
    from rrs_tpu_torch.tools.gemm_ab import gx_shapes, gx_slices_forced

    picked = tm.gx_plan
    with gx_slices_forced(3):
        p = tm.gx_plan(4, 2560, 6144)
        assert (p.slices, p.slice_units) == (3, 4)
        p = splitk.Plan(p.strips, p.slices, p.slice_units, 0)
        _check_plan(p, 4, 2560, 6144, False, "forced", picked=False)
    assert tm.gx_plan is picked
    shapes = gx_shapes()
    assert ("down", 1, 9728, 2560) in shapes and ("30b o", 1, 4096, 2048) in shapes
    assert all(tm.gx_viable(m, k, n) for _, m, k, n in shapes)
