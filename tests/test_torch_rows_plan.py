"""The selected-rows grid of B9 (``tcq4_matmul_experts_rows``) and B12
(``mxfp4_matmul_experts_rows``) on the CPU: the K slices ``splitk.rows_plan``
gives ``csrc/gemm_sm90.cuh``'s ``rows_kernel`` at every decode call of the
MoE models (whole units covering K once; enough blocks for the card at the
published widths), with the scratch and counters the wrappers allocate; the
plain versions summed slice by slice in the plan's order (the reordering of
the f32 sums the kernel makes) against the unsplit plain versions and the
JAX kernels run in interpret mode; the C entries' arity against their
bindings; the sources without the kernels the grid replaced; the profile
labels; and the wrappers launching nothing on the CPU."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rrs_tpu.formats.kquants import quantize_mxfp4
from rrs_tpu.ops import mxfp4_matmul as jmx
from rrs_tpu.ops import tcq4_matmul as jtm
from rrs_tpu_torch import kernels
from rrs_tpu_torch.models.config import PRESETS, ModelConfig
from rrs_tpu_torch.ops import mxfp4_matmul as mx
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import rel_err

TOL = 1e-5                   # bf16 operands on both sides, f32 sums in another order

QWEN3_30B = ModelConfig.from_gguf(chip_smoke.QWEN3_30B_A3B_GGUF)
CONFIGS = {"Qwen3-30B-A3B": QWEN3_30B, "gpt-oss-20b": PRESETS["gpt-oss-20b"],
           "qwen3moe 2-layer": chip_smoke.qwen3moe_small_cfg(),
           "gpt-oss 2-layer": chip_smoke.gptoss_small_cfg(), "tiny-oss": PRESETS["tiny-oss"]}
FULL = {"Qwen3-30B-A3B", "gpt-oss-20b"}


def _decode_calls(cfg: ModelConfig) -> list[tuple[str, int, int, int, int]]:
    """(label, n_sel, K, N, unit) of every B9 / B12 launch of a decode or
    short-prefill step (n_tok <= 16 tokens, ``models/moe.py`` ``_packed_ffn``):
    gate and up K n_embd -> N n_ff_exp, down K n_ff_exp -> N n_embd (MXFP4
    stacks pad N to 128), over n_tok * top_k rows."""
    mxfp4 = cfg.arch == "gpt-oss"
    pad = (lambda n: -(-n // 128) * 128) if mxfp4 else (lambda n: n)     # noqa: E731
    unit = mx.GROUP if mxfp4 else tm.TILE_K
    calls = []
    for n_tok in range(1, 17):
        n_sel = n_tok * cfg.n_experts_used
        calls += [(f"{n_tok} tokens gate/up", n_sel, cfg.n_embd, pad(cfg.n_ff_exp), unit),
                  (f"{n_tok} tokens down", n_sel, cfg.n_ff_exp, pad(cfg.n_embd), unit)]
    return calls


def _slice_bounds(p: splitk.Plan, k: int, unit: int) -> list[tuple[int, int]]:
    """[k0, k1) of each slice of plan ``p``, in the order the kernel sums
    them (slice s covers units s * slice_units ...)."""
    step = p.slice_units * unit
    return [(k0, min(k, k0 + step)) for k0 in range(0, k, step)]


def _check_plan(p: splitk.Plan, n_sel: int, k: int, n: int, unit: int, full: bool, label):
    units = k // unit
    bounds = _slice_bounds(p, k, unit)
    assert len(bounds) == p.slices, label
    assert bounds[0][0] == 0 and bounds[-1][1] == k, label
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:])), label
    assert all(k0 % unit == 0 and k0 < k1 for k0, k1 in bounds), label
    assert p.strips == -(-n // splitk.STRIP), label
    if full:
        # two waves of one-strip blocks on the 132 SMs, or one slice a unit
        assert p.strips * n_sel * p.slices >= splitk.MIN_BLOCKS or p.slices == units, label
    # the scratch is the kernel's [n_sel, slices, strips * 128]; a counter a
    # (row, strip) tile, zero before the launch
    want = p.slices * n_sel * p.strips * splitk.STRIP if p.slices > 1 else 0
    assert p.scratch_elems == want, label
    scratch, counters = splitk.buffers(p, torch.device("cpu"))
    if p.slices == 1:
        assert scratch is None and counters is None, label
    else:
        assert scratch.numel() == want and scratch.dtype == torch.float32, label
        assert counters.numel() >= n_sel * p.strips and not counters.any(), label


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rows_plan_covers_k_and_fills_the_card(name):
    """Every decode call of the model: whole units, in order, covering K
    once; at the published widths at least MIN_BLOCKS blocks or one slice a
    unit."""
    for label, n_sel, k, n, unit in _decode_calls(CONFIGS[name]):
        assert k % unit == 0, label
        _check_plan(splitk.rows_plan(n_sel, k, n, unit), n_sel, k, n, unit, name in FULL, label)


@pytest.mark.parametrize("proj,k,n", [("gate/up", 2048, 768), ("down", 768, 2048)])
def test_rows_plan_every_qwen3moe_row_count(proj, k, n):
    """Qwen3-30B-A3B's two shapes at every n_sel from 1 to 128 (16 tokens x
    top-8), not only the multiples of 8 a step gives."""
    for n_sel in range(1, 129):
        _check_plan(tm.rows_plan(n_sel, k, n), n_sel, k, n, tm.TILE_K, True, (proj, n_sel))


def test_rows_plan_every_gptoss_row_count():
    for n_sel in range(4, 65, 4):
        _check_plan(mx.rows_plan(n_sel, 2880, 2944), n_sel, 2880, 2944, mx.GROUP, True, n_sel)


@pytest.mark.parametrize("plan,n_sel,k,n,slices,per,blocks", [
    (tm.rows_plan, 8, 2048, 768, 8, 1, 384),      # B9 gate/up, one decode token
    (tm.rows_plan, 8, 768, 2048, 3, 1, 384),      # B9 down
    (tm.rows_plan, 32, 2048, 768, 2, 4, 384),     # B9 gate/up, four served tokens
    (tm.rows_plan, 32, 768, 2048, 1, 3, 512),     # B9 down: one slice
    (mx.rows_plan, 4, 2880, 2944, 4, 23, 368),    # B12, one decode token
    (mx.rows_plan, 16, 2880, 2944, 1, 90, 368),   # B12, four served tokens: one slice
], ids=["B9 gate/up n_sel 8", "B9 down n_sel 8", "B9 gate/up n_sel 32", "B9 down n_sel 32",
        "B12 n_sel 4", "B12 n_sel 16"])
def test_rows_plan_at_the_headline_shapes(plan, n_sel, k, n, slices, per, blocks):
    p = plan(n_sel, k, n)
    assert (p.slices, p.slice_units) == (slices, per)
    assert p.strips * n_sel * p.slices == blocks


def test_rows_plan_fills_one_wave_else_takes_plans_rule():
    """Where a slice count puts between MIN_BLOCKS and ROWS_SLOTS blocks on
    the card, the plan takes the largest such count, split evenly;
    elsewhere it is ``plan``'s decode rule over the rows' tiles (the rule B2
    / B4 / B11 keep). ROWS_SLOTS is the kernel's launch bounds: three 4-warp
    blocks an SM at MT = 1, the only MT it is launched at."""
    body = (kernels.CSRC / "gemm_sm90.cuh").read_text()
    assert "constexpr int kDecodeWarps = 4;" in body and splitk.ROWS_SLOTS == 3 * splitk.SMS
    assert re.search(r"__launch_bounds__\(kDecodeWarps \* 32, MT == 1 \? 3 : 2\)\s*rows_kernel",
                     body)
    assert "rows_kernel<L, 1><<<" in body and "rows_kernel<L, 2>" not in body
    # (n_sel, K, N, unit) -> (slices, slice units, blocks) within one wave
    for args, want in (((1, 2880, 2944, mx.GROUP), (15, 6, 345)),
                       ((4, 2880, 2944, mx.GROUP), (4, 23, 368)),
                       ((16, 2880, 2944, mx.GROUP), (1, 90, 368)),
                       ((8, 2048, 768, tm.TILE_K), (8, 1, 384)),
                       ((24, 2048, 768, tm.TILE_K), (2, 4, 288))):
        p = splitk.rows_plan(*args)
        assert (p.slices, p.slice_units, p.strips * args[0] * p.slices) == want, args
        assert splitk.MIN_BLOCKS <= want[2] <= splitk.ROWS_SLOTS
    # no count between the two: one row is plan's grid at M = 1 (48 blocks,
    # a slice a superblock); 32 rows of down take one slice (512 blocks), 40
    # rows of gate / up two (480: one slice would leave 240)
    assert splitk.rows_plan(1, 2048, 768, tm.TILE_K) == splitk.plan(1, 2048, 768, tm.TILE_K)
    assert tm.rows_plan(32, 768, 2048).slices == 1
    assert (tm.rows_plan(40, 2048, 768).slices, tm.rows_plan(40, 2048, 768).slice_units) == (2, 4)


# ---------------------------------------------------------------------------
# The slices summed in the plan's order, against the plain versions and JAX
# ---------------------------------------------------------------------------

def _tcq4_stacks(rng, n_exp, k, n):
    qs = rng.integers(0, 256, (n_exp, k // 2, n), dtype=np.uint8)
    eff = np.asarray(jnp.asarray(rng.random((n_exp, k // 32, n), dtype=np.float32) * 0.01
                                 + 1e-3, jnp.bfloat16))
    return qs, eff, (torch.from_numpy(qs),
                     torch.from_numpy(eff.view(np.uint16).copy()).view(torch.bfloat16))


def _mxfp4_stacks(rng, n_exp, n, k):
    packed = []
    for _ in range(n_exp):
        w = rng.standard_normal((n, k)).astype(np.float32)
        packed.append(jmx.pack_mxfp4_device(quantize_mxfp4(w), (n, k)))
    return np.stack([p[0] for p in packed]), np.stack([p[1] for p in packed])


def _split_sum(plain, p, k, unit, a, qs_all, scales, ids):
    """The plain version over each slice of plan ``p``, summed in slice
    order: qs byte rows k0 / 2 .. k1 / 2 and scale rows k0 / 32 .. k1 / 32
    hold exactly the slice's k (a TCQ4 superblock's 128 byte rows, an MXFP4
    group's 16)."""
    acc = None
    for k0, k1 in _slice_bounds(p, k, unit):
        part = plain(a[:, k0:k1], qs_all[:, k0 // 2:k1 // 2], scales[:, k0 // 32:k1 // 32], ids)
        acc = part if acc is None else acc + part
    return acc


# (n_sel, K, N): plans of 8, 3 and 4 slices, the last with a ragged N
B9_SPLITS = [(4, 2048, 256), (8, 768, 512), (16, 1024, 200)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_sel,k,n", B9_SPLITS)
def test_b9_slices_sum_to_plain_and_jax(n_sel, k, n, dtype):
    """Repeated ids and an expert no row selects, as at served decode."""
    rng = np.random.default_rng(n_sel * k + n)
    qs, eff, (qs_t, eff_t) = _tcq4_stacks(rng, 5, k, n)
    ids = (np.arange(n_sel) * 3 % 4).astype(np.int32)
    a_np = rng.standard_normal((n_sel, k)).astype(np.float32)
    a = torch.from_numpy(a_np).to(dtype)
    p = tm.rows_plan(n_sel, k, n)
    assert p.slices > 1
    ids_t = torch.from_numpy(ids)
    got = _split_sum(tm.tcq4_matmul_experts_rows_plain, p, k, tm.TILE_K, a, qs_t, eff_t, ids_t)
    ref = tm.tcq4_matmul_experts_rows_plain(a, qs_t, eff_t, ids_t)
    assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    jax_ref = np.asarray(jtm.tcq4_matmul_experts_rows(
        jnp.asarray(a.float().numpy()), jnp.asarray(qs), jnp.asarray(eff, jnp.bfloat16),
        jnp.asarray(ids), interpret=True))
    assert rel_err(got.numpy(), jax_ref) < TOL
    assert rel_err(tm.tcq4_matmul_experts_rows(a, qs_t, eff_t, ids_t).numpy(), jax_ref) < TOL


# (n_sel, K, N before padding): plans of 20, 10 and 10 slices
B12_SPLITS = [(4, 640, 256), (16, 640, 200), (2, 320, 120)]


@pytest.mark.parametrize("n_sel,k,n", B12_SPLITS)
def test_b12_slices_sum_to_plain_and_jax(n_sel, k, n):
    rng = np.random.default_rng(n_sel + k + n)
    qs, sx = _mxfp4_stacks(rng, 3, n, k)
    n_pad = qs.shape[-1]
    ids = (np.arange(n_sel) * 2 % 3).astype(np.int32)
    a = torch.from_numpy(rng.standard_normal((n_sel, k)).astype(np.float32))
    p = mx.rows_plan(n_sel, k, n_pad)
    assert p.slices > 1
    args = (torch.from_numpy(qs), torch.from_numpy(sx), torch.from_numpy(ids))
    got = _split_sum(mx.mxfp4_matmul_experts_rows_plain, p, k, mx.GROUP, a, *args)
    ref = mx.mxfp4_matmul_experts_rows_plain(a, *args)
    assert float((got - ref).abs().max() / ref.abs().max()) <= TOL
    jax_ref = np.asarray(jmx.mxfp4_matmul_experts_rows(jnp.asarray(a.numpy()), jnp.asarray(qs),
                                                       jnp.asarray(sx), jnp.asarray(ids),
                                                       interpret=True))
    assert rel_err(got.numpy(), jax_ref) < TOL
    assert rel_err(mx.mxfp4_matmul_experts_rows(a, *args).numpy(), jax_ref) < TOL


# ---------------------------------------------------------------------------
# The sources, the bindings and the labels
# ---------------------------------------------------------------------------

def _src(name: str) -> str:
    return (kernels.CSRC / name).read_text()


@pytest.mark.parametrize("entry,source", [("rrs_mxfp4_rows", "mxfp4_matmul.cu"),
                                          ("rrs_tcq4_experts_rows", "tcq4_experts.cu")])
def test_rows_entry_arity_matches_the_binding(entry, source):
    params = re.search(rf"int {entry}\(([^)]*)\)", _src(source)).group(1)
    assert len(params.split(",")) == len(kernels.SIGNATURES[entry])
    for arg in ("int slice_units", "void* scratch", "void* counters"):
        assert arg in params, arg


def test_sources_drop_the_replaced_kernels():
    """The CUDA-core rows kernels and their shared-memory limit are gone;
    both entries reach the decode body's rows_kernel through the loaders of
    B4 and B11, not copies of them; splitk_kernel runs the same block
    without the rows flag."""
    texts = {p.name: p.read_text() for p in kernels.CSRC.iterdir()}
    for name, text in texts.items():
        for gone in ("tcq4_rows_kernel", "mxfp4_rows_kernel", "kRowsMaxK"):
            assert gone not in text, (name, gone)
    for name in ("tcq4_experts.cu", "mxfp4_matmul.cu"):
        assert "__shared__" not in texts[name], name
    body = texts["gemm_sm90.cuh"]
    assert re.search(r"splitk_kernel\(.*?\{\s*splitk_block<L, MT, false>\(", body, re.S)
    assert re.search(r"rows_kernel\(.*?\{\s*splitk_block<L, MT, true>\(", body, re.S)
    assert len(re.findall(r"__launch_bounds__\(kDecodeWarps \* 32, MT == 1 \? 3 : 2\)", body)) == 2
    assert "rrs::tcq4_rows(" in texts["tcq4_experts.cu"]
    assert "sm90::launch_rows<L>" in texts["tcq4_matmul.cu"]
    assert "launch_rows<L>" in texts["mxfp4_matmul.cu"]


def test_profile_labels_name_the_rows_kernel():
    """The rows kernel has its own name: profiles count it as B9 or B12 by
    its loader, and B4 / B11 keep theirs."""
    label, anon = chip_smoke.kernel_label, "(anonymous namespace)"
    assert label(f"void rrs::sm90::rows_kernel<{anon}::TCQ4<__nv_bfloat16, __nv_bfloat16>, 1>"
                 f"(...)") == "tcq4_matmul_experts_rows"
    assert label(f"void rrs::sm90::rows_kernel<{anon}::TCQ4<__nv_bfloat16, float>, 1>(...)") \
        == "tcq4_matmul_experts_rows"
    assert label(f"void rrs::sm90::rows_kernel<{anon}::MXFP4<__nv_bfloat16>, 1>(...)") \
        == "mxfp4_matmul_experts_rows"
    assert label(f"void rrs::sm90::splitk_kernel<{anon}::TCQ4<__nv_bfloat16, float>, 1>(...)") \
        == "tcq4_matmul"
    assert label(f"void rrs::sm90::splitk_kernel<{anon}::MXFP4<__nv_bfloat16>, 2>(...)") \
        == "mxfp4_matmul"
    assert not any("rows" in key for key in chip_smoke.KERNEL_NAMES)


def test_rows_wrappers_launch_nothing_on_the_cpu():
    rng = np.random.default_rng(11)
    _, _, (qs_t, eff_t) = _tcq4_stacks(rng, 3, 512, 64)
    qs, sx = _mxfp4_stacks(rng, 3, 64, 128)
    kernels.reset_launches()
    ids = torch.tensor([2, 0, 2], dtype=torch.int32)
    tm.tcq4_matmul_experts_rows(torch.ones((3, 512)), qs_t, eff_t, ids)
    tm.tcq4_matmul_experts_rows(torch.ones((3, 512), dtype=torch.bfloat16), qs_t, eff_t, ids)
    mx.mxfp4_matmul_experts_rows(torch.ones((3, 128)), torch.from_numpy(qs),
                                 torch.from_numpy(sx), ids)
    assert not any(kernels.LAUNCHES.values())


@pytest.mark.parametrize("module,unit,k,slices,per", [(tm, tm.TILE_K, 2048, 3, 3),
                                                      (mx, mx.GROUP, 2880, 7, 13)],
                         ids=["B9", "B12"])
def test_rows_sweep_forces_even_slices_and_restores_the_plan(module, unit, k, slices, per):
    """``tools/rows_sweep.py`` times the wrappers under other slice counts by
    replacing the module's ``rows_plan`` while its context is open."""
    from rrs_tpu_torch.tools.rows_sweep import slices_forced

    picked = module.rows_plan
    with slices_forced(module, unit, slices):
        p = module.rows_plan(8, k, 768)
        assert (p.slices, p.slice_units) == (slices, per)
        assert p.scratch_elems == slices * 8 * 6 * splitk.STRIP
        _check_plan(p, 8, k, 768, unit, False, "forced")
    assert module.rows_plan is picked
