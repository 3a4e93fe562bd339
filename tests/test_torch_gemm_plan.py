"""The split-K plan of B2 (``q8_matmul``) and B4 (``tcq4_matmul``), on the
CPU: which slices of K the kernels sum, how many blocks they launch, and the
scratch the wrappers allocate; and the plain
versions summed slice by slice in the plan's order, which is the reordering
of the f32 sums that the kernels make, against the unsplit plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from rrs_tpu_torch.models.config import PRESETS, ModelConfig
from rrs_tpu_torch.models.linear import n_pad_width
from rrs_tpu_torch.ops import q8_matmul as q8
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import SMALL

# Qwen3-30B-A3B as its published config.json gives it (the fields the
# linears' shapes read)
QWEN3_30B_A3B = ModelConfig(arch="qwen3moe", n_layers=48, n_embd=2048, n_heads=32,
                            n_kv_heads=4, head_dim=128, n_ff=6144, vocab_size=151936,
                            context_length=40960, n_experts=128, n_experts_used=8,
                            n_ff_exp=768)
CONFIGS = {"qwen3-4b": PRESETS["qwen3-4b"], "gpt-oss-20b": PRESETS["gpt-oss-20b"],
           "Qwen3-30B-A3B": QWEN3_30B_A3B, "tiny": PRESETS["tiny"],
           "tiny-oss": PRESETS["tiny-oss"], "small": ModelConfig(**SMALL)}
UNIT = {"q8": q8.GROUP, "tcq4": tm.TILE_K}
PLAN = {"q8": q8.splitk_plan, "tcq4": tm.splitk_plan}


def _pad256(k: int) -> int:
    return -(-k // 256) * 256


def linear_shapes(cfg: ModelConfig) -> list[tuple[str, str, int, int]]:
    """(name, format, K, N) of every dense weight matmul of a model: the
    fused attention and FFN projections (Q8_0 attention for gpt-oss, TCQ4
    elsewhere; the MoE router where there are experts) and the Q8_0 lm_head,
    with K and N padded as the loaders pad them."""
    e, hd = cfg.n_embd, cfg.n_heads * cfg.head_dim
    qkv_n = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
    out = []
    if cfg.arch == "gpt-oss":
        out += [("qkv", "q8", _pad256(e), n_pad_width(qkv_n)),
                ("o", "q8", _pad256(hd), n_pad_width(e))]
    else:
        out += [("qkv", "tcq4", e, qkv_n), ("o", "tcq4", hd, e)]
        if cfg.n_experts:
            out.append(("router", "tcq4", e, cfg.n_experts))
        else:
            out += [("gate_up", "tcq4", e, 2 * cfg.n_ff), ("down", "tcq4", cfg.n_ff, e)]
    out.append(("lm_head", "q8", _pad256(e), n_pad_width(cfg.vocab_size)))
    return out


CASES = [(c, *s) for c, cfg in CONFIGS.items() for s in linear_shapes(cfg)]


def slice_bounds(p: splitk.Plan, k: int, unit: int) -> list[tuple[int, int]]:
    """[k0, k1) of each slice of plan ``p``, in the order the kernels sum
    them (csrc/gemm_sm90.cuh: slice z covers units z * slice_units ...)."""
    step = p.slice_units * unit
    return [(k0, min(k, k0 + step)) for k0 in range(0, k, step)]


@pytest.mark.parametrize("config,name,fmt,k,n", CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in CASES])
def test_plan_covers_k_and_fills_the_card(config, name, fmt, k, n):
    unit = UNIT[fmt]
    assert k % (256 if fmt == "tcq4" else unit) == 0
    units = k // unit
    for m in (*range(1, splitk.MAX_M + 1), 17, 64, 128, 512, 2048):
        p = PLAN[fmt](m, k, n)
        prefill = m > splitk.MAX_M
        # the prefill body steps through K 64 deep
        step = max(unit, splitk.PREFILL_BK) if prefill else unit
        bounds = slice_bounds(p, k, unit)
        # whole units, in order, covering K once
        assert len(bounds) == p.slices
        assert bounds[0][0] == 0 and bounds[-1][1] == k
        assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
        assert all(k0 % step == 0 and k0 < k1 for k0, k1 in bounds)
        assert p.strips == -(-n // splitk.STRIP)
        # two waves (decode) or one block on each of 132 SMs (prefill)
        # wherever K allows it
        tiles = p.strips * (-(-m // (64 if m < 128 else 128)) if prefill else 1)
        blocks = splitk.PREFILL_MIN_BLOCKS if prefill else splitk.MIN_BLOCKS
        assert tiles * p.slices >= blocks or p.slices == k // step
        # the scratch the wrapper allocates is the kernels' [slices, M, strips * 128]
        want = p.slices * m * p.strips * splitk.STRIP if p.slices > 1 else 0
        assert p.scratch_elems == want
        scratch, counters = splitk.buffers(p, torch.device("cpu"))
        if p.slices == 1:
            assert scratch is None and counters is None
        else:
            assert scratch.numel() == want and scratch.dtype == torch.float32
            assert counters.numel() >= tiles and not counters.any()


def _split_sum(plain, p, k, unit, a, *w_slices):
    """The plain version over each slice, summed in the plan's order."""
    acc = None
    for k0, k1 in slice_bounds(p, k, unit):
        part = plain(a[:, k0:k1], *(f(k0, k1) for f in w_slices))
        acc = part if acc is None else acc + part
    return acc


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# (K, N): the tiny and small configs' shapes, and shapes that split K many ways
SUM_SHAPES = [(256, 512), (512, 256), (256, 1024), (2048, 256), (4096, 384), (1280, 200)]


@pytest.mark.parametrize("k,n", SUM_SHAPES)
@pytest.mark.parametrize("m", [1, 4, 16, 64])
def test_q8_slices_sum_to_the_plain_version(k, n, m):
    rng = np.random.default_rng(k + n + m)
    q = torch.from_numpy(rng.integers(-127, 128, (k, n), dtype=np.int8))
    scale = torch.from_numpy(rng.uniform(1e-4, 2e-3, (k // 32, n)).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(torch.bfloat16)
    p = q8.splitk_plan(m, k, n)
    got = _split_sum(q8.q8_matmul_plain, p, k, q8.GROUP, a,
                     lambda k0, k1: q[k0:k1], lambda k0, k1: scale[k0 // 32:k1 // 32])
    ref = q8.q8_matmul_plain(a, q, scale)
    assert _rel(got, ref) <= 1e-5


@pytest.mark.parametrize("k,n", [s for s in SUM_SHAPES if s[0] % 256 == 0])
@pytest.mark.parametrize("m", [1, 4, 16, 64])
def test_tcq4_slices_sum_to_the_plain_version(k, n, m):
    rng = np.random.default_rng(k * n + m)
    qs = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    eff = torch.from_numpy(rng.uniform(1e-3, 1.1e-2, (k // 32, n)).astype(np.float32)
                           ).to(torch.bfloat16)
    a = torch.from_numpy((rng.integers(-7, 8, (m, k)) / 7.0).astype(np.float32))
    p = tm.splitk_plan(m, k, n)
    got = _split_sum(tm.tcq4_matmul_plain, p, k, tm.TILE_K, a,
                     lambda k0, k1: qs[k0 // 2:k1 // 2], lambda k0, k1: eff[k0 // 32:k1 // 32])
    ref = tm.tcq4_matmul_plain(a, qs, eff)
    assert _rel(got, ref) <= 1e-5
