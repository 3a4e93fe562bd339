"""The expert grid of B10 (``tcq4_matmul_all_experts``), B13
(``mxfp4_matmul_all_experts``) and B19 (``tcq4_matmul_experts``) on the CPU:
the grid the wrappers give ``csrc/gemm_sm90.cuh``'s ``experts_kernel`` at
every call the model paths make (enough blocks for the card with one K
slice at the published widths); the ring of every loader the grid
instantiates within two blocks an SM; the C entries' arity against their
bindings; the plain versions against the JAX kernels run in interpret mode
at the capacities the models give them, with f32 and bf16 activations,
shared and per-expert; B19's plain version bit-equal to B10's; the wrappers
launching nothing on the CPU; and no source naming the kernels and the
header the grid replaced."""

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
from rrs_tpu_torch.models import moe
from rrs_tpu_torch.models.config import PRESETS, ModelConfig
from rrs_tpu_torch.ops import mxfp4_matmul as mx
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm
from rrs_tpu_torch.runtime.context import PREFILL_BUCKETS

from test_torch_common import rel_err

TOL = 1e-5                   # bf16 operands on both sides, f32 sums in another order
SMEM_BLOCK = 232448          # 227 KB, the most shared memory one H100 block may use

QWEN3_30B = ModelConfig.from_gguf(chip_smoke.QWEN3_30B_A3B_GGUF)
OSS = PRESETS["gpt-oss-20b"]
CONFIGS = {"Qwen3-30B-A3B": QWEN3_30B, "gpt-oss-20b": OSS,
           "qwen3moe 2-layer": chip_smoke.qwen3moe_small_cfg(),
           "gpt-oss 2-layer": chip_smoke.gptoss_small_cfg(), "tiny-oss": PRESETS["tiny-oss"]}
FULL = {"Qwen3-30B-A3B", "gpt-oss-20b"}


def _calls(cfg: ModelConfig) -> list[tuple[str, int, int, int]]:
    """(label, Z, M, N) of every B10 / B13 launch a prefill step of 1 or 4
    lanes makes: the shared rows of gpt-oss's batched decode at 16 < T <= 64,
    else the capacity dispatch's C rows an expert; gate and up at n_ff_exp,
    down at n_embd (MXFP4 stacks pad N to 128)."""
    mxfp4 = cfg.arch == "gpt-oss"
    pad = (lambda n: -(-n // 128) * 128) if mxfp4 else (lambda n: n)     # noqa: E731
    calls = []
    for n_tok in sorted({lanes * b for lanes in (1, 4) for b in PREFILL_BUCKETS}):
        if n_tok <= 16:
            continue
        m = n_tok if mxfp4 and n_tok <= 64 else moe.capacity(cfg.n_experts, cfg.n_experts_used,
                                                             n_tok)
        for proj, n in (("gate/up", cfg.n_ff_exp), ("down", cfg.n_embd)):
            calls.append((f"{n_tok} tokens {proj}", cfg.n_experts, m, pad(n)))
    return calls


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_expert_grid_covers_every_call(name):
    """Every output row and column in exactly one block, 64-row tiles below
    128 rows; at the published widths at least two blocks for each of the
    132 SMs at every call, so one K slice fills the card (B10: 6 or 16
    strips x 1 row tile x 128 experts at C = 64; B13: 23 strips x 32 experts
    at T = 64)."""
    for label, z, m, n in _calls(CONFIGS[name]):
        g = splitk.experts_grid(z, m, n)
        assert g.row_tile == (64 if m < 128 else 128)
        assert (g.row_tiles - 1) * g.row_tile < m <= g.row_tiles * g.row_tile, label
        assert (g.strips - 1) * splitk.STRIP < n <= g.strips * splitk.STRIP, label
        assert g.experts == z and g.blocks == g.strips * g.row_tiles * z
        if name in FULL:
            assert g.blocks >= 2 * splitk.SMS, (label, g)


def test_expert_grid_at_the_headline_shapes():
    assert splitk.experts_grid(128, 64, 768).blocks == 6 * 1 * 128
    assert splitk.experts_grid(128, 64, 2048).blocks == 16 * 1 * 128
    assert splitk.experts_grid(32, 64, 2944).blocks == 23 * 1 * 32
    # B19 takes B10's tile at the same M (its outputs are B10's bit for bit)
    for m in (1, 16, 40, 127, 128, 300):
        assert splitk.experts_grid(8, m, 768).row_tile == splitk.experts_grid(128, m, 768).row_tile


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

def _src(name: str) -> str:
    return (kernels.CSRC / name).read_text()


def _int(src: str, pattern: str) -> int:
    return int(re.search(pattern, src, re.S).group(1))


def _raw_bytes(loader: str, eff_bytes: int) -> int:
    """The loader's raw weight bytes a 64-deep stage, from its source."""
    bn = _int(_src("gemm_sm90.cuh"), r"constexpr int kBN = (\d+);")
    if loader == "MXFP4":
        src = _src("mxfp4_matmul.cu")
        q = _int(src, r"kQBytes = (\d+) \* rrs::sm90::kBN;") * bn
        return q + _int(src, r"kRawBytes = kQBytes \+ (\d+) \* rrs::sm90::kBN;") * bn
    src = _src("tcq4_matmul.cu")
    q = _int(src, r"kQBytes = (\d+) \* kBN;") * bn
    assert "kEffBytes = 2 * kBN * static_cast<int>(sizeof(EffT));" in src
    assert "kRawBytes = kQBytes + kEffBytes;" in src
    return q + 2 * bn * eff_bytes


@pytest.mark.parametrize("row_tile", [64, 128])
@pytest.mark.parametrize("loader,eff_bytes,raw", [("MXFP4", 0, 4352), ("TCQ4", 2, 4608),
                                                  ("TCQ4", 4, 5120)],
                         ids=["MXFP4<bf16> (B13)", "TCQ4<bf16, bf16> (B10, B19)",
                              "TCQ4<float, bf16> (B19 f32 eff)"])
def test_expert_loader_rings_fit_two_blocks(loader, eff_bytes, raw, row_tile):
    """Every loader the expert grid instantiates, at both row tiles: three
    stages of bf16 A rows and the loader's raw bytes, and two bf16 B tiles,
    within half an SM's shared memory less the 1 KB the SM keeps a block
    (the PrefillSmem static_assert), so two blocks share an SM."""
    body = _src("gemm_sm90.cuh")
    bn, bk = _int(body, r"constexpr int kBN = (\d+);"), _int(body, r"constexpr int kBK = (\d+);")
    assert (bn, bk) == (splitk.STRIP, splitk.PREFILL_BK)
    assert _raw_bytes(loader, eff_bytes) == raw
    stages, ld_b = _int(body, r"kStages = (\d+);"), _int(body, r"kLdB = kBN \+ (\d+);") + bn
    ring = stages * (row_tile * bk * 2 + raw) + 2 * bk * ld_b * 2
    assert ring <= SMEM_BLOCK // 2 - 1024
    assert "static_assert(kBytes <= 232448 / 2 - 1024" in body
    assert re.search(r"__launch_bounds__\(kPrefillThreads, 2\)\s*experts_kernel", body)
    for tile in (64, 128):
        assert f"launch_experts_bm<L, {tile}>" in body


@pytest.mark.parametrize("entry,source", [("rrs_mxfp4_all_experts", "mxfp4_matmul.cu"),
                                          ("rrs_tcq4_all_experts", "tcq4_experts.cu"),
                                          ("rrs_tcq4_experts_sel", "tcq4_experts.cu")])
def test_expert_entry_arity_matches_the_binding(entry, source):
    params = re.search(rf"int {entry}\(([^)]*)\)", _src(source)).group(1)
    assert len(params.split(",")) == len(kernels.SIGNATURES[entry])
    assert "int row_tile" in params


def test_sources_drop_the_replaced_kernels():
    """The WMMA expert GEMMs and their tile loaders are gone; so is the WMMA
    header, which no source includes; the expert kernels reach the TCQ4
    loader through one library entry, not a copy."""
    assert not (kernels.CSRC / "tcq4_tile.cuh").exists()
    texts = {p.name: p.read_text() for p in kernels.CSRC.iterdir()}
    for name, text in texts.items():
        for gone in ("tcq4_experts_gemm_kernel", "mxfp4_gemm_kernel", "load_b_mxfp4",
                     "load_b_tcq4", "tcq4_tile.cuh"):
            assert gone not in text, (name, gone)
    assert not [n for n, t in texts.items() if '#include "gemm_bf16.cuh"' in t] \
        and "gemm_bf16.cuh" not in texts
    assert [n for n, t in texts.items() if re.search(r"struct TCQ4 \{", t)] == ["tcq4_matmul.cu"]
    assert [n for n, t in texts.items() if re.search(r"struct MXFP4 \{", t)] == \
        ["mxfp4_matmul.cu"]
    assert "rrs::tcq4_experts(" in texts["tcq4_experts.cu"]
    assert "launch_experts<L>" in texts["mxfp4_matmul.cu"]


def test_profile_labels_name_the_expert_kernel():
    """The expert kernel has its own name: the profile counts it as B10 or
    B13 by its loader, and B11 / B4 keep theirs."""
    label, anon = chip_smoke.kernel_label, "(anonymous namespace)"
    assert label(f"void rrs::sm90::experts_kernel<{anon}::MXFP4<__nv_bfloat16>, 64>(...)") \
        == "mxfp4_matmul_all_experts"
    assert label(f"void rrs::sm90::experts_kernel<{anon}::TCQ4<float, __nv_bfloat16>, 128>"
                 f"(...)") == "tcq4_matmul_all_experts"
    assert label(f"void rrs::sm90::gemm_kernel<{anon}::MXFP4<__nv_bfloat16>, 64, float>(...)") \
        == "mxfp4_matmul"


# ---------------------------------------------------------------------------
# The plain versions against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def _act(rng, shape, dtype):
    a = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bf16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a, torch.from_numpy(a).to(torch.bfloat16 if dtype == "bf16" else torch.float32)


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


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout", ["shared", "per-expert"])
@pytest.mark.parametrize("t", [24, 40, 64])
def test_b10_plain_matches_jax(t, layout, dtype):
    """T = 24 and 40 are not multiples of the 64-row tile; N = 200 is no
    multiple of the 128-column strip."""
    rng = np.random.default_rng(t)
    n_exp, k, n = 2, 512, 200
    qs, eff, (qs_t, eff_t) = _tcq4_stacks(rng, n_exp, k, n)
    a_np, a_t = _act(rng, (t, k) if layout == "shared" else (n_exp, t, k), dtype)
    ref = np.asarray(jtm.tcq4_matmul_all_experts(
        jnp.asarray(a_np), jnp.asarray(qs), jnp.asarray(eff, jnp.bfloat16), interpret=True))
    got = tm.tcq4_matmul_all_experts(a_t, qs_t, eff_t)
    assert got.dtype == torch.float32 and got.shape == (n_exp, t, n)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout", ["shared", "per-expert"])
@pytest.mark.parametrize("t", [24, 40, 64])
def test_b13_plain_matches_jax(t, layout, dtype):
    rng = np.random.default_rng(100 + t)
    n_exp, k = 2, 320
    qs, sx = _mxfp4_stacks(rng, n_exp, 272, k)                 # N padded to 384
    a_np, a_t = _act(rng, (t, k) if layout == "shared" else (n_exp, t, k), dtype)
    ref = np.asarray(jmx.mxfp4_matmul_all_experts(jnp.asarray(a_np), jnp.asarray(qs),
                                                  jnp.asarray(sx), interpret=True))
    got = mx.mxfp4_matmul_all_experts(a_t, torch.from_numpy(qs), torch.from_numpy(sx))
    assert got.dtype == torch.float32 and got.shape == (n_exp, t, 384)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 24, 40])
def test_b19_plain_is_b10_plain_of_its_ids(m, dtype):
    """Shared rows against each selected expert (a repeated id, experts no id
    selects): B19's plain version is B10's plain out[ids] bit for bit, as
    the card holds the two kernels."""
    rng = np.random.default_rng(7 + m)
    _, _, (qs_t, eff_t) = _tcq4_stacks(rng, 5, 256, 136)
    a = torch.from_numpy(rng.standard_normal((m, 256)).astype(np.float32)).to(dtype)
    ids = torch.tensor([3, 0, 3, 4])
    out = tm.tcq4_matmul_experts(a, qs_t, eff_t, ids)
    assert torch.equal(out, tm.tcq4_matmul_all_experts(a, qs_t, eff_t)[ids])


def test_wrappers_launch_nothing_on_the_cpu():
    rng = np.random.default_rng(9)
    _, _, (qs_t, eff_t) = _tcq4_stacks(rng, 3, 256, 64)
    qs, sx = _mxfp4_stacks(rng, 3, 64, 128)
    kernels.reset_launches()
    a = torch.ones((3, 20, 256))
    tm.tcq4_matmul_all_experts(a, qs_t, eff_t)
    tm.tcq4_matmul_all_experts(a[0], qs_t, eff_t)
    tm.tcq4_matmul_experts(a[0], qs_t, eff_t.float(), torch.tensor([2, 0]))
    mx.mxfp4_matmul_all_experts(torch.ones((20, 128)), torch.from_numpy(qs),
                                torch.from_numpy(sx))
    assert not any(kernels.LAUNCHES.values())
