"""B18 (``tcq4_matmul_pb``) on ``csrc/gemm_sm90.cuh`` through the PB loader,
and B16 (``tcq4_matmul_a8``) on ``csrc/tcq4_gx2.cu``'s split-K integer
stream, on the CPU: ``splitk.a8_plan`` at every M <= 32 and every K of
qwen3-4b, Qwen3-30B-A3B and the 2-layer test models, and the plans of B1 /
B4 / B18 left as they were; B16's order of sums
(``tcq4_matmul_a8_splitk_plain``) against its plain version, the integer
oracle and the JAX kernel in interpret mode; B18's group-major walk of the
group-interleaved pack, emulated in PyTorch, against ``decode_pb`` and
``pb_prepare``, and its bias folded unit by unit in the kernel's order
against the plain version and the JAX kernel in interpret mode; the C
entries' arity, the loader's constants and the removed names, read from the
sources; the profile labels; and the wrappers launching nothing on the CPU.

Limits: rel 1e-5 for B16 (f32 sums in another order; the limit of
tests/test_torch_tcq4_int.py); B18 1e-3 against its plain version (bf16
operands, f32 sums in another order) and 2e-2 against JAX at M = 4 and 16
(JAX's own bound for the bf16 dequant path); at M = 1, where JAX's interpret
mode keeps the (q + 24) * e products in f32, the same walk with f32
products within 1e-5 (tests/test_torch_tcq4_extra.py says why)."""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from rrs_tpu.formats.tcq4 import dequantize_activations_rrs as jax_dequant_act
from rrs_tpu.formats.tcq4 import effective_scales, quantize_tcq4
from rrs_tpu.ops import tcq4_matmul as jtm
from rrs_tpu_torch import kernels
from rrs_tpu_torch.formats.tcq4 import unpack_nibbles_torch
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import rel_err
from test_torch_gx_plan import CONFIGS

INT_TOL = 1e-5
PB_TOL = 1e-3
PB_JAX_TOL = 2e-2
SB = tm.TILE_K


def _src(name: str) -> str:
    return (kernels.CSRC / name).read_text()


def _bf16(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x).view(np.uint16).copy()).view(torch.bfloat16)


# ---------------------------------------------------------------------------
# The plans
# ---------------------------------------------------------------------------

def _linears(cfg) -> dict[str, tuple[int, int]]:
    """(K, N) of each TCQ4 linear outside the experts (models/llama.py)."""
    e = cfg.n_embd
    shapes = {"qkv": (e, cfg.n_q_dim + 2 * cfg.n_kv_dim), "o": (cfg.n_q_dim, e)}
    if not cfg.n_experts:
        shapes.update(gate_up=(e, 2 * cfg.n_ff), down=(cfg.n_ff, e))
    return shapes


def _check_a8_plan(p: splitk.Plan, m: int, k: int, n: int, label):
    units = k // SB
    assert p.strips == -(-n // splitk.STRIP), label
    assert 1 <= p.slices <= splitk.GX_MAX_SLICES, label
    assert p.slice_units == -(-units // p.slices), label               # an even split
    assert (p.slices - 1) * p.slice_units < units <= p.slices * p.slice_units, label
    assert p.scratch_elems == 0, label                                  # the cluster sums
    assert splitk.gx_smem(m, p.slice_units, 4, 0) <= splitk.GX_MAX_SMEM, label
    # no other even split costs less (ties: the fewer slices)
    cost = splitk.a8_cost(m, k, n, p.slices)
    assert cost is not None, label
    for per in range(1, units + 1):
        s = -(-units // per)
        other = splitk.a8_cost(m, k, n, s)
        assert other is None or (cost, p.slices) <= (other, s), (label, s)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_a8_plan_covers_k_at_every_model_linear(name):
    for lname, (k, n) in _linears(CONFIGS[name]).items():
        for m in range(1, tm.A8_MAX_M + 1):
            _check_a8_plan(tm.a8_plan(m, k, n), m, k, n, (name, lname, m))


@pytest.mark.parametrize("m", [1, 2, 8, 9, 16, 17, 24, 32])
def test_a8_plan_exists_at_every_k(m):
    """Every K up to 24,576 (96 superblocks), at the widest N and narrow
    ones: 16 slices of 6 superblocks still fit one block an SM at M = 32."""
    for k in range(256, 24577, 256):
        for n in (128, 264, 19456):
            _check_a8_plan(tm.a8_plan(m, k, n), m, k, n, (m, k, n))
    with pytest.raises(ValueError, match="outside"):
        tm.a8_plan(33, 256, 128)


@pytest.mark.parametrize("m,k,n,slices,per", [
    (1, 2560, 6144, 10, 1),       # qwen3-4b qkv: 480 blocks in one wave
    (1, 4096, 2560, 16, 1),       # o
    (1, 2560, 19456, 10, 1),      # gate_up (2 slices: 304 blocks of 83 KB, two waves)
    (1, 9728, 2560, 13, 3),       # down
    (32, 2560, 6144, 5, 2),
    (32, 2560, 19456, 3, 4),
    (32, 9728, 2560, 10, 4),      # 13 slices: two clusters a GPC, a second wave
    (1, 2048, 5120, 8, 1),        # Qwen3-30B-A3B qkv
    (1, 4096, 2048, 16, 1),       # Qwen3-30B-A3B o
], ids=["qkv", "o", "gate_up", "down", "qkv M=32", "gate_up M=32", "down M=32", "30B qkv",
        "30B o"])
def test_a8_plan_at_the_headline_shapes(m, k, n, slices, per):
    """The picks the K-slice sweep of ``gemm_ab --subjects b18,b16`` found
    best or within 3% of it on the H100."""
    p = tm.a8_plan(m, k, n)
    assert (p.slices, p.slice_units) == (slices, per)


def test_a8_cost_counts_cluster_waves():
    """Down at M = 32: 13 slices of 87 KB blocks fit two an SM, but a GPC
    of 16 SMs holds only two 13-block clusters, so 20 strips take two waves;
    10 slices of 116 KB blocks fit three clusters a GPC, one wave."""
    assert splitk.a8_cost(32, 9728, 2560, 13) == 2 * (3 + splitk.A8_SPLIT_COST)
    assert splitk.a8_cost(32, 9728, 2560, 10) == 1 * (4 + splitk.A8_SPLIT_COST)
    assert splitk.a8_cost(32, 9728, 2560, 38) is None          # a cluster of 38 blocks


@pytest.mark.parametrize("m,k,n,unit,want", [
    (1, 2560, 6144, 256, (10, 1)),      # B4 / B18 decode: 480 blocks
    (16, 9728, 2560, 256, (19, 2)),
    (512, 2560, 6144, 256, (1, 10)),    # B4 / B18 prefill: 192 tiles
    (512, 4096, 2560, 256, (2, 8)),     # 80 tiles
    (512, 9728, 2560, 256, (2, 19)),
    (1, 2560, 153600, 32, (1, 80)),     # B2 lm_head
], ids=["pb M=1 qkv", "pb M=16 down", "pb M=512 qkv", "pb M=512 o", "pb M=512 down", "q8 head"])
def test_b4_plan_unchanged_and_taken_by_b18(m, k, n, unit, want):
    """B18 takes B4's plan (``splitk_plan``, 256-k units); its picks stay as
    they were."""
    p = splitk.plan(m, k, n, unit)
    assert (p.slices, p.slice_units) == want
    if unit == SB:
        assert tm.splitk_plan(m, k, n) == p


@pytest.mark.parametrize("m,k,n,want", [(1, 2560, 6144, (5, 2)), (1, 9728, 2560, (13, 3)),
                                        (4, 2560, 19456, (5, 2)), (8, 4096, 2560, (16, 1))],
                         ids=["qkv", "down", "gate_up M=4", "o M=8"])
def test_gx_plan_unchanged(m, k, n, want):
    p = tm.gx_plan(m, k, n)
    assert (p.slices, p.slice_units) == want


def test_wrappers_take_their_plans():
    src = Path(tm.__file__).read_text()
    body = src[src.index("def tcq4_matmul_a8("):src.index("# Prefill: dequant")]
    assert "a8_plan(m, k, n)" in body and "_gx_launch(" in body
    body = src[src.index("def tcq4_matmul_pb("):src.index("# Prefill: int8 superblock")]
    assert "splitk_plan(m, k, n)" in body and "pb_group_major(a_gi)" in body


# ---------------------------------------------------------------------------
# B16: the kernel's order of sums
# ---------------------------------------------------------------------------

def _a8_case(seed, m, k, n):
    rng = np.random.default_rng(seed)
    a_q = rng.integers(-7, 8, (m, k)).astype(np.int8)
    a_s = (rng.random((m, k // SB)) + 0.5).astype(np.float32)
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    eff = (rng.random((k // 32, n), dtype=np.float32) * 0.02 + 1e-3)
    return (a_q, a_s, qs, eff), tuple(torch.from_numpy(x) for x in (a_q, a_s, qs, eff))


# (M, K, N): a plan of 10, 5 and 4 slices at M = 1, 9 (two row tiles) and 32
# (four), a ragged N, and one slice of one superblock
A8_SPLITS = [(1, 2560, 128), (9, 2560, 136), (32, 1024, 200), (3, 256, 64), (17, 2048, 256)]


def _a8_slice_sum(p, a_q, a_s, qs, eff):
    acc = None
    for s0 in range(0, a_q.shape[1] // SB, p.slice_units):
        k0, k1 = s0 * SB, min(a_q.shape[1], (s0 + p.slice_units) * SB)
        part = tm.tcq4_matmul_a8_plain(a_q[:, k0:k1], a_s[:, k0 // SB:k1 // SB],
                                       qs[k0 // 2:k1 // 2], eff[k0 // 32:k1 // 32])
        acc = part if acc is None else acc + part
    return acc


@pytest.mark.parametrize("m,k,n", A8_SPLITS)
def test_a8_slices_sum_to_plain_oracle_and_jax(m, k, n):
    (a_q, a_s, qs, eff), t = _a8_case(5 * m + k + n, m, k, n)
    p = tm.a8_plan(m, k, n)
    got = tm.tcq4_matmul_a8_splitk_plain(*t, p).numpy()
    assert rel_err(got, tm.tcq4_matmul_a8_plain(*t).numpy()) < INT_TOL
    assert rel_err(got, tm.tcq4_matmul_ref(*t).numpy()) < INT_TOL
    assert rel_err(_a8_slice_sum(p, *t).numpy(), got) < INT_TOL
    jax_ref = np.asarray(jtm.tcq4_matmul_a8(jnp.asarray(a_q), jnp.asarray(a_s), jnp.asarray(qs),
                                            jnp.asarray(eff), interpret=True))
    assert rel_err(got, jax_ref) < INT_TOL


@pytest.mark.parametrize("m", [1, 8, 32])
def test_a8_one_slice_in_jax_group_order_is_plain_bit_for_bit(m, monkeypatch):
    """The emulation differs from the JAX-order plain version only in the
    slices and the groups' order: one slice and groups 0 .. 7 give its bits."""
    _, t = _a8_case(m, m, 1024, 64)
    monkeypatch.setattr(tm, "A8_GROUP_ORDER", tuple(range(8)))
    one = splitk.Plan(1, 1, 1024 // SB, 0)
    assert torch.equal(tm.tcq4_matmul_a8_splitk_plain(*t, one), tm.tcq4_matmul_a8_plain(*t))


def test_a8_group_order_is_the_quarter_walk():
    """The body walks a superblock's quarters, each the low-nibble group qq
    then the high one qq + 4 (csrc/tcq4_gx2.cu)."""
    assert tm.A8_GROUP_ORDER == tuple(qq + 4 * hi for qq in range(4) for hi in range(2))
    assert sorted(tm.A8_GROUP_ORDER) == list(range(8))


@pytest.mark.parametrize("m", [1, 32])
def test_a8_scaled_by_16_is_the_same_bits(m):
    """The kernel sums 16 x dot * eff and scales by (a_scale / 7) / 16: both
    factors of 2 are exact, so its output is the emulation's bit for bit."""
    _, (a_q, a_s, qs, eff) = _a8_case(40 + m, m, 2560, 128)
    p = tm.a8_plan(m, 2560, 128)
    g = 2560 // 32
    wq = unpack_nibbles_torch(qs).float().reshape(g, 32, 128)
    dots16 = torch.bmm(a_q.float().reshape(m, g, 32).transpose(0, 1), wq) * 16.0
    s16 = (a_s * torch.tensor(1.0 / 7.0)) * 0.0625
    out = None
    for s0 in range(0, g // 8, p.slice_units):
        y = torch.zeros((m, 128))
        for sb in range(s0, min(g // 8, s0 + p.slice_units)):
            acc = torch.zeros((m, 128))
            for gi in tm.A8_GROUP_ORDER:
                acc = acc + dots16[sb * 8 + gi] * eff[sb * 8 + gi]
            y = y + acc * s16[:, sb:sb + 1]
        out = y if out is None else out + y
    assert torch.equal(out, tm.tcq4_matmul_a8_splitk_plain(a_q, a_s, qs, eff, p))


# ---------------------------------------------------------------------------
# B18: the group-major walk and the bias folded into it
# ---------------------------------------------------------------------------

def _pb_case(seed, m, k=1024, n=256):
    rng = np.random.default_rng(seed)
    t = quantize_tcq4((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    eff_b = np.asarray(jnp.asarray(effective_scales(t).astype(np.float32), jnp.bfloat16))
    a_q = rng.integers(-7, 8, (m, k)).astype(np.int8)
    a_s = (rng.random((m, k // 256)) + 0.5).astype(np.float32)
    a = np.asarray(jax_dequant_act(jnp.asarray(a_q), jnp.asarray(a_s)))
    return t.qs, eff_b, a


def _bits_to_bf16(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).to(torch.int16).view(torch.bfloat16).to(torch.float32)


def _decode(nib: torch.Tensor, e: torch.Tensor, f32_products: bool = False) -> torch.Tensor:
    """The kernel's decode of codes n: the bf16 bits 0x4180 | ((n ^ 8) << 3)
    (q + 24), times the bf16 scales, rounded once to bf16."""
    q24 = _bits_to_bf16(0x4180 | ((nib.to(torch.int32) ^ 8) << 3))
    prod = q24 * e.to(torch.float32)
    return prod if f32_products else prod.to(torch.bfloat16).to(torch.float32)


def _walk(qs_gi: torch.Tensor, eff: torch.Tensor, f32_products: bool = False) -> torch.Tensor:
    """The weights in group-major order (row 32 g + j) as the loader walks
    them: unit U, group pair p, its 32 byte rows j G / 2 + 4 U + p, the low
    nibbles group 8 U + 2 p and the high ones the next."""
    k = 2 * qs_gi.shape[0]
    G, n = k // 32, qs_gi.shape[1]
    w = torch.empty((k, n), dtype=torch.float32)
    for unit in range(G // 8):
        for p in range(4):
            g0 = 8 * unit + 2 * p
            rows = qs_gi[torch.arange(32) * (G // 2) + 4 * unit + p].to(torch.int32)
            w[32 * g0:32 * g0 + 32] = _decode(rows & 15, eff[g0], f32_products)
            w[32 * g0 + 32:32 * g0 + 64] = _decode(rows >> 4, eff[g0 + 1], f32_products)
    return w


def _stage_walk(qs_gi: torch.Tensor, eff: torch.Tensor) -> torch.Tensor:
    """The prefill loader's stages: stage u is byte rows r G / 2 + u, its
    low nibbles B rows 0 .. 31 (group 2u), its high ones 32 .. 63."""
    k = 2 * qs_gi.shape[0]
    G = k // 32
    tiles = []
    for u in range(G // 2):
        rows = qs_gi[torch.arange(32) * (G // 2) + u].to(torch.int32)
        tiles += [_decode(rows & 15, eff[2 * u]), _decode(rows >> 4, eff[2 * u + 1])]
    return torch.cat(tiles)


@pytest.mark.parametrize("k,n", [(256, 64), (1024, 128), (2560, 8)])
def test_group_major_walk_is_decode_pb_reordered(k, n):
    rng = np.random.default_rng(k + n)
    qs = torch.from_numpy(rng.integers(0, 256, (k // 2, n), dtype=np.uint8))
    eff = _bf16(np.asarray(jnp.asarray(rng.random((k // 32, n), dtype=np.float32) * 0.02
                                       + 1e-3, jnp.bfloat16)))
    qs_gi = tm.pack_gi(qs)
    G = k // 32
    ref = tm.decode_pb(qs_gi, eff)                                 # k_new = j G + g order
    gm = ref.reshape(32, G, n).transpose(0, 1).reshape(k, n)      # row 32 g + j
    assert torch.equal(_walk(qs_gi, eff), gm)
    assert torch.equal(_stage_walk(qs_gi, eff), gm)
    # group-major order is the original k order of the sb pack
    biased = tm.dequantize_w(qs, torch.ones_like(eff, dtype=torch.float32)) + 24.0
    want = (biased * eff.float().repeat_interleave(32, 0)).to(torch.bfloat16).float()
    assert torch.equal(gm, want)


@pytest.mark.parametrize("m", [1, 4, 16, 40])
def test_group_major_activations_are_pb_prepare_av(m):
    a = torch.from_numpy(np.random.default_rng(m).standard_normal((m, 1024)).astype(np.float32))
    a_gi, _ = tm.pb_prepare(a)
    got = tm.pb_group_major(a_gi)
    assert got.is_contiguous() and torch.equal(got, a.to(torch.bfloat16))


def _pb_kernel_order(a_gi, ag24, qs_gi, eff, f32_products=False):
    """B18 in the kernel's order under B4's plan: per K slice, unit by unit,
    the unit's four group pairs (each one 64-deep step of bf16 operands, f32
    sums) then its bias step, -[hi | lo] of its 8 groups against their eff
    rows twice; the slices' partials added in slice order."""
    m, k = a_gi.shape
    n, G = qs_gi.shape[1], k // 32
    a = tm.pb_group_major(a_gi).float()
    w = _walk(qs_gi, eff, f32_products)
    e, ag = eff.float(), ag24.float()
    plan = tm.splitk_plan(m, k, n)
    out = None
    for s0 in range(0, k // SB, plan.slice_units):
        y = torch.zeros((m, n))
        for unit in range(s0, min(k // SB, s0 + plan.slice_units)):
            for p in range(4):
                c = slice(256 * unit + 64 * p, 256 * unit + 64 * p + 64)
                y = y + a[:, c] @ w[c]
            g8 = slice(8 * unit, 8 * unit + 8)
            bias_a = -torch.cat([ag[:, g8], ag[:, G + 8 * unit:G + 8 * unit + 8]], dim=1)
            y = y + bias_a @ torch.cat([e[g8], e[g8]])
        out = y if out is None else out + y
    return out


@pytest.mark.parametrize("m", [4, 16])
def test_pb_bias_folded_per_unit_matches_plain_and_jax(m):
    qs, eff_b, a = _pb_case(60 + m, m)
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    qs_gi, eff = tm.pack_gi(torch.from_numpy(qs)), _bf16(eff_b)
    got = _pb_kernel_order(a_gi, ag24, qs_gi, eff).numpy()
    assert rel_err(got, tm.tcq4_matmul_pb_plain(a_gi, ag24, qs_gi, eff).numpy()) < PB_TOL
    ja_gi, jag24 = jtm.pb_prepare(jnp.asarray(a))
    ref = np.asarray(jtm.tcq4_matmul_pb(ja_gi, jag24, jnp.asarray(jtm.pack_gi_np(qs)),
                                        jnp.asarray(eff_b), bn=128, interpret=True))
    assert rel_err(got, ref) < PB_JAX_TOL


def test_pb_bias_folded_per_unit_at_m1_with_f32_products():
    qs, eff_b, a = _pb_case(61, 1)
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    qs_gi, eff = tm.pack_gi(torch.from_numpy(qs)), _bf16(eff_b)
    ja_gi, jag24 = jtm.pb_prepare(jnp.asarray(a))
    ref = np.asarray(jtm.tcq4_matmul_pb(ja_gi, jag24, jnp.asarray(jtm.pack_gi_np(qs)),
                                        jnp.asarray(eff_b), bn=128, interpret=True))
    got = _pb_kernel_order(a_gi, ag24, qs_gi, eff, f32_products=True).numpy()
    assert rel_err(got, ref) < INT_TOL
    rounded = _pb_kernel_order(a_gi, ag24, qs_gi, eff).numpy()
    assert rel_err(rounded, tm.tcq4_matmul_pb_plain(a_gi, ag24, qs_gi, eff).numpy()) < PB_TOL


@pytest.mark.parametrize("nib", range(16))
def test_pb_decode_bits_are_q_plus_24(nib):
    q = nib - 16 if nib >= 8 else nib
    assert _bits_to_bf16(torch.tensor([0x4180 | ((nib ^ 8) << 3)])).item() == q + 24


# ---------------------------------------------------------------------------
# The sources, the bindings and the labels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry,source", [("rrs_tcq4_pb", "tcq4_pb.cu"),
                                          ("rrs_tcq4_a8", "tcq4_gx2.cu")])
def test_entry_arity_matches_the_binding(entry, source):
    params = re.search(rf"int {entry}\(([^)]*)\)", _src(source)).group(1)
    assert len(params.split(",")) == len(kernels.SIGNATURES[entry])
    assert "int slice_units" in params
    assert ("scratch" in params) == (entry == "rrs_tcq4_pb")


def _int(text: str, pattern: str) -> int:
    return int(re.search(pattern, text).group(1))


def test_pb_loader_constants_and_its_prefill_smem():
    """The PB loader's units and stage bytes, and the ring with its two bias
    tiles within two blocks an SM at both row tiles."""
    pb, body = _src("tcq4_pb.cu"), _src("gemm_sm90.cuh")
    assert "struct PB {" in pb and "static constexpr bool kBiasDot = true;" in pb
    assert "kUnitK = 256;" in pb and "kInner = 4;" in pb
    assert "kQBytes = 32 * kBN;" in pb and "kRawBytes = kQBytes + 2 * kBN * 2;" in pb
    bn, bk = _int(body, r"kBN = (\d+);"), _int(body, r"kBK = (\d+);")
    ld_b, stages = bn + _int(body, r"kLdB = kBN \+ (\d+);"), _int(body, r"kStages = (\d+);")
    assert "kBytes = kABytes + 8 * kLdB * 2;" in body and "kABytes = BM * 16 * 2;" in body
    for bm in (64, 128):
        ring = stages * (bm * bk * 2 + 32 * bn + 2 * bn * 2) + 2 * bk * ld_b * 2
        assert ring + 2 * (bm * 16 * 2 + 8 * ld_b * 2) <= 232448 // 2 - 1024, bm
    # the bias step sits behind the loader's flag, as kExperts and kRows do
    assert body.count("if constexpr (BiasDot<L>::value)") == 2
    assert "launch_splitk<PB>" in pb and "launch_gemm<PB, float>" in pb


def test_a8_instantiation_and_limits_in_the_source():
    src = _src("tcq4_gx2.cu")
    assert "kGivenA8 = 3" in src and src.count("__global__") == 1
    for mt in (1, 2, 4):
        assert f"launch<kGivenA8, float, {mt}>" in src
    assert "M > 32" in src and tm.A8_MAX_M == splitk.A8_MAX_M == 32
    assert splitk.GX_MAX_SMEM == _int(src, r"kMaxSmem = (\d+) \* 1024;") * 1024
    assert splitk.SM_SMEM == 228 * 1024 and splitk.GPCS * splitk.GPC_SMS <= splitk.SMS
    # the plan's shared memory is the kernel's formula with f32 eff and no staging
    assert splitk.gx_smem(32, 3, 4, 0) == 3 * (128 * 128 + 8 * 128 * 4) + 32 * (3 * 256 + 16) \
        + 32 * 3 * 4


def test_replaced_kernels_are_gone():
    assert not (kernels.CSRC / "gemm_bf16.cuh").exists()
    assert not (kernels.CSRC / "tcq4_a8.cu").exists()
    for p in kernels.CSRC.iterdir():
        text = p.read_text()
        for gone in ("gemm_bf16.cuh", "tcq4_pb_kernel", "a8_kernel", "namespace gemm",
                     "rrs::gemm", "load_b_pb", "load_neg_e2", "load_ag", "wmma"):
            assert gone not in text, (p.name, gone)


def test_profile_labels_name_the_new_kernels():
    label, anon = chip_smoke.kernel_label, "(anonymous namespace)"
    assert label(f"void rrs::sm90::gemm_kernel<{anon}::PB, 128, float>(...)") == "tcq4_matmul_pb"
    assert label(f"void rrs::sm90::splitk_kernel<{anon}::PB, 2>(...)") == "tcq4_matmul_pb"
    assert label(f"void {anon}::gx_sm90_kernel<3, float, 4>({anon}::Args)") == "tcq4_matmul_a8"
    assert label(f"void {anon}::gx_sm90_kernel<1, __nv_bfloat16, 1>({anon}::Args)") \
        == "tcq4_matmul_gx2"
    assert label(f"void rrs::sm90::splitk_kernel<{anon}::TCQ4<__nv_bfloat16, float>, 1>(...)") \
        == "tcq4_matmul"
    assert "a8_kernel" not in chip_smoke.KERNEL_NAMES
    assert chip_smoke.INT["a8"][1] == "rrs_tpu_torch/csrc/tcq4_gx2.cu"


def test_cpu_calls_launch_nothing():
    qs, eff_b, a = _pb_case(7, 2, k=512, n=64)
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    _, t = _a8_case(7, 2, 512, 64)
    kernels.reset_launches()
    tm.tcq4_matmul_pb(a_gi, ag24, tm.pack_gi(torch.from_numpy(qs)), _bf16(eff_b))
    tm.tcq4_matmul_a8(*t)
    assert not any(kernels.LAUNCHES.values())
