"""The split-K plans of B11 (``mxfp4_matmul``) and B5 (``tcq4_matmul_i8p``)
on the CPU, and the arithmetic their CUDA bodies do that the CPU can check:
the plans cover K in whole units and fill the card at gpt-oss-20b's and
qwen3-4b's shapes; the plain versions summed slice by slice in the plan's
order (the reordering of the f32 sums that the kernels make) agree with the
JAX kernels run in interpret mode; the loaders' constants and the entries'
arity match the sources; and the bit formulas of both decodes, emulated in
NumPy as the kernels write them, give every weight exactly."""

from __future__ import annotations

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats import tcq4 as jtcq4
from rrs_tpu.formats.kquants import quantize_mxfp4
from rrs_tpu.ops import mxfp4_matmul as jmx
from rrs_tpu.ops import tcq4_matmul as jmm
from rrs_tpu_torch import kernels
from rrs_tpu_torch.models.config import PRESETS
from rrs_tpu_torch.ops import mxfp4_matmul as mx
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import rel_err

SMEM_BLOCK = 232448          # 227 KB, the most shared memory one H100 block may use

# gpt-oss-20b's MXFP4 expert projections (K, N padded as pack_mxfp4_device pads N)
OSS = PRESETS["gpt-oss-20b"]
OSS_SHAPES = {"gate/up": (OSS.n_embd, -(-OSS.n_ff_exp // 128) * 128),
              "down": (OSS.n_ff_exp, -(-OSS.n_embd // 128) * 128)}
# qwen3-4b's packed TCQ4 projections, fused as the fabricated weights pack them
Q4B = PRESETS["qwen3-4b"]
Q4B_SHAPES = {"qkv": (Q4B.n_embd, (Q4B.n_heads + 2 * Q4B.n_kv_heads) * Q4B.head_dim),
              "o": (Q4B.n_heads * Q4B.head_dim, Q4B.n_embd),
              "gate_up": (Q4B.n_embd, 2 * Q4B.n_ff), "down": (Q4B.n_ff, Q4B.n_embd)}


def slice_bounds(p: splitk.Plan, k: int, unit: int) -> list[tuple[int, int]]:
    """[k0, k1) of each slice, in the order the kernels sum them."""
    step = p.slice_units * unit
    return [(k0, min(k, k0 + step)) for k0 in range(0, k, step)]


def _busiest(tiles: int, units: int, per: int, split_steps: int) -> int:
    """Steps on the busiest SM: ceil(blocks / 132) blocks of ``per`` steps,
    each ``split_steps`` more when K is split."""
    slices = -(-units // per)
    return -(-tiles * slices // splitk.SMS) * (per + (split_steps if slices > 1 else 0))


def _check_plan(p: splitk.Plan, m: int, k: int, n: int, unit: int, row_tile: int,
                split_steps: int):
    """Whole steps covering K once, in order; the slice length no other
    length beats on the busiest SM (so neither one slice nor the default
    rule's count); the scratch the wrapper allocates."""
    step = max(unit, splitk.PREFILL_BK)
    bounds = slice_bounds(p, k, unit)
    assert len(bounds) == p.slices
    assert bounds[0][0] == 0 and bounds[-1][1] == k
    assert all(b[1] == c[0] for b, c in zip(bounds, bounds[1:]))
    assert all(k0 % step == 0 and k0 < k1 for k0, k1 in bounds)
    assert p.strips == -(-n // splitk.STRIP)
    tiles, units = p.strips * -(-m // row_tile), k // step
    per = p.slice_units * unit // step
    best = min(_busiest(tiles, units, q, split_steps) for q in range(1, units + 1))
    assert _busiest(tiles, units, per, split_steps) == best
    default = splitk.plan(m, k, n, unit)
    assert best <= _busiest(tiles, units, default.slice_units * unit // step, split_steps)
    assert best <= _busiest(tiles, units, units, split_steps)
    assert p.scratch_elems == (p.slices * m * p.strips * splitk.STRIP if p.slices > 1 else 0)
    scratch, counters = splitk.buffers(p, torch.device("cpu"))
    if p.slices > 1:
        assert scratch.numel() == p.scratch_elems and counters.numel() >= tiles


@pytest.mark.parametrize("name", sorted(OSS_SHAPES))
@pytest.mark.parametrize("m", [1, 4, 16, 17, 64, 300, 512, 2048])
def test_mxfp4_plan_covers_k_and_fills_the_card(name, m):
    k, n = OSS_SHAPES[name]
    assert (k, n) == (2880, 2944)
    p = mx.splitk_plan(m, k, n)
    if m <= splitk.MAX_M:
        # the decode stream: whole scale groups, two waves of strips
        bounds = slice_bounds(p, k, mx.GROUP)
        assert bounds[-1][1] == k and all(k0 % mx.GROUP == 0 for k0, _ in bounds)
        assert p.strips * p.slices >= splitk.MIN_BLOCKS or p.slices == k // mx.GROUP
    else:
        # the prefill body's 64-deep steps (45 at K = 2880), BM 64 below M = 128
        _check_plan(p, m, k, n, mx.GROUP, 64 if m < 128 else 128, 3)


@pytest.mark.parametrize("name", sorted(Q4B_SHAPES))
@pytest.mark.parametrize("m", [256, 300, 512, 1024, 2048, 4096])
def test_i8p_plan_covers_k_and_fills_the_card(name, m):
    k, n = Q4B_SHAPES[name]
    p = tm.i8p_plan(m, k, n)
    _check_plan(p, m, k, n, tm.TILE_K, 128, 3)
    # a full wave of output tiles alone is never split
    if p.strips * -(-m // 128) % splitk.SMS == 0:
        assert p.slices == 1


def test_default_plan_unchanged():
    """B2 and B4 keep their plan: at least one block on every SM, K split
    into units // need slices."""
    p = splitk.plan(300, 2880, 2944, 32)
    assert (p.slices, p.slice_units) == (3, 44)
    p = splitk.plan(512, 9728, 2560, 256)
    assert (p.slices, p.slice_units) == (2, 19)


# ---------------------------------------------------------------------------
# Slice sums against the JAX kernels (interpret mode)
# ---------------------------------------------------------------------------

def _mx_weights(rng, n, k):
    w = rng.standard_normal((n, k)).astype(np.float32)
    return jmx.pack_mxfp4_device(quantize_mxfp4(w), (n, k))


@pytest.mark.parametrize("m", [1, 5, 16, 17, 48])
@pytest.mark.parametrize("k,n", [(320, 272), (1024, 128)])
def test_mxfp4_slices_sum_to_the_jax_kernel(m, k, n):
    """K = 320 splits into 5 prefill steps (or 10 scale groups), K = 1024
    into 16 (32): every slice its own, at the small N here."""
    rng = np.random.default_rng(m * k + n)
    qs, sx = _mx_weights(rng, n, k)
    a = rng.standard_normal((m, k)).astype(np.float32)
    ref = np.asarray(jmx.mxfp4_matmul(jnp.asarray(a), jnp.asarray(qs), jnp.asarray(sx),
                                      interpret=True))
    p = mx.splitk_plan(m, k, qs.shape[1])
    assert p.slices > 1
    at, qt, st = torch.from_numpy(a), torch.from_numpy(qs), torch.from_numpy(sx)
    got = None
    for k0, k1 in slice_bounds(p, k, mx.GROUP):
        part = mx.mxfp4_matmul_plain(at[:, k0:k1], qt[k0 // 2:k1 // 2], st[k0 // 32:k1 // 32])
        got = part if got is None else got + part
    assert rel_err(got.numpy(), ref) <= 1e-3


def _i8p_split_plain(p, a_sbi, a_scale, qs_sbi, f8, e2):
    """The kernel's arithmetic under plan ``p``: each slice's superblocks in
    order from zero (acc += p * (e2 * (a_scale / 7))), the slices added in
    slice order, one rounding to the output type."""
    m, k = a_sbi.shape
    w8 = tm.decode_w8(qs_sbi, f8).to(torch.float32)
    a = a_sbi.to(torch.float32)
    as7 = a_scale * (1.0 / 7.0)
    total = None
    for k0, k1 in slice_bounds(p, k, tm.TILE_K):
        acc = torch.zeros((m, qs_sbi.shape[1]), dtype=torch.float32)
        for sb in range(k0 // tm.TILE_K, k1 // tm.TILE_K):
            r = slice(sb * tm.TILE_K, (sb + 1) * tm.TILE_K)
            acc += (a[:, r] @ w8[r]) * (e2[sb:sb + 1, :] * as7[:, sb:sb + 1])
        total = acc if total is None else total + acc
    return total.to(torch.bfloat16) if tm.i8p_out_bf16(m) else total


@pytest.mark.parametrize("m,k,n", [(48, 2560, 128), (300, 2048, 256), (1024, 2048, 128)])
def test_i8p_slices_sum_to_the_jax_kernel(m, k, n):
    """f32 output rel 1e-5, bf16 output (padded M >= 1024) 8e-3, as
    tests/test_torch_i8p.py holds the unsplit plain version."""
    rng = np.random.default_rng(m + k + n)
    t = jtcq4.quantize_tcq4((rng.standard_normal((n, k)) * 0.05).astype(np.float32),
                            use_native=False)
    eff = jnp.asarray(jtcq4.effective_scales(t), jnp.bfloat16)
    x = rng.standard_normal((m, k)).astype(np.float32) * 0.3
    jq, js = jtcq4.quantize_activations_rrs(jnp.asarray(x))
    pack = jmm.pack_i8p(jnp.asarray(np.ascontiguousarray(t.qs)), eff)
    ref = np.asarray(jmm.tcq4_matmul_i8p(jmm.prep_a_sbi(jq), js, *pack, bm=512,
                                         interpret=True)).astype(np.float32)
    p = tm.i8p_plan(m, k, n)
    assert p.slices > 1
    got = _i8p_split_plain(p, tm.prep_a_sbi(torch.from_numpy(np.array(jq))),
                           torch.from_numpy(np.array(js)),
                           *(torch.from_numpy(np.array(v)) for v in pack))
    tol = 8e-3 if tm.i8p_out_bf16(m) else 1e-5
    assert rel_err(got.float().numpy(), ref) <= tol


# ---------------------------------------------------------------------------
# The sources
# ---------------------------------------------------------------------------

def _src(name: str) -> str:
    return (kernels.CSRC / name).read_text()


def _int(src: str, pattern: str) -> int:
    return int(re.search(pattern, src, re.S).group(1))


def test_mxfp4_loader_constants_match_the_plan():
    """One slice unit is one scale group; a 64-deep prefill stage is 32 byte
    rows x 128 columns of qs and 2 exponent rows (4,352 bytes), and the
    prefill body's ring still fits two blocks an SM."""
    src, body = _src("mxfp4_matmul.cu"), _src("gemm_sm90.cuh")
    assert _int(src, r"struct MXFP4 \{.*?kUnitK = (\d+);") == mx.GROUP
    bn, bk = _int(body, r"constexpr int kBN = (\d+);"), _int(body, r"constexpr int kBK = (\d+);")
    assert bn == splitk.STRIP and bk == splitk.PREFILL_BK
    q_bytes = _int(src, r"kQBytes = (\d+) \* rrs::sm90::kBN;") * bn
    raw = q_bytes + _int(src, r"kRawBytes = kQBytes \+ (\d+) \* rrs::sm90::kBN;") * bn
    assert q_bytes == bk // 2 * bn and raw == q_bytes + bk // mx.GROUP * bn == 4352
    stages, ld_b = _int(body, r"kStages = (\d+);"), bn + 8
    ring = stages * (128 * bk * 2 + raw) + 2 * bk * ld_b * 2
    assert ring <= SMEM_BLOCK // 2 - 1024


def test_i8p_constants_match_the_plan():
    """128 x 128 tiles over 256-deep superblocks (the plan's strip, row tile
    and unit); three stages and two w8 tiles within one block's 227 KB."""
    src = _src("tcq4_i8p.cu")
    c = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}
    assert c["kBN8"] == splitk.STRIP and c["kBM"] == 128 and c["kSB"] == tm.TILE_K
    stage = c["kBM"] * c["kSB"] + c["kSB"] // 2 * c["kBN8"] + 8 * c["kBN8"] \
        + c["kBN8"] * 4 + c["kBM"] * 4
    w8 = c["kBN8"] * c["kSB"]
    assert (stage, w8) == (51200, 32768)
    assert c["kStages"] * stage + 2 * w8 <= SMEM_BLOCK
    assert "static_assert(kSmemBytes <= 232448" in src
    assert "constexpr int kStageBytes = kABytes + kQBytes + kFBytes + kBN8 * 4 + kBM * 4;" in src


@pytest.mark.parametrize("entry,source", [("rrs_mxfp4_matmul", "mxfp4_matmul.cu"),
                                          ("rrs_tcq4_i8p", "tcq4_i8p.cu")])
def test_entry_arity_matches_the_binding(entry, source):
    params = re.search(rf"int {entry}\(([^)]*)\)", _src(source)).group(1)
    assert len(params.split(",")) == len(kernels.SIGNATURES[entry])


# ---------------------------------------------------------------------------
# The decodes' bit formulas, as the kernels write them, on every input
# ---------------------------------------------------------------------------

def _fp4x2_bf16(nib, s2):
    """csrc/mxfp4_matmul.cu fp4x2_bf16 in uint32 arithmetic."""
    em = nib & 0x00070007
    mag = (em << 6) + (s2 << 7)
    live = ((em ^ 0x00010001) + 0x00070007) & 0x00080008
    return ((mag & (live * 0x1FFF)) | ((nib & 0x00080008) << 12)) & 0xFFFFFFFF


def test_mxfp4_pair_decode_every_byte():
    """Both nibbles of every byte at every exponent the pack writes, in both
    pairings (one byte's two nibbles: the decode body; the same nibble of
    two columns: the prefill body), against dequant_mxfp4's bits."""
    byte = np.arange(256, dtype=np.uint64)[:, None]
    sexp = np.arange(1, 252, dtype=np.uint64)[None, :]
    qs = torch.from_numpy(np.tile(np.arange(256, dtype=np.uint8)[:, None], (1, 251)))
    sx = torch.from_numpy(np.tile(np.arange(1, 252, dtype=np.uint8)[None, :], (256 // 16, 1)))
    ref = (mx.dequant_mxfp4(qs, sx).numpy().view(np.uint32) >> 16).reshape(256, 2, 251)
    one = _fp4x2_bf16((byte & 0xF) | ((byte & 0xF0) << 12), sexp * 0x00010001)
    np.testing.assert_array_equal(one & 0xFFFF, ref[:, 0])
    np.testing.assert_array_equal(one >> 16, ref[:, 1])
    # two columns: byte b (exponent s) beside byte 255 - b (exponent 252 - s)
    x = byte | ((255 - byte) << 16)
    s2 = sexp | ((252 - sexp) << 16)
    lo, hi = _fp4x2_bf16(x & 0x000F000F, s2), _fp4x2_bf16((x >> 4) & 0x000F000F, s2)
    np.testing.assert_array_equal(lo & 0xFFFF, ref[:, 0])
    np.testing.assert_array_equal(hi & 0xFFFF, ref[:, 1])
    np.testing.assert_array_equal(lo >> 16, ref[::-1, 0, ::-1])
    np.testing.assert_array_equal(hi >> 16, ref[::-1, 1, ::-1])


def _f16(bits) -> np.ndarray:
    return np.asarray(bits, np.uint16).view(np.float16).astype(np.float64)


def test_i8p_half_decode_every_code_and_ratio():
    """csrc/tcq4_i8p.cu decode_part: 1024 + u (u = nibble ^ 8) less 1032 is
    w4 (a low nibble), and so is a quarter of 256 + 4u less 72 (a high one,
    in place in bits 4-7); 1024 + (f + 128) less 1152 is f; fma(w4, f, 0.5) is exact and
    fma(t, 1/8, 1536), rounded once to the nearest half, is 1536 + w8 (the
    fraction of (w4 f + 0.5) / 8 is never one half), whose low byte is w8 as
    decode_w8 gives it, for every nibble and every f8 byte."""
    nib = np.arange(16, dtype=np.uint16)[:, None]
    f8_bytes = np.arange(-127, 128).astype(np.int8).view(np.uint8).astype(np.uint16)[None, :]
    w4 = _f16(0x6400 | (nib ^ 8)) - 1032
    np.testing.assert_array_equal(_f16(0x5C00 | ((nib ^ 8) << 4)) * 0.25 - 72, w4)
    f = _f16(0x6400 | (f8_bytes ^ 0x80)) - 1152
    np.testing.assert_array_equal(f[0], np.arange(-127, 128))
    t = w4 * f + 0.5
    assert np.all(np.float16(t).astype(np.float64) == t)
    z = np.float16(t / 8 + 1536)                  # the exact value, rounded once
    got = (z.view(np.uint16) & 0xFF).astype(np.uint8).view(np.int8)
    qs = torch.from_numpy(np.repeat(np.arange(16, dtype=np.uint8)[:, None] * 0x11,
                                    8, axis=0).reshape(128, 1).repeat(255, axis=1))
    f8 = torch.from_numpy(np.tile(np.arange(-127, 128, dtype=np.int8)[None, :], (8, 1)))
    ref = tm.decode_w8(qs, f8)[:128:8].numpy()    # row 8i: nibble i, every f
    np.testing.assert_array_equal(got.reshape(16, 255), ref.astype(np.int8))


def test_profile_labels_name_the_new_kernels():
    """chip_smoke.py's decode and prefill profiles attribute B11's two sm90
    bodies (MXFP4 loader), B5's kernel and B13's expert grid (the prefill
    body's experts_kernel on the same loader) to their own kernels, and B2 /
    B4 as before."""
    import chip_smoke

    label = chip_smoke.kernel_label
    anon = "(anonymous namespace)"
    assert label(f"void rrs::sm90::gemm_kernel<{anon}::MXFP4<__nv_bfloat16>, 128, float>"
                 f"(...)") == "mxfp4_matmul"
    assert label(f"void rrs::sm90::splitk_kernel<{anon}::MXFP4<float>, 1>(...)") \
        == "mxfp4_matmul"
    assert label(f"void {anon}::i8p_sm90_kernel<__nv_bfloat16>({anon}::Args, ...)") \
        == "tcq4_matmul_i8p"
    assert label(f"void rrs::sm90::experts_kernel<{anon}::MXFP4<__nv_bfloat16>, 64>"
                 f"({anon}::MXFP4<__nv_bfloat16>::Params, ...)") == "mxfp4_matmul_all_experts"
    assert label(f"void rrs::sm90::gemm_kernel<{anon}::TCQ4<__nv_bfloat16, __nv_bfloat16>, "
                 f"128, float>(...)") == "tcq4_matmul"
    assert label(f"void rrs::sm90::splitk_kernel<{anon}::Q8<float>, 2>(...)") == "q8_matmul"
