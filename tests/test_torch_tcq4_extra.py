"""The last three TCQ4 kernels' plain versions against rrs_tpu, whose kernels
run in interpret mode as the JAX package's own tests run them, on the same
NumPy inputs: ``tcq4_matmul_fused`` (B17), ``tcq4_matmul_pb`` with
``pack_gi`` and ``pb_prepare`` (B18) and ``tcq4_matmul_experts`` (B19); and
the wrappers' shape and type checks. No model path calls these kernels, in
either package.

Tolerances, relative to the largest output:
- B17 1e-5: the plain rotation sums j = 0 ... 255 in turn (the kernel's
  order) and JAX's interpret dot in its own order, so the f32 rotations differ
  in their last bits; with these seeds no int4 code sits close enough to a
  half-way point to flip, and the rest is the order of the f32 sums of the
  bf16 dot. Against the port's rotate-quantize-B4 pipeline, JAX's own 2e-2
  (tests/test_tcq4_matmul.py:133).
- B18 1e-5 at M = 4 and 16, where JAX's interpret mode rounds each
  (q + 24) * e product to bf16 as the TPU does; the integer oracle 2e-2 at
  every M (the bf16 products). At M = 1 JAX's interpret mode keeps those
  products in f32 (so the JAX test allows only 3e-3 there); the port rounds
  them as the chip does at every M, and the test asserts both the
  departure and its cause.
- B19 1e-5: bf16 operands, exact products, f32 sums in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats.fwht import hadamard_matrix
from rrs_tpu.formats.tcq4 import dequantize_activations_rrs as jax_dequant_act
from rrs_tpu.formats.tcq4 import effective_scales, quantize_tcq4
from rrs_tpu.ops import tcq4_matmul as jax_tm
from rrs_tpu_torch.formats.tcq4 import dequantize_activations_rrs, quantize_activations_rrs
from rrs_tpu_torch.models.linear import rotate_activations
from rrs_tpu_torch.ops import tcq4_matmul as tm

from test_torch_common import rel_err

TOL = 1e-5
JAX_DEQUANT_TOL = 2e-2       # the bf16 dequant path in tests/test_tcq4_matmul.py


def _bf16_torch(x: np.ndarray) -> torch.Tensor:
    """A bf16 NumPy array (from JAX) as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.asarray(x).view(np.uint16).copy()).view(torch.bfloat16)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy().view(np.uint16)


def _weights(rng, k, n):
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    eff = (rng.random((k // 32, n), dtype=np.float32) * 0.02 + 1e-3)
    return qs, eff


def _eff_pair(eff: np.ndarray, kind: str):
    """(the JAX operand, the torch operand) for an f32 or bf16 eff."""
    if kind == "f32":
        return jnp.asarray(eff), torch.from_numpy(eff)
    jb = jnp.asarray(eff, jnp.bfloat16)
    return jb, _bf16_torch(np.asarray(jb))


def _x_pair(x: np.ndarray, kind: str):
    if kind == "f32":
        return jnp.asarray(x), torch.from_numpy(x)
    jb = jnp.asarray(x, jnp.bfloat16)
    return jb, _bf16_torch(np.asarray(jb))


HAD = hadamard_matrix(256).astype(np.float32)


# ---------------------------------------------------------------------------
# B17 tcq4_matmul_fused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_kind", ["f32", "bf16"])
@pytest.mark.parametrize("eff_kind", ["f32", "bf16"])
@pytest.mark.parametrize("k", [512, 1024])
@pytest.mark.parametrize("m", [1, 3, 16])
def test_fused_plain_matches_jax(m, k, eff_kind, x_kind):
    rng = np.random.default_rng(100 * m + k // 256)
    n = 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    qs, eff = _weights(rng, k, n)
    jx, tx = _x_pair(x, x_kind)
    je, te = _eff_pair(eff, eff_kind)
    ref = np.asarray(jax_tm.tcq4_matmul_fused(jx, jnp.asarray(HAD), jnp.asarray(qs), je,
                                              bn=128, interpret=True))
    got = tm.tcq4_matmul_fused(tx, torch.from_numpy(HAD), torch.from_numpy(qs), te)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert rel_err(got.numpy(), ref) < TOL


def test_fused_plain_matches_jax_with_any_had():
    """had is any f32 [256, 256], not only the Hadamard matrix."""
    rng = np.random.default_rng(5)
    m, k, n = 4, 512, 128
    had = (rng.standard_normal((256, 256)) / 16).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    qs, eff = _weights(rng, k, n)
    ref = np.asarray(jax_tm.tcq4_matmul_fused(jnp.asarray(x), jnp.asarray(had), jnp.asarray(qs),
                                              jnp.asarray(eff), bn=128, interpret=True))
    got = tm.tcq4_matmul_fused(torch.from_numpy(x), torch.from_numpy(had),
                               torch.from_numpy(qs), torch.from_numpy(eff))
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("m", [3, 16])
def test_fused_plain_matches_rotate_quantize_pipeline(m):
    """The port's own pipeline (rotation matmul, activation quantizer, B4's
    plain version) within JAX's bound for its fused kernel against its
    pipeline (tests/test_tcq4_matmul.py:104-133)."""
    rng = np.random.default_rng(21 + m)
    k, n = 512, 128
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    qs, eff = (torch.from_numpy(v) for v in _weights(rng, k, n))
    a = dequantize_activations_rrs(*quantize_activations_rrs(rotate_activations(x, None)))
    want = tm.tcq4_matmul_plain(a, qs, eff)
    got = tm.tcq4_matmul_fused(x, torch.from_numpy(HAD), qs, eff)
    assert rel_err(got.numpy(), want.numpy()) < JAX_DEQUANT_TOL


def test_fused_codes_are_the_quantizer_on_the_ordered_rotation():
    """The fused codes are the activation quantizer's, bit for bit, on the
    ordered rotation; the ordered rotation is the matrix product up to f32
    rounding; and its dequantized activations fed to B4's plain version give
    the fused plain output bit for bit (the card's B17 / B4 identity)."""
    rng = np.random.default_rng(9)
    m, k, n = 5, 768, 64
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    had = torch.from_numpy(HAD)
    rot = tm.fused_rotate(x, had).reshape(m, k)
    assert rel_err(rot.numpy(), (x.reshape(m, 3, 256) @ had).reshape(m, k).numpy()) < 1e-6
    q, amax = tm.fused_codes(x, had)
    a_q, a_s = quantize_activations_rrs(rot)
    assert torch.equal(q, a_q.to(torch.float32)) and torch.equal(amax, a_s)
    a = tm.fused_activations(x, had)
    assert torch.equal(a, dequantize_activations_rrs(a_q, a_s))
    qs, eff = (torch.from_numpy(v) for v in _weights(rng, k, n))
    assert torch.equal(tm.tcq4_matmul_plain(a, qs, eff), tm.tcq4_matmul_fused(x, had, qs, eff))


# ---------------------------------------------------------------------------
# B18 tcq4_matmul_pb
# ---------------------------------------------------------------------------

def _pb_case(seed, m, k=1024, n=256):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    t = quantize_tcq4(w)
    eff_b = np.asarray(jnp.asarray(effective_scales(t).astype(np.float32), jnp.bfloat16))
    a_q = rng.integers(-7, 8, (m, k)).astype(np.int8)
    a_s = (rng.random((m, k // 256)) + 0.5).astype(np.float32)
    a = np.asarray(jax_dequant_act(jnp.asarray(a_q), jnp.asarray(a_s)))
    return t.qs, eff_b, a_q, a_s, a


@pytest.mark.parametrize("k,n", [(512, 128), (1024, 256), (2560, 64)])
def test_pack_gi_matches_jax(k, n):
    """Byte-equal to both JAX repacks."""
    rng = np.random.default_rng(k + n)
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    got = tm.pack_gi(torch.from_numpy(qs))
    assert got.dtype == torch.uint8 and got.shape == (k // 2, n)
    np.testing.assert_array_equal(got.numpy(), jax_tm.pack_gi_np(qs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_tm.pack_gi_jnp(jnp.asarray(qs))))


@pytest.mark.parametrize("m", [1, 4, 16])
def test_pb_prepare_matches_jax(m):
    """a_gi and ag24 bit-equal (the 32-element group sums land on the same
    f32 in both packages at these inputs, so hi and lo agree bit for bit)."""
    a = _pb_case(3 + m, m)[4]
    ja_gi, jag24 = jax_tm.pb_prepare(jnp.asarray(a))
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    assert a_gi.dtype == ag24.dtype == torch.bfloat16 and ag24.shape == (m, 2 * 1024 // 32)
    np.testing.assert_array_equal(_bits(a_gi), np.asarray(ja_gi).view(np.uint16))
    np.testing.assert_array_equal(_bits(ag24), np.asarray(jag24).view(np.uint16))


@pytest.mark.parametrize("chunks", ["2G-deep chunks", "one chunk"])
@pytest.mark.parametrize("m", [4, 16])
def test_pb_plain_matches_jax(m, chunks):
    qs, eff_b, _, _, a = _pb_case(11 + m, m)
    g = 1024 // 32
    ja_gi, jag24 = jax_tm.pb_prepare(jnp.asarray(a))
    ref = np.asarray(jax_tm.tcq4_matmul_pb(
        ja_gi, jag24, jnp.asarray(jax_tm.pack_gi_np(qs)), jnp.asarray(eff_b), bn=128,
        bk=2 * g if chunks == "2G-deep chunks" else 1024, interpret=True))
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    got = tm.tcq4_matmul_pb(a_gi, ag24, tm.pack_gi(torch.from_numpy(qs)), _bf16_torch(eff_b))
    assert got.dtype == torch.float32 and got.shape == (m, 256)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("m", [1, 4, 16])
def test_pb_plain_matches_oracle(m):
    qs, eff_b, a_q, a_s, a = _pb_case(40 + m, m)
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    got = tm.tcq4_matmul_pb(a_gi, ag24, tm.pack_gi(torch.from_numpy(qs)), _bf16_torch(eff_b))
    ref = tm.tcq4_matmul_ref(torch.from_numpy(a_q), torch.from_numpy(a_s), torch.from_numpy(qs),
                             torch.from_numpy(eff_b.astype(np.float32)))
    assert rel_err(got.numpy(), ref.numpy()) < JAX_DEQUANT_TOL


def test_pb_at_m1_jax_interpret_keeps_f32_products():
    """At M = 1 JAX's interpret mode (bm = 1) keeps each (q + 24) * e product
    in f32, though the kernel declares it bf16 and the TPU rounds it; the
    port rounds it at every M. So the plain version departs from JAX there by
    about 1e-2 of the largest output, and the same arithmetic with f32
    products matches JAX within TOL."""
    qs, eff_b, _, _, a = _pb_case(11, 1)
    g = 1024 // 32
    ja_gi, jag24 = jax_tm.pb_prepare(jnp.asarray(a))
    ref = np.asarray(jax_tm.tcq4_matmul_pb(
        ja_gi, jag24, jnp.asarray(jax_tm.pack_gi_np(qs)), jnp.asarray(eff_b), bn=128, bk=2 * g,
        interpret=True))
    a_gi, ag24 = tm.pb_prepare(torch.from_numpy(a.copy()))
    qs_gi, eff = tm.pack_gi(torch.from_numpy(qs)), _bf16_torch(eff_b)
    got = tm.tcq4_matmul_pb(a_gi, ag24, qs_gi, eff)
    assert 1e-3 < rel_err(got.numpy(), ref) < JAX_DEQUANT_TOL
    codes = torch.stack([qs_gi & 15, qs_gi >> 4], dim=1).reshape(1024, 256)
    w32 = ((codes ^ 8).float() + 16.0) * eff.float().repeat(32, 1)        # f32 products
    f32_products = -(ag24.float() @ torch.cat([eff, eff]).float()) + a_gi.float() @ w32
    assert rel_err(f32_products.numpy(), ref) < TOL


# ---------------------------------------------------------------------------
# B19 tcq4_matmul_experts
# ---------------------------------------------------------------------------

def _stacks(rng, n_exp, k, n):
    qs = rng.integers(0, 256, (n_exp, k // 2, n), dtype=np.uint8)
    eff = (rng.random((n_exp, k // 32, n), dtype=np.float32) * 0.01 + 1e-3)
    return qs, eff


IDS = np.array([3, 0, 3, 4], np.int32)


@pytest.mark.parametrize("eff_kind", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 2, 9])
def test_experts_plain_matches_jax(m, eff_kind):
    """Shared rows against each selected expert, with a repeated id and
    experts no id selects."""
    rng = np.random.default_rng(5 + m)
    k, n = 512, 256
    qs, eff = _stacks(rng, 5, k, n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    je, te = _eff_pair(eff, eff_kind)
    ref = np.asarray(jax_tm.tcq4_matmul_experts(jnp.asarray(a), jnp.asarray(qs), je,
                                                jnp.asarray(IDS), interpret=True))
    got = tm.tcq4_matmul_experts(torch.from_numpy(a), torch.from_numpy(qs), te,
                                 torch.from_numpy(IDS).long())
    assert got.dtype == torch.float32 and got.shape == (IDS.size, m, n)
    assert rel_err(got.numpy(), ref) < TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_experts_diagonal_and_all_experts(dtype):
    """With M = n_sel rows, out[i, i] is B9's row i; and out[i] is B10's
    out[ids[i]] over the same shared rows (bf16 eff), as on the card."""
    rng = np.random.default_rng(2)
    k, n = 512, 128
    qs, eff = _stacks(rng, 5, k, n)
    qs_t, eff_t = torch.from_numpy(qs), _bf16_torch(np.asarray(jnp.asarray(eff, jnp.bfloat16)))
    a = torch.from_numpy(rng.standard_normal((IDS.size, k)).astype(np.float32)).to(dtype)
    ids = torch.from_numpy(IDS).long()
    out = tm.tcq4_matmul_experts(a, qs_t, eff_t, ids)
    diag = out[torch.arange(IDS.size), torch.arange(IDS.size)]
    rows = tm.tcq4_matmul_experts_rows(a, qs_t, eff_t, ids)
    assert rel_err(diag.numpy(), rows.numpy()) < TOL
    every = tm.tcq4_matmul_all_experts(a, qs_t, eff_t)
    assert rel_err(out.numpy(), every[ids].numpy()) < TOL


# ---------------------------------------------------------------------------
# The wrappers' checks (made before the CPU branch, so they run here)
# ---------------------------------------------------------------------------

def test_wrappers_check_shapes_types_and_m():
    rng = np.random.default_rng(1)
    k, n = 512, 64
    qs, eff = (torch.from_numpy(v) for v in _weights(rng, k, n))
    had = torch.from_numpy(HAD)
    x = torch.zeros((2, k))
    with pytest.raises(ValueError, match="had"):
        tm.tcq4_matmul_fused(x, had[:128], qs, eff)
    with pytest.raises(ValueError, match="M >= 1"):
        tm.tcq4_matmul_fused(torch.zeros((0, k)), had, qs, eff)
    with pytest.raises(ValueError, match="M >= 1"):
        tm.tcq4_matmul_fused(torch.zeros((1, 2, k)), had, qs, eff)
    with pytest.raises(ValueError, match="TCQ4 shapes"):
        tm.tcq4_matmul_fused(torch.zeros((2, 256)), had, qs, eff)
    with pytest.raises(TypeError, match="f32 or bf16 x"):
        tm.tcq4_matmul_fused(x.to(torch.float16), had, qs, eff)
    with pytest.raises(TypeError, match="f32 had"):
        tm.tcq4_matmul_fused(x, had.double(), qs, eff)

    a_gi, ag24 = tm.pb_prepare(x)
    qs_gi, eff_b = tm.pack_gi(qs), eff.to(torch.bfloat16)
    assert tuple(tm.tcq4_matmul_pb(a_gi, ag24, qs_gi, eff_b).shape) == (2, n)
    with pytest.raises(ValueError, match="ag24"):
        tm.tcq4_matmul_pb(a_gi, ag24[:, :8], qs_gi, eff_b)
    with pytest.raises(ValueError, match="shapes"):
        tm.tcq4_matmul_pb(a_gi[:0], ag24[:0], qs_gi, eff_b)
    with pytest.raises(ValueError, match="shapes"):
        tm.tcq4_matmul_pb(a_gi[:, :256], ag24, qs_gi, eff_b)
    with pytest.raises(TypeError, match="bf16 a_gi"):
        tm.tcq4_matmul_pb(a_gi.float(), ag24, qs_gi, eff_b)
    with pytest.raises(TypeError, match="bf16 eff"):
        tm.tcq4_matmul_pb(a_gi, ag24, qs_gi, eff)

    qs_all, eff_all = torch.stack([qs, qs]), torch.stack([eff, eff])
    ids = torch.tensor([1, 0, 1])
    assert tuple(tm.tcq4_matmul_experts(x, qs_all, eff_all, ids).shape) == (3, 2, n)
    with pytest.raises(ValueError, match="M >= 1"):
        tm.tcq4_matmul_experts(torch.zeros((2, 2, k)), qs_all, eff_all, ids)
    with pytest.raises(ValueError, match="ids"):
        tm.tcq4_matmul_experts(x, qs_all, eff_all, ids[None])
    with pytest.raises(ValueError, match="K a multiple of 256"):
        tm.tcq4_matmul_experts(torch.zeros((2, 256)), qs_all, eff_all, ids)
    with pytest.raises(TypeError, match="bf16 or f32 eff"):
        tm.tcq4_matmul_experts(x, qs_all, eff_all.double(), ids)
    with pytest.raises(TypeError, match="bf16 or f32 a"):
        tm.tcq4_matmul_experts(x.to(torch.float16), qs_all, eff_all, ids)


def test_no_model_path_reaches_the_three_kernels():
    """As in the JAX package, nothing in the port's models, runtime, serving
    or tools calls B17, B18 or B19; ``tools/gemm_ab.py``, which times kernels
    against an older tree and drives no model, is the one exception."""
    from pathlib import Path

    root = Path(tm.__file__).resolve().parent.parent
    names = ("tcq4_matmul_fused", "tcq4_matmul_pb", "tcq4_matmul_experts(")
    for sub in ("models", "runtime", "serving", "tools"):
        for path in (root / sub).rglob("*.py"):
            if path == root / "tools" / "gemm_ab.py":
                continue
            text = path.read_text()
            assert not any(name in text for name in names), path
