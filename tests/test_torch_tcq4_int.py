"""The integer decode kernels of rrs_tpu_torch against rrs_tpu: gx (B14) on
pre-quantized activations, gx3 (B15) with the Hadamard rotation fused, a8
(B16) on the tensor cores, through their plain versions (which the CUDA
kernels are held against on the card), with the JAX kernels in interpret
mode and the integer oracle ``tcq4_matmul_ref``; the pre-quantized route and
the ``RRS_GX3`` switch of ``linear_apply``. The limits are the JAX tests' own
(tests/test_tcq4_matmul.py): rel 1e-5 of the oracle for gx, atol 1e-4 for
gx3 against rotate(HIGHEST) + gx2, rtol = atol = 1e-6 for a8."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats import tcq4 as jtcq4
from rrs_tpu.formats.fwht import fwht_np, hadamard_matrix
from rrs_tpu.models import linear as jlinear
from rrs_tpu.ops import tcq4_matmul as jmm
from rrs_tpu_torch import kernels
from rrs_tpu_torch.formats import tcq4 as ttcq4
from rrs_tpu_torch.models import linear as tlinear
from rrs_tpu_torch.ops import tcq4_matmul as tmm

from test_torch_common import rel_err


def _t(a):
    a = np.array(a, order="C")          # a writable copy (JAX hands out read-only views)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _quantized(n, k, seed):
    """A TCQ4 weight (qs, f32 eff, bf16 eff) from the JAX quantizer."""
    rng = np.random.default_rng(seed)
    t = jtcq4.quantize_tcq4((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    eff32 = jtcq4.effective_scales(t).astype(np.float32)
    return t.qs, eff32, np.asarray(jnp.asarray(eff32, jnp.bfloat16))


def _codes(m, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-7, 8, (m, k)).astype(np.int8),
            (rng.random((m, k // 256)) + 0.5).astype(np.float32))


@pytest.mark.parametrize("m,k,n,bk", [(1, 512, 256, 256), (4, 512, 256, 256),
                                      (1, 5120, 128, 0)])
def test_gx_plain_matches_jax_kernel_and_oracle(m, k, n, bk):
    qs, _, effb = _quantized(n, k, seed=m + k)
    a_q, a_s = _codes(m, k, seed=3 * m + k)
    got = tmm.tcq4_matmul_gx(_t(a_q), _t(a_s), _t(qs), _t(effb)).numpy()
    kw = {"bk": bk} if bk else {}
    jgot = np.asarray(jmm.tcq4_matmul_gx(jnp.asarray(a_q), jnp.asarray(a_s), jnp.asarray(qs),
                                         jnp.asarray(effb), interpret=True, **kw))
    ref = np.asarray(jmm.tcq4_matmul_ref(a_q, a_s, qs, np.asarray(effb, np.float32)))
    assert rel_err(got, ref) < 1e-5
    assert rel_err(got, jgot) < 1e-5
    # f32 eff takes the same arithmetic
    got32 = tmm.tcq4_matmul_gx(_t(a_q), _t(a_s), _t(qs),
                               torch.from_numpy(np.asarray(effb, np.float32))).numpy()
    np.testing.assert_array_equal(got32, got)


def test_gx_on_gx2_codes_is_gx2():
    """Given gx2's own codes and absmax, gx computes gx2's product bit for bit
    (the kernels share one body; the card holds the same)."""
    qs, _, effb = _quantized(256, 1024, seed=9)
    a = torch.from_numpy(np.random.default_rng(9).standard_normal((3, 1024)).astype(np.float32))
    a_q, a_s = ttcq4.quantize_activations_rrs(a)
    np.testing.assert_array_equal(tmm.tcq4_matmul_gx(a_q, a_s, _t(qs), _t(effb)).numpy(),
                                  tmm.tcq4_matmul_gx2(a, _t(qs), _t(effb)).numpy())


def test_fwht256_is_the_sylvester_transform():
    x = np.random.default_rng(4).standard_normal((3, 768)).astype(np.float32)
    got = tmm.fwht256(torch.from_numpy(x)).numpy()
    # f32 butterfly against the f64 oracle: 8 rounded add stages of |x| ~ 16
    np.testing.assert_allclose(got, fwht_np(x.reshape(3, 3, 256)).reshape(3, 768),
                               rtol=0, atol=1e-5)
    via_matrix = (x.reshape(3, 3, 256).astype(np.float64) @ hadamard_matrix(256)).reshape(3, 768)
    np.testing.assert_allclose(got, via_matrix, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m", [1, 8])
def test_gx3_plain_matches_jax_kernel(m):
    k, n = 512, 256
    rng = np.random.default_rng(2 + m)
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    eff = (rng.random((k // 32, n)) * 0.02).astype(np.float32)
    effb = np.asarray(jnp.asarray(eff, jnp.bfloat16))
    x = rng.standard_normal((m, k)).astype(np.float32)
    got = tmm.tcq4_matmul_gx3(torch.from_numpy(x), _t(qs), _t(effb)).numpy()
    had = jnp.asarray(hadamard_matrix(256), jnp.float32)
    jgot = np.asarray(jmm.tcq4_matmul_gx3(jnp.asarray(x), had, jnp.asarray(qs),
                                          jnp.asarray(effb), interpret=True))
    np.testing.assert_allclose(got, jgot, atol=1e-4)
    rot = jlinear.rotate_activations(jnp.asarray(x), None, precision=jax.lax.Precision.HIGHEST)
    want = np.asarray(jmm.tcq4_matmul_gx2(rot, jnp.asarray(qs), jnp.asarray(effb),
                                          interpret=True))
    np.testing.assert_allclose(got, want, atol=1e-4)
    # a bf16 x is converted exactly
    xb = torch.from_numpy(x).to(torch.bfloat16)
    np.testing.assert_array_equal(tmm.tcq4_matmul_gx3(xb, _t(qs), _t(effb)).numpy(),
                                  tmm.tcq4_matmul_gx3(xb.float(), _t(qs), _t(effb)).numpy())


@pytest.mark.parametrize("m,k,n", [(3, 512, 256), (1, 1024, 128), (32, 512, 128)])
def test_a8_plain_matches_jax_kernel_and_oracle(m, k, n):
    rng = np.random.default_rng(11 + m)
    a_q, a_s = _codes(m, k, seed=11 * m)
    qs = rng.integers(0, 256, (k // 2, n), dtype=np.uint8)
    eff = (rng.random((k // 32, n), dtype=np.float32) * 0.02 + 1e-3)
    got = tmm.tcq4_matmul_a8(_t(a_q), _t(a_s), _t(qs), _t(eff)).numpy()
    ref = np.asarray(jmm.tcq4_matmul_ref(a_q, a_s, qs, eff))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    jgot = np.asarray(jmm.tcq4_matmul_a8(jnp.asarray(a_q), jnp.asarray(a_s), jnp.asarray(qs),
                                         jnp.asarray(eff), bn=128, interpret=True))
    np.testing.assert_allclose(got, jgot, rtol=1e-6, atol=1e-6)
    port_ref = tmm.tcq4_matmul_ref(_t(a_q), _t(a_s), _t(qs), _t(eff)).numpy()
    np.testing.assert_allclose(got, port_ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("m", [1, 20])
def test_prequantized_route_matches_jax(m):
    """``_tcq4_matmul_route``: gx at decode M, the dequant kernel above."""
    k, n = 512, 256
    qs, eff32, effb = _quantized(n, k, seed=30 + m)
    a_q, a_s = _codes(m, k, seed=31 + m)
    got = tlinear._tcq4_matmul_route(_t(a_q), _t(a_s), _t(qs), _t(effb)).float().numpy()
    ref = np.asarray(jlinear._tcq4_matmul_route(jnp.asarray(a_q), jnp.asarray(a_s),
                                                jnp.asarray(qs), jnp.asarray(effb)), np.float32)
    # gx is integer-exact; the dequant route rounds its operands to bf16
    assert rel_err(got, ref) < (1e-5 if m == 1 else 2e-2)


@pytest.mark.parametrize("perm", [False, True])
def test_gx3_flag_changes_nothing_on_the_cpu(perm, monkeypatch):
    """JAX takes gx3 only off the CPU (rrs_tpu/models/linear.py:377); with
    RRS_GX3=1 both packages' CPU linears keep the rotate + gx2 route."""
    k, n = 512, 256
    rng = np.random.default_rng(50)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    p = np.concatenate([rng.permutation(256) + 256 * b for b in range(2)]) if perm else None
    jl = jlinear.TCQ4Linear.from_tensor(jtcq4.quantize_tcq4(w, perm=p))
    tl = tlinear.TCQ4Linear(qs=_t(np.asarray(jl.qs)), eff=_t(np.asarray(jl.eff)),
                            gather=None if p is None else torch.from_numpy(p % 256))
    x = rng.standard_normal((1, 1, k)).astype(np.float32)
    off = tlinear.linear_apply(tl, torch.from_numpy(x)).numpy()
    monkeypatch.setenv("RRS_GX3", "1")
    assert tlinear._gx3_on() and jlinear._gx3_on()
    on = tlinear.linear_apply(tl, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(on, off)
    ref = np.asarray(jlinear.linear_apply(jl, jnp.asarray(x)))
    assert rel_err(on, ref) < 1e-5


def test_wrappers_raise_outside_their_gates():
    qs = torch.zeros((128, 64), dtype=torch.uint8)
    eff = torch.ones((8, 64), dtype=torch.bfloat16)
    big_qs = torch.zeros((9728 // 2, 64), dtype=torch.uint8)
    big_eff = torch.ones((9728 // 32, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="gx_viable"):
        tmm.tcq4_matmul_gx(torch.zeros((9, 256), dtype=torch.int8), torch.ones((9, 1)), qs, eff)
    with pytest.raises(ValueError, match="gx_viable"):
        tmm.tcq4_matmul_gx(torch.zeros((2, 9728), dtype=torch.int8), torch.ones((2, 38)),
                           big_qs, big_eff)
    with pytest.raises(ValueError, match="gx_viable"):
        tmm.tcq4_matmul_gx3(torch.zeros((9, 256)), qs, eff)
    with pytest.raises(ValueError, match="gx_viable"):
        tmm.tcq4_matmul_gx3(torch.zeros((2, 9728)), big_qs, big_eff)
    with pytest.raises(ValueError, match="1..32"):
        tmm.tcq4_matmul_a8(torch.zeros((33, 256), dtype=torch.int8), torch.ones((33, 1)), qs,
                           eff.float())
    with pytest.raises(ValueError, match="a_scale"):
        tmm.tcq4_matmul_gx(torch.zeros((1, 256), dtype=torch.int8), torch.ones((1, 2)), qs, eff)
    assert tmm.A8_MAX_M == jmm.A8_MAX_M


def test_cpu_calls_launch_nothing():
    before = dict(kernels.LAUNCHES)
    qs, _, effb = _quantized(64, 256, seed=1)
    a_q, a_s = _codes(2, 256, seed=1)
    tmm.tcq4_matmul_gx(_t(a_q), _t(a_s), _t(qs), _t(effb))
    tmm.tcq4_matmul_gx3(torch.randn(2, 256), _t(qs), _t(effb))
    tmm.tcq4_matmul_a8(_t(a_q), _t(a_s), _t(qs), torch.from_numpy(np.asarray(effb, np.float32)))
    assert kernels.LAUNCHES == before
    assert {"tcq4_matmul_gx", "tcq4_matmul_gx3", "tcq4_matmul_a8"} <= set(kernels.LAUNCHES)
    assert {"rrs_tcq4_gx", "rrs_tcq4_gx3", "rrs_tcq4_a8"} <= set(kernels.SIGNATURES)
