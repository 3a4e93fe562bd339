"""TCQ4 numerics of rrs_tpu_torch against rrs_tpu: rotation, activation
quantization, the gx2 and dequant matmuls (plain versions, which the CUDA
kernels are held against on the card), and the route by M."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats.fwht import fwht_np
from rrs_tpu.formats import tcq4 as jtcq4
from rrs_tpu.models import linear as jlinear
from rrs_tpu.ops import tcq4_matmul as jmm
from rrs_tpu_torch.formats import tcq4 as ttcq4
from rrs_tpu_torch.models import linear as tlinear
from rrs_tpu_torch.ops import tcq4_matmul as tmm

from test_torch_common import rel_err


def _weights(n, k, seed):
    rng = np.random.default_rng(seed)
    t = jtcq4.quantize_tcq4((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    eff = np.asarray(jnp.asarray(jtcq4.effective_scales(t), jnp.bfloat16))
    return t, eff


def _t(a):
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@pytest.mark.parametrize("perm", [False, True])
def test_rotation_matches_fwht(perm):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 768)).astype(np.float32)
    gather = None
    xp = x
    if perm:
        p = np.concatenate([rng.permutation(256) + 256 * b for b in range(3)])
        gather = torch.from_numpy(p % 256)
        xp = x[:, p]
    ref = fwht_np(xp.reshape(3, 3, 256)).reshape(3, 768)
    got = tlinear.rotate_activations(torch.from_numpy(x), gather).numpy()
    # atol: f32 summation of 256 products of |x| / 16 (the oracle runs in f64)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_quantize_activations_bit_exact():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((5, 512)).astype(np.float32)
    x[1, :256] = 0.0                                   # amax < eps guard
    x[2, :256] = np.resize(np.array([7.0, 0.5, 1.5, 2.5, -0.5, -2.5], np.float32), 256)
    jq, js = jtcq4.quantize_activations_rrs(jnp.asarray(x))
    tq, ts = ttcq4.quantize_activations_rrs(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jd = jtcq4.dequantize_activations_rrs(jq, js)
    td = ttcq4.dequantize_activations_rrs(tq, ts)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_quantize_activations_bit_exact_at_half_way_points():
    """Values within an ulp of a code's half-way point: the scale 7 / amax
    must round as one true division (torch's ``7.0 / tensor`` is 7 * (1 /
    amax), which flips about 9% of these codes)."""
    rng = np.random.default_rng(7)
    nb = 64
    amax = (rng.random(nb) * 4 + 0.1).astype(np.float32)
    k = rng.integers(0, 7, (nb, 255)).astype(np.float32)
    x = ((k + 0.5) * (amax[:, None] / np.float32(7))).astype(np.float32)
    step = rng.choice([-1, 0, 1], x.shape).astype(np.float32)
    x = np.nextafter(x, x + step)                      # one ulp down, none or up
    x = np.concatenate([amax[:, None], x], 1).reshape(8, nb // 8 * 256)
    jq, js = jtcq4.quantize_activations_rrs(jnp.asarray(x))
    tq, ts = ttcq4.quantize_activations_rrs(torch.from_numpy(x))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def test_nibble_unpack_matches():
    t, _ = _weights(64, 512, 3)
    ref = jtcq4.unpack_nibbles(t.qs)
    np.testing.assert_array_equal(ttcq4.unpack_nibbles(t.qs), ref)
    np.testing.assert_array_equal(ttcq4.unpack_nibbles_torch(_t(t.qs)).numpy(), ref)


@pytest.mark.parametrize("m,k,n", [(1, 512, 256), (4, 512, 256), (1, 5120, 128)])
def test_gx2_plain_matches_oracle_and_jax_kernel(m, k, n):
    t, eff = _weights(n, k, seed=m + k)
    rng = np.random.default_rng(m * 7 + n)
    a = rng.standard_normal((m, k)).astype(np.float32)
    got = tmm.tcq4_matmul_gx2_plain(torch.from_numpy(a), _t(t.qs), _t(eff)).numpy()
    a_q, a_s = jtcq4.quantize_activations_rrs(jnp.asarray(a))
    effb = np.asarray(eff, np.float32)
    ref = jmm.tcq4_matmul_ref(a_q, a_s, t.qs, effb)
    assert rel_err(got, ref) < 1e-5
    port_ref = tmm.tcq4_matmul_ref(_t(np.asarray(a_q)), _t(np.asarray(a_s)), _t(t.qs),
                                   torch.from_numpy(effb)).numpy()
    assert rel_err(port_ref, ref) < 1e-6
    jgot = np.asarray(jmm.tcq4_matmul_gx2(jnp.asarray(a), jnp.asarray(t.qs),
                                          jnp.asarray(eff), interpret=True))
    assert rel_err(got, jgot) < 1e-5


@pytest.mark.parametrize("m,k,n", [(4, 256, 1024), (1, 512, 128), (3, 5120, 128)])
def test_gx2_plain_sums_in_jax_interpret_order(m, k, n):
    """ROADMAP C2: on the CPU the plain gx2 sums its groups as the JAX kernel
    in interpret mode does where a K chunk of ``_pick_bk_gx`` holds at most
    16 groups (a fused multiply-add chain per chunk, the chunks then added),
    so the two are the same bits.
    One group sum after another with each product rounded first, the order
    the port took before, parts from it in the last bit on about half of the
    outputs, which a bf16 output cast turns into a bf16 ulp."""
    from rrs_tpu.ops.tcq4_matmul import _pick_bk_gx

    assert all(tmm._gx_chunk(kk) == _pick_bk_gx(kk) for kk in range(256, 16384, 256))
    t, eff = _weights(n, k, seed=k + n)
    a = np.random.default_rng(m + k).standard_normal((m, k)).astype(np.float32)
    got = tmm.tcq4_matmul_gx2_plain(torch.from_numpy(a), _t(t.qs), _t(eff)).numpy()
    jgot = np.asarray(jmm.tcq4_matmul_gx2(jnp.asarray(a), jnp.asarray(t.qs), jnp.asarray(eff),
                                          interpret=True))
    np.testing.assert_array_equal(got, jgot)
    a_q, a_s = ttcq4.quantize_activations_rrs(torch.from_numpy(a))
    g = k // 32
    w = tmm.unpack_nibbles_torch(_t(t.qs)).float().reshape(g, 32, n)
    p = torch.bmm(a_q.float().reshape(m, g, 32).transpose(0, 1), w)
    s = (a_s * (1.0 / 7.0)).repeat_interleave(8, dim=1)
    rounded = (p * s.t()[:, :, None] * _t(eff).float()[:, None, :]).sum(0).numpy()
    assert (rounded != jgot).mean() > 0.1


@pytest.mark.parametrize("m,n,k", [(1, 128, 256), (8, 256, 512), (3, 128, 768), (20, 128, 512)])
def test_tcq4_matmul_exact_mode_matches_jax_kernel(m, n, k):
    t, _ = _weights(n, k, seed=m + n)
    eff32 = jtcq4.effective_scales(t).astype(np.float32)
    x_rot = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    a = np.asarray(jtcq4.dequantize_activations_rrs(*jtcq4.quantize_activations_rrs(
        jnp.asarray(x_rot))))
    ref = np.asarray(jmm.tcq4_matmul(jnp.asarray(a), jnp.asarray(t.qs), jnp.asarray(eff32),
                                     interpret=True, fast=False))
    got = tmm.tcq4_matmul_plain(torch.from_numpy(a), _t(t.qs), torch.from_numpy(eff32),
                                fast=False).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m", [4, 16, 64])
def test_tcq4_matmul_fast_mode_close_to_jax_kernel(m):
    n, k = 256, 512
    t, eff = _weights(n, k, seed=13 + m)
    x_rot = np.random.default_rng(m).standard_normal((m, k)).astype(np.float32)
    a = np.asarray(jtcq4.dequantize_activations_rrs(*jtcq4.quantize_activations_rrs(
        jnp.asarray(x_rot))))
    ref = np.asarray(jmm.tcq4_matmul(jnp.asarray(a), jnp.asarray(t.qs), jnp.asarray(eff),
                                     interpret=True, fast=True), np.float32)
    got = tmm.tcq4_matmul(torch.from_numpy(a), _t(t.qs), _t(eff)).float().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel   # bf16 operand rounding only (the JAX CPU path keeps f32 below M=8)


def test_gx_viable_routing_matches_jax():
    for m in range(1, 11):
        for k in (256, 2560, 4096, 5120, 8192, 9728, 12288):
            for n in (0, 2560, 19456):
                assert tmm.gx_viable(m, k, n) == jmm.gx_viable(m, k, n), (m, k, n)
    qwen3_4b = {"qkv": (2560, 6144), "o": (4096, 2560), "gate_up": (2560, 19456),
                "down": (9728, 2560)}
    assert all(tmm.gx_viable(1, k, n) for k, n in qwen3_4b.values())
    assert not tmm.gx_viable(2, 9728, 2560)          # M=2 down goes to tcq4_matmul
    assert tmm.gx_viable(2, 2560, 19456)
    assert not tmm.gx_viable(9, 256, 256)


def test_out_dtype_follows_padded_m():
    assert not tmm.tcq4_out_bf16(512)
    assert tmm.tcq4_out_bf16(1024) and tmm.tcq4_out_bf16(1000)   # 1000 pads to 1024
    assert not tmm.tcq4_out_bf16(5)


@pytest.mark.parametrize("m", [1, 20])
@pytest.mark.parametrize("perm", [False, True])
def test_tcq4_linear_apply_matches_jax(m, perm):
    """The whole TCQ4 linear (gather, rotation, route by M, kernel), including
    a block-local channel permutation."""
    k, n = 512, 256
    rng = np.random.default_rng(40 + m)
    w = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    p = np.concatenate([rng.permutation(256) + 256 * b for b in range(2)]) if perm else None
    t = jtcq4.quantize_tcq4(w, perm=p)
    jl = jlinear.TCQ4Linear.from_tensor(t)
    tl = tlinear.TCQ4Linear(qs=_t(np.asarray(jl.qs)), eff=_t(np.asarray(jl.eff)),
                            gather=None if p is None else torch.from_numpy(p % 256))
    x = rng.standard_normal((1, m, k)).astype(np.float32)
    ref = np.asarray(jlinear.linear_apply(jl, jnp.asarray(x)))
    got = tlinear.linear_apply(tl, torch.from_numpy(x)).numpy()
    # gx2 (M=1) is integer-exact; the prefill route rounds operands to bf16
    assert rel_err(got, ref) < (1e-5 if m == 1 else 2e-2)
