"""The plain-torch scans of the recurrent families against rrs_tpu's: Mamba's
``ssm_conv`` / ``ssm_scan`` / ``ssm_step`` and RWKV6's ``wkv6`` (none is a
TPU kernel; they are plain jnp there), and the norms around them
(``layer_norm``, the weightless ``rms_norm``).

Inputs are NumPy draws from a seed, handed to both packages. The tolerances
are JAX's own (tests/test_mamba.py, tests/test_rwkv.py): 2e-4 against the
float64 sequential oracles, 1e-4 for a chunked run against a whole one,
1e-5 for a decode step against a one-token scan and for the conv's state
carry. The port's log-step scan sums in another order than JAX's
associative scan; against JAX's own outputs it is held to the oracle's 2e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.ops import basic as jax_basic
from rrs_tpu.ops import rwkv as jax_rwkv
from rrs_tpu.ops import ssm as jax_ssm
from rrs_tpu_torch.ops import basic, rwkv, ssm

import test_torch_common  # noqa: F401  (one torch thread a worker)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scan_inputs(seed, b, t, d, n, h0_scale=0.1):
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32) * h0_scale
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    dt = rng.standard_normal((b, t, d)).astype(np.float32)
    a = -np.exp(rng.standard_normal((d, n)).astype(np.float32) * 0.3)
    bc = rng.standard_normal((b, t, n)).astype(np.float32)
    cc = rng.standard_normal((b, t, n)).astype(np.float32)
    return h0, x, dt, a, bc, cc


@pytest.mark.parametrize("t", [1, 9, 128], ids=["T=1", "T=9", "T=128"])
def test_ssm_scan_matches_oracle_and_jax(t):
    args = _scan_inputs(0, 2, t, 16, 8)
    y, h = ssm.ssm_scan(*_t(*args))
    y_ref, h_ref = jax_ssm.ssm_scan_ref(*args)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), h_ref, rtol=2e-4, atol=2e-4)
    y_j, h_j = jax.jit(jax_ssm.ssm_scan)(*map(jnp.asarray, args))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_j), rtol=2e-4, atol=2e-4)
    # the port's oracle is JAX's
    y_o, h_o = ssm.ssm_scan_ref(*args)
    np.testing.assert_array_equal(y_o, y_ref)
    np.testing.assert_array_equal(h_o, h_ref)


def test_ssm_scan_chunked_state_carry():
    """12 tokens at once == three 4-token scans carrying h (and the exact
    chunks of the context, 8 + 4)."""
    h0, x, dt, a, bc, cc = _scan_inputs(1, 1, 12, 8, 4, h0_scale=0.0)
    y_full, h_full = ssm.ssm_scan(*_t(h0, x, dt, a, bc, cc))
    for cuts in ((0, 4, 8, 12), (0, 8, 12)):
        h = torch.from_numpy(h0)
        ys = []
        for i, j in zip(cuts[:-1], cuts[1:]):
            y, h = ssm.ssm_scan(h, *_t(x[:, i:j], dt[:, i:j], a, bc[:, i:j], cc[:, i:j]))
            ys.append(y)
        np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(h.numpy(), h_full.numpy(), rtol=1e-4, atol=1e-4)


def test_ssm_step_matches_scan_and_jax():
    h0, x, dt, a, bc, cc = _scan_inputs(2, 2, 1, 8, 4)
    y1, h1 = ssm.ssm_scan(*_t(h0, x, dt, a, bc, cc))
    y2, h2 = ssm.ssm_step(*_t(h0, x[:, 0], dt[:, 0], a, bc[:, 0], cc[:, 0]))
    np.testing.assert_allclose(y1[:, 0].numpy(), y2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h1.numpy(), h2.numpy(), rtol=1e-5, atol=1e-5)
    y_j, h_j = jax_ssm.ssm_step(*map(jnp.asarray, (h0, x[:, 0], dt[:, 0], a, bc[:, 0],
                                                   cc[:, 0])))
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ssm_conv_matches_jax_and_carries_state(dtype):
    """JAX's conv on the same inputs (a bf16 state keeps its dtype), and 10
    tokens at once == chunks of 5 carrying the state."""
    rng = np.random.default_rng(3)
    b, t, d, k = 2, 10, 8, 4
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    w = rng.standard_normal((k, d)).astype(np.float32)
    bias = rng.standard_normal((d,)).astype(np.float32)
    st0 = rng.standard_normal((b, k - 1, d)).astype(np.float32)
    tdt, jdt = (torch.float32, jnp.float32) if dtype == "f32" else (torch.bfloat16, jnp.bfloat16)
    xt, wt, bt, st = _t(x, w, bias, st0)
    y, new = ssm.ssm_conv(xt.to(tdt), st.to(tdt), wt, bt)
    y_j, new_j = jax_ssm.ssm_conv(jnp.asarray(x, jdt), jnp.asarray(st0, jdt), jnp.asarray(w),
                                  jnp.asarray(bias))
    assert y.dtype == torch.float32 and new.dtype == tdt
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(new.float().numpy(), np.asarray(new_j, np.float32))
    y_full, _ = ssm.ssm_conv(xt, st, wt, bt)
    ys, s = [], st
    for i in range(0, t, 5):
        yc, s = ssm.ssm_conv(xt[:, i:i + 5], s, wt, bt)
        ys.append(yc)
    np.testing.assert_allclose(torch.cat(ys, 1).numpy(), y_full.numpy(), rtol=1e-5, atol=1e-5)


def _wkv_inputs(seed, b, t, h, d, scale=0.5):
    rng = np.random.default_rng(seed)
    k, v, r = (rng.standard_normal((b, t, h, d)).astype(np.float32) * scale for _ in range(3))
    tf = rng.standard_normal((h, d)).astype(np.float32) * scale
    td = rng.random((b, t, h, d)).astype(np.float32) * 0.9
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32) * 0.1
    return k, v, r, tf, td, s0


def test_wkv6_matches_oracle_and_jax():
    args = _wkv_inputs(0, 2, 7, 3, 8)
    out, s1 = rwkv.wkv6(*_t(*args))
    out_ref, s_ref = jax_rwkv.wkv6_ref(*args)
    np.testing.assert_allclose(out.numpy(), out_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s1.numpy(), s_ref, rtol=2e-4, atol=2e-4)
    out_j, s_j = jax.jit(jax_rwkv.wkv6)(*map(jnp.asarray, args))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(s1.numpy(), np.asarray(s_j), rtol=2e-4, atol=2e-4)
    o2, s2 = rwkv.wkv6_ref(*args)
    np.testing.assert_array_equal(o2, out_ref)
    np.testing.assert_array_equal(s2, s_ref)


def test_wkv6_chunked_state_carry():
    k, v, r, tf, td, _ = _wkv_inputs(1, 1, 8, 2, 4, scale=0.3)
    s = torch.zeros((1, 2, 4, 4))
    full, s_full = rwkv.wkv6(*_t(k, v, r, tf, td), s)
    outs = []
    for i in range(0, 8, 4):
        o, s = rwkv.wkv6(*_t(k[:, i:i + 4], v[:, i:i + 4], r[:, i:i + 4], tf, td[:, i:i + 4]),
                         s)
        outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s.numpy(), s_full.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("affine", [True, False], ids=["affine", "bare"])
def test_layer_norm_matches_jax(affine):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32) if affine else None
    b = rng.standard_normal(64).astype(np.float32) if affine else None
    eps = 1e-5 if affine else 64e-5
    got = basic.layer_norm(torch.from_numpy(x).to(torch.bfloat16),
                           None if w is None else torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b), eps=eps)
    ref = jax_basic.layer_norm(jnp.asarray(x, jnp.bfloat16),
                               None if w is None else jnp.asarray(w),
                               None if b is None else jnp.asarray(b), eps=eps)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref, np.float32))


def test_weightless_rms_norm_is_the_norm_with_unit_weight():
    x = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 48)).astype(np.float32))
    np.testing.assert_array_equal(basic.rms_norm(x, None, 1e-5).numpy(),
                                  basic.rms_norm(x, torch.ones(48), 1e-5).numpy())
