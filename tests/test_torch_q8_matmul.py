"""Q8_0 matmul of rrs_tpu_torch against rrs_tpu's oracle, including the
N padding policy and the n_logical slice of the lm_head."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models import linear as jlinear
from rrs_tpu.ops.q8_matmul import q8_matmul_ref as jq8_ref
from rrs_tpu_torch.models import linear as tlinear
from rrs_tpu_torch.ops import q8_matmul as tq8


def _case(m, k, n, seed):
    """Q8_0 codes of an N(0, 0.05) weight, as tests/test_q8_matmul.py makes them."""
    rng = np.random.default_rng(seed)
    lin = jlinear.Q8Linear.quantize((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    a = rng.standard_normal((m, k)).astype(np.float32)
    q = np.ascontiguousarray(np.asarray(lin.q)[:, :n])
    s = np.ascontiguousarray(np.asarray(lin.scale)[:, :n])
    return a, q, s


@pytest.mark.parametrize("m,k,n", [(1, 256, 128), (8, 512, 256), (37, 256, 384)])
def test_q8_matmul_matches_jax_oracle(m, k, n):
    a, q, s = _case(m, k, n, seed=m + n)
    ref = np.asarray(jq8_ref(jnp.asarray(a), jnp.asarray(q), jnp.asarray(s)))
    got = tq8.q8_matmul(torch.from_numpy(a), torch.from_numpy(q), torch.from_numpy(s)).numpy()
    # the JAX package's own kernel-vs-oracle tolerance (bf16 operands)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=1e-2)
    port_ref = tq8.q8_matmul_ref(torch.from_numpy(a), torch.from_numpy(q),
                                 torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(port_ref, ref, rtol=1e-5, atol=1e-5)


def test_q8_matmul_bf16_activations():
    a, q, s = _case(4, 256, 128, seed=3)
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    ref = np.asarray(jq8_ref(jnp.asarray(a16.float().numpy()), jnp.asarray(q), jnp.asarray(s)))
    got = tq8.q8_matmul(a16, torch.from_numpy(q), torch.from_numpy(s)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=1e-2)


@pytest.mark.parametrize("n_logical,k", [(300, 256), (9000, 256), (200, 288)])
def test_q8_linear_padding_and_slice(n_logical, k):
    """Q8Linear.quantize pads N (128, or 2048 past 8192) and K (to 256) like
    the JAX package; linear_apply slices back to n_logical."""
    rng = np.random.default_rng(n_logical)
    w = (rng.standard_normal((n_logical, k)) * 0.05).astype(np.float32)
    jl = jlinear.Q8Linear.quantize(w)
    tl = tlinear.Q8Linear.quantize(w)
    np.testing.assert_array_equal(tl.q.numpy(), np.asarray(jl.q))
    np.testing.assert_array_equal(tl.scale.numpy(), np.asarray(jl.scale))
    assert (tl.n_logical, tl.k_logical) == (jl.n_logical, jl.k_logical)
    assert tl.q.shape[1] == tlinear.n_pad_width(n_logical) == jlinear.n_pad_width(n_logical)
    x = rng.standard_normal((1, 3, k)).astype(np.float32)
    ref = np.asarray(jlinear.linear_apply(jl, jnp.asarray(x)))
    got = tlinear.linear_apply(tl, torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (1, 3, n_logical)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=1e-2)
