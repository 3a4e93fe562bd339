"""The host sampler chain of rrs_tpu_torch against rrs_tpu's: each logit
transform on the same seeded logits, greedy picks, and sampled draws that
stay inside the set the JAX chain keeps (the two packages draw from
different generators, so the draws themselves are not compared)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.runtime import sampler as js
from rrs_tpu_torch.runtime import sampler as ts

V = 500


def _logits(seed: int = 0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((3, V)) * 3).astype(np.float32)


TRANSFORMS = {
    "top_k": (lambda m, x: m.apply_top_k(x, 40)),
    "top_p": (lambda m, x: m.apply_top_p(x, 0.9)),
    "min_p": (lambda m, x: m.apply_min_p(x, 0.05)),
    "typical": (lambda m, x: m.apply_typical(x, 0.8)),
    "top_n_sigma": (lambda m, x: m.apply_top_n_sigma(x, 1.5)),
    "logit_bias": (lambda m, x: m.apply_logit_bias(x, ((3, 5.0), (7, -2.5)))),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches_jax(name):
    x = _logits(1)
    ref = np.asarray(TRANSFORMS[name](js, jnp.asarray(x)))
    got = TRANSFORMS[name](ts, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


def test_penalties_match_jax():
    x = _logits(2)
    counts = np.random.default_rng(3).integers(0, 3, (3, V)).astype(np.float32)
    p = js.SamplerParams(penalty_repeat=1.3, penalty_freq=0.2, penalty_present=0.4)
    ref = np.stack([np.asarray(js.apply_penalties(jnp.asarray(x[i]), jnp.asarray(counts[i]), p))
                    for i in range(3)])
    tp = ts.SamplerParams(penalty_repeat=1.3, penalty_freq=0.2, penalty_present=0.4)
    got = ts.apply_penalties(torch.from_numpy(x), torch.from_numpy(counts), tp).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_greedy_and_sampled_draws():
    x = _logits(4)
    greedy = ts.sample(torch.from_numpy(x), torch.Generator(), ts.SamplerParams(temperature=0.0))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(js.sample(
        jnp.asarray(x), jax.random.PRNGKey(0), js.SamplerParams(temperature=0.0))))
    kw = dict(temperature=0.8, top_k=40, top_p=0.9, min_p=0.02)
    chain = jnp.asarray(x) / 0.8
    for f in (lambda l: js.apply_top_k(l, 40), lambda l: js.apply_top_p(l, 0.9),
              lambda l: js.apply_min_p(l, 0.02)):
        chain = f(chain)
    kept = np.asarray(chain) > js.NEG_INF / 2
    gen = torch.Generator().manual_seed(0)
    draws = [ts.sample(torch.from_numpy(x), gen, ts.SamplerParams(**kw)).numpy()
             for _ in range(50)]
    assert all(kept[row, tok] for d in draws for row, tok in enumerate(d))
    # a seed fixes the draws
    again = ts.sample(torch.from_numpy(x), torch.Generator().manual_seed(0), ts.SamplerParams(**kw))
    np.testing.assert_array_equal(again.numpy(), draws[0])
