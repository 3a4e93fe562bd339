"""The on-device sampler twins of rrs_tpu_torch against rrs_tpu's, on the
same seeded [B, V] logits: the deterministic transforms to 1e-6 (ids
exact), greedy picks exactly, and the sampled arm by its support. The two
packages draw from different generators (jax.random against torch.Generator),
so draws are held to JAX's ``final`` mask: over 256 seeds no token outside it
is drawn, and every token in it with probability > 5% is."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.runtime import sampler as js
from rrs_tpu_torch.runtime import sampler as ts

B, V = 3, 300


def _logits(seed=0, scale=3.0):
    return (np.random.default_rng(seed).standard_normal((B, V)) * scale).astype(np.float32)


def _gens(seed, n=B):
    return [torch.Generator().manual_seed(seed * 1000 + i) for i in range(n)]


def _t(a):
    return torch.from_numpy(np.array(a))


def test_device_penalties_match_jax():
    rng = np.random.default_rng(1)
    x = _logits(1)
    counts = rng.integers(0, 3, (B, V)).astype(np.float32)
    bias = np.where(rng.random((B, V)) < 0.05, rng.standard_normal((B, V)), 0).astype(np.float32)
    rep = np.array([1.0, 1.3, 0.8], np.float32)
    frq = np.array([0.0, 0.2, 0.5], np.float32)
    prs = np.array([0.0, 0.4, 0.1], np.float32)
    ref = np.asarray(js.device_penalties(*(jnp.asarray(a) for a in (x, counts, rep, frq, prs,
                                                                      bias))))
    got = ts.device_penalties(*(_t(a) for a in (x, counts, rep, frq, prs, bias))).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_device_top_n_sigma_and_xtc_match_jax():
    x = _logits(2)
    x[0, :10] = js.NEG_INF                                  # masked entries stay out
    nsig = np.array([0.0, 1.0, 2.5], np.float32)
    ref = np.asarray(js.device_top_n_sigma(jnp.asarray(x), jnp.asarray(nsig)))
    got = ts.device_top_n_sigma(_t(x), _t(nsig)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    # XTC with probability 1 draws a gate that always fires: deterministic
    temp = np.array([0.7, 1.0, 0.0], np.float32)
    xp = np.array([1.0, 1.0, 0.0], np.float32)
    xt = np.array([0.01, 0.05, 0.1], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    ref = np.asarray(js.device_xtc(jnp.asarray(x), keys, jnp.asarray(temp), jnp.asarray(xp),
                                   jnp.asarray(xt)))
    got = ts.device_xtc(_t(x), _gens(0), _t(temp), _t(xp), _t(xt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (got <= js.NEG_INF / 2).sum() > 0


def test_topk_candidates_match_jax():
    x = _logits(3)
    jv, ji = js.topk_candidates(jnp.asarray(x))              # V <= 4096: exact top_k
    tv, ti = ts.topk_candidates(_t(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=0)


def test_topk_candidates_break_ties_as_jax():
    """Logits rounded to integers tie: equal values come in ascending id
    order, as ``lax.top_k`` gives them, so the greedy pick over the
    candidates (the decode run's, and its grammar resample's) is
    ``argmax``'s, the lowest id among ties, as the host path's is.
    ``torch.topk`` alone put higher ids first on ties, and a served decode
    run parted from the host path (ROADMAP queue C). Which of the ids tied
    at the 128th value make the set is left open (their values are equal)."""
    x = np.round(_logits(3))
    assert all(len(set(r[:8])) < 8 for r in -np.sort(-x, axis=-1))        # ties at the top
    jv, ji = (np.asarray(a) for a in jax.lax.top_k(jnp.asarray(x), 128))
    tv, ti = (a.numpy() for a in ts.topk_candidates(_t(x)))
    np.testing.assert_array_equal(tv, jv)
    above = jv > jv[:, -1:]
    np.testing.assert_array_equal(np.where(above, ti, -1), np.where(above, ji, -1))
    z = np.zeros((B,), np.float32)
    got = ts.device_sample(_t(x), _gens(0), _t(z), _t(np.full((B,), 128, np.int64)),
                           _t(np.ones((B,), np.float32)), _t(z))
    np.testing.assert_array_equal(got.numpy(), x.argmax(-1))


def test_device_dry_matches_jax():
    rng = np.random.default_rng(4)
    w = js.DRY_WINDOW
    x = _logits(5)
    cv, ci = js.topk_candidates(jnp.asarray(x))
    top = np.asarray(ci)
    dwin = np.full((B, w), -1, np.int32)
    # lane 0: a repeated phrase of likely tokens; lane 1: a short history of
    # likely tokens; lane 2: DRY off
    dwin[0, -60:] = np.concatenate([rng.permutation(top[0, :12])] * 5)
    dwin[1, -30:] = rng.choice(top[1, :6], 30)
    dwin[2] = rng.integers(0, V, w)
    mult = np.array([2.0, 1.5, 0.0], np.float32)
    base = np.array([1.75, 2.0, 1.75], np.float32)
    allowed = np.array([2, 1, 2], np.int32)
    lastn = np.array([256, 64, 256], np.int32)
    rv, ri = js.device_dry(jnp.asarray(dwin), cv, ci, *(jnp.asarray(a) for a in
                                                         (mult, base, allowed, lastn)))
    gv, gi = ts.device_dry(_t(dwin.astype(np.int64)), _t(np.asarray(cv)),
                           _t(np.asarray(ci)).to(torch.int64),
                           *(_t(a) for a in (mult, base, allowed.astype(np.int64),
                                             lastn.astype(np.int64))))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(gv.numpy(), np.asarray(rv), rtol=1e-6, atol=1e-6)
    assert not np.array_equal(np.asarray(rv), np.asarray(cv))     # the penalty bit


@pytest.mark.parametrize("case", ["temp0", "top_k1", "min_p1"])
def test_device_sample_greedy_cases(case):
    x = _logits(6)
    temp = np.array([0.0 if case == "temp0" else 0.9] * B, np.float32)
    top_k = np.array([1 if case == "top_k1" else 128] * B, np.int64)
    min_p = np.array([1.0 if case == "min_p1" else 0.0] * B, np.float32)
    top_p = np.ones((B,), np.float32)
    for seed in range(4):
        got = ts.device_sample(_t(x), _gens(seed), _t(temp), _t(top_k), _t(top_p), _t(min_p))
        np.testing.assert_array_equal(got.numpy(), x.argmax(-1))


CASES = {
    "top_k": dict(top_k=12),
    "top_p": dict(top_p=0.6),
    "min_p": dict(min_p=0.1),
    "typical": dict(typ_p=0.5),
    "mixed": dict(top_k=40, top_p=0.9, min_p=0.02, typ_p=0.9),
}


def _jax_support(x, temp, top_k, top_p, min_p, typ_p, k_max):
    """JAX device_sample's final mask: a Gumbel draw that is 1e9 at rank r
    and 0 elsewhere picks rank r exactly when final[r] holds."""
    cands = jax.lax.top_k(jnp.asarray(x), k_max)
    ids = np.asarray(cands[1])
    support = np.zeros((x.shape[0], k_max), bool)
    orig = jax.random.gumbel
    try:
        for r in range(k_max):
            jax.random.gumbel = lambda key, shape, _r=r: jnp.zeros(shape).at[_r].set(1e9)
            out = np.asarray(js.device_sample(
                jnp.asarray(x), jax.random.split(jax.random.PRNGKey(0), x.shape[0]),
                jnp.asarray(temp), jnp.asarray(top_k, jnp.int32), jnp.asarray(top_p),
                jnp.asarray(min_p), k_max=k_max, cands=cands,
                typ_p=None if typ_p is None else jnp.asarray(typ_p)))
            support[:, r] = out == ids[:, r]
    finally:
        jax.random.gumbel = orig
    return ids, support


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_sample_support_matches_jax(case):
    k_max = 64
    c = CASES[case]
    x = _logits(7, scale=2.0)
    temp = np.full((B,), 0.8, np.float32)
    top_k = np.full((B,), c.get("top_k", k_max), np.int64)
    top_p = np.full((B,), c.get("top_p", 1.0), np.float32)
    min_p = np.full((B,), c.get("min_p", 0.0), np.float32)
    typ_p = np.full((B,), c["typ_p"], np.float32) if "typ_p" in c else None
    ids, support = _jax_support(x, temp, top_k, top_p, min_p, typ_p, k_max)
    assert support.any(1).all() and not support.all()
    cands = ts.topk_candidates(_t(x), k_max)
    drawn = [set() for _ in range(B)]
    for seed in range(256):
        out = ts.device_sample(_t(x), _gens(seed), _t(temp), _t(top_k), _t(top_p), _t(min_p),
                               k_max=k_max, cands=cands,
                               typ_p=None if typ_p is None else _t(typ_p))
        for lane, tok in enumerate(out.tolist()):
            drawn[lane].add(tok)
    for lane in range(B):
        allowed = set(ids[lane][support[lane]].tolist())
        assert drawn[lane] <= allowed, (lane, drawn[lane] - allowed)
        v = x[lane][ids[lane]] / temp[lane]
        p = np.where(support[lane], np.exp(v - v.max()), 0.0)
        p /= p.sum()
        likely = set(ids[lane][p > 0.05].tolist())
        assert likely <= drawn[lane], (lane, likely - drawn[lane])


def test_device_mirostat_mu_update():
    """mu' = mu - eta * (surprise(token) - tau), the token's surprise <= mu,
    or the argmax when nothing qualifies (tests/test_decode_run.py:297)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 64)) * 3.0).astype(np.float32)
    temp = np.array([1.0, 0.7], np.float32)
    mu = np.array([6.0, 1e-4], np.float32)
    eta = np.array([0.1, 0.1], np.float32)
    tau = np.array([5.0, 5.0], np.float32)
    tok, mu2 = ts.device_mirostat(_t(x), _gens(1, 2), _t(temp), _t(mu), _t(eta), _t(tau))
    lp = np.asarray(jax.nn.log_softmax(x / temp[:, None], axis=-1))
    surprise = -lp / np.log(2.0)
    t0, t1 = int(tok[0]), int(tok[1])
    assert surprise[0, t0] <= mu[0] + 1e-4
    assert t1 == int(np.argmax(lp[1]))
    np.testing.assert_allclose(mu2.numpy(), [mu[0] - 0.1 * (surprise[0, t0] - 5.0),
                                             mu[1] - 0.1 * (surprise[1, t1] - 5.0)], rtol=1e-5)
    # the same rule in the JAX twin, on its own draw
    jt, jmu = js.device_mirostat(jnp.asarray(x), jax.random.split(jax.random.PRNGKey(1), 2),
                                 jnp.asarray(temp), jnp.asarray(mu), jnp.asarray(eta),
                                 jnp.asarray(tau))
    assert int(jt[1]) == t1
    np.testing.assert_allclose(float(jmu[1]), float(mu2[1]), rtol=1e-5)


def test_host_mirostat_and_dry_match_jax():
    """The host chain's mirostat v2 and DRY, which the engine's per-token
    path takes."""
    x = _logits(8)[0]
    p = js.SamplerParams(temperature=0.9, mirostat=2, mirostat_tau=4.0, mirostat_eta=0.2)
    tp = ts.SamplerParams(temperature=0.9, mirostat=2, mirostat_tau=4.0, mirostat_eta=0.2)
    tok, mu = ts.mirostat_v2_sample(x, torch.Generator().manual_seed(0), 3.0, tp)
    lg = x.astype(np.float64) / 0.9
    probs = np.exp(lg - lg.max())
    probs /= probs.sum()
    s = -np.log2(probs)
    assert s[tok] <= 3.0 and abs(mu - (3.0 - 0.2 * (s[tok] - 4.0))) < 1e-9
    hist = [5, 6, 7, 8, 5, 6, 7, 9, 5, 6, 7]
    assert ts.dry_penalties(hist, V, 2.0, 1.75, 2, 64) == js.dry_penalties(hist, V, 2.0, 1.75,
                                                                          2, 64)
    assert js.SamplerParams() == js.SamplerParams(**vars(ts.SamplerParams())) and p.mirostat == 2
