"""Attention of rrs_tpu_torch (the plain version the CUDA kernel is held
against on the card) against rrs_tpu's attention_ref, f32, with every option
the kernel takes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.ops.flash_attention import attention_ref as jref
from rrs_tpu_torch.ops import flash_attention as tfa

CASES = {
    "decode_g1": dict(t=1, h=4, hkv=4),
    "decode_g4": dict(t=1, h=8, hkv=2),
    "prefill_g2": dict(t=12, h=4, hkv=2),
    "prefill_g4_padded": dict(t=9, h=8, hkv=2, pad_rows=3),
    "odd_s": dict(t=5, h=4, hkv=2, s=200),
    "padded_lane": dict(t=3, h=4, hkv=2, b=2, dead_lane=True),
    "softcap": dict(t=6, h=4, hkv=2, softcap=5.0),
    "window_ring": dict(t=7, h=4, hkv=2, s=32, window=10, start=40),
    "alibi": dict(t=6, h=8, hkv=4, alibi=8.0),
    "sinks": dict(t=6, h=4, hkv=2, sinks=True, pad_rows=2),
}


def _inputs(t, h, hkv, s=96, d=64, b=1, start=20, pad_rows=0, dead_lane=False, seed=0,
            **_):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    pos = np.tile(np.arange(start, start + t, dtype=np.int32), (b, 1))
    if pad_rows:
        pos[:, t - pad_rows:] = -1
    if dead_lane:
        pos[1] = -1
    return q, k, v, pos


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_plain_matches_jax_ref(name):
    c = CASES[name]
    q, k, v, pos = _inputs(**c)
    scale = 1.0 / np.sqrt(q.shape[-1])
    kw = dict(softcap=c.get("softcap", 0.0), window=c.get("window", 0),
              alibi=c.get("alibi", 0.0))
    sinks = (np.random.default_rng(9).standard_normal(c["h"]).astype(np.float32)
             if c.get("sinks") else None)
    ref = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos),
                          scale, sinks=None if sinks is None else jnp.asarray(sinks), **kw))
    tq, tk, tv, tp = (torch.from_numpy(x) for x in (q, k, v, pos))
    ts = None if sinks is None else torch.from_numpy(sinks)
    got = tfa.flash_attention(tq, tk, tv, tp, scale, sinks=ts, **kw).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    dead = pos < 0
    assert np.all(got[dead] == 0.0)           # a padded row outputs exactly 0
    plain = tfa.attention_ref(tq, tk, tv, tp, scale, sinks=ts, **kw).numpy()
    np.testing.assert_array_equal(got, plain)  # on the CPU the wrapper is the plain version


def test_alibi_slopes_match():
    from rrs_tpu.ops.flash_attention import alibi_slopes_np

    for h in (4, 6, 12, 32):
        np.testing.assert_array_equal(tfa.alibi_slopes_np(h, 8.0), alibi_slopes_np(h, 8.0))
