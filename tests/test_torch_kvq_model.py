"""The forward over a quantized KV cache: rrs_tpu_torch's InferenceContext
with ``kv_quant="q8"`` or ``"q4"`` against rrs_tpu's with the same option, on
the ``tiny`` preset with dense random weights (2 kv heads: q4 takes the
head-pair layout) and on a 1-kv-head variant (q4 takes the halves layout).
Prefill of 10 tokens and 6 greedy decode steps, B=1; the JAX context runs op
by op (``jax.disable_jit``), as in tests/test_torch_model.py, and the logits
are held to that test's tolerance."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.llama import random_weights as jax_random_weights
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import torch_cfg, weights_tree

PROMPT = [5, 9, 200, 31, 7, 7, 301, 42, 11, 3]
N_DECODE = 6
# |logit| here is ~2; bf16 activation rounding at different sites of the two
# forwards stays far inside this (tests/test_torch_model.py's bound)
LOGIT_ATOL = 0.05
CASES = {"q8-hkv2": ("q8", 2), "q8-hkv1": ("q8", 1), "q4-hkv2": ("q4", 2),
         "q4-hkv1": ("q4", 1)}


def _run(ctx, host):
    seq = ctx.new_sequence()
    logits = [host(ctx.prefill(seq, PROMPT))]
    tokens = []
    last = logits[0][-1]
    for _ in range(N_DECODE):
        tok = int(np.argmax(last))
        tokens.append(tok)
        last = host(ctx.decode({seq: tok})[seq])
        logits.append(last[None])
    return logits, tokens, ctx


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    quant, hkv = CASES[request.param]
    jcfg = dataclasses.replace(JAX_PRESETS["tiny"], n_kv_heads=hkv)
    jw = jax_random_weights(jcfg, seed=0)
    with jax.disable_jit():
        jrun = _run(JaxContext(jcfg, jw, n_lanes=1, max_seq=64, kv_quant=quant),
                    lambda x: np.asarray(x, np.float32))
    cfg = torch_cfg(jcfg)
    trun = _run(InferenceContext(cfg, weights_from_numpy(cfg, weights_tree(jw), device="cpu"),
                                 n_lanes=1, max_seq=64, kv_quant=quant, device="cpu"),
                lambda t: t.numpy())
    return request.param, jrun, trun


def test_kvq_cache_layout_matches_jax(runs):
    name, (_, _, jctx), (_, _, tctx) = runs
    assert tctx.kv.quantized
    for ja, ta in zip(jctx.kv.k[0], tctx.kv.k[0]):
        assert tuple(ta.shape) == ja.shape and str(ta.dtype).split(".")[-1] == str(ja.dtype)
    if name == "q4-hkv1":
        assert tctx.kv.k[0][0].shape[-1] == 32           # halves: D / 2 bytes a slot
    if name == "q4-hkv2":
        assert tctx.kv.k[0][0].shape[1] == 1             # head-pair: Hkv / 2 planes


def test_kvq_prefill_logits_match(runs):
    _, (jlogits, _, _), (tlogits, _, _) = runs
    assert tlogits[0].shape == jlogits[0].shape == (len(PROMPT), 512)
    np.testing.assert_allclose(tlogits[0], jlogits[0], atol=LOGIT_ATOL, rtol=0)


def test_kvq_decode_logits_match(runs):
    _, (jlogits, _, _), (tlogits, _, _) = runs
    for step in range(1, N_DECODE + 1):
        np.testing.assert_allclose(tlogits[step], jlogits[step], atol=LOGIT_ATOL, rtol=0)


def test_kvq_greedy_tokens_identical(runs):
    _, (_, jtokens, _), (_, ttokens, _) = runs
    assert ttokens == jtokens


def test_kvq_close_to_bf16_cache():
    """Quantized K/V stay near the bf16 cache's logits (the JAX test's bounds,
    tests/test_kv_quant.py: q8 within 5e-2 with the same argmax, q4 with a
    per-row correlation above 0.97)."""
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.models.llama import random_weights

    cfg = PRESETS["tiny"]
    w = random_weights(cfg, seed=0, device="cpu")
    out = {}
    for quant in ("none", "q8", "q4"):
        ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=32, kv_quant=quant, device="cpu")
        out[quant] = ctx.prefill(ctx.new_sequence(), [1, 2, 3, 4, 5]).numpy()
    np.testing.assert_allclose(out["q8"], out["none"], rtol=5e-2, atol=5e-2)
    np.testing.assert_array_equal(out["q8"].argmax(-1), out["none"].argmax(-1))
    for row_q, row_f in zip(out["q4"], out["none"]):
        assert np.corrcoef(row_q, row_f)[0, 1] > 0.97
    with pytest.raises(ValueError, match="q8 or q4"):
        InferenceContext(cfg, w, max_seq=32, kv_quant="q3", device="cpu")
    assert torch.is_tensor(ctx.kv.k[0][0])
