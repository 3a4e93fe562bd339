"""The whole forward of rrs_tpu_torch against rrs_tpu on the 2-layer model of
tests/test_pipeline_e2e.py: TCQ4 linears fused into qkv / gate-up, a Q8_0
lm_head, carried across with ``weights_from_numpy``, the last layer's qkv
quantized under a channel permutation (the gathered rotation); prefill at T=20
(bucket 64, the dequant kernel) and 8 greedy decode steps (gx2), B=1.

The JAX CPU oracle runs gx2 and tcq4_matmul in Pallas interpret mode and the
lm_head through the f32 ``q8_matmul_ref``; the port's lm_head rounds its
operands to bf16 like the TPU kernel, which bounds the logit difference.

The oracle runs op by op (``jax.disable_jit``). Under ``jit`` XLA's CPU
backend keeps f32 excess precision through fused bf16 elementwise chains
(rms_norm, SiLU, the residual adds), so it skips bf16 rounding sites that the
op-by-op forward and the port both honour; the int4 activation quantizer
turns those last-bit differences into flipped codes, and the jitted logits
drift by up to ~0.6 from both."""

import jax
import numpy as np
import pytest
import torch

from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.llama import weights_from_numpy
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import small_jax_model, torch_cfg, weights_tree

PROMPT = [3, 17, 42, 99, 5, 8, 250, 1, 77, 64, 12, 200, 31, 9, 150, 2, 111, 45, 6, 88]
N_DECODE = 8
# |logit| here is ~1; the bf16 lm_head operands and bf16 activation rounding
# at other sites keep the port within this of the JAX CPU forward
LOGIT_ATOL = 0.05


def _run(ctx, prefill_fn_out):
    seq = ctx.new_sequence()
    logits = [np.asarray(prefill_fn_out(ctx.prefill(seq, PROMPT)), np.float32)]
    tokens = []
    last = logits[0][-1]
    for _ in range(N_DECODE):
        tok = int(np.argmax(last))
        tokens.append(tok)
        last = np.asarray(prefill_fn_out(ctx.decode({seq: tok})[seq]), np.float32)
        logits.append(last[None])
    return logits, tokens


@pytest.fixture(scope="module")
def runs():
    jcfg, jw = small_jax_model(seed=0, perm_layer=True)
    assert jw.layers[-1].wqkv.gather is not None
    with jax.disable_jit():
        jlogits, jtokens = _run(JaxContext(jcfg, jw, n_lanes=1, max_seq=64), np.asarray)
    tw = weights_from_numpy(torch_cfg(jcfg), weights_tree(jw), device="cpu")
    tlogits, ttokens = _run(InferenceContext(torch_cfg(jcfg), tw, n_lanes=1, max_seq=64,
                                             device="cpu"),
                            lambda t: t.numpy())
    return jlogits, jtokens, tlogits, ttokens


def test_prefill_logits_match(runs):
    jlogits, _, tlogits, _ = runs
    assert tlogits[0].shape == jlogits[0].shape == (len(PROMPT), 256)
    np.testing.assert_allclose(tlogits[0], jlogits[0], atol=LOGIT_ATOL, rtol=0)


def test_decode_logits_match(runs):
    jlogits, _, tlogits, _ = runs
    for step in range(1, N_DECODE + 1):
        np.testing.assert_allclose(tlogits[step], jlogits[step], atol=LOGIT_ATOL, rtol=0)


def test_greedy_tokens_identical(runs):
    _, jtokens, _, ttokens = runs
    assert ttokens == jtokens


def test_weights_from_numpy_carries_every_array():
    jcfg, jw = small_jax_model(seed=1, perm_layer=True)
    tw = weights_from_numpy(torch_cfg(jcfg), weights_tree(jw), device="cpu")
    np.testing.assert_array_equal(tw.layers[-1].wqkv.gather.numpy(),
                                  np.asarray(jw.layers[-1].wqkv.gather))
    lw, tl = jw.layers[0], tw.layers[0]
    np.testing.assert_array_equal(tl.wqkv.qs.numpy(), np.asarray(lw.wqkv.qs))
    np.testing.assert_array_equal(tl.wqkv.eff.float().numpy(),
                                  np.asarray(lw.wqkv.eff, np.float32))
    assert tl.wqkv.eff.dtype == torch.bfloat16 and tl.wq is None
    np.testing.assert_array_equal(tw.lm_head.q.numpy(), np.asarray(jw.lm_head.q))
    assert tw.lm_head.n_logical == jw.lm_head.n_logical
    np.testing.assert_array_equal(tw.embed.float().numpy(), np.asarray(jw.embed, np.float32))
