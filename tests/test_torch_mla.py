"""Multi-head latent attention (deepseek2) through rrs_tpu_torch against
rrs_tpu.

* ``ModelConfig.from_gguf`` field by field against JAX's: on DeepSeek-V2-Lite's
  published metadata (YaRN x40 with the stored 0.1 * mscale_all_dim), on
  ``tiny-mla``'s exported file (q LoRA, V3 routing: sigmoid gating, groups,
  selection bias), the lite form (no q LoRA, V2's softmax routing) and a
  legacy file with the unsplit ``attn_kv_b``; MLA's YaRN factors at s = 40.
* ``mla_attention`` against JAX's on one layer over bf16, q8 and q4 caches,
  a 6-token prefill of two lanes and a decode step with a padded lane: the
  outputs and every cache row.
* ``tiny-mla`` (2 layers: a dense lead layer and an MoE layer with a shared
  expert) through ``InferenceContext``: prefill logits within JAX's own 2e-2
  (tests/test_mla.py) and rel L2 ``GLUE_TOL``, and greedy tokens identical, with
  dense weights, in the lite form, and with TCQ4 weights (tiny-mla at E = 256,
  every projection TCQ4_K32 by JAX's quantizer, both packages through the
  NumPy decode's bits).
* The MLA context shift (only the leading rope dims re-rotated): the port's
  shifted cache against JAX's (bf16, q8, q4), and a shifted lane's next logits
  against a fresh prefill of the kept tokens within JAX's 5e-2
  (tests/test_mla.py).
* A slot file of an MLA lane saved by the port restores in the port and in
  JAX, and the next logits agree.
* The legacy ``attn_kv_b`` file loads to the split file's weights, bit for
  bit; ``imatrix`` captures MLA's inputs under JAX's names.
* The verbs (``generate``, ``bench`` over q8 KV, ``batched-bench``,
  ``perplexity``, ``imatrix``, ``quantize``) run on the tiny-mla file, and
  the engine serves an MLA slot past its context through the context shift.
"""

import dataclasses
import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.models import llama as jllama
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import PRESETS as JAX_PRESETS
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.models.linear import DenseLinear as JaxDense
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.runtime.kv_cache import KVCache

from test_torch_common import assert_same_greedy, rewrite_gguf, tiny_vocab_tokens, torch_cfg

GLUE_TOL = 0.05
TINY = dataclasses.replace(JAX_PRESETS["tiny-mla"], n_layers=2)
# TCQ4-eligible widths: every projection's K a multiple of 256
WIDE = dataclasses.replace(TINY, n_embd=256, q_lora_rank=256, v_head_dim=64, n_ff=512)
# the lite form: no q LoRA, V2's softmax routing without groups or bias
LITE = dataclasses.replace(TINY, q_lora_rank=0, expert_gating_softmax=True,
                           expert_weights_norm=False, expert_weights_scale=1.0,
                           n_expert_groups=0, n_group_used=0)
PROMPT = [int(t) for t in np.random.default_rng(5).integers(0, 512, 16)]


def deepseek_v2_lite_metadata() -> dict:
    """GGUF metadata of DeepSeek-V2-Lite as its published config.json gives
    it (split k_b / v_b layout: the cache row sizes under key / value_length,
    the head sizes under the *_mla keys)."""
    a = "deepseek2"
    return {"general.architecture": a, f"{a}.block_count": 27, f"{a}.context_length": 163840,
            f"{a}.embedding_length": 2048, f"{a}.feed_forward_length": 10944,
            f"{a}.attention.head_count": 16, f"{a}.attention.head_count_kv": 1,
            f"{a}.attention.key_length": 576, f"{a}.attention.value_length": 512,
            f"{a}.attention.key_length_mla": 192, f"{a}.attention.value_length_mla": 128,
            f"{a}.attention.layer_norm_rms_epsilon": 1e-6, f"{a}.rope.freq_base": 10000.0,
            f"{a}.rope.dimension_count": 64, f"{a}.rope.scaling.type": "yarn",
            f"{a}.rope.scaling.factor": 40.0,
            f"{a}.rope.scaling.original_context_length": 4096,
            f"{a}.rope.scaling.yarn_log_multiplier": 0.0707,
            f"{a}.attention.kv_lora_rank": 512, f"{a}.leading_dense_block_count": 1,
            f"{a}.expert_count": 64, f"{a}.expert_used_count": 6,
            f"{a}.expert_shared_count": 2, f"{a}.expert_feed_forward_length": 1408,
            f"{a}.expert_weights_scale": 1.0, f"{a}.vocab_size": 102400}


def jax_load(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path)


def _legacy_edit():
    """Merge each layer's attn_k_b [H, r, nope] / attn_v_b [H, v, r] into the
    legacy attn_kv_b [H * (nope + v), r]."""
    held = {}

    def edit(name, arr):
        if name.endswith("attn_k_b.weight"):
            held[name] = arr
            return {}
        if name.endswith("attn_v_b.weight"):
            p = name.rsplit(".", 2)[0]
            kb = held[f"{p}.attn_k_b.weight"].transpose(0, 2, 1)         # [H, nope, r]
            kvb = np.concatenate([kb, arr], axis=1)                      # [H, nope + v, r]
            return {f"{p}.attn_kv_b.weight": kvb.reshape(-1, kvb.shape[-1])}
        return {name: arr}

    return edit


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from rrs_tpu.quantize.quantizer import quantize_model as jax_quantize

    d = tmp_path_factory.mktemp("torch_mla")
    out = {}
    for name, cfg in (("tiny", TINY), ("lite", LITE), ("wide", WIDE),
                      ("one", dataclasses.replace(TINY, n_layers=1))):
        export_random_gguf(cfg, d / f"{name}.gguf", seed=7,
                           vocab_tokens=tiny_vocab_tokens(cfg.vocab_size))
        out[name] = d / f"{name}.gguf"
    with mock.patch.object(jax_native, "available", lambda: False):
        jax_quantize(out["wide"], d / "wide-tcq4.gguf", verbose=False)
    out["tcq4"] = d / "wide-tcq4.gguf"
    a = "deepseek2"
    out["legacy"] = rewrite_gguf(
        out["tiny"], d / "legacy.gguf", edit=_legacy_edit(),
        kv={f"{a}.attention.key_length": TINY.head_dim,
            f"{a}.attention.value_length": TINY.v_head_dim},
        drop_kv=(f"{a}.attention.key_length_mla", f"{a}.attention.value_length_mla"))
    return out


def _metadata(path) -> dict:
    from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf

    g = jax_read_gguf(path)
    md = dict(g.metadata)
    g.close()
    return md


@pytest.mark.parametrize("source", ["deepseek-v2-lite", "tiny", "lite", "legacy"])
def test_from_gguf_matches_jax(files, source):
    md = deepseek_v2_lite_metadata() if source == "deepseek-v2-lite" else _metadata(files[source])
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    assert cfg.is_mla and cfg.kv_cache_heads == 1
    if source == "deepseek-v2-lite":
        assert (cfg.head_dim, cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim) == (192, 128, 64,
                                                                                   128)
        assert (cfg.kv_k_dim, cfg.kv_v_dim, cfg.q_lora_rank, cfg.n_dense_lead) == (576, 512, 0, 1)
        assert cfg.rope_yarn_log_mul == pytest.approx(0.707)
        assert cfg.expert_gating_softmax and cfg.rope_scaling_type == "yarn"
        for f in ("n_embd", "n_heads", "n_ff", "n_experts", "n_experts_used", "n_ff_exp",
                  "kv_lora_rank", "rope_scale_factor", "rope_orig_context", "vocab_size"):
            assert getattr(cfg, f) == getattr(JAX_PRESETS["deepseek-v2-lite"], f), f
    else:
        ref = {"tiny": TINY, "lite": LITE, "legacy": TINY}[source]
        for f in ("head_dim", "v_head_dim", "q_lora_rank", "kv_lora_rank", "qk_rope_dim",
                  "n_dense_lead", "expert_gating_softmax", "n_expert_groups", "n_group_used"):
            assert getattr(cfg, f) == getattr(ref, f), f


def test_mla_yarn_factors_at_s40():
    """attn_factor cancels apply_rope's YaRN mscale, and the kq scale is
    mscale^2 / sqrt(192) with rope_yarn_log_mul 0.707."""
    cfg = ModelConfig.from_gguf(deepseek_v2_lite_metadata())
    jcfg = JaxConfig.from_gguf(deepseek_v2_lite_metadata())
    rp = llama.mla_rope_params(cfg)
    assert rp.attn_factor * (1.0 + 0.1 * math.log(40.0)) == pytest.approx(1.0, abs=1e-12)
    want = (1.0 + 0.1 * 0.707 * math.log(40.0)) ** 2 / math.sqrt(192)
    assert llama.mla_kq_scale(cfg) == pytest.approx(want, rel=1e-6)
    assert llama.mla_kq_scale(cfg) == pytest.approx(jllama.mla_kq_scale(jcfg), rel=1e-12)
    from rrs_tpu.ops.basic import apply_rope as jax_apply_rope
    from rrs_tpu_torch.ops.basic import apply_rope

    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 6, 16, 64)).astype(np.float32)
    pos = np.array([[0, 1, 4095, 4096, 60000, 163839]], np.int32)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), rp).numpy()
    ref = np.asarray(jax_apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    jllama.mla_rope_params(jcfg)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), np.linalg.norm(x, axis=-1), rtol=1e-5)


def _layer_pair(cfg, seed=0):
    """One MLA layer's dense weights, as JAX's LayerWeights and the port's."""
    rng = np.random.default_rng(seed)
    e, h, r = cfg.n_embd, cfg.n_heads, cfg.kv_lora_rank

    def mat(*shape, scl=0.05):
        return (rng.standard_normal(shape) * scl).astype(np.float32)

    arrs = dict(wq_a=mat(e, cfg.q_lora_rank), wq=mat(cfg.q_lora_rank, h * cfg.head_dim),
                wkv_a=mat(e, r + cfg.qk_rope_dim), wo=mat(h * cfg.v_head_dim, e),
                q_norm=1 + mat(cfg.q_lora_rank, scl=0.3), k_norm=1 + mat(r, scl=0.3),
                wk_b=mat(h, cfg.qk_nope_dim, r, scl=0.1), wv_b=mat(h, r, cfg.v_head_dim, scl=0.1))
    lins = ("wq_a", "wq", "wkv_a", "wo")
    jb = {k: jnp.asarray(v, jnp.bfloat16) for k, v in arrs.items()}
    jb = {k: JaxDense(w=v) if k in lins else v for k, v in jb.items()}
    jl = jllama.LayerWeights(attn_norm=None, wk=None, wv=None, ffn_norm=None, w_gate=None,
                             w_up=None, w_down=None, **jb)
    tb = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in arrs.items()}
    tl = llama.LayerWeights(attn_norm=None, wk=None, wv=None, ffn_norm=None, w_gate=None,
                            w_up=None, w_down=None,
                            **{k: (llama.DenseLinear(w=v) if k in lins else v)
                               for k, v in tb.items()})
    return jl, tl


def _caches(cfg, kv, b, s):
    """JAX and port caches of one MLA layer (bf16, or a (codes, scales) pair)."""
    out = []
    for dim in (cfg.kv_k_dim, cfg.kv_v_dim):
        if kv == "bf16":
            out.append((jnp.zeros((b, 1, s, dim), jnp.bfloat16),
                        torch.zeros((b, 1, s, dim), dtype=torch.bfloat16)))
            continue
        cols = dim if kv == "q8" else dim // 2
        jdt, tdt = (jnp.int8, torch.int8) if kv == "q8" else (jnp.uint8, torch.uint8)
        out.append(((jnp.zeros((b, 1, s, cols), jdt), jnp.ones((b, 1, 1, s), jnp.float32)),
                    (torch.zeros((b, 1, s, cols), dtype=tdt),
                     torch.ones((b, 1, 1, s), dtype=torch.float32))))
    return out


def _np(c):
    if isinstance(c, tuple):
        return tuple(_np(x) for x in c)
    if isinstance(c, torch.Tensor):
        return c.float().numpy()
    return np.asarray(c, np.float32)


@pytest.mark.parametrize("kv", ["bf16", "q8", "q4"])
def test_mla_attention_matches_jax(kv):
    cfg = torch_cfg(TINY)
    jl, tl = _layer_pair(TINY)
    (jk, tk), (jv, tv) = _caches(TINY, kv, 2, 16)
    rng = np.random.default_rng(1)
    steps = [
        # a 6-token prefill of both lanes (the second from position 3)
        (np.array([[0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 8]], np.int32),
         np.array([[0, 1, 2, 3, 4, 5], [3, 4, 5, 6, 7, 8]], np.int32)),
        # a decode step of lane 0, lane 1 padded
        (np.array([[6], [0]], np.int32), np.array([[6], [-1]], np.int32)),
    ]
    for pos, mask in steps:
        x = rng.standard_normal((2, pos.shape[1], TINY.n_embd)).astype(np.float32)
        slots = np.where(mask < 0, 15, pos).astype(np.int32)
        with jax.disable_jit():
            ref, jk, jv = jllama.mla_attention(
                TINY, jl, jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), jk, jv,
                jnp.asarray(mask), jnp.asarray(slots))
        got = llama.mla_attention(cfg, tl, torch.from_numpy(x).to(torch.bfloat16),
                                  torch.from_numpy(pos), tk, tv, torch.from_numpy(mask),
                                  llama._lane_slots(slots, mask))
        ref = np.asarray(ref, np.float32)
        live = mask[:, 0] >= 0
        np.testing.assert_allclose(got.float().numpy()[live], ref[live], rtol=2e-2, atol=2e-2)
        rel = np.linalg.norm(got.float().numpy()[live] - ref[live]) / np.linalg.norm(ref[live])
        assert rel < 1e-2, rel
        for name, t, j in (("K", tk, jk), ("V", tv, jv)):
            tn, jn = _np(t), _np(j)
            if kv == "bf16":
                # one bf16 step: the projections' f32 sums may round apart
                np.testing.assert_allclose(tn[:, :, :9], jn[:, :, :9], rtol=2.0 ** -7,
                                           atol=1e-6, err_msg=name)
            else:
                np.testing.assert_array_equal(tn[0][:, :, :9], jn[0][:, :, :9], err_msg=name)
                np.testing.assert_allclose(tn[1][..., :9], jn[1][..., :9], rtol=1e-5,
                                           err_msg=name)


@pytest.mark.parametrize("model", ["tiny", "lite", "tcq4"])
def test_logits_and_greedy_tokens_match_jax(files, model):
    jcfg, jw, _ = jax_load(files[model])
    with jax.disable_jit():
        ref_toks = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).generate(PROMPT, 4)
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=64)
        forced = np.asarray(jctx.prefill(jctx.new_sequence(), PROMPT + ref_toks[:3]),
                            np.float32)
    ref = forced[:len(PROMPT)]
    cfg, w, _ = load_model(files[model], device="cpu")
    assert cfg == torch_cfg(jcfg)
    lw0, lw1 = w.layers
    assert lw0.moe is None and lw1.moe is not None and lw1.moe.shared_gate is not None
    assert (lw0.wq_a is None) == (model == "lite")
    if model == "tcq4":
        assert all(type(lin).__name__ == "TCQ4Linear"
                   for lin in (lw0.wq_a, lw0.wq, lw0.wkv_a, lw0.wo))
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu")
    got = ctx.prefill(ctx.new_sequence(), PROMPT).float().numpy()
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    assert rel < GLUE_TOL, rel
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    toks = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu").generate(PROMPT, 4)
    assert_same_greedy(toks, ref_toks, forced[len(PROMPT) - 1:])


@pytest.mark.parametrize("kv", ["none", "q8", "q4"])
def test_mla_context_shift(files, kv):
    """JAX's test on its 1-layer model (whose latents depend on their own
    token only): shift out the first 4 of 8 tokens; the next logits agree
    with a fresh prefill of the kept 4 within 5e-2. The shifted cache
    agrees with JAX's shift of the same prefill: bf16 rows within one bf16
    step, a quantized K within one quantization step per element (the two
    round the rotation's f32 result at either side of a half-way point, as
    tests/test_torch_kv_cache.py holds it), V codes and scales equal."""
    from rrs_tpu.runtime import kv_codec as jkc
    from rrs_tpu_torch.runtime import kv_codec as tkc

    toks, n_keep, n_discard = [3, 1, 4, 1, 5, 9, 2, 6], 0, 4
    jcfg, jw, _ = jax_load(files["one"])
    cfg, w, _ = load_model(files["one"], device="cpu")
    with jax.disable_jit():
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=32, kv_quant=kv)
        js = jctx.new_sequence()
        jctx.prefill(js, toks)
    jctx.kv.seq_shift(jcfg, js, n_keep, n_discard)
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=32, kv_quant=kv, device="cpu")
    sa = ctx.new_sequence()
    ctx.prefill(sa, toks)
    ctx.kv.seq_shift(cfg, sa, n_keep, n_discard)
    assert ctx.kv.lengths[0] == len(toks) - n_discard
    n = len(toks) - n_discard
    (tk,), (jk,), (tv,), (jv,) = ctx.kv.k, jctx.kv.k, ctx.kv.v, jctx.kv.v
    if kv == "none":
        for t, j in ((tk, jk), (tv, jv)):
            np.testing.assert_allclose(_np(t)[:, :, :n], _np(j)[:, :, :n], rtol=2.0 ** -7,
                                       atol=1e-6)
    else:
        got = tkc.dequantize(*tk).numpy()[:, :, :n]
        ref = np.asarray(jkc.dequantize(*jk))[:, :, :n]
        step = np.maximum(tk[1].numpy(), np.asarray(jk[1]))[..., :n].transpose(0, 1, 3, 2)
        assert (np.abs(got - ref) <= 1.0001 * step).all()
        np.testing.assert_array_equal(tv[0].numpy()[:, :, :n], np.asarray(jv[0])[:, :, :n])
        np.testing.assert_array_equal(tv[1].numpy()[..., :n], np.asarray(jv[1])[..., :n])
    la = ctx.decode({sa: 7})[sa].float().numpy()
    fresh = InferenceContext(cfg, w, n_lanes=1, max_seq=32, kv_quant=kv, device="cpu")
    sb = fresh.new_sequence()
    fresh.prefill(sb, toks[n_discard:])
    lb = fresh.decode({sb: 7})[sb].float().numpy()
    np.testing.assert_allclose(la, lb, rtol=5e-2, atol=5e-2)
    if kv != "q4":
        # JAX's test holds the argmax over bf16; the 4-bit requantization
        # of the shifted rows moves near-ties
        assert la.argmax() == lb.argmax()


@pytest.mark.parametrize("kv", ["none", "q8"])
def test_slot_file_round_trips(files, kv, tmp_path):
    """An MLA lane saved by the port restores in the port (cache rows equal)
    and in JAX; the next decode step agrees."""
    from rrs_tpu.runtime import state as jax_state
    from rrs_tpu_torch.runtime import state

    cfg, w, _ = load_model(files["tiny"], device="cpu")
    ctx = InferenceContext(cfg, w, n_lanes=2, max_seq=32, kv_quant=kv, device="cpu")
    ctx.new_sequence()                                   # lane 0 taken: restore into lane 1
    s0 = ctx.new_sequence()
    ctx.prefill(s0, PROMPT[:10])
    path = tmp_path / "slot.rrsstate"
    state.save_sequence(ctx, s0, path, tokens=PROMPT[:10])
    want = ctx.decode({s0: 7})[s0].float().numpy()
    back = InferenceContext(cfg, w, n_lanes=1, max_seq=32, kv_quant=kv, device="cpu")
    s1, toks = state.load_sequence(back, path)
    assert toks == PROMPT[:10] and back.kv.lengths[0] == 10
    for tk, bk in zip(ctx.kv.k + ctx.kv.v, back.kv.k + back.kv.v):
        tn, bn = _np(tk), _np(bk)
        if kv == "none":
            np.testing.assert_array_equal(tn[1, :, :10], bn[0, :, :10])
        else:
            np.testing.assert_array_equal(tn[0][1, :, :10], bn[0][0, :, :10])
            np.testing.assert_allclose(tn[1][1, ..., :10], bn[1][0, ..., :10], rtol=1e-6)
    got = back.decode({s1: 7})[s1].float().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    jcfg, jw, _ = jax_load(files["tiny"])
    with jax.disable_jit():
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=32, kv_quant=kv)
        js, _ = jax_state.load_sequence(jctx, path)
        jgot = np.asarray(jctx.decode({js: 7})[js], np.float32)
    np.testing.assert_allclose(got, jgot, rtol=2e-2, atol=2e-2)


def test_legacy_kv_b_equals_split(files):
    cfg, w, _ = load_model(files["tiny"], device="cpu")
    lcfg, lw, _ = load_model(files["legacy"], device="cpu")
    jcfg, jw, _ = jax_load(files["legacy"])
    assert lcfg == cfg and lcfg == torch_cfg(jcfg)
    for a, b, j in zip(w.layers, lw.layers, jw.layers):
        for f in ("wk_b", "wv_b"):
            np.testing.assert_array_equal(getattr(a, f).view(torch.uint16).numpy(),
                                          getattr(b, f).view(torch.uint16).numpy(), err_msg=f)
            np.testing.assert_array_equal(getattr(b, f).float().numpy(),
                                          np.asarray(getattr(j, f), np.float32), err_msg=f)


def test_cache_geometry_matches_jax():
    from rrs_tpu.runtime.kv_cache import KVCache as JaxKVCache

    md = deepseek_v2_lite_metadata()
    md["deepseek2.block_count"] = 2
    cfg, jcfg = ModelConfig.from_gguf(md), JaxConfig.from_gguf(md)
    for quant in ("none", "q8", "q4"):
        kv = KVCache.create(cfg, 2, 128, quant=quant)
        jkv = JaxKVCache.create(jcfg, 2, 128, quant=quant)
        for t, j in zip(kv.k + kv.v, jkv.k + jkv.v):
            t, j = (t, j) if quant != "none" else ((t,), (j,))
            assert [tuple(x.shape) for x in t] == [tuple(x.shape) for x in j]
        shape = tuple((kv.k[0][0] if quant != "none" else kv.k[0]).shape)
        assert shape == (2, 1, 128, {"none": 576, "q8": 576, "q4": 288}[quant])


def test_imatrix_captures_mla_inputs_under_jax_names(files):
    from rrs_tpu.quantize.imatrix import collect_imatrix as jax_collect
    from rrs_tpu_torch.quantize.imatrix import collect_imatrix

    jcfg, jw, _ = jax_load(files["tiny"])
    cfg, w, _ = load_model(files["tiny"], device="cpu")
    chunks = [PROMPT[:16]]
    with jax.disable_jit():
        ref = jax_collect(jcfg, jw, chunks)
    got = collect_imatrix(cfg, w, chunks)
    assert set(got) == set(ref)
    for name in ("blk.0.attn_q_a.weight", "blk.0.attn_q_b.weight", "blk.0.attn_kv_a_mqa.weight",
                 "blk.0.attn_output.weight", "blk.0.ffn_down.weight", "blk.1.attn_q_b.weight"):
        assert name in got
    for name, (sums, n) in got.items():
        rs, rn = ref[name]
        assert n == rn, name
        assert np.linalg.norm(sums - rs) / np.linalg.norm(rs) < 1e-2, name


VERBS = {
    "generate": ["generate", "-p", "abc", "-n", "4", "--cache-type", "q4"],
    "bench": ["bench", "--pp", "8", "--tg", "2", "-r", "1", "--ctk", "q8_0", "-o", "jsonl"],
    "batched-bench": ["batched-bench", "--pp", "8", "--tg", "2", "--pl", "2", "--json"],
    "perplexity": ["perplexity", "-f", "{text}", "--n-ctx", "16"],
    "imatrix": ["imatrix", "-f", "{text}", "-o", "{out}", "--chunk-len", "16"],
    "quantize": ["quantize", "{wide}", "{out}"],
}


@pytest.mark.parametrize("verb", list(VERBS))
def test_verbs_run_on_an_mla_file(files, verb, tmp_path, capsys):
    from rrs_tpu_torch.__main__ import main

    text = tmp_path / "text.txt"
    text.write_text("the quick brown fox jumps over the lazy dog " * 4)
    out = tmp_path / "out.gguf"
    args = [a.format(text=text, out=out, wide=files["wide"]) for a in VERBS[verb]]
    if verb == "quantize":
        main(args)
        cfg, w, _ = load_model(out, device="cpu")
        assert cfg.is_mla and type(w.layers[0].wkv_a).__name__ == "TCQ4Linear"
        return
    main([args[0], "-m", str(files["tiny"]), *args[1:], "--device", "cpu"])
    cap = capsys.readouterr()
    printed = cap.out + cap.err
    if verb == "imatrix":
        from rrs_tpu_torch.quantize import imatrix

        im = imatrix.load_imatrix(out)
        assert "blk.0.attn_kv_a_mqa.weight" in im and "blk.1.attn_q_b.weight" in im
        assert all(np.isfinite(v).all() for v in im.values())
    elif verb == "perplexity":
        ppl = float(printed.split("Final PPL = ")[1].split()[0])
        assert np.isfinite(ppl) and ppl > 1.0, printed
    elif verb == "generate":
        assert "gen 4 tok" in printed, printed
    else:
        assert printed.strip(), verb


def test_engine_serves_an_mla_slot_past_its_context(files):
    """A greedy request of 60 tokens in a 40-slot context: the engine shifts
    the MLA lane (keep 1, drop half) and the request gets all its tokens."""
    from rrs_tpu_torch.runtime.sampler import SamplerParams
    from rrs_tpu_torch.serving.engine import Engine, GenRequest

    cfg, w, _ = load_model(files["tiny"], device="cpu")
    eng = Engine(InferenceContext(cfg, w, n_lanes=1, max_seq=40, kv_quant="q8", device="cpu"))
    shifts, orig = [], eng.ctx.kv.seq_shift
    eng.ctx.kv.seq_shift = lambda *a: shifts.append(a[2:]) or orig(*a)
    out, done = [], {}
    eng.submit(GenRequest(prompt_tokens=[5, 6, 7, 8, 9], max_tokens=60,
                          params=SamplerParams(temperature=0.0),
                          on_token=lambda t, p, fin, r: done.__setitem__("r", r) if fin
                          else out.append(t)))
    for _ in range(400):
        eng._iterate()
        if done:
            break
    assert done.get("r") == "length" and len(out) == 60
    assert shifts and all(n_keep == 1 for n_keep, _ in shifts)
