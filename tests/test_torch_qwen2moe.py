"""qwen2moe (shared experts, ROADMAP A8c) and GGUFs of mixed weight types
through rrs_tpu_torch against rrs_tpu.

* ``ModelConfig.from_gguf`` on Qwen2-57B-A14B's published metadata gives
  JAX's config.
* A tiny qwen2moe GGUF (2 layers, E = 256, 8 experts of 256 top-2, a shared
  expert of 512) is written with JAX's writer: its shared expert in F32, Q8_0
  or TCQ4_K32 and its expert stacks dense (F32), TCQ4_K32, or Q4_K (which
  both packages dequantize to dense stacks). Both packages
  load the same weights (the shared expert dense bf16, as JAX loads it, bit
  for bit); prefill logits agree within ``GLUE_TOL`` relative L2 and greedy
  tokens are identical, over prompts that take the rows branch (12 tokens),
  the capacity dispatch (40) and the overflow scan (300 copies of a token).
  The routing of these prompts is tie-free (random f32 routers).
* qwen2moe metadata reads as JAX reads it; JAX's loaded shared stacks cross
  into the port bit for bit; a file carrying ``ffn_gate_inp_shexp`` loads
  with the gate ignored and one warning.
* A tiny llama GGUF whose 2-D weights take every K-quant, legacy-quant and
  i-quant type in turn loads in both packages to the same bf16 dense
  weights, and greedy tokens are identical.

The published qwen2moe gates its shared expert with ``shared_expert_gate``;
JAX adds it ungated and the port follows JAX (ROADMAP queue C). The JAX
package loads through its NumPy tile decode (bf16 eff, as the port) and runs
op by op (``jax.disable_jit``), for the reasons given in
tests/test_torch_context.py.
"""

import warnings
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.formats import kquants as jax_kquants
from rrs_tpu.formats.tcq4 import quantize_tcq4 as jax_quantize_tcq4
from rrs_tpu.formats.tile_codec import encode_tcq4_gguf as jax_encode_tcq4
from rrs_tpu.gguf.constants import GGMLType
from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf
from rrs_tpu.gguf.writer import GGUFWriter as JaxWriter
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear
from rrs_tpu_torch.models.llama import _moe_from_numpy
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime.context import InferenceContext

from test_torch_common import linear_tree, tiny_vocab_tokens, torch_cfg

GLUE_TOL = 0.05
TINY = JaxConfig(arch="qwen2moe", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64,
                 n_ff=512, vocab_size=256, context_length=1024, rope_theta=1e6, attn_bias=True,
                 n_experts=8, n_experts_used=2, n_ff_exp=256)
SHARED_FF = 512
PROMPTS = {"rows": list(range(40, 52)),
           "capacity": [int(t) for t in np.random.default_rng(2).integers(0, 256, 40)],
           "overflow": [77] * 300}
MODELS = [(sh, ex) for sh in ("F32", "Q8_0", "TCQ4_K32") for ex in ("dense", "tcq4")] + \
    [("F32", "q4_k")]


def qwen2_57b_a14b_metadata() -> dict:
    """GGUF metadata of Qwen2-57B-A14B as its published config.json gives it."""
    a = "qwen2moe"
    return {"general.architecture": a, f"{a}.block_count": 28, f"{a}.context_length": 32768,
            f"{a}.embedding_length": 3584, f"{a}.feed_forward_length": 18944,
            f"{a}.attention.head_count": 28, f"{a}.attention.head_count_kv": 4,
            f"{a}.attention.layer_norm_rms_epsilon": 1e-6, f"{a}.rope.freq_base": 1e6,
            f"{a}.expert_count": 64, f"{a}.expert_used_count": 8,
            f"{a}.expert_feed_forward_length": 2560,
            f"{a}.expert_shared_feed_forward_length": 20480, f"{a}.vocab_size": 151936}


def test_from_gguf_matches_jax():
    md = qwen2_57b_a14b_metadata()
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    assert cfg.attn_bias and not cfg.qk_norm and not cfg.norm_topk_prob
    assert (cfg.n_experts, cfg.n_experts_used, cfg.n_ff_exp, cfg.head_dim) == (64, 8, 2560, 128)


def _payload(w: np.ndarray, kind: str):
    """(data, GGMLType) of a logical [..., N, K] f32 weight."""
    if kind == "F32":
        return w.astype(np.float32), GGMLType.F32
    if kind == "Q8_0":
        return np.asarray(jax_kquants.quantize_q8_0(w), np.uint8), GGMLType.Q8_0
    mats = w.reshape(-1, *w.shape[-2:])
    raw = b"".join(bytes(jax_encode_tcq4(jax_quantize_tcq4(m))) for m in mats)
    return np.frombuffer(raw, np.uint8), GGMLType.TCQ4_K32


@pytest.fixture(scope="module")
def ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_qwen2moe")
    src = d / "f32.gguf"
    export_random_gguf(TINY, src, seed=0, vocab_tokens=tiny_vocab_tokens(256))
    g = jax_read_gguf(src)
    rng = np.random.default_rng(1)
    shared = {i: {"gate": rng.standard_normal((SHARED_FF, 256)) * 0.05,
                  "up": rng.standard_normal((SHARED_FF, 256)) * 0.05,
                  "down": rng.standard_normal((256, SHARED_FF)) * 0.05}
              for i in range(TINY.n_layers)}
    out = {}
    for sh, ex in MODELS:
        path = d / f"shexp_{sh}_exps_{ex}.gguf"
        with mock.patch.object(jax_native, "available", lambda: False):
            w = JaxWriter(path)
            for k, v in g.metadata.items():
                w.add_kv(k, v, vtype=g.metadata_types.get(k))
            w.add_uint32("qwen2moe.expert_shared_feed_forward_length", SHARED_FF)
            for name, info in g.tensors.items():
                arr = np.array(g.tensor(name), np.float32)
                if ex == "tcq4" and name.endswith("_exps.weight"):
                    data, gt = _payload(arr, "TCQ4_K32")
                    w.add_tensor(name, data, shape=info.shape, ggml_type=gt)
                elif ex == "q4_k" and name.endswith("_exps.weight"):
                    w.add_tensor(name, np.asarray(jax_kquants.quantize_q4_k(arr), np.uint8),
                                 shape=info.shape, ggml_type=GGMLType.Q4_K)
                else:
                    w.add_tensor(name, arr)
                if name.endswith("ffn_down_exps.weight"):
                    li = int(name.split(".")[1])
                    for n in ("gate", "up", "down"):
                        m = shared[li][n].astype(np.float32)
                        data, gt = _payload(m, sh)
                        w.add_tensor(f"blk.{li}.ffn_{n}_shexp.weight", data, shape=m.shape,
                                     ggml_type=gt)
            w.write()
        out[sh, ex] = path
    g.close()
    return out


def jax_load(path):
    with mock.patch.object(jax_native, "available", lambda: False):
        return jax_loader.load_model(path)


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.uint16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


@pytest.mark.parametrize("shexp,exps", MODELS, ids=[f"shexp_{s}-exps_{e}" for s, e in MODELS])
def test_loads_equal_in_both_packages(ggufs, shexp, exps):
    jcfg, jw, _ = jax_load(ggufs[shexp, exps])
    cfg, w, _ = load_model(ggufs[shexp, exps], device="cpu")
    assert cfg == torch_cfg(jcfg) and cfg.arch == "qwen2moe"
    for jl, tl in zip(jw.layers, w.layers):
        assert tl.moe.quantized == (exps == "tcq4")
        for f in ("router", "gate", "up", "down", "gate_qs", "gate_eff", "up_qs", "up_eff",
                  "down_qs", "down_eff", "shared_gate", "shared_up", "shared_down"):
            t, j = getattr(tl.moe, f), getattr(jl.moe, f)
            assert (t is None) == (j is None), f
            if t is not None:
                np.testing.assert_array_equal(_bits(t), _bits(j), err_msg=f)
        assert tl.moe.shared_gate.shape == (256, SHARED_FF)
        assert tl.moe.shared_down.dtype == torch.bfloat16


def _cases():
    out = [(sh, ex, p) for sh, ex in MODELS[:6] for p in ("rows", "capacity")]
    out.append(("F32", "q4_k", "capacity"))
    return out + [("TCQ4_K32", "tcq4", "overflow"), ("F32", "dense", "overflow")]


@pytest.mark.parametrize("shexp,exps,prompt", _cases(),
                         ids=[f"shexp_{s}-exps_{e}-{p}" for s, e, p in _cases()])
def test_logits_and_tokens_match_jax(ggufs, shexp, exps, prompt):
    jcfg, jw, _ = jax_load(ggufs[shexp, exps])
    p = PROMPTS[prompt]
    with jax.disable_jit():
        jctx = JaxContext(jcfg, jw, n_lanes=1, max_seq=512 + 16)
        ref_logits = np.asarray(jctx.prefill(jctx.new_sequence(), p)[-1], np.float32)
        ref = JaxContext(jcfg, jw, n_lanes=1, max_seq=512 + 16).generate(p, 4)
    cfg, w, _ = load_model(ggufs[shexp, exps], device="cpu")
    ctx = InferenceContext(cfg, w, n_lanes=1, max_seq=512 + 16, device="cpu")
    got_logits = ctx.prefill(ctx.new_sequence(), p)[-1].float().numpy()
    rel = np.linalg.norm(got_logits - ref_logits) / np.linalg.norm(ref_logits)
    assert rel < GLUE_TOL, rel
    got = InferenceContext(cfg, w, n_lanes=1, max_seq=512 + 16, device="cpu").generate(p, 4)
    assert len(got) == 4 and got == ref


def test_shared_expert_is_added_ungated(ggufs):
    """Zeroing the shared expert's down projection removes exactly its term:
    the port adds it with no gate, as JAX does."""
    cfg, w, _ = load_model(ggufs["F32", "dense"], device="cpu")
    from rrs_tpu_torch.models.moe import moe_ffn

    mw = w.layers[0].moe
    x = torch.randn(1, 3, 256, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    with_sh = moe_ffn(cfg, mw, x).float()
    import dataclasses

    without = moe_ffn(cfg, dataclasses.replace(mw, shared_gate=None), x).float()
    x2 = x.reshape(3, 256).float()
    g, u = x2 @ mw.shared_gate.float(), x2 @ mw.shared_up.float()
    term = ((torch.nn.functional.silu(g) * u).to(torch.bfloat16).float()
            @ mw.shared_down.float()).reshape(1, 3, 256)
    rel = ((with_sh - without - term).norm() / term.norm()).item()
    assert rel < 2e-2, rel


@pytest.mark.parametrize("n_experts", [None, 4], ids=["no expert count", "4 experts"])
def test_qwen2moe_reads_as_moe_qwen2(n_experts):
    """qwen2moe, which raised before its shared experts were ported, reads as
    JAX reads it: a qwen2 with q / k / v biases and no qk norm."""
    md = {"general.architecture": "qwen2moe", "qwen2moe.block_count": 2,
          "qwen2moe.embedding_length": 64}
    if n_experts is not None:
        md["qwen2moe.expert_count"] = n_experts
    cfg = ModelConfig.from_gguf(md)
    assert cfg == torch_cfg(JaxConfig.from_gguf(md))
    assert cfg.arch == "qwen2moe" and cfg.attn_bias and not cfg.qk_norm
    assert cfg.n_experts == (n_experts or 0)


@pytest.mark.parametrize("shexp", ["F32", "Q8_0", "TCQ4_K32"])
def test_shared_stacks_cross_from_jax_bit_for_bit(ggufs, shexp):
    """JAX's loaded MoE weights, shared stacks included, cross into the port
    (``_moe_from_numpy``, as ``weights_from_numpy`` takes them) bit for bit."""
    _, jw, _ = jax_load(ggufs[shexp, "dense"])
    for jl in jw.layers:
        mw = _moe_from_numpy(linear_tree(jl.moe), "cpu")
        for f in ("shared_gate", "shared_up", "shared_down"):
            got = getattr(mw, f)
            assert got.dtype == torch.bfloat16, f
            np.testing.assert_array_equal(_bits(got), _bits(getattr(jl.moe, f)), err_msg=f)


def test_shared_expert_gate_is_ignored_with_a_warning(ggufs, tmp_path):
    """A file that carries ``ffn_gate_inp_shexp`` (as published qwen2moe
    GGUFs do) loads as JAX loads it, the gate ignored, and says so once; a
    file without it loads silently."""
    src = ggufs["F32", "dense"]
    dst = tmp_path / "gated.gguf"
    g = jax_read_gguf(src)
    w = JaxWriter(dst)
    for k, v in g.metadata.items():
        w.add_kv(k, v, vtype=g.metadata_types.get(k))
    for name in g.tensors:
        w.add_tensor(name, np.array(g.tensor(name), np.float32))
    for i in range(TINY.n_layers):
        w.add_tensor(f"blk.{i}.ffn_gate_inp_shexp.weight", np.full(256, 0.5, np.float32))
    w.write()
    g.close()
    with pytest.warns(UserWarning, match="ffn_gate_inp_shexp") as caught:
        _, gated, _ = load_model(dst, device="cpu")
    assert len([c for c in caught if "ffn_gate_inp_shexp" in str(c.message)]) == 1
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, plain, _ = load_model(src, device="cpu")
    for gl, pl in zip(gated.layers, plain.layers):
        for f in ("shared_gate", "shared_up", "shared_down", "router"):
            np.testing.assert_array_equal(_bits(getattr(gl.moe, f)), _bits(getattr(pl.moe, f)))


# -- a llama GGUF of mixed weight types ---------------------------------------------

MIXED = [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q2_K,
         GGMLType.Q3_K, GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.IQ4_NL,
         GGMLType.IQ4_XS, GGMLType.TQ1_0, GGMLType.TQ2_0, GGMLType.IQ2_XXS, GGMLType.IQ2_XS,
         GGMLType.IQ2_S, GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.Q8_K]
# types with no encoder: random blocks whose leading scale (f16; f32 for Q8_K)
# is set to a small finite value
_RANDOM = {GGMLType.IQ2_XXS: 66, GGMLType.IQ2_XS: 74, GGMLType.IQ2_S: 82,
           GGMLType.IQ3_XXS: 98, GGMLType.IQ3_S: 110, GGMLType.IQ1_S: 50, GGMLType.Q8_K: 292}
_ENC = {GGMLType.Q4_0: "q4_0", GGMLType.Q4_1: "q4_1", GGMLType.Q5_0: "q5_0",
        GGMLType.Q5_1: "q5_1", GGMLType.Q2_K: "q2_k", GGMLType.Q3_K: "q3_k",
        GGMLType.Q4_K: "q4_k", GGMLType.Q5_K: "q5_k", GGMLType.Q6_K: "q6_k",
        GGMLType.IQ4_NL: "iq4_nl", GGMLType.IQ4_XS: "iq4_xs", GGMLType.TQ1_0: "tq1_0",
        GGMLType.TQ2_0: "tq2_0"}


def _mixed_payload(w: np.ndarray, gt: GGMLType, rng) -> np.ndarray:
    if gt in _ENC:
        return np.asarray(getattr(jax_kquants, f"quantize_{_ENC[gt]}")(w), np.uint8)
    nb = w.size // 256
    blocks = rng.integers(0, 256, size=(nb, _RANDOM[gt]), dtype=np.uint8)
    if gt == GGMLType.Q8_K:
        blocks[:, :4] = np.full(nb, 4e-4, np.float32).view(np.uint8).reshape(nb, 4)
    else:
        blocks[:, :2] = np.full(nb, 1e-3, np.float16).view(np.uint8).reshape(nb, 2)
    return blocks.reshape(-1)


@pytest.fixture(scope="module")
def mixed_gguf(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mixed")
    cfg = JaxConfig(arch="llama", n_layers=3, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64,
                    n_ff=512, vocab_size=256, context_length=512, rope_neox=False)
    src, dst = d / "f32.gguf", d / "mixed.gguf"
    export_random_gguf(cfg, src, seed=5, vocab_tokens=tiny_vocab_tokens(256))
    g = jax_read_gguf(src)
    w = JaxWriter(dst)
    for k, v in g.metadata.items():
        w.add_kv(k, v, vtype=g.metadata_types.get(k))
    rng = np.random.default_rng(8)
    i, types = 0, {}
    for name, info in g.tensors.items():
        arr = np.array(g.tensor(name), np.float32)
        if len(info.shape) == 2 and name != "token_embd.weight":
            gt = MIXED[i % len(MIXED)]
            i += 1
            w.add_tensor(name, _mixed_payload(arr, gt, rng), shape=info.shape, ggml_type=gt)
            types[name] = gt
        else:
            w.add_tensor(name, arr)
    w.write()
    g.close()
    assert set(types.values()) == set(MIXED)
    return dst


def test_mixed_types_load_and_generate_like_jax(mixed_gguf):
    jcfg, jw, _ = jax_load(mixed_gguf)
    cfg, w, _ = load_model(mixed_gguf, device="cpu")
    assert cfg == torch_cfg(jcfg)
    n = 0
    for jl, tl in zip(jw.layers, w.layers):
        for f in ("wqkv", "wo", "w_gateup", "w_down", "wq", "wk", "wv", "w_gate", "w_up"):
            t, j = getattr(tl, f), getattr(jl, f)
            assert (t is None) == (j is None), f
            if t is not None:
                assert isinstance(t, DenseLinear)
                np.testing.assert_array_equal(_bits(t.w), _bits(j.w), err_msg=f)
                n += 1
    assert n >= 3 * 4
    np.testing.assert_array_equal(_bits(w.lm_head.w), _bits(jw.lm_head.w))
    prompt = [int(t) for t in np.random.default_rng(3).integers(0, 256, 10)]
    with jax.disable_jit():
        ref = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).generate(prompt, 6)
    got = InferenceContext(cfg, w, n_lanes=1, max_seq=64, device="cpu").generate(prompt, 6)
    assert len(got) == 6 and got == ref
