"""The MoE FFN of rrs_tpu_torch against rrs_tpu's: ``route`` in its three
gating modes (equal expert ids, weights within 1e-6), and ``moe_ffn`` over
MXFP4 stacks with gpt-oss's biases at 2 tokens (the rows kernel B12), 24 (all
experts, B13 over shared activations) and 80 (capacity dispatch, B13 over
per-expert activations), and the overflow fallback (the per-expert scan, B11)
on the skewed router of tests/test_mxfp4.py; then qwen3moe's softmax routing
with ``norm_topk_prob`` over TCQ4 stacks (the rows kernel B9 at 2 tokens, the
capacity dispatch with B10 at 40, the overflow scan of dequantized experts)
and over dense bf16 stacks (the gather at 2 tokens, the capacity einsums at
40, the all-experts fallback). The JAX side runs its kernels in interpret
mode, as its own tests do. Both round the output to bf16 after f32 sums
taken in other orders: held within 8e-3 of its largest magnitude (one bf16
ulp is 2^-8 of an element). The inputs are tie-free: the router's top-k
picks the same experts on both sides (``test_route_matches_jax``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.formats.kquants import quantize_mxfp4
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.moe import MoEWeights as JaxMoE
from rrs_tpu.models.moe import moe_ffn as jax_moe_ffn
from rrs_tpu.models.moe import quantize_experts as jax_quantize_experts
from rrs_tpu.models.moe import route as jax_route
from rrs_tpu.ops.mxfp4_matmul import pack_mxfp4_device
from rrs_tpu_torch.models import moe
from rrs_tpu_torch.models.llama import _moe_from_numpy

from test_torch_common import linear_tree, rel_err, torch_cfg

OUT_TOL = 8e-3


def _cfg(**over):
    base = dict(arch="gpt-oss", n_layers=1, n_embd=128, n_heads=4, n_kv_heads=2, head_dim=64,
                n_ff=256, vocab_size=64, context_length=64, n_experts=4, n_experts_used=2,
                n_ff_exp=192, moe_act="swiglu_oai", expert_softmax_weight=True)
    return JaxConfig(**{**base, **over})


def _jax_moe(cfg, rng, biases=True) -> JaxMoE:
    e, fe, n_exp = cfg.n_embd, cfg.n_ff_exp, cfg.n_experts

    def stack(n_out, k_in):
        packed = [pack_mxfp4_device(quantize_mxfp4(
            rng.standard_normal((n_out, k_in)).astype(np.float32)), (n_out, k_in))
            for _ in range(n_exp)]
        return (jnp.asarray(np.stack([p[0] for p in packed])),
                jnp.asarray(np.stack([p[1] for p in packed])))

    (gq, ge), (uq, ue), (dq, de) = stack(fe, e), stack(fe, e), stack(e, fe)
    b = {}
    if biases:
        f32 = lambda *s: jnp.asarray(rng.standard_normal(s).astype(np.float32) * 0.1)  # noqa: E731
        b = dict(router_bias=f32(n_exp), gate_b=f32(n_exp, fe), up_b=f32(n_exp, fe),
                 down_b=f32(n_exp, e))
    return JaxMoE(router=jnp.asarray(rng.standard_normal((e, n_exp)).astype(np.float32)),
                  gate=None, up=None, down=None, gate_qs=gq, gate_eff=ge, up_qs=uq, up_eff=ue,
                  down_qs=dq, down_eff=de, quant_kind="mxfp4", **b)


def _port(mw: JaxMoE) -> moe.MoEWeights:
    return _moe_from_numpy(linear_tree(mw), "cpu")


ROUTES = {
    "softmax": dict(expert_softmax_weight=False, n_experts=8, n_experts_used=2),
    "sigmoid norm groups bias": dict(expert_softmax_weight=False, expert_gating_softmax=False,
                                     norm_topk_prob=True, n_experts=8, n_experts_used=3,
                                     n_expert_groups=4, n_group_used=2,
                                     expert_weights_scale=2.5),
    "softmax weight, router bias": dict(n_experts=8, n_experts_used=4),
}


@pytest.mark.parametrize("mode", sorted(ROUTES))
def test_route_matches_jax(mode):
    cfg = _cfg(**ROUTES[mode])
    rng = np.random.default_rng(1)
    mw = _jax_moe(cfg, rng, biases=mode.endswith("router bias"))
    if mode.startswith("sigmoid"):
        mw = dataclasses.replace(mw, probs_bias=jnp.asarray(
            rng.standard_normal(cfg.n_experts).astype(np.float32) * 0.1))
    x = (rng.standard_normal((40, cfg.n_embd)) * 0.3).astype(np.float32)
    ji, jv = jax_route(cfg, mw, jnp.asarray(x))
    ti, tv = moe.route(torch_cfg(cfg), _port(mw), torch.from_numpy(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


@pytest.mark.parametrize("t_len", [2, 24, 80], ids=["rows", "all-experts", "capacity"])
def test_moe_ffn_matches_jax(t_len):
    cfg = _cfg()
    rng = np.random.default_rng(4)
    mw = _jax_moe(cfg, rng)
    x = (rng.standard_normal((1, t_len, cfg.n_embd)) * 0.3).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_moe_ffn(cfg, mw, xj), np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = moe.moe_ffn(torch_cfg(cfg), _port(mw), xt)
    assert got.dtype == torch.bfloat16 and got.shape == (1, t_len, cfg.n_embd)
    assert rel_err(got.float().numpy(), ref) < OUT_TOL


def test_moe_overflow_fallback_matches_jax(monkeypatch):
    """Positive activations on a router that scores only experts 0 and 1
    (the others tie at 0 and are never picked): every token routes to
    experts 0 / 1, counts 96 > capacity 64, so the
    port takes the per-expert scan over all tokens (B11 three times per
    expert), as JAX's lax.cond does; the capacity path is never run."""
    cfg = _cfg(n_experts=8)
    rng = np.random.default_rng(7)
    bias = np.zeros((cfg.n_embd, cfg.n_experts), np.float32)
    bias[:, 0], bias[:, 1] = 0.5, 0.4
    mw = dataclasses.replace(_jax_moe(cfg, rng), router=jnp.asarray(bias),
                             router_bias=jnp.zeros((cfg.n_experts,), jnp.float32))
    x = np.abs(rng.standard_normal((1, 96, cfg.n_embd)) * 0.3).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_moe_ffn(cfg, mw, xj), np.float32)
    calls = {"b11": 0, "b13": 0}
    b11, b13 = moe.mxfp4_matmul, moe.mxfp4_matmul_all_experts

    def count(key, fn):
        def run(*a):
            calls[key] += 1
            return fn(*a)
        return run

    monkeypatch.setattr(moe, "mxfp4_matmul", count("b11", b11))
    monkeypatch.setattr(moe, "mxfp4_matmul_all_experts", count("b13", b13))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = moe.moe_ffn(torch_cfg(cfg), _port(mw), xt)
    assert calls == {"b11": 3 * cfg.n_experts, "b13": 0}
    assert rel_err(got.float().numpy(), ref) < OUT_TOL


def test_unported_expert_stacks_raise():
    """An unknown packed codec does not run. (Shared experts, which raised
    here, are ported: their crossing is checked in
    tests/test_torch_qwen2moe.py.)"""
    cfg = _cfg()
    mw = _jax_moe(cfg, np.random.default_rng(0), biases=False)
    port = dataclasses.replace(_port(mw), quant_kind="q4_0")
    with pytest.raises(NotImplementedError, match="q4_0"):
        moe.moe_ffn(torch_cfg(cfg), port, torch.zeros((1, 2, cfg.n_embd), dtype=torch.bfloat16))


# -- qwen3moe: TCQ4 and dense bf16 expert stacks ---------------------------------

def _qcfg(**over):
    base = dict(arch="qwen3moe", n_layers=1, n_embd=256, n_heads=4, n_kv_heads=2, head_dim=64,
                n_ff=0, vocab_size=64, context_length=64, qk_norm=True, n_experts=8,
                n_experts_used=2, n_ff_exp=256, norm_topk_prob=True)
    return JaxConfig(**{**base, **over})


def _dense_moe(cfg, rng, skew=False) -> JaxMoE:
    """Dense bf16 stacks; ``skew``: a router that scores only experts 0 and 1
    (the others tie at 0 and are never picked), so that positive activations
    route every token there and overflow the capacity."""
    e, fe, n_exp = cfg.n_embd, cfg.n_ff_exp, cfg.n_experts
    router = rng.standard_normal((e, n_exp)).astype(np.float32)
    if skew:
        router = np.zeros((e, n_exp), np.float32)
        router[:, 0], router[:, 1] = 0.5, 0.4
    bf = lambda *shape: jnp.asarray(rng.standard_normal(shape) * 0.05, jnp.bfloat16)  # noqa: E731
    return JaxMoE(router=jnp.asarray(router, jnp.bfloat16), gate=bf(n_exp, e, fe),
                  up=bf(n_exp, e, fe), down=bf(n_exp, fe, e))


def _counted(monkeypatch, names):
    calls = dict.fromkeys(names, 0)
    for name in names:
        fn = getattr(moe, name)

        def run(*a, _n=name, _f=fn):
            calls[_n] += 1
            return _f(*a)
        monkeypatch.setattr(moe, name, run)
    return calls


QWEN_BRANCHES = {"rows": (2, False), "capacity": (40, False), "overflow": (96, True)}


@pytest.mark.parametrize("stacks", ["tcq4", "dense"])
@pytest.mark.parametrize("branch", sorted(QWEN_BRANCHES))
def test_qwen3moe_ffn_matches_jax(monkeypatch, stacks, branch):
    """Each branch of ``moe_ffn`` over qwen3moe's stacks, its kernels counted:
    rows: three B9 launches; capacity (cap = 40 covers every count): three
    B10 launches over the per-expert buffer; overflow (96 tokens on experts
    0 / 1 against cap = 64): the per-expert scan, with no B9 / B10 launch.
    Dense stacks take the same branches without a kernel; only the overflow
    fallbacks build the dense [T, E] combine."""
    t_len, skew = QWEN_BRANCHES[branch]
    cfg = _qcfg()
    rng = np.random.default_rng(11)
    mw = _dense_moe(cfg, rng, skew=skew)
    if stacks == "tcq4":
        mw = jax_quantize_experts(mw)
    x = (rng.standard_normal((1, t_len, cfg.n_embd)) * 0.3).astype(np.float32)
    if skew:
        x = np.abs(x)
    xj = jnp.asarray(x, jnp.bfloat16)
    ref = np.asarray(jax_moe_ffn(cfg, mw, xj), np.float32)
    calls = _counted(monkeypatch, ["tcq4_matmul_experts_rows", "tcq4_matmul_all_experts",
                                   "_dequant_expert", "_combine"])
    port = _port(mw)
    assert port.quant_kind == "tcq4" and port.quantized == (stacks == "tcq4")
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = moe.moe_ffn(torch_cfg(cfg), port, xt)
    assert got.dtype == torch.bfloat16 and got.shape == (1, t_len, cfg.n_embd)
    expect = {"rows": (3, 0, 0, 0), "capacity": (0, 3, 0, 0),
              "overflow": (0, 0, 3 * cfg.n_experts, 1)}[branch]
    if stacks == "dense":
        expect = (0, 0, 0, expect[3])
    assert tuple(calls.values()) == expect
    assert rel_err(got.float().numpy(), ref) < OUT_TOL
