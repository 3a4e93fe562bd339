"""rrs_tpu_torch/train/finetune.py, the ``finetune`` verb and the autograd
Functions of models/linear.py against the JAX package on the CPU.

The port's counterparts of tests/test_train.py's six tests; the loss and the
gradient of every float leaf against ``jax.value_and_grad`` of JAX's
``_loss_fn`` (a 2-layer qwen3 in f32, qwen3moe with dense f32 expert
stacks, gemma2, and a TCQ4 model through the straight-through backward with
the JAX side under ``jax.disable_jit()``); the optimizer steps and the trained
weights against JAX's ``train``; each backward alone against JAX's on the same
cotangent; the verb against JAX's verb; and the refusals.

Tolerances (measured on these inputs, with a margin):
* gradients, per leaf: max |port - JAX| <= GRAD_TOL[0] x max |JAX| and
  ||port - JAX|| <= GRAD_TOL[1] x ||JAX||. The scratch caches are bf16, so
  in both packages a gradient reaching the K / V rows is rounded once to bf16
  on its way (one bf16 step is 3.9e-3 of a value), and a last-bit
  difference before that rounding can flip it: measured worst 1.4e-3 and
  5.9e-4 (qwen3moe's layer-0 wk; qwen3 agrees within 6e-7). The TCQ4 model's
  leaves are bf16: BF16_GRAD_TOL, measured worst 3.4e-3 and 1.1e-3;
* losses: f32 1e-5 absolute; the TCQ4 model 1e-3, the reference's own
  limit on a reloaded loss (tests/test_train.py:104);
* the chunked loop against the per-step loop: equal (the same operations);
  JAX's own limit is 2e-4 (tests/test_train.py:54);
* trained f32 weights after AdamW: WEIGHT_TOL_LR x lr absolute. Adam divides
  each gradient by its own running RMS, so a weight whose gradient is near
  zero moves by up to lr a step on either side of a last-bit difference; the
  measured worst case is 0.14 lr after 6 steps with weight decay;
* the backwards alone: f32 rel 1e-5 (products of the same f32 operands in
  another order).
"""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu.models import linear as jlin
from rrs_tpu.models.config import ModelConfig as JaxConfig
from rrs_tpu.models.llama import random_weights as jax_random_weights
from rrs_tpu.train import finetune as jft
from rrs_tpu_torch import kernels
from rrs_tpu_torch.models import linear as tlin
from rrs_tpu_torch.models.llama import random_weights, weights_from_numpy
from rrs_tpu_torch.train import finetune as tft
from test_torch_common import small_jax_model, torch_cfg, weights_tree

GRAD_TOL = (5e-3, 2e-3)
BF16_GRAD_TOL = (2e-2, 5e-3)
Q8_HEAD_GRAD_TOL = (2e-2, 1.5e-2)
WEIGHT_TOL_LR = 0.5
BWD_TOL = 1e-5


def _cfg(**over):
    """The 2-layer qwen3 of tests/test_train.py."""
    return JaxConfig(**{**dict(
        arch="qwen3", n_layers=2, n_embd=64, n_heads=4, n_kv_heads=2, head_dim=16, n_ff=128,
        vocab_size=64, context_length=128, qk_norm=True), **over})


def _tcq4_cfg():
    """The TCQ4 model of tests/test_train.py::test_quantized_leaves_frozen."""
    return _cfg(n_layers=1, n_embd=256, n_ff=256)


def _port(cfg, w):
    return torch_cfg(cfg), weights_from_numpy(torch_cfg(cfg), weights_tree(w), device="cpu")


def _flat(tree, prefix="") -> dict:
    """{dotted field path: f32 array} of the tensors of a JAX or port tree."""
    out = {}
    if dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            out.update(_flat(getattr(tree, f.name), f"{prefix}{f.name}."))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            out.update(_flat(x, f"{prefix}{i}."))
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().to(torch.float32).numpy() \
            if tree.is_floating_point() else tree.numpy()
    elif tree is not None and not isinstance(tree, (int, float, str)):
        a = np.asarray(tree)
        out[prefix[:-1]] = a.astype(np.float32) if a.dtype.kind == "V" or \
            a.dtype.name == "bfloat16" else a
    return out


def _batches(cfg, n_tok=600, seq_len=16, batch=2, seed=2, n=6):
    toks = list(np.random.default_rng(1).integers(0, cfg.vocab_size, n_tok))
    return tft.make_dataset(toks, seq_len=seq_len, batch=batch, seed=seed)[:n]


def _jax_value_and_grad(cfg, w, batch):
    params, static = jft.partition(w)
    return jax.value_and_grad(
        lambda p: jft._loss_fn(cfg, jft.combine(p, static), jnp.asarray(batch)))(params)


def _port_value_and_grad(tcfg, tw, batch):
    params, static, _ = tft.trainable(tw)
    loss = tft._loss_fn(tcfg, tft.combine(params, static), batch)
    loss.backward()
    grads = tft._tree_map(
        lambda p: None if p is None else (torch.zeros_like(p) if p.grad is None else p.grad),
        params)
    return loss.item(), grads


# ---------------------------------------------------------------------------
# The counterparts of tests/test_train.py
# ---------------------------------------------------------------------------

def test_make_dataset():
    toks = list(range(100))
    batches = tft.make_dataset(toks, seq_len=16, batch=2)
    assert all(b.shape == (2, 17) and b.dtype == np.int32 for b in batches)
    for b in batches:
        for row in b:
            assert (np.diff(row) == 1).all()
    # the same blocks in the same order as JAX's, for several seeds and sizes
    for seed, seq_len, batch in ((0, 16, 2), (3, 7, 3), (5, 33, 1)):
        ref = jft.make_dataset(toks, seq_len=seq_len, batch=batch, seed=seed)
        got = tft.make_dataset(toks, seq_len=seq_len, batch=batch, seed=seed)
        assert len(got) == len(ref) and all((a == b).all() for a, b in zip(got, ref))


def test_adamw_loss_decreases():
    cfg = torch_cfg(_cfg())
    w = random_weights(cfg, seed=0, dtype=torch.float32)
    rng = np.random.default_rng(0)
    pattern = list(rng.integers(0, cfg.vocab_size, 16))
    batches = tft.make_dataset(pattern * 40, seq_len=16, batch=2, seed=1)[:8]
    before = tft.evaluate(cfg, w, batches[:2], device="cpu")
    w2, losses = tft.train(cfg, w, batches, tft.TrainConfig(lr=3e-3), n_epochs=4,
                           device="cpu")
    after = tft.evaluate(cfg, w2, batches[:2], device="cpu")
    assert after < before * 0.7, (before, after, losses[:3], losses[-3:])


def test_chunked_steps_match_loop():
    cfg = torch_cfg(_cfg())
    w = random_weights(cfg, seed=0, dtype=torch.float32)
    batches = _batches(cfg)
    seen = []
    w1, l1 = tft.train(cfg, w, batches, tft.TrainConfig(lr=1e-3), device="cpu")
    w2, l2 = tft.train(cfg, w, batches, tft.TrainConfig(lr=1e-3), chunk_steps=4,
                       on_step=lambda i, l: seen.append((i, l)), device="cpu")
    assert l1 == l2 and seen == list(enumerate(l2)) and len(l2) == 6
    assert torch.equal(w1.layers[1].w_down.w, w2.layers[1].w_down.w)


def test_sgd_runs():
    cfg = torch_cfg(_cfg())
    w = random_weights(cfg, seed=1, dtype=torch.float32)
    toks = list(np.random.default_rng(2).integers(0, 64, 200))
    batches = tft.make_dataset(toks, seq_len=8, batch=1)[:3]
    _, losses = tft.train(cfg, w, batches,
                          tft.TrainConfig(optimizer="sgd", lr=1e-2, clip_norm=1.0), device="cpu")
    assert len(losses) == 3 and all(np.isfinite(l) for l in losses)


def test_quantized_leaves_frozen(monkeypatch):
    """TCQ4 codes and the i8p pack's codes are untouched by training, through
    every route of the forward (gx2 at M = 8, the dequant kernel's plain
    version at M = 64, the i8p one at M = 256), and so are the scales
    without weight decay; the caller's weights are not modified."""
    monkeypatch.setenv("RRS_PREFILL_I8", "1")
    cfg = torch_cfg(_tcq4_cfg())
    w = random_weights(cfg, seed=3, quantize=True)
    q = [lw.wq for lw in w.layers]
    assert all(isinstance(l, tlin.TCQ4Linear) and l.i8p is not None for l in q)
    before = {k: v.copy() for k, v in _flat(w).items()}
    toks = list(np.random.default_rng(4).integers(0, 64, 600))
    for seq_len in (8, 64, 256):
        batches = tft.make_dataset(toks, seq_len=seq_len, batch=1)[:2]
        w2, losses = tft.train(cfg, w, batches, tft.TrainConfig(lr=1e-3), device="cpu")
        assert all(np.isfinite(losses))
        after = _flat(w2)
        for k, v in before.items():
            if re.search(r"\.(qs|eff|i8p\.\d)$", k):
                np.testing.assert_array_equal(after[k], v, err_msg=k)
        assert not np.array_equal(after["embed"], before["embed"])
        assert w2.layers[0].wq.qs is w.layers[0].wq.qs          # frozen leaves shared
    for k, v in _flat(w).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


def test_finetune_roundtrip_gguf(tmp_path):
    """Train -> export GGUF -> reload -> the same (lower) loss."""
    from rrs_tpu_torch.models.export import export_random_gguf, export_weights_gguf
    from rrs_tpu_torch.models.loader import load_model

    cfg = torch_cfg(_cfg())
    vocab = [chr(33 + i) for i in range(cfg.vocab_size)]
    src = export_random_gguf(cfg, tmp_path / "src.gguf", seed=0, vocab_tokens=vocab)
    cfg2, w, md = load_model(src, dtype=torch.float32, fuse=False, device="cpu")
    toks = list(np.random.default_rng(0).integers(0, cfg.vocab_size, 16)) * 20
    batches = tft.make_dataset(toks, seq_len=16, batch=2)[:4]
    before = tft.evaluate(cfg2, w, batches[:2], device="cpu")
    w2, _ = tft.train(cfg2, w, batches, tft.TrainConfig(lr=3e-3), n_epochs=2, device="cpu")
    loss_trained = tft.evaluate(cfg2, w2, batches[:2], device="cpu")
    out = export_weights_gguf(cfg2, w2, tmp_path / "trained.gguf", metadata=md)
    cfg3, w3, _ = load_model(out, dtype=torch.float32, fuse=False, device="cpu")
    loss_reloaded = tft.evaluate(cfg3, w3, batches[:2], device="cpu")
    assert loss_trained < before
    assert abs(loss_reloaded - loss_trained) < 1e-3


# ---------------------------------------------------------------------------
# Loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

def _moe_model(tmp_path):
    """JAX's _moe_model of tests/test_train_sharding.py (dense f32 expert
    stacks), loaded f32 and unfused by each package's loader."""
    from rrs_tpu.models.export import export_random_gguf
    from rrs_tpu.models.loader import load_model as jax_load_model
    from rrs_tpu_torch.models.loader import load_model

    cfg = _cfg(arch="qwen3moe", n_ff=0, context_length=64, n_experts=4, n_experts_used=2,
               n_ff_exp=64, norm_topk_prob=True)
    export_random_gguf(cfg, tmp_path / "m.gguf", seed=3)
    jcfg, jw = jax_load_model(tmp_path / "m.gguf", dtype=np.float32, fuse=False)[:2]
    tcfg, tw = load_model(tmp_path / "m.gguf", dtype=torch.float32, fuse=False,
                          device="cpu")[:2]
    assert tw.layers[0].moe is not None and tw.layers[0].moe.gate.dtype == torch.float32
    return jcfg, jw, tcfg, tw


def _model(name, tmp_path):
    if name == "qwen3moe":
        return _moe_model(tmp_path)
    if name == "tcq4":
        cfg = _tcq4_cfg()
        w = jax_random_weights(cfg, seed=3, quantize=True)
    elif name == "tcq4-q8head":
        cfg, w = small_jax_model(seed=0)
    elif name == "gemma2":
        cfg = _cfg(arch="gemma2", qk_norm=False, swa_pattern=2, swa_window=8, attn_softcap=1.0,
                   final_softcap=2.0, ffn_act="gelu", embd_scale=8.0, sandwich_norm=True)
        w = jax_random_weights(cfg, seed=5, dtype=np.float32, scale=0.1)
    else:
        cfg = _cfg()
        w = jax_random_weights(cfg, seed=0, dtype=np.float32)
    return (cfg, w, *_port(cfg, w))


@pytest.mark.parametrize("name", ["qwen3", "qwen3moe", "gemma2", "tcq4", "tcq4-q8head"])
def test_loss_and_grads_match_jax(name, tmp_path):
    """The loss and every float leaf's gradient against jax.value_and_grad.
    "tcq4-q8head" is the 2-layer model of the port's parity tests (fused TCQ4
    qkv / gate-up, a Q8_0 head): there the CPU forwards part before the
    backward, as the port's plain Q8 version rounds the head's operands to
    bf16 (the kernel's arithmetic) where JAX's CPU route is f32 (loss 2e-4
    apart, gradients Q8_HEAD_GRAD_TOL, measured worst 1.05e-2 and 8.7e-3)."""
    jcfg, jw, tcfg, tw = _model(name, tmp_path)
    quant = name.startswith("tcq4")
    if name == "qwen3moe":
        assert jcfg.n_experts == 4 and tcfg == torch_cfg(jcfg)
    batch = _batches(tcfg, seq_len=8 if quant else 16, batch=1 if quant else 2)[0]
    if quant:
        with jax.disable_jit():
            lj, gj = _jax_value_and_grad(jcfg, jw, batch)
    else:
        lj, gj = _jax_value_and_grad(jcfg, jw, batch)
    lt, gt = _port_value_and_grad(tcfg, tw, batch)
    assert abs(float(lj) - lt) <= (1e-3 if quant else 1e-5), (float(lj), lt)
    fj, ft = _flat(gj), _flat(gt)
    assert set(fj) == set(ft) and len(fj) > 10
    tol = {"tcq4": BF16_GRAD_TOL, "tcq4-q8head": Q8_HEAD_GRAD_TOL}.get(name, GRAD_TOL)
    for k, ref in fj.items():
        got = ft[k]
        assert got.shape == ref.shape, k
        scale = np.abs(ref).max()
        if k.endswith(("eff", "i8p.2")):
            np.testing.assert_array_equal(got, 0.0, err_msg=k)   # the STE's none
            np.testing.assert_array_equal(ref, 0.0, err_msg=k)
            continue
        err = np.abs(got - ref).max() / max(scale, 1e-30)
        l2 = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
        assert err <= tol[0] and l2 <= tol[1], (k, err, l2)


# ---------------------------------------------------------------------------
# Optimizer steps and trained weights against JAX's train
# ---------------------------------------------------------------------------

TRAIN_CASES = {
    "adamw": jft.TrainConfig(lr=1e-3),
    "adamw-decay": jft.TrainConfig(lr=1e-3, weight_decay=0.1),
    "sgd-clip": jft.TrainConfig(optimizer="sgd", lr=1e-2, clip_norm=1.0),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_matches_jax(case):
    jtc = TRAIN_CASES[case]
    cfg = _cfg()
    # weights at 0.2: a gradient norm above the clip
    w = jax_random_weights(cfg, seed=0, dtype=np.float32, scale=0.2 if "sgd" in case else 0.02)
    tcfg, tw = _port(cfg, w)
    batches = _batches(tcfg)
    if "clip" in case:
        _, g = _port_value_and_grad(tcfg, tw, batches[0])
        norm = float(torch.sqrt(sum((x * x).sum() for x in tft._leaves(g))))
        assert norm > 1.5 * jtc.clip_norm, norm
    wj, lj = jft.train(cfg, w, batches, jtc)
    wt, lt = tft.train(tcfg, tw, batches, tft.TrainConfig(**dataclasses.asdict(jtc)),
                       device="cpu")
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-4)
    fj, ft = _flat(wj), _flat(wt)
    assert set(fj) == set(ft)
    tol = WEIGHT_TOL_LR * jtc.lr
    for k, ref in fj.items():
        moved = np.abs(ref - _flat(w)[k]).max()
        assert moved > 0 or "sgd" in case, k
        assert np.abs(ft[k] - ref).max() <= tol, (k, np.abs(ft[k] - ref).max(), tol)


def test_weight_decay_moves_eff_as_jax():
    """Every float leaf is a parameter, TCQ4's bf16 eff too: its gradient is
    zero, so AdamW moves it by the decay alone, in bf16, as in JAX; the codes
    stay as they were."""
    cfg = _tcq4_cfg()
    w = jax_random_weights(cfg, seed=3, quantize=True)
    tcfg, tw = _port(cfg, w)
    batches = _batches(tcfg, seq_len=8, batch=1, n=3)
    jtc = jft.TrainConfig(lr=1e-2, weight_decay=0.5)
    wj, _ = jft.train(cfg, w, batches, jtc)
    wt, _ = tft.train(tcfg, tw, batches, tft.TrainConfig(**dataclasses.asdict(jtc)),
                      device="cpu")
    fj, ft, f0 = _flat(wj), _flat(wt), _flat(w)
    effs = [k for k in fj if k.endswith(".eff")]
    assert effs
    for k in effs:
        assert not np.array_equal(fj[k], f0[k]), k                    # it moved in JAX
        np.testing.assert_array_equal(ft[k], fj[k], err_msg=k)
        np.testing.assert_array_equal(ft[k.replace(".eff", ".qs")], f0[k.replace(".eff", ".qs")])


# ---------------------------------------------------------------------------
# The backwards alone, on the same cotangent
# ---------------------------------------------------------------------------

def _rel(got, ref) -> float:
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("m", [1, 8, 64, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tcq4_backward_matches_jax(m, dtype, monkeypatch):
    """x.grad of a TCQ4 linear under autograd, at the M of each route (gx2,
    the dequant kernel, i8p with the pack), against ``_tcq4_apply_bwd`` on
    the same g; the forward equals the one without autograd."""
    from rrs_tpu.formats.tcq4 import quantize_tcq4

    monkeypatch.setenv("RRS_PREFILL_I8", "1")
    rng = np.random.default_rng(m)
    k, n = 512, 96
    wm = (rng.standard_normal((n, k)) * 0.05).astype(np.float32)
    jl = jlin.TCQ4Linear.from_tensor(quantize_tcq4(wm))
    tl = tlin.TCQ4Linear.from_arrays(np.array(jl.qs), np.asarray(jl.eff, np.float32))
    assert tl.i8p is not None
    tdt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(tdt)
    g = rng.standard_normal((m, n)).astype(np.float32)
    xr = x.clone().requires_grad_(True)
    y = tlin.linear_apply(tl, xr)
    with torch.no_grad():
        np.testing.assert_array_equal(y.detach().float().numpy(),
                                      tlin.linear_apply(tl, x).float().numpy())
    y.backward(torch.from_numpy(g).to(y.dtype))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    ref, *rest = jlin._tcq4_apply_bwd((jl.qs, jl.eff, jnp.zeros((0,), jdt)),
                                      jnp.asarray(g).astype(y.dtype == torch.float32
                                                            and jnp.float32 or jnp.bfloat16))
    assert rest == [None, None, None] and xr.grad.dtype == tdt
    got = xr.grad.float().numpy()
    ref = np.asarray(ref, np.float32)
    if dtype == "float32":
        assert _rel(got, ref) <= BWD_TOL
    else:                                   # one bf16 rounding of the same f32 value
        assert _rel(got, ref) <= 2 ** -8


@pytest.mark.parametrize("shape", [(4, 256, 128), (6, 320, 100)])
def test_q8_backward_matches_jax(shape):
    """dx and the f32 scales' gradient of a Q8_0 linear against ``jax.grad``
    of JAX's ``linear_apply`` (its CPU route ``q8_matmul_ref``), a K padded to
    256 and an N padded to 128 among them."""
    m, k, n = shape
    rng = np.random.default_rng(k)
    jl = jlin.Q8Linear.quantize((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    assert (jl.k_logical != 0) == (k % 256 != 0)
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)

    def jf(xx, sc):
        lay = dataclasses.replace(jl, scale=sc)
        return jnp.sum(jlin.linear_apply(lay, xx) * g)

    jgx, jgs = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jl.scale)
    tl = tlin.Q8Linear(q=torch.from_numpy(np.array(jl.q)),
                       scale=torch.from_numpy(np.array(jl.scale)).requires_grad_(True),
                       n_logical=jl.n_logical, k_logical=jl.k_logical)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tlin.linear_apply(tl, xt) * torch.from_numpy(g)).sum().backward()
    assert _rel(xt.grad.numpy(), np.asarray(jgx)) <= BWD_TOL
    assert _rel(tl.scale.grad.numpy(), np.asarray(jgs)) <= BWD_TOL


def test_mxfp4_backward_matches_jax():
    """dx of an MXFP4 linear against ``jax.grad`` of JAX's ``linear_apply``
    (its CPU route ``mxfp4_matmul_ref``); the e8m0 scales are integers."""
    from rrs_tpu.formats.kquants import quantize_mxfp4

    rng = np.random.default_rng(7)
    n, k, m = 100, 256, 5
    raw = quantize_mxfp4((rng.standard_normal((n, k)) * 0.05).astype(np.float32))
    jl = jlin.MXFP4Linear.from_gguf(raw, (n, k))
    tl = tlin.MXFP4Linear.from_gguf(raw, (n, k))
    x = rng.standard_normal((m, k)).astype(np.float32)
    g = rng.standard_normal((m, n)).astype(np.float32)
    jgx = jax.grad(lambda xx: jnp.sum(jlin.linear_apply(jl, xx) * g))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (tlin.linear_apply(tl, xt) * torch.from_numpy(g)).sum().backward()
    assert _rel(xt.grad.numpy(), np.asarray(jgx)) <= BWD_TOL


# ---------------------------------------------------------------------------
# The verb, the loader, and the refusals
# ---------------------------------------------------------------------------

def _verb_files(tmp_path):
    from rrs_tpu.models.export import export_random_gguf

    cfg = _cfg()
    vocab = [chr(33 + i) for i in range(cfg.vocab_size)]
    src = export_random_gguf(cfg, tmp_path / "src.gguf", seed=0, vocab_tokens=vocab)
    pattern = "".join(np.random.default_rng(9).choice(vocab, 24))
    text = tmp_path / "train.txt"
    text.write_text(pattern * 12)
    return src, text


def test_finetune_verb_matches_jax(tmp_path, capsys):
    """``finetune --device cpu`` against JAX's verb on the same GGUF and
    text: the same batch count, per-step losses within 1e-3 (the reference's
    limit on a reloaded loss; measured 3e-4 after 16 AdamW steps at lr 3e-3,
    the sign sensitivity of Adam again), the written tensors within
    WEIGHT_TOL_LR x lr, and the trained loss the verb prints equal to the
    reloaded file's."""
    from rrs_tpu.__main__ import main as jax_main
    from rrs_tpu_torch.__main__ import main
    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.models.vocab import Vocab

    src, text = _verb_files(tmp_path)
    args = ["finetune", "-m", str(src), "-f", str(text), "--lr", "3e-3", "--seq-len", "16",
            "--batch", "2", "--epochs", "2"]
    jax_main(args + ["-o", str(tmp_path / "jax.gguf")])
    jout = capsys.readouterr().out
    main(args + ["-o", str(tmp_path / "port.gguf"), "--device", "cpu"])
    tout = capsys.readouterr().out
    head = lambda s: s.splitlines()[0]                                   # noqa: E731
    assert head(tout) == head(jout) and "-> 8 batches" in head(jout)
    step = re.compile(r"step (\d+): loss ([0-9.]+)")
    lj = [float(v) for _, v in step.findall(jout)]
    lt = [float(v) for _, v in step.findall(tout)]
    assert len(lt) == len(lj) == 16
    np.testing.assert_allclose(lt, lj, rtol=0, atol=1e-3)
    gj, gt = read_gguf(tmp_path / "jax.gguf"), read_gguf(tmp_path / "port.gguf")
    try:
        assert set(gt.tensors) == set(gj.tensors)
        assert gt.metadata == gj.metadata
        for name in gj.tensors:
            a, b = np.asarray(gj.tensor(name)), np.asarray(gt.tensor(name))
            assert np.abs(a - b).max() <= WEIGHT_TOL_LR * 3e-3, name
    finally:
        gj.close()
        gt.close()
    trained = float(re.search(r"trained loss ([0-9.]+)", tout).group(1))
    cfg, w, _ = load_model(tmp_path / "port.gguf", dtype=torch.float32, fuse=False, device="cpu")
    g = read_gguf(src)
    vocab = Vocab.from_gguf(g.metadata)
    g.close()
    toks = vocab.encode(text.read_text(), add_special=True)
    batches = tft.make_dataset(toks, seq_len=16, batch=2)[:2]
    assert abs(tft.evaluate(cfg, w, batches, device="cpu") - trained) < 1e-3
    assert trained < lt[0]


def test_finetune_verb_needs_cuda_unless_asked(tmp_path):
    from rrs_tpu_torch.__main__ import main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    src, text = _verb_files(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["finetune", "-m", str(src), "-f", str(text), "-o", str(tmp_path / "o.gguf")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tft.train(torch_cfg(_cfg()), None, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tft.evaluate(torch_cfg(_cfg()), None, [])


def test_load_f32_unfused_matches_jax_leaves(tmp_path, monkeypatch):
    """``load_model(dtype=f32, fuse=False)`` as the verb loads: every leaf in
    the dtype JAX's loader gives it (float leaves f32, TCQ4 eff bf16, codes
    integer), unfused, the TCQ4 linears with their i8p packs. JAX's loader
    runs its NumPy route: its native one keeps eff in f32, which the port
    does not copy (ROADMAP queue C)."""
    from unittest import mock

    from rrs_tpu import native as jax_native
    from rrs_tpu.models.loader import load_model as jax_load_model
    from rrs_tpu_torch.models.loader import load_model
    from test_torch_common import tcq4_gguf

    monkeypatch.setenv("RRS_PREFILL_I8", "1")
    path = tcq4_gguf(tmp_path)
    with mock.patch.object(jax_native, "available", lambda: False):
        _, jw, _ = jax_load_model(path, dtype=np.float32, fuse=False)
    _, tw, _ = load_model(path, dtype=torch.float32, fuse=False, device="cpu")
    lw = tw.layers[0]
    assert lw.wqkv is None and lw.w_gateup is None
    assert isinstance(lw.wq, tlin.TCQ4Linear) and lw.wq.i8p is not None

    def dtypes(tree, prefix=""):
        out = {}
        if dataclasses.is_dataclass(tree):
            for f in dataclasses.fields(tree):
                out.update(dtypes(getattr(tree, f.name), f"{prefix}{f.name}."))
        elif isinstance(tree, (list, tuple)):
            for i, x in enumerate(tree):
                out.update(dtypes(x, f"{prefix}{i}."))
        elif hasattr(tree, "dtype"):
            out[prefix[:-1]] = str(tree.dtype).replace("torch.", "")
        return out

    dj, dt = dtypes(jw), dtypes(tw)
    assert dj == {k: v.replace("int64", "int32") if k.endswith("gather") else v
                  for k, v in dt.items()}
    floats = {k: v for k, v in dt.items() if "float" in v}
    assert floats and all(v == "float32" for k, v in floats.items() if not k.endswith(".eff"))
    assert all(v == "bfloat16" for k, v in floats.items() if k.endswith(".eff"))


def test_tcq4_gather_backward_refused():
    """JAX's jax.grad fails in the Pallas call of a TCQ4 linear with a channel
    permutation (linear.py:480-483 bypasses _tcq4_apply); the port raises
    NotImplementedError there, and runs it without autograd."""
    from rrs_tpu.formats.tcq4 import quantize_tcq4

    rng = np.random.default_rng(0)
    wm = (rng.standard_normal((64, 256)) * 0.05).astype(np.float32)
    t = quantize_tcq4(wm, perm=rng.permutation(256))
    jl = jlin.TCQ4Linear.from_tensor(t)
    tl = tlin.TCQ4Linear.from_arrays(t.qs, np.asarray(jl.eff, np.float32), perm=t.perm)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    with pytest.raises(Exception):
        jax.grad(lambda xx: jnp.sum(jlin.linear_apply(jl, xx)))(jnp.asarray(x))
    with pytest.raises(NotImplementedError, match="channel permutation"):
        tlin.linear_apply(tl, torch.from_numpy(x).requires_grad_(True))
    with torch.no_grad():
        y = tlin.linear_apply(tl, torch.from_numpy(x).requires_grad_(True))
    assert y.shape == (4, 64) and not y.requires_grad


@pytest.mark.parametrize("kind", ["tcq4", "mxfp4"])
def test_packed_experts_backward_refused(kind):
    """jax.grad fails in every branch of JAX's moe_ffn over packed stacks;
    the port refuses them under autograd and runs them without."""
    from rrs_tpu.formats.kquants import quantize_mxfp4
    from rrs_tpu.models import moe as jmoe
    from rrs_tpu.ops import mxfp4_matmul as jmx
    from rrs_tpu_torch.models import moe as tmoe

    cfg = _cfg(arch="qwen3moe", n_embd=256, n_ff=0, n_experts=4, n_experts_used=2,
               n_ff_exp=256, norm_topk_prob=True)
    rng = np.random.default_rng(1)
    e = 4
    dense = {n: (rng.standard_normal((e, 256, 256)) * 0.05).astype(np.float32)
             for n in ("gate", "up", "down")}
    router = (rng.standard_normal((256, e)) * 0.05).astype(np.float32)
    if kind == "tcq4":
        jmw = jmoe.quantize_experts(jmoe.MoEWeights(
            router=jnp.asarray(router), **{k: jnp.asarray(v, jnp.bfloat16)
                                           for k, v in dense.items()}))
    else:
        def stack(ws):
            packed = [jmx.pack_mxfp4_device(quantize_mxfp4(np.ascontiguousarray(w.T)),
                                            (256, 256)) for w in ws]
            return (jnp.asarray(np.stack([p[0] for p in packed])),
                    jnp.asarray(np.stack([p[1] for p in packed])))
        st = {n: stack(v) for n, v in dense.items()}
        jmw = jmoe.MoEWeights(router=jnp.asarray(router), gate=None, up=None, down=None,
                              quant_kind="mxfp4", **{f"{n}_{s}": st[n][i] for n in st
                                                     for i, s in enumerate(("qs", "eff"))})
    tmw = tmoe.MoEWeights(router=torch.from_numpy(router), quant_kind=kind, **{
        f"{n}_{s}": torch.from_numpy(np.array(getattr(jmw, f"{n}_{s}")).view(
            np.uint16) if s == "eff" and kind == "tcq4" else np.array(getattr(jmw, f"{n}_{s}")))
        for n in ("gate", "up", "down") for s in ("qs", "eff")})
    if kind == "tcq4":
        for n in ("gate", "up", "down"):
            setattr(tmw, f"{n}_eff", getattr(tmw, f"{n}_eff").view(torch.bfloat16))
    x = rng.standard_normal((1, 4, 256)).astype(np.float32)
    with pytest.raises(Exception):
        jax.grad(lambda xx: jnp.sum(jmoe.moe_ffn(cfg, jmw, xx)))(jnp.asarray(x))
    tcfg = torch_cfg(cfg)
    with pytest.raises(NotImplementedError, match="packed"):
        tmoe.moe_ffn(tcfg, tmw, torch.from_numpy(x).requires_grad_(True))
    with torch.no_grad():
        y = tmoe.moe_ffn(tcfg, tmw, torch.from_numpy(x).requires_grad_(True))
    assert y.shape == (1, 4, 256) and torch.isfinite(y).all()


def test_kernel_wrappers_refuse_grad():
    """A wrapper called under grad with an input that requires grad raises
    (its output would cut the gradient); under no_grad, and inside the
    autograd Functions, it runs."""
    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    x = torch.ones(3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.refuse_grad("k", torch.zeros(3), x)
    kernels.refuse_grad("k", torch.zeros(3), x.detach(), None)
    with torch.no_grad():
        kernels.refuse_grad("k", x)
    rng = np.random.default_rng(2)
    lin = tlin.Q8Linear.quantize((rng.standard_normal((64, 256)) * 0.05).astype(np.float32))
    a = torch.from_numpy(rng.standard_normal((2, 256)).astype(np.float32)).requires_grad_(True)
    with pytest.raises(RuntimeError, match="q8_matmul"):
        q8.q8_matmul(a, lin.q, lin.scale)
    qs = torch.randint(0, 256, (128, 64), dtype=torch.uint8)
    eff = torch.full((8, 64), 0.01).to(torch.bfloat16)
    with pytest.raises(RuntimeError, match="tcq4_matmul_gx2"):
        tm.tcq4_matmul_gx2(a, qs, eff)
    q = torch.zeros((1, 2, 4, 64), dtype=torch.bfloat16, requires_grad=True)
    kv = torch.zeros((1, 1, 2, 64), dtype=torch.bfloat16)
    pos = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="flash_attention"):
        fa.flash_attention(q, kv, kv, pos, 0.125)
    y = tlin.linear_apply(lin, a)
    y.sum().backward()
    assert y.grad_fn is not None and a.grad is not None
