"""Shared helpers for the tests that hold rrs_tpu_torch against rrs_tpu.

Inputs are made with NumPy from a seed and handed to both packages; the JAX
package's weights cross over as the plain nested dict of NumPy arrays that
``rrs_tpu_torch.models.llama.weights_from_numpy`` takes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

# The suite runs in several worker processes on one machine (pytest-xdist).
# At these sizes torch's intra-op threads, one per core in every worker by
# default, only contend with each other (the port's tests ran ~100x slower
# under 6 workers), so each worker keeps one.
torch.set_num_threads(1)

# The 2-layer model of tests/test_pipeline_e2e.py (every TCQ4 K a multiple of 256).
SMALL = dict(arch="qwen3", n_layers=2, n_embd=256, n_heads=4, n_kv_heads=2,
             head_dim=64, n_ff=512, vocab_size=256, context_length=512, qk_norm=True)


def jax_cfg(**over):
    from rrs_tpu.models.config import ModelConfig

    return ModelConfig(**{**SMALL, **over})


def torch_cfg(cfg):
    """The port's ModelConfig with the fields of a JAX one."""
    from rrs_tpu_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: getattr(cfg, k) for k in names if hasattr(cfg, k)})


def torch_clip(ccfg, cw, device="cpu"):
    """The port's (ClipConfig, ClipWeights) with the fields of the JAX
    package's: every array as an f32 tensor on ``device`` (the layers and the
    resampler dict too)."""
    from rrs_tpu_torch.mtmd import clip

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x, np.float32)).to(device)

    def fields(obj, skip=()):
        return {f.name: t(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in skip}

    layers = [clip.ClipLayer(**fields(lw)) for lw in cw.layers]
    rs = None if cw.rs is None else {k: t(v) for k, v in cw.rs.items()}
    return (clip.ClipConfig(**dataclasses.asdict(ccfg)),
            clip.ClipWeights(layers=layers, rs=rs, **fields(cw, skip=("layers", "rs"))))


def torch_audio(acfg, aw, device="cpu"):
    """The port's (AudioConfig, AudioWeights) of the JAX package's: every
    array an f32 tensor on ``device`` (the layers and the projector dict
    too). The conv weights are [Cout, Cin, 3] in both packages."""
    from rrs_tpu_torch.mtmd import audio

    def t(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    def fields(obj, skip=()):
        return {f.name: t(getattr(obj, f.name)) for f in dataclasses.fields(obj)
                if f.name not in skip}

    return (audio.AudioConfig(**dataclasses.asdict(acfg)),
            audio.AudioWeights(layers=[audio.AudioLayer(**fields(lw)) for lw in aw.layers],
                               proj={k: t(v) for k, v in aw.proj.items()},
                               **fields(aw, skip=("layers", "proj"))))


# the vocoder's conv weights: the JAX package's [k, Cin, Cout] -> conv1d's
# [Cout, Cin / groups, k], turned once here as the port's loader turns them
VOCODER_CONVS = ("conv_w", "conv1_w", "conv2_w", "q_w", "k_w", "v_w", "o_w", "dw_w")


def torch_vocoder(vw, device="cpu"):
    """The port's VocoderWeights of the JAX package's, f32 on ``device``."""
    from rrs_tpu_torch.tts import vocoder

    def t(name, x):
        a = np.array(x, np.float32)
        if name in VOCODER_CONVS:
            a = np.ascontiguousarray(a.transpose(2, 1, 0))
        return torch.from_numpy(a).to(device)

    def params(d):
        return {k: t(k, v) for k, v in d.items()}

    skip = ("posnet", "convnext")
    return vocoder.VocoderWeights(
        posnet=[vocoder.PosnetLayer(kind=p.kind, params=params(p.params)) for p in vw.posnet],
        convnext=[params(c) for c in vw.convnext],
        **{f.name: t(f.name, getattr(vw, f.name)) for f in dataclasses.fields(vw)
           if f.name not in skip})


def to_numpy(x):
    return None if x is None else np.asarray(x)


def linear_tree(layer):
    """A JAX linear (or MoEWeights) dataclass -> dict of NumPy arrays (ints,
    floats and strings kept as they are, the i8p pack as a tuple of
    arrays)."""
    if layer is None:
        return None
    out = {}
    for f in dataclasses.fields(layer):
        v = getattr(layer, f.name)
        if isinstance(v, tuple):
            out[f.name] = tuple(to_numpy(a) for a in v)
        elif dataclasses.is_dataclass(v):          # a LoRA adapter's base linear
            out[f.name] = linear_tree(v)
        else:
            out[f.name] = v if isinstance(v, (int, float, str)) or v is None else to_numpy(v)
    return out


def weights_tree(w) -> dict:
    """JAX ModelWeights -> the nested NumPy dict of ``weights_from_numpy``."""
    def layer(lw):
        d = {}
        for f in dataclasses.fields(lw):
            v = getattr(lw, f.name)
            if v is None:
                d[f.name] = None
            elif dataclasses.is_dataclass(v):
                d[f.name] = linear_tree(v)
            else:
                d[f.name] = to_numpy(v)
        return d

    embed = w.embed
    embed = tuple(to_numpy(e) for e in embed) if isinstance(embed, tuple) else to_numpy(embed)
    return {"embed": embed, "layers": [layer(lw) for lw in w.layers],
            "final_norm": to_numpy(w.final_norm), "lm_head": linear_tree(w.lm_head),
            "rope_factors": to_numpy(getattr(w, "rope_factors", None))}


def small_jax_model(seed: int = 0, perm_layer: bool = False):
    """2-layer JAX model: random TCQ4 weights fused into qkv / gate-up and a
    Q8_0 lm_head, as the real loader builds them. ``perm_layer``: the last
    layer's qkv is quantized under a block-local channel permutation, so its
    activations take the gathered rotation."""
    from rrs_tpu.formats.tcq4 import quantize_tcq4
    from rrs_tpu.models import llama as jllama
    from rrs_tpu.models.linear import Q8Linear, TCQ4Linear, fuse_linears

    cfg = jax_cfg()
    w = jllama.random_weights(cfg, seed=seed, quantize=True)
    rng = np.random.default_rng(seed + 100)
    for lw in w.layers:
        lw.wqkv = fuse_linears([lw.wq, lw.wk, lw.wv])
        lw.w_gateup = fuse_linears([lw.w_gate, lw.w_up])
        lw.wq = lw.wk = lw.wv = lw.w_gate = lw.w_up = None
    if perm_layer:
        e, n = cfg.n_embd, cfg.n_q_dim + 2 * cfg.n_kv_dim
        perm = np.concatenate([rng.permutation(256) + 256 * b for b in range(e // 256)])
        wqkv = (rng.standard_normal((n, e)) * 0.02).astype(np.float32)
        w.layers[-1].wqkv = TCQ4Linear.from_tensor(quantize_tcq4(wqkv, perm=perm))
    head = (rng.standard_normal((cfg.vocab_size, cfg.n_embd)) * 0.05).astype(np.float32)
    w.lm_head = Q8Linear.quantize(head)
    return cfg, w


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-30))


def tiny_vocab_tokens(n: int) -> list[str]:
    """The char-level vocabulary of tests/test_server.py: token i is a
    printable char, or <tok{i}> past U+02FF."""
    return [chr(33 + i) if 33 + i < 0x2FF else f"<tok{i}>" for i in range(n)]


def tcq4_gguf(directory, seed: int = 0):
    """A 2-layer TCQ4 GGUF with a char vocab, written by the JAX package's
    exporter and quantizer; returns its path."""
    from rrs_tpu.models.export import export_random_gguf
    from rrs_tpu.quantize.quantizer import quantize_model

    src, dst = directory / "f32.gguf", directory / "tcq4.gguf"
    vocab = [chr(33 + i) if 33 + i < 288 else f"<t{i}>" for i in range(256)]
    export_random_gguf(jax_cfg(), src, seed=seed, vocab_tokens=vocab)
    quantize_model(src, dst, verbose=False)
    return dst


def rewrite_gguf(src, dst, kv: dict | None = None, edit=None, drop_kv=()):
    """Copy the GGUF ``src`` to ``dst`` with JAX's writer: every KV but those
    named in ``drop_kv``, plus or over ``kv``; every tensor as f32, passed
    through ``edit(name, array) -> {name: array}`` when given (which may
    rename, split, merge or drop by returning several or none); then the
    tensors ``edit("", None)`` returns last."""
    from rrs_tpu.gguf.reader import read_gguf as jax_read_gguf
    from rrs_tpu.gguf.writer import GGUFWriter as JaxWriter

    g = jax_read_gguf(src)
    w = JaxWriter(dst)
    for k, v in g.metadata.items():
        if k not in (kv or {}) and k not in drop_kv:
            w.add_kv(k, v, vtype=g.metadata_types.get(k))
    for k, v in (kv or {}).items():
        w.add_kv(k, v)
    out = {}
    for name in g.tensors:
        arr = np.array(g.tensor(name), np.float32)
        out.update(edit(name, arr) if edit else {name: arr})
    if edit:
        out.update(edit("", None) or {})
    for name, arr in out.items():
        w.add_tensor(name, np.ascontiguousarray(arr, np.float32))
    w.write()
    g.close()
    return dst


def assert_same_greedy(got: list, ref: list, rows: np.ndarray) -> None:
    """Greedy tokens identical, step by step, up to a step where the
    reference's top two logits tie at bf16 resolution (one step of the top
    value apart, so that either package's rounding may pick either): there
    the port's token must be one of the tied ones, and the runs part."""
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        if a == b:
            continue
        top = rows[i].max()
        ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7)
        assert rows[i][a] >= top - ulp, (i, got, ref, rows[i][a], top)
        return


@contextlib.contextmanager
def exact_jit():
    """``jax.jit`` compiling without XLA's CPU excess precision, within the
    block: jitted bf16 chains then round where the op-by-op forward (and the
    port) rounds, as ``jax.disable_jit`` would give, at jit speed. The JAX
    package's sharded steps (``shard_map`` under ``jax.jit``) are held to the
    port this way."""
    import functools
    from unittest import mock

    import jax

    orig = jax.jit

    def jit(fun=None, **kw):
        kw.setdefault("compiler_options", {"xla_allow_excess_precision": False})
        return orig(fun, **kw) if fun is not None else functools.partial(jit, **kw)

    with mock.patch.object(jax, "jit", jit):
        yield
