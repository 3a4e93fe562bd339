"""GGUF -> device weights.

Port of ``load_model`` with ``_linear`` / ``_norm`` / ``_load_moe`` from
``rrs_tpu/models/loader.py``. A path named ``<base>-NNNNN-of-NNNNN.gguf``
opens the whole shard set (``tools.gguf_split.MultiGGUF``). TCQ4_K32 tensors
(with their ``tcq4.*.perm`` channel permutations) decode on the host into the
K-major kernel layout, through the native tile decode where it builds, else
the NumPy tile codec (the same codes and f32 eff; eff is rounded to bf16
either way, where the JAX package's native route keeps it f32); Q8_0 matrices
stay packed (Q8Linear, and the Q8_0 embedding table when the head is
untied); MXFP4 matrices and gpt-oss expert stacks stay packed in the device
layout of ``ops/mxfp4_matmul.py``; every other type (F32/F16/BF16, the
K-quants, legacy quants and i-quants) is dequantized by ``kquants`` into a
bf16 DenseLinear; a tied head is the transposed embedding. MoE expert stacks
load as MXFP4 (gpt-oss), TCQ4_K32 (decoded per expert into the stacked
kernel layout, eff rounded to bf16) or dense (any other type, dequantized and
transposed to [E, K, N] bf16); a quantized router is dequantized to the
original domain; qwen2moe's shared expert (``ffn_{gate,up,down}_shexp``)
loads dense, whatever its type, as in the JAX package, and its gate
``ffn_gate_inp_shexp`` is ignored with a warning, as JAX ignores it.
gpt-oss's router and expert biases, its per-head sinks (under either tensor
name) and its pre-FFN norm (shipped as ``post_attention_norm``) load as the
JAX package loads them.

The other attention families load as in ``rrs_tpu/models/loader.py``: an MLA
layer (``attn_kv_a_mqa``) takes ``attn_q_a`` + ``attn_q_a_norm`` + ``attn_q_b``
(or the lite form's single ``attn_q``), ``attn_kv_a_mqa`` + ``attn_kv_a_norm``,
and the split ``attn_k_b`` / ``attn_v_b`` factors, or the legacy ``attn_kv_b``
split on load, as bf16 [H, nope, r] / [H, r, v]; its linears stay unfused,
its leading dense layers take ``ffn_gate`` / ``ffn_up`` / ``ffn_down`` and its
MoE layers their ``_shexp`` shared experts (dense). gemma's
``post_attention_norm`` / ``post_ffw_norm`` (and olmo2's) load as the
sandwich norms, and a missing pre-norm (olmo2 ships none) as ones; phi3's
pre-fused ``attn_qkv`` (with its bias) fills the fused qkv slot, a lone
``ffn_up`` of 2 x n_ff the fused gate-up slot, and ``rope_factors_long`` or
``_short`` (long when the trained context exceeds the original) the LongRoPE
factors. A llama / mistral / qwen file whose layers carry ``ffn_gate_inp``
loads them as MoE layers.

The recurrent families load as ``_load_mamba`` / ``_load_rwkv6`` /
``_load_hybrid`` of the JAX loader, chosen as it chooses them (hybrid, then
RWKV6, then Mamba): the same tensor names, the conv taps transposed to
[d_conv, d_inner], ``ssm_a`` / ``ssm_d`` with or without their ``.weight``
suffix, dt / B / C norms where a layer has them; RWKV6's LoRA factors
transposed to x @ w, its lerps flattened (``time_mix_lerp_fused``, or the
five ``time_mix_lerp_{w,k,v,r,g}``) and its norms f32; a jamba layer is a
Mamba layer when it has ``ssm_in`` and attention otherwise, its FFN dense or
MoE. Their linears stay unfused, as the JAX loader keeps them.
"""

from __future__ import annotations

import warnings
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch import native
from rrs_tpu_torch.device import resolve_device
from rrs_tpu_torch.formats.tcq4 import effective_scales
from rrs_tpu_torch.formats.tile_codec import decode_tcq4_gguf
from rrs_tpu_torch.gguf.constants import GGMLType, tcq4_perm_key
from rrs_tpu_torch.gguf.reader import GGUFFile, read_gguf
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import (DenseLinear, MXFP4Linear, Q8Linear, TCQ4Linear,
                                         fuse_linears)
from rrs_tpu_torch.models.llama import LayerWeights, ModelWeights
from rrs_tpu_torch.models.moe import MoEWeights
from rrs_tpu_torch.ops.mxfp4_matmul import pack_mxfp4_device
from rrs_tpu_torch.tools.gguf_split import SPLIT_RE, MultiGGUF

def _f32(g: GGUFFile, name: str) -> np.ndarray:
    """A writable f32 copy (the reader hands out read-only mmap views)."""
    return np.array(g.tensor(name), dtype=np.float32)


def _norm(g: GGUFFile, name: str, device, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(_f32(g, name)).to(device=device, dtype=dtype)


def _tcq4_codes(raw: np.ndarray, shape) -> tuple[np.ndarray, np.ndarray]:
    """A TCQ4_K32 payload for a logical [N, K] weight -> (qs u8 [K//2, N],
    eff f32 [K//32, N]): the native tile decode where it builds, else the
    NumPy codec (the same bits)."""
    if native.available():
        return native.tcq4_decode_tiles(raw, shape[0], shape[1])
    t = decode_tcq4_gguf(raw, shape)
    return t.qs, effective_scales(t)


def _dense(w: np.ndarray, device, dtype) -> DenseLinear:
    """A bf16 DenseLinear from a logical [N, K] f32 weight."""
    return DenseLinear(w=torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device,
                                                                        dtype=dtype))


def _linear(g: GGUFFile, name: str, device, dtype=torch.bfloat16,
            bias_name: Optional[str] = None):
    """A linear from GGUF tensor ``name`` (logical [N, K])."""
    info = g.tensors[name]
    bias = None
    if bias_name and bias_name in g.tensors:
        bias = torch.from_numpy(_f32(g, bias_name)).to(device)
    if info.ggml_type == GGMLType.TCQ4_K32:
        qs, eff = _tcq4_codes(g.tensor_bytes(name), info.shape)
        return TCQ4Linear.from_arrays(qs, eff, perm=g.metadata.get(tcq4_perm_key(name)),
                                      bias=bias, device=device)
    if info.ggml_type == GGMLType.Q8_0 and len(info.shape) == 2 and info.shape[1] % 32 == 0:
        return Q8Linear.from_q8_gguf(g.tensor_bytes(name), info.shape, bias=bias,
                                     device=device)
    if info.ggml_type == GGMLType.MXFP4:
        if len(info.shape) != 2 or info.shape[1] % 64:
            raise NotImplementedError(f"{name}: MXFP4 {info.shape} needs a 2-D weight with "
                                      "K % 64 == 0")
        return MXFP4Linear.from_gguf(g.tensor_bytes(name), info.shape, bias=bias, device=device)
    lin = _dense(_f32(g, name), device, dtype)            # any other type, dequantized
    lin.bias = bias
    return lin


def _load_moe(g: GGUFFile, p: str, device, dtype=torch.bfloat16) -> MoEWeights:
    """MoEWeights of layer prefix ``p``: the router (x @ router, in
    ``dtype``), the gpt-oss router and per-expert biases (GGUF [E, N]
    arrays), an expert-selection bias, a shared expert (dense bf16, [K, N]
    like a DenseLinear's weight), and the expert stacks (GGUF gate / up
    [E, F, K], down [E, K, F]): MXFP4 packed per expert, TCQ4_K32 decoded per
    expert, or dense (any other type, dequantized)."""
    def f32(name):
        return torch.from_numpy(_f32(g, name)).to(device)

    fields = dict(router=torch.from_numpy(
        np.ascontiguousarray(_f32(g, f"{p}.ffn_gate_inp.weight").T)).to(device=device, dtype=dtype))
    for tname, field in (("exp_probs_b.bias", "probs_bias"), ("ffn_gate_inp.bias", "router_bias"),
                         ("ffn_gate_exps.bias", "gate_b"), ("ffn_up_exps.bias", "up_b"),
                         ("ffn_down_exps.bias", "down_b")):
        if f"{p}.{tname}" in g.tensors:
            fields[field] = f32(f"{p}.{tname}")
    for n in ("gate", "up", "down"):
        if f"{p}.ffn_{n}_shexp.weight" in g.tensors:
            fields[f"shared_{n}"] = _dense(_f32(g, f"{p}.ffn_{n}_shexp.weight"), device, dtype).w
    names = {n: f"{p}.ffn_{n}_exps.weight" for n in ("gate", "up", "down")}
    kind = g.tensors[names["gate"]].ggml_type
    if kind == GGMLType.MXFP4 and all(g.tensors[nm].shape[-1] % 64 == 0
                                      for nm in names.values()):
        for n, name in names.items():
            info = g.tensors[name]
            raw = g.tensor_bytes(name)
            per = raw.size // info.shape[0]
            packed = [pack_mxfp4_device(raw[ei * per:(ei + 1) * per], info.shape[1:])
                      for ei in range(info.shape[0])]
            fields[f"{n}_qs"] = torch.from_numpy(np.stack([q for q, _ in packed])).to(device)
            fields[f"{n}_eff"] = torch.from_numpy(np.stack([s for _, s in packed])).to(device)
        return MoEWeights(quant_kind="mxfp4", **fields)
    if kind == GGMLType.TCQ4_K32:
        # per-expert payloads, concatenated in expert order
        for n, name in names.items():
            info = g.tensors[name]
            raw = g.tensor_bytes(name)
            per = raw.size // info.shape[0]
            codes = [_tcq4_codes(raw[ei * per:(ei + 1) * per], info.shape[1:])
                     for ei in range(info.shape[0])]
            fields[f"{n}_qs"] = torch.from_numpy(np.stack([q for q, _ in codes])).to(device)
            fields[f"{n}_eff"] = torch.from_numpy(np.stack(
                [e for _, e in codes])).to(torch.bfloat16).to(device)
        return MoEWeights(quant_kind="tcq4", **fields)
    for n, name in names.items():
        # any other stack type is dequantized whole (the reader's kquants route)
        fields[n] = torch.from_numpy(np.ascontiguousarray(_f32(g, name).transpose(0, 2, 1))).to(
            device=device, dtype=dtype)
    return MoEWeights(**fields)


def _mla_layer(g: GGUFFile, cfg: ModelConfig, p: str, lin, norm, has, device, dtype,
               moe) -> LayerWeights:
    """One deepseek2 layer: the q LoRA (or the lite form's single attn_q),
    the joint kv projection with its norm, the wk_b / wv_b factors (split in
    the file, or the legacy attn_kv_b split here) as bf16, and a dense FFN or
    the MoE layer, every linear unfused as the JAX loader keeps them."""
    nope = cfg.qk_nope_dim
    if has("attn_k_b"):
        # GGUF [H, r, nope] -> [H, nope, r]; [H, v, r] -> [H, r, v]
        wk_b = _f32(g, f"{p}.attn_k_b.weight").transpose(0, 2, 1)
        wv_b = _f32(g, f"{p}.attn_v_b.weight").transpose(0, 2, 1)
    else:
        # legacy [H * (nope + v), r]
        kvb = _f32(g, f"{p}.attn_kv_b.weight").reshape(cfg.n_heads, nope + cfg.v_head_dim, -1)
        wk_b = kvb[:, :nope, :]
        wv_b = kvb[:, nope:, :].transpose(0, 2, 1)

    def fac(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    lite = not has("attn_q_a")
    return LayerWeights(
        attn_norm=norm("attn_norm"),
        wq=lin("attn_q") if lite else lin("attn_q_b"),
        wq_a=None if lite else lin("attn_q_a"),
        q_norm=None if lite else norm("attn_q_a_norm"),
        wkv_a=lin("attn_kv_a_mqa"), k_norm=norm("attn_kv_a_norm"),
        wk_b=fac(wk_b), wv_b=fac(wv_b), wk=None, wv=None,
        wo=lin("attn_output"),
        ffn_norm=norm("ffn_norm"),
        w_gate=None if moe is not None else lin("ffn_gate"),
        w_up=None if moe is not None else lin("ffn_up"),
        w_down=None if moe is not None else lin("ffn_down"),
        moe=moe)


def load_model(path: str | Path, dtype=torch.bfloat16, overrides: dict | None = None,
               device=None, fuse: bool = True):
    """Load a GGUF model (one file, or any shard of a ``-NNNNN-of-NNNNN``
    set) onto ``device`` (``None`` = cuda), with the q/k/v and gate/up
    projections fused where ``fuse_linears`` can. ``fuse=False`` keeps every
    linear separate (TCQ4 ones with their i8p packs), as LoRA adapters need
    (``models.adapter.attach_lora``).
    Returns (config, weights, metadata)."""
    dev = resolve_device(device)
    g = MultiGGUF(path) if SPLIT_RE.match(Path(path).name) else read_gguf(path)
    try:
        if overrides:
            g.metadata.update(overrides)
        cfg = ModelConfig.from_gguf(g.metadata)
        if cfg.vocab_size == 0:
            import dataclasses

            cfg = dataclasses.replace(cfg, vocab_size=g.tensors["token_embd.weight"].shape[0])
        if cfg.is_hybrid:
            return _load_hybrid(g, cfg, dev, dtype)
        if cfg.rwkv_head_size > 0:
            return _load_rwkv6(g, cfg, dev, dtype)
        if cfg.is_recurrent:
            return _load_mamba(g, cfg, dev, dtype)
        if any(t.endswith("ffn_gate_inp_shexp.weight") for t in g.tensors):
            warnings.warn(f"{path}: ffn_gate_inp_shexp (the shared expert's gate) is ignored and "
                          "the shared expert is added ungated, as the JAX package does; the "
                          "outputs differ from the published model's", stacklevel=2)
        layers = []
        for i in range(cfg.n_layers):
            p = f"blk.{i}"
            lin = lambda n, b=None: _linear(g, f"{p}.{n}.weight", dev, dtype,   # noqa: E731
                                            b and f"{p}.{n}.bias")
            norm = lambda n: _norm(g, f"{p}.{n}.weight", dev, dtype)           # noqa: E731
            has = lambda n: f"{p}.{n}.weight" in g.tensors                     # noqa: E731
            is_moe = has("ffn_gate_inp")
            moe = _load_moe(g, p, dev, dtype) if is_moe else None
            if has("attn_kv_a_mqa"):
                layers.append(_mla_layer(g, cfg, p, lin, norm, has, dev, dtype, moe))
                continue
            wq = wk = wv = w_gate = w_up = wqkv = w_gateup = None
            if has("attn_qkv"):
                wqkv = lin("attn_qkv", 1)             # phi3: pre-fused q|k|v
            else:
                wq, wk, wv = lin("attn_q", 1), lin("attn_k", 1), lin("attn_v", 1)
                if fuse and type(wq) is type(wk) is type(wv):
                    wqkv = fuse_linears([wq, wk, wv])
                if wqkv is not None:
                    wq = wk = wv = None
            if not is_moe:
                if not has("ffn_gate") and has("ffn_up"):
                    w_gateup = lin("ffn_up")          # phi3: pre-fused gate|up
                else:
                    w_gate, w_up = lin("ffn_gate"), lin("ffn_up")
                    if fuse and type(w_gate) is type(w_up):
                        w_gateup = fuse_linears([w_gate, w_up])
                    if w_gateup is not None:
                        w_gate = w_up = None
            has_qn = has("attn_q_norm")
            # gpt-oss ships its pre-FFN norm under the post_attention_norm
            # name; every other family's is a sandwich norm
            ffn_norm = "ffn_norm"
            if cfg.arch == "gpt-oss" and not has(ffn_norm):
                ffn_norm = "post_attention_norm"
            sandwich = cfg.arch != "gpt-oss"
            sinks = next((n for n in (f"{p}.attn_sinks.weight", f"{p}.attn_sinks")
                          if n in g.tensors), None)
            ones = torch.ones((cfg.n_embd,), dtype=dtype, device=dev)
            layers.append(LayerWeights(
                # olmo2 ships no pre-norms: ones stand in (unused)
                attn_norm=norm("attn_norm") if has("attn_norm") else ones,
                wq=wq, wk=wk, wv=wv,
                wo=lin("attn_output", 1),
                q_norm=norm("attn_q_norm") if has_qn else None,
                k_norm=norm("attn_k_norm") if has_qn else None,
                ffn_norm=norm(ffn_norm) if has(ffn_norm) else ones,
                w_gate=w_gate, w_up=w_up,
                w_down=None if is_moe else lin("ffn_down"),
                wqkv=wqkv, w_gateup=w_gateup,
                moe=moe,
                attn_sinks=None if sinks is None else torch.from_numpy(_f32(g, sinks)).to(dev),
                attn_post_norm=norm("post_attention_norm")
                if sandwich and has("post_attention_norm") else None,
                ffn_post_norm=norm("post_ffw_norm") if has("post_ffw_norm") else None,
            ))

        emb_info = g.tensors["token_embd.weight"]
        if emb_info.ggml_type == GGMLType.Q8_0 and "output.weight" in g.tensors:
            # large Q8_0 tables stay packed; rows are dequantized per lookup
            from rrs_tpu_torch.formats.kquants import q8_blocks

            q, d = q8_blocks(np.ascontiguousarray(g.tensor_bytes("token_embd.weight")),
                             emb_info.shape)
            embed = (torch.from_numpy(np.ascontiguousarray(q)).to(dev),
                     torch.from_numpy(np.ascontiguousarray(d)).to(dev))
        else:
            embed = torch.from_numpy(_f32(g, "token_embd.weight")).to(device=dev, dtype=dtype)
        if "output.weight" in g.tensors:
            lm_head = _linear(g, "output.weight", dev, dtype)
        else:
            lm_head = DenseLinear(w=embed.t())            # tied embeddings
        # LongRoPE (phi3): the long factors when the trained context exceeds
        # the original one, else the short ones
        rope_factors = None
        if "rope_factors_long.weight" in g.tensors:
            orig = cfg.rope_orig_context or cfg.context_length
            name = ("rope_factors_long.weight" if cfg.context_length > orig
                    else "rope_factors_short.weight")
            rope_factors = torch.from_numpy(_f32(g, name)).to(dev)
        weights = ModelWeights(embed=embed, layers=layers,
                               final_norm=_norm(g, "output_norm.weight", dev, dtype),
                               lm_head=lm_head, rope_factors=rope_factors)
        md = dict(g.metadata)
    finally:
        g.close()
    return cfg, weights, md


def _embed_and_head(g: GGUFFile, device, dtype):
    """A recurrent model's bf16 embedding and its head: ``output.weight``,
    or the tied transposed embedding."""
    embed = torch.from_numpy(_f32(g, "token_embd.weight")).to(device=device, dtype=dtype)
    if "output.weight" in g.tensors:
        return embed, _linear(g, "output.weight", device, dtype)
    return embed, DenseLinear(w=embed.t())


def _mamba_layer(g: GGUFFile, p: str, device, dtype):
    """One Mamba layer of prefix ``p``."""
    from rrs_tpu_torch.models.mamba import MambaLayer

    def f32(name):
        t = f"{p}.{name}.weight" if f"{p}.{name}.weight" in g.tensors else f"{p}.{name}"
        return torch.from_numpy(_f32(g, t)).to(device)

    def norm(name):
        t = f"{p}.{name}.weight"
        return _norm(g, t, device, dtype) if t in g.tensors else None

    return MambaLayer(
        norm=_norm(g, f"{p}.attn_norm.weight", device, dtype),
        w_in=_linear(g, f"{p}.ssm_in.weight", device, dtype),
        conv_w=f32("ssm_conv1d").t().contiguous(),              # -> [d_conv, d_inner]
        conv_b=torch.from_numpy(_f32(g, f"{p}.ssm_conv1d.bias")).to(device),
        w_x=_linear(g, f"{p}.ssm_x.weight", device, dtype),
        w_dt=_linear(g, f"{p}.ssm_dt.weight", device, dtype),
        dt_bias=torch.from_numpy(_f32(g, f"{p}.ssm_dt.bias")).to(device),
        A=f32("ssm_a"), D=f32("ssm_d"),
        w_out=_linear(g, f"{p}.ssm_out.weight", device, dtype),
        dt_norm=norm("ssm_dt_norm"), b_norm=norm("ssm_b_norm"), c_norm=norm("ssm_c_norm"))


def _load_mamba(g: GGUFFile, cfg: ModelConfig, device, dtype):
    from rrs_tpu_torch.models.mamba import MambaWeights

    layers = [_mamba_layer(g, f"blk.{i}", device, dtype) for i in range(cfg.n_layers)]
    embed, head = _embed_and_head(g, device, dtype)
    return cfg, MambaWeights(embed=embed, layers=layers,
                             final_norm=_norm(g, "output_norm.weight", device, dtype),
                             lm_head=head), dict(g.metadata)


def _load_rwkv6(g: GGUFFile, cfg: ModelConfig, device, dtype):
    """RWKV6 tensors (numpy shapes, the GGUF ne order reversed)."""
    from rrs_tpu_torch.models.rwkv6 import Rwkv6Layer, Rwkv6Weights

    e = cfg.n_embd

    def f32(name, transform=lambda a: a):
        return torch.from_numpy(np.ascontiguousarray(transform(_f32(g, name)))).to(device)

    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}"
        if f"{p}.time_mix_lerp_fused.weight" in g.tensors:
            fused = f32(f"{p}.time_mix_lerp_fused.weight", lambda a: a.reshape(5, e))
        else:
            fused = torch.stack([f32(f"{p}.time_mix_lerp_{n}.weight", lambda a: a.reshape(e))
                                 for n in ("w", "k", "v", "r", "g")])
        flat = lambda a: a.reshape(e)          # noqa: E731
        lin = lambda n: _linear(g, f"{p}.{n}.weight", device, dtype)   # noqa: E731
        layers.append(Rwkv6Layer(
            ln1_w=f32(f"{p}.attn_norm.weight"), ln1_b=f32(f"{p}.attn_norm.bias"),
            ln2_w=f32(f"{p}.attn_norm_2.weight"), ln2_b=f32(f"{p}.attn_norm_2.bias"),
            tm_w1=f32(f"{p}.time_mix_w1.weight", np.transpose),
            tm_w2=f32(f"{p}.time_mix_w2.weight", lambda a: a.transpose(0, 2, 1)),
            tm_lerp_x=f32(f"{p}.time_mix_lerp_x.weight", flat), tm_lerp_fused=fused,
            tm_first=f32(f"{p}.time_mix_first.weight"),
            tm_decay=f32(f"{p}.time_mix_decay.weight", flat),
            tm_decay_w1=f32(f"{p}.time_mix_decay_w1.weight", np.transpose),
            tm_decay_w2=f32(f"{p}.time_mix_decay_w2.weight", np.transpose),
            w_key=lin("time_mix_key"), w_value=lin("time_mix_value"),
            w_recept=lin("time_mix_receptance"), w_gate=lin("time_mix_gate"),
            w_out=lin("time_mix_output"),
            tm_ln_w=f32(f"{p}.time_mix_ln.weight"), tm_ln_b=f32(f"{p}.time_mix_ln.bias"),
            cm_lerp_k=f32(f"{p}.channel_mix_lerp_k.weight", flat),
            cm_lerp_r=f32(f"{p}.channel_mix_lerp_r.weight", flat),
            cm_key=lin("channel_mix_key"), cm_value=lin("channel_mix_value"),
            cm_recept=lin("channel_mix_receptance")))
    embed, head = _embed_and_head(g, device, dtype)
    return cfg, Rwkv6Weights(
        embed=embed, tok_norm_w=f32("token_embd_norm.weight"),
        tok_norm_b=f32("token_embd_norm.bias"), layers=layers,
        final_norm_w=f32("output_norm.weight"), final_norm_b=f32("output_norm.bias"),
        lm_head=head), dict(g.metadata)


def _load_hybrid(g: GGUFFile, cfg: ModelConfig, device, dtype):
    """jamba: a Mamba layer where ``ssm_in`` is present, else attention
    (unfused q / k / v / o, no q / k norms); then a dense FFN or MoE."""
    from rrs_tpu_torch.models.hybrid import HybridLayer, HybridWeights

    layers = []
    for i in range(cfg.n_layers):
        p = f"blk.{i}"
        lin = lambda n: _linear(g, f"{p}.{n}.weight", device, dtype)   # noqa: E731
        attn = ssm = None
        if f"{p}.ssm_in.weight" in g.tensors:
            ssm = _mamba_layer(g, p, device, dtype)
        else:
            attn = LayerWeights(attn_norm=_norm(g, f"{p}.attn_norm.weight", device, dtype),
                                wq=lin("attn_q"), wk=lin("attn_k"), wv=lin("attn_v"),
                                wo=lin("attn_output"), q_norm=None, k_norm=None, ffn_norm=None,
                                w_gate=None, w_up=None, w_down=None)
        moe = (_load_moe(g, p, device, dtype) if f"{p}.ffn_gate_inp.weight" in g.tensors
               else None)
        layers.append(HybridLayer(
            kind="ssm" if ssm is not None else "attn", attn=attn, ssm=ssm,
            ffn_norm=_norm(g, f"{p}.ffn_norm.weight", device, dtype),
            w_gate=None if moe else lin("ffn_gate"), w_up=None if moe else lin("ffn_up"),
            w_down=None if moe else lin("ffn_down"), moe=moe))
    embed, head = _embed_and_head(g, device, dtype)
    return cfg, HybridWeights(embed=embed, layers=layers,
                              final_norm=_norm(g, "output_norm.weight", device, dtype),
                              lm_head=head), dict(g.metadata)


def parse_kv_overrides(specs) -> dict:
    """Parse ``--override-kv KEY=TYPE:VALUE`` specs; TYPE is one of
    int/float/bool/str."""
    out: dict = {}
    for spec in specs or []:
        key, eq, tv = spec.partition("=")
        typ, _, val = tv.partition(":")
        if not key or not eq or typ not in ("int", "float", "bool", "str"):
            raise ValueError(f"bad --override-kv {spec!r}; want KEY=TYPE:VALUE with "
                             f"TYPE in int/float/bool/str")
        if typ == "int":
            out[key] = int(val)
        elif typ == "float":
            out[key] = float(val)
        elif typ == "bool":
            out[key] = val.strip().lower() in ("1", "true", "yes", "on")
        else:
            out[key] = val
    return out
