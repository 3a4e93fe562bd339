"""GGUF -> device weights.

Port of ``load_model`` with ``_linear`` / ``_norm`` / ``_load_moe`` from
``rrs_tpu/models/loader.py``: TCQ4_K32 tensors (with their ``tcq4.*.perm``
channel permutations) decode on the host with the NumPy tile codec into the
K-major kernel layout; Q8_0 matrices stay packed (Q8Linear, and the Q8_0
embedding table when the head is untied); MXFP4 matrices and gpt-oss expert
stacks stay packed in the device layout of ``ops/mxfp4_matmul.py``;
F32/F16/BF16 become bf16 DenseLinears; a tied head is the transposed
embedding. MoE expert stacks load as MXFP4 (gpt-oss), TCQ4_K32 (decoded per
expert into the stacked kernel layout, eff rounded to bf16) or dense
F32/F16/BF16 (transposed to [E, K, N] bf16); a quantized router is
dequantized to the original domain. gpt-oss's router and expert biases, its
per-head sinks (under either tensor name) and its pre-FFN norm (shipped as
``post_attention_norm``) load as the JAX package loads them.

MLA, shared experts (ROADMAP A8c), recurrent and hybrid layers, sandwich
norms, fused pre-packed qkv / gate-up tensors and split GGUFs raise
NotImplementedError.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

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

_NOT_PORTED = ("attn_kv_a_mqa", "ssm_in", "time_mix_key", "attn_qkv", "post_ffw_norm",
               "ffn_gate_shexp")


def _f32(g: GGUFFile, name: str) -> np.ndarray:
    """A writable f32 copy (the reader hands out read-only mmap views)."""
    return np.array(g.tensor(name), dtype=np.float32)


def _norm(g: GGUFFile, name: str, device, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.from_numpy(_f32(g, name)).to(device=device, dtype=dtype)


def _linear(g: GGUFFile, name: str, device, dtype=torch.bfloat16,
            bias_name: Optional[str] = None):
    """A linear from GGUF tensor ``name`` (logical [N, K])."""
    info = g.tensors[name]
    bias = None
    if bias_name and bias_name in g.tensors:
        bias = torch.from_numpy(_f32(g, bias_name)).to(device)
    if info.ggml_type == GGMLType.TCQ4_K32:
        t = decode_tcq4_gguf(g.tensor_bytes(name), info.shape)
        perm = g.metadata.get(tcq4_perm_key(name))
        if perm is not None:
            t.perm = np.asarray(perm, np.int32)
        return TCQ4Linear.from_tensor(t, bias=bias, device=device)
    if info.ggml_type == GGMLType.Q8_0 and len(info.shape) == 2 and info.shape[1] % 32 == 0:
        return Q8Linear.from_q8_gguf(g.tensor_bytes(name), info.shape, bias=bias,
                                     device=device)
    if info.ggml_type == GGMLType.MXFP4:
        if len(info.shape) != 2 or info.shape[1] % 64:
            raise NotImplementedError(f"{name}: MXFP4 {info.shape} needs a 2-D weight with "
                                      "K % 64 == 0")
        return MXFP4Linear.from_gguf(g.tensor_bytes(name), info.shape, bias=bias, device=device)
    w = _f32(g, name)                                     # [N, K]
    return DenseLinear(w=torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device,
                                                                        dtype=dtype),
                       bias=bias)


def _load_moe(g: GGUFFile, p: str, device, dtype=torch.bfloat16) -> MoEWeights:
    """MoEWeights of layer prefix ``p``: the router (x @ router, in
    ``dtype``), the gpt-oss router and per-expert biases (GGUF [E, N]
    arrays), an expert-selection bias, and the expert stacks (GGUF gate / up
    [E, F, K], down [E, K, F]): MXFP4 packed per expert, TCQ4_K32 decoded per
    expert, or dense."""
    def f32(name):
        return torch.from_numpy(_f32(g, name)).to(device)

    fields = dict(router=torch.from_numpy(
        np.ascontiguousarray(_f32(g, f"{p}.ffn_gate_inp.weight").T)).to(device=device, dtype=dtype))
    for tname, field in (("exp_probs_b.bias", "probs_bias"), ("ffn_gate_inp.bias", "router_bias"),
                         ("ffn_gate_exps.bias", "gate_b"), ("ffn_up_exps.bias", "up_b"),
                         ("ffn_down_exps.bias", "down_b")):
        if f"{p}.{tname}" in g.tensors:
            fields[field] = f32(f"{p}.{tname}")
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
            ts = [decode_tcq4_gguf(raw[ei * per:(ei + 1) * per], info.shape[1:])
                  for ei in range(info.shape[0])]
            fields[f"{n}_qs"] = torch.from_numpy(np.stack([t.qs for t in ts])).to(device)
            fields[f"{n}_eff"] = torch.from_numpy(np.stack(
                [effective_scales(t).astype(np.float32) for t in ts])).to(torch.bfloat16).to(device)
        return MoEWeights(quant_kind="tcq4", **fields)
    for n, name in names.items():
        if g.tensors[name].ggml_type not in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
            raise NotImplementedError(f"{name}: {GGMLType(g.tensors[name].ggml_type).name} "
                                      "expert stacks are not ported to rrs_tpu_torch")
        fields[n] = torch.from_numpy(np.ascontiguousarray(_f32(g, name).transpose(0, 2, 1))).to(
            device=device, dtype=dtype)
    return MoEWeights(**fields)


def load_model(path: str | Path, dtype=torch.bfloat16, overrides: dict | None = None,
               device=None):
    """Load a GGUF model onto ``device`` (``None`` = cuda), with the
    q/k/v and gate/up projections fused where ``fuse_linears`` can.
    Returns (config, weights, metadata)."""
    dev = resolve_device(device)
    g = read_gguf(path)
    try:
        if overrides:
            g.metadata.update(overrides)
        cfg = ModelConfig.from_gguf(g.metadata)
        if cfg.vocab_size == 0:
            import dataclasses

            cfg = dataclasses.replace(cfg, vocab_size=g.tensors["token_embd.weight"].shape[0])
        for tname in g.tensors:
            parts = tname.split(".")
            if any(part in parts for part in _NOT_PORTED) or (
                    "post_attention_norm" in parts and cfg.arch != "gpt-oss"):
                raise NotImplementedError(f"tensor {tname}: layer kind not ported to rrs_tpu_torch")
        layers = []
        for i in range(cfg.n_layers):
            p = f"blk.{i}"
            lin = lambda n, b=None: _linear(g, f"{p}.{n}.weight", dev, dtype,   # noqa: E731
                                            b and f"{p}.{n}.bias")
            is_moe = f"{p}.ffn_gate_inp.weight" in g.tensors
            wq, wk, wv = lin("attn_q", 1), lin("attn_k", 1), lin("attn_v", 1)
            w_gate, w_up = (None, None) if is_moe else (lin("ffn_gate"), lin("ffn_up"))
            wqkv = w_gateup = None
            if type(wq) is type(wk) is type(wv):
                wqkv = fuse_linears([wq, wk, wv])
            if wqkv is not None:
                wq = wk = wv = None
            if not is_moe and type(w_gate) is type(w_up):
                w_gateup = fuse_linears([w_gate, w_up])
            if w_gateup is not None:
                w_gate = w_up = None
            has_qn = f"{p}.attn_q_norm.weight" in g.tensors
            # gpt-oss ships its pre-FFN norm under the post_attention_norm name
            ffn_norm = f"{p}.ffn_norm.weight"
            if cfg.arch == "gpt-oss" and ffn_norm not in g.tensors:
                ffn_norm = f"{p}.post_attention_norm.weight"
            sinks = next((n for n in (f"{p}.attn_sinks.weight", f"{p}.attn_sinks")
                          if n in g.tensors), None)
            layers.append(LayerWeights(
                attn_norm=_norm(g, f"{p}.attn_norm.weight", dev, dtype),
                wq=wq, wk=wk, wv=wv,
                wo=lin("attn_output", 1),
                q_norm=_norm(g, f"{p}.attn_q_norm.weight", dev, dtype) if has_qn else None,
                k_norm=_norm(g, f"{p}.attn_k_norm.weight", dev, dtype) if has_qn else None,
                ffn_norm=_norm(g, ffn_norm, dev, dtype),
                w_gate=w_gate, w_up=w_up,
                w_down=None if is_moe else lin("ffn_down"),
                wqkv=wqkv, w_gateup=w_gateup,
                moe=_load_moe(g, p, dev, dtype) if is_moe else None,
                attn_sinks=None if sinks is None else torch.from_numpy(_f32(g, sinks)).to(dev),
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
        weights = ModelWeights(embed=embed, layers=layers,
                               final_norm=_norm(g, "output_norm.weight", dev, dtype),
                               lm_head=lm_head)
        md = dict(g.metadata)
    finally:
        g.close()
    return cfg, weights, md


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
