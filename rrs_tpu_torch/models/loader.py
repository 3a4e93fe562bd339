"""GGUF -> device weights for the dense path.

Port of ``load_model`` with ``_linear`` / ``_norm`` from
``rrs_tpu/models/loader.py``: TCQ4_K32 tensors (with their ``tcq4.*.perm``
channel permutations) decode on the host with the NumPy tile codec into the
K-major kernel layout; Q8_0 matrices stay packed (Q8Linear, and the Q8_0
embedding table when the head is untied); F32/F16/BF16 become bf16
DenseLinears; a tied head is the transposed embedding.

MLA, MoE, MXFP4, recurrent and hybrid layers, fused pre-packed qkv / gate-up
tensors and split GGUFs raise NotImplementedError until their slices.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rrs_tpu_torch.device import resolve_device
from rrs_tpu_torch.formats.tile_codec import decode_tcq4_gguf
from rrs_tpu_torch.gguf.constants import GGMLType, tcq4_perm_key
from rrs_tpu_torch.gguf.reader import GGUFFile, read_gguf
from rrs_tpu_torch.models.config import ModelConfig
from rrs_tpu_torch.models.linear import DenseLinear, Q8Linear, TCQ4Linear, fuse_linears
from rrs_tpu_torch.models.llama import LayerWeights, ModelWeights

_NOT_PORTED = ("attn_kv_a_mqa", "ffn_gate_inp", "ssm_in", "time_mix_key", "attn_qkv",
               "attn_sinks", "post_attention_norm", "post_ffw_norm")


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
        raise NotImplementedError(f"{name}: MXFP4 is not ported to rrs_tpu_torch")
    w = _f32(g, name)                                     # [N, K]
    return DenseLinear(w=torch.from_numpy(np.ascontiguousarray(w.T)).to(device=device,
                                                                        dtype=dtype),
                       bias=bias)


def load_model(path: str | Path, dtype=torch.bfloat16, overrides: dict | None = None,
               device=None):
    """Load a dense GGUF model onto ``device`` (``None`` = cuda), with the
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
            if any(part in tname.split(".") for part in _NOT_PORTED):
                raise NotImplementedError(f"tensor {tname}: layer kind not ported to rrs_tpu_torch")
        layers = []
        for i in range(cfg.n_layers):
            p = f"blk.{i}"
            lin = lambda n, b=None: _linear(g, f"{p}.{n}.weight", dev, dtype,   # noqa: E731
                                            b and f"{p}.{n}.bias")
            wq, wk, wv = lin("attn_q", 1), lin("attn_k", 1), lin("attn_v", 1)
            w_gate, w_up = lin("ffn_gate"), lin("ffn_up")
            wqkv = w_gateup = None
            if type(wq) is type(wk) is type(wv):
                wqkv = fuse_linears([wq, wk, wv])
            if wqkv is not None:
                wq = wk = wv = None
            if type(w_gate) is type(w_up):
                w_gateup = fuse_linears([w_gate, w_up])
            if w_gateup is not None:
                w_gate = w_up = None
            has_qn = f"{p}.attn_q_norm.weight" in g.tensors
            layers.append(LayerWeights(
                attn_norm=_norm(g, f"{p}.attn_norm.weight", dev, dtype),
                wq=wq, wk=wk, wv=wv,
                wo=lin("attn_output", 1),
                q_norm=_norm(g, f"{p}.attn_q_norm.weight", dev, dtype) if has_qn else None,
                k_norm=_norm(g, f"{p}.attn_k_norm.weight", dev, dtype) if has_qn else None,
                ffn_norm=_norm(g, f"{p}.ffn_norm.weight", dev, dtype),
                w_gate=w_gate, w_up=w_up,
                w_down=lin("ffn_down"),
                wqkv=wqkv, w_gateup=w_gateup,
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
