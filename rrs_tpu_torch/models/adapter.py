"""Adapters: LoRA and control vectors (llama-adapter.cpp analog).

Port of ``rrs_tpu/models/adapter.py``. LoRA runs as a low-rank side path
beside the base linear (the reference's llm_build_lora_mm semantics):
y = base(x) + scale * (x @ A) @ B, so it composes with quantized bases
without requantization. The base keeps its kernel; the two thin products of
the delta are ``torch.matmul`` with f32 accumulation, as JAX computes them
outside any Pallas kernel. Control vectors add a per-layer steering vector
to the residual stream (llama_apply_adapter_cvec).

LoRA GGUF convention (convert_lora_to_gguf.py): tensors named
``blk.N.<name>.lora_a`` [r, K] and ``.lora_b`` [N, r], metadata
``adapter.lora.alpha``; effective scale = user_scale * alpha / r.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass
class LoraLinear:
    """base linear + low-rank delta. a: [K, r], b: [r, N], bf16 on the
    base's device."""

    base: Any
    a: torch.Tensor
    b: torch.Tensor
    scale: float = 1.0

    @property
    def shape(self):
        return self.base.shape

    @property
    def bias(self):
        return None


def apply_lora_delta(layer: LoraLinear, x2: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + scale * (x @ a) @ b, each product over ``a``'s dtype with an f32
    result (JAX's ``preferred_element_type=float32``)."""
    from rrs_tpu_torch.models.linear import _dense_matmul

    lo = _dense_matmul(x2.to(layer.a.dtype), layer.a)
    delta = _dense_matmul(lo.to(layer.b.dtype), layer.b)
    return y + layer.scale * delta


def _to_bf16(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device=device,
                                                                    dtype=torch.bfloat16)


def load_lora_gguf(path: str | Path, scale: float = 1.0,
                   device="cpu") -> tuple[dict, float]:
    """Read a LoRA adapter GGUF. Returns ({tensor_name: (a [K, r], b [r, N],
    eff)}, scale), ``a`` and ``b`` bf16 on ``device``."""
    from rrs_tpu_torch.gguf.reader import read_gguf

    out: dict[str, tuple] = {}
    with read_gguf(path) as g:
        alpha = float(g.metadata.get("adapter.lora.alpha", 0.0) or 0.0)
        names = {t[: -len(".lora_a")] for t in g.tensors if t.endswith(".lora_a")}
        for base_name in names:
            a = g.tensor(f"{base_name}.lora_a").astype(np.float32)  # [r, K]
            b = g.tensor(f"{base_name}.lora_b").astype(np.float32)  # [N, r]
            r = a.shape[0]
            eff = scale * (alpha / r if alpha > 0 else 1.0)
            out[base_name] = (_to_bf16(a.T, device), _to_bf16(b.T, device), eff)
    return out, scale


_LORA_FIELD_MAP = {
    "attn_q.weight": "wq",
    "attn_k.weight": "wk",
    "attn_v.weight": "wv",
    "attn_output.weight": "wo",
    "ffn_gate.weight": "w_gate",
    "ffn_up.weight": "w_up",
    "ffn_down.weight": "w_down",
}


def attach_lora(weights, adapters: dict) -> None:
    """Wrap matching layer linears with LoraLinear, in place. Requires
    unfused weights (``load_model(fuse=False)``)."""
    for name, (a, b, eff) in adapters.items():
        parts = name.split(".")
        if parts[0] != "blk":
            continue
        li = int(parts[1])
        field = _LORA_FIELD_MAP.get(".".join(parts[2:]))
        if field is None or li >= len(weights.layers):
            continue
        lw = weights.layers[li]
        base = getattr(lw, field)
        if base is None:
            raise ValueError(
                f"LoRA targets {name} but weights are fused; reload with fuse=False")
        setattr(lw, field, LoraLinear(base=base, a=a, b=b, scale=eff))


@dataclasses.dataclass
class ControlVector:
    """Per-layer steering vectors added to the residual stream."""

    vectors: torch.Tensor     # [n_layers, n_embd] f32
    strength: float = 1.0

    def apply(self, x: torch.Tensor, li: int) -> torch.Tensor:
        return x + (self.strength * self.vectors[li]).to(x.dtype)
