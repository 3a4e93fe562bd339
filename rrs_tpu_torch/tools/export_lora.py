"""Merge a LoRA adapter into base weights and write a merged GGUF
(tools/export-lora analog: W' = W + scale * B @ A, then re-export).

Port of ``rrs_tpu/tools/export_lora.py``: host NumPy, the same f32 sums, so
the same bytes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from rrs_tpu_torch.gguf.constants import GGMLType
from rrs_tpu_torch.gguf.reader import read_gguf
from rrs_tpu_torch.gguf.writer import GGUFWriter


def export_lora_merged(
    base_path: str | Path,
    lora_path: str | Path,
    out_path: str | Path,
    scale: float = 1.0,
) -> Path:
    """Stream the base GGUF, adding scale*(B@A) to each adapted tensor.
    Quantized base tensors are dequantized to F32 before merging (the
    reference requires F16/F32 bases for merge too, export-lora.cpp)."""
    from rrs_tpu_torch.formats.kquants import dequantize

    adapters: dict[str, tuple] = {}
    with read_gguf(lora_path) as g:
        alpha = float(g.metadata.get("adapter.lora.alpha", 0.0) or 0.0)
        for t in list(g.tensors):
            if t.endswith(".lora_a"):
                base_name = t[: -len(".lora_a")]
                a = g.tensor(f"{base_name}.lora_a").astype(np.float32)  # [r,K]
                b = g.tensor(f"{base_name}.lora_b").astype(np.float32)  # [N,r]
                r = a.shape[0]
                eff = scale * (alpha / r if alpha > 0 else 1.0)
                adapters[base_name] = (a, b, eff)

    with read_gguf(base_path) as g:
        w = GGUFWriter(out_path)
        for k, v in g.metadata.items():
            w.add_kv(k, v)
        n_merged = 0
        for name, info in g.tensors.items():
            if name in adapters:
                a, bm, eff = adapters[name]
                if info.ggml_type in (GGMLType.F32, GGMLType.F16):
                    base = g.tensor(name).astype(np.float32)
                else:
                    base = dequantize(g.tensor_bytes(name), info.ggml_type, info.shape)
                merged = base + eff * (bm @ a)           # [N,K]
                w.add_tensor(name, merged.astype(np.float32))
                n_merged += 1
            else:
                # pass through raw payload unchanged
                w.add_tensor(name, g.tensor_bytes(name), shape=tuple(info.shape),
                             ggml_type=info.ggml_type)
        w.write()
    if n_merged == 0:
        raise ValueError("no adapter tensors matched the base model")
    return Path(out_path)
