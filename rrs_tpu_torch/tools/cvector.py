"""Control-vector generation (tools/cvector-generator analog): contrast
positive vs negative prompt activations per layer, take the mean difference
(the reference also offers PCA; mean-diff is its default-quality mode), and
write a control-vector GGUF (tensors ``direction.{li}``, the format
llama_adapter_cvec loads).

Port of ``rrs_tpu/tools/cvector.py``: each prompt runs one forward of the
port's model on the weights' device over throwaway caches
(``models.llama.scratch_caches``), with the forward's ``"__hidden__"``
capture; the per-layer means come back to the host in f32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rrs_tpu_torch.models import llama as llama_model


@torch.inference_mode()
def collect_hidden_means(cfg, weights, token_lists) -> np.ndarray:
    """Mean per-layer hidden state for each prompt. [n_prompts, L, E]."""
    dev = weights.device
    out = []
    for toks in token_lists:
        t = len(toks)
        tok = np.asarray(toks, np.int32)[None, :]
        pos = np.arange(t, dtype=np.int32)[None, :]
        kc, vc = llama_model.scratch_caches(cfg, 1, t, device=dev)
        cap = {"__hidden__": {}}
        llama_model.forward(cfg, weights, tok, pos, kc, vc, pos, pos, cap=cap)
        out.append(np.stack([cap["__hidden__"][li].cpu().numpy()
                             for li in range(cfg.n_layers)]))
    return np.stack(out)                                  # [P, L, E]


def build_control_vector(cfg, weights, positive_tokens, negative_tokens) -> np.ndarray:
    """Mean-difference direction per layer. [L, E] f32."""
    pos = collect_hidden_means(cfg, weights, positive_tokens)
    neg = collect_hidden_means(cfg, weights, negative_tokens)
    return (pos.mean(0) - neg.mean(0)).astype(np.float32)


def save_control_vector(path: str | Path, directions: np.ndarray,
                        model_hint: str = "") -> Path:
    from rrs_tpu_torch.gguf.writer import GGUFWriter

    w = GGUFWriter(path)
    w.add_string("general.architecture", "controlvector")
    w.add_string("controlvector.model_hint", model_hint)
    w.add_uint32("controlvector.layer_count", directions.shape[0])
    for li in range(directions.shape[0]):
        # reference numbering: direction.1 = applied after layer 0
        w.add_tensor(f"direction.{li + 1}", directions[li])
    w.write()
    return Path(path)


def load_control_vector(path: str | Path, n_layers: int, n_embd: int,
                        strength: float = 1.0, device="cpu"):
    """Read a control-vector GGUF into a ``models.adapter.ControlVector``
    whose vectors live on ``device``."""
    from rrs_tpu_torch.gguf.reader import read_gguf
    from rrs_tpu_torch.models.adapter import ControlVector

    vecs = np.zeros((n_layers, n_embd), np.float32)
    with read_gguf(path) as g:
        for name in g.tensors:
            if not name.startswith("direction."):
                continue
            li = int(name.split(".")[1]) - 1
            if 0 <= li < n_layers:
                vecs[li] = g.tensor(name).astype(np.float32)
    return ControlVector(vectors=torch.from_numpy(vecs).to(device), strength=strength)
