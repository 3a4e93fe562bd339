"""imatrix collection: per-channel activation second moments.

Port of ``rrs_tpu/quantize/imatrix.py`` (tools/imatrix/imatrix.cpp analog:
sum(x^2) per input channel of every matmul, collect_imatrix :219). Each
calibration chunk runs one forward of the port's model on the weights'
device, with a capture dict that ``models.llama._capture`` fills; the sums
come back to the host and accumulate in f32 per tensor, as in the JAX
package. MoE layers capture their attention linears only (the JAX forward
captures no expert input). Output: tensor name -> (sums [K] f32, n_tokens),
and GGUF save / load in the reference's imatrix-GGUF convention
(``general.type = "imatrix"``, per-tensor ``<name>.in_sum2`` and
``<name>.counts``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from rrs_tpu_torch.models import llama as llama_model
from rrs_tpu_torch.models.config import ModelConfig


@torch.inference_mode()
def collect_imatrix(cfg: ModelConfig, weights, token_chunks: list[list[int]],
                    chunk_len: int = 512) -> dict[str, tuple[np.ndarray, int]]:
    """Run the calibration chunks through the model (on ``weights.device``)
    and accumulate each linear's per-channel sums of squares."""
    dev = weights.device
    acc: dict[str, tuple[np.ndarray, int]] = {}
    for chunk in token_chunks:
        chunk = chunk[:chunk_len]
        if len(chunk) < 2:
            continue
        t = len(chunk)
        toks = np.asarray(chunk, np.int32)[None, :]
        pos = np.arange(t, dtype=np.int32)[None, :]
        kc, vc = llama_model.scratch_caches(cfg, 1, t, device=dev)
        cap: dict = {}
        llama_model.forward(cfg, weights, toks, pos, kc, vc, pos, pos, cap=cap)
        counts = cap.pop("__counts__")
        for name, sums in cap.items():
            s = sums.cpu().numpy()
            if name in acc:
                prev, n = acc[name]
                acc[name] = (prev + s, n + int(counts[name]))
            else:
                acc[name] = (s, int(counts[name]))
    return acc


def save_imatrix(path: str | Path, acc: dict[str, tuple[np.ndarray, int]]) -> Path:
    from rrs_tpu_torch.gguf.writer import GGUFWriter

    w = GGUFWriter(path)
    w.add_string("general.type", "imatrix")
    w.add_string("general.architecture", "imatrix")
    for name, (sums, count) in acc.items():
        w.add_tensor(f"{name}.in_sum2", sums.astype(np.float32))
        w.add_tensor(f"{name}.counts", np.asarray([float(count)], np.float32))
    return w.write()


def load_imatrix(path: str | Path) -> dict[str, np.ndarray]:
    """Mean-squared activations per tensor: sum2 / counts."""
    from rrs_tpu_torch.gguf.reader import read_gguf

    out = {}
    with read_gguf(path) as g:
        for name in g.tensors:
            if name.endswith(".in_sum2"):
                base = name[: -len(".in_sum2")]
                sums = g.tensor(name).astype(np.float32)
                counts = g.tensor(f"{base}.counts").astype(np.float32)
                out[base] = sums / max(float(counts[0]), 1.0)
    return out


def derive_tcq4_perms(imatrix: dict[str, np.ndarray], block: int = 256) -> dict[str, np.ndarray]:
    """Per-tensor channel permutations: channels sorted by imatrix magnitude,
    descending and stable, within each 256-wide FWHT block
    (derive_tcq4_perms_from_imatrix, tools/quantize/quantize.cpp:127-164).
    perm[i] is the source channel of position i."""
    perms = {}
    for name, m in imatrix.items():
        k = m.shape[0]
        if k % block:
            continue
        perm = np.empty(k, np.int32)
        for b0 in range(0, k, block):
            perm[b0:b0 + block] = b0 + np.argsort(-m[b0:b0 + block], kind="stable")
        perms[name] = perm
    return perms
