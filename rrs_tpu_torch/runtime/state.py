"""Session state save / restore (llama_state_* analog).

Port of ``rrs_tpu/runtime/state.py``, on the same file format, so that a file
saved by either package loads into the other:
  * full-context state (``save_state`` / ``load_state``): every lane's K/V
    prefix and the lane bookkeeping;
  * per-sequence state (``save_sequence`` / ``load_sequence``): one
    sequence's K/V prefix and, optionally, its tokens, restorable into any
    free lane of a context with the same model shape.

The file is an npz container: ``__meta__`` holds a JSON header (magic
``"rrs_tpu-state"``, version 1, the model fingerprint), and ``k{i}`` / ``v{i}``
each layer's K/V as f32 [.., Hkv, n, D]. A quantized cache is saved
dequantized and requantized on load, with NumPy on the host (the codec's
mirror), so its codes come back as they were and a scale may move by an ulp.
The file is written to exactly the path given (NumPy would append ``.npz``
to a name without it).

A recurrent or hybrid context's memory has no such file format: every entry
raises NotImplementedError on it (the JAX package's fails there on the
missing K/V layers; ROADMAP queue C).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

STATE_MAGIC = "rrs_tpu-state"
STATE_VERSION = 1


def _fingerprint(cfg) -> dict:
    return {
        "arch": cfg.arch,
        "n_layers": cfg.n_layers,
        "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
    }


def _check_header(meta: dict, cfg):
    if meta.get("magic") != STATE_MAGIC:
        raise ValueError("not an rrs_tpu state file")
    if meta.get("version") != STATE_VERSION:
        raise ValueError(f"unsupported state version {meta.get('version')}")
    if meta.get("fingerprint") != _fingerprint(cfg):
        raise ValueError(
            f"state/model mismatch: {meta.get('fingerprint')} vs {_fingerprint(cfg)}")


def _np_dequant(arr: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """NumPy mirror of ``kv_codec.dequantize`` (arr [..., H?, S, D or D/2],
    sc [..., H, S]); a head-pair q4 array has half as many head planes."""
    if arr.dtype == np.uint8:
        a32 = arr.astype(np.int32)
        if arr.ndim >= 3 and arr.shape[-3] * 2 == sc.shape[-2]:      # head-pair
            st = np.stack([(a32 & 15) - 8, (a32 >> 4) - 8], axis=-3)
            arr = st.reshape(st.shape[:-4] + (st.shape[-4] * 2,) + st.shape[-2:])
        else:
            arr = np.concatenate([(a32 << 28) >> 28, (a32 << 24) >> 28], axis=-1)
    return arr.astype(np.float32) * sc[..., None]


def _np_requant(data: np.ndarray, u8: bool, hp: bool = False):
    """f32 [..., H, S, D] -> (stored values, scales [..., H, S])."""
    qmax = 7.0 if u8 else 127.0
    sc = np.maximum(np.abs(data).max(-1) / qmax, 1e-10)
    q = np.clip(np.rint(data / sc[..., None]), -qmax, qmax).astype(np.int8)
    if u8 and hp:
        b = (q.astype(np.int32) + 8).astype(np.uint8)
        q = b[..., 0::2, :, :] | (b[..., 1::2, :, :] << 4)
    elif u8:
        d = q.shape[-1]
        q = ((q[..., : d // 2].astype(np.uint8) & 0xF)
             | ((q[..., d // 2:].astype(np.uint8) & 0xF) << 4))
    return q, sc.astype(np.float32)


def _dequant_host(c, index, n: int) -> np.ndarray:
    """f32 NumPy copy of the first n slots of ``c[index]`` (a bf16 cache or a
    (codes, scales) pair)."""
    if isinstance(c, tuple):
        arr, sc = c
        nl = min(n, arr.shape[2])
        return _np_dequant(arr[index][..., :nl, :].cpu().numpy(),
                           sc[index][..., 0, :nl].cpu().numpy())
    nl = min(n, c.shape[2])
    return c[index][..., :nl, :].float().cpu().numpy()


def _store_host(c, index, data: np.ndarray) -> None:
    """Write f32 ``data`` [.., Hkv, n, D] into the first n slots of
    ``c[index]`` in place, requantized for a (codes, scales) pair."""
    if isinstance(c, tuple):
        arr, sc = c
        n = min(data.shape[-2], arr.shape[2])
        q, s = _np_requant(data[..., :n, :], arr.dtype == torch.uint8,
                           hp=arr.shape[1] * 2 == sc.shape[1])
        arr[index][..., :n, :] = torch.from_numpy(q).to(arr.device, arr.dtype)
        sc[index][..., 0, :n] = torch.from_numpy(s).to(sc.device)
        return
    n = min(data.shape[-2], c.shape[2])
    c[index][..., :n, :] = torch.from_numpy(np.ascontiguousarray(data[..., :n, :])).to(
        c.device, c.dtype)


def _kv_of(ctx):
    """The context's KV cache; a recurrent or hybrid memory raises."""
    from rrs_tpu_torch.runtime.kv_cache import KVCache, ShardedKVCache

    if not isinstance(ctx.kv, KVCache):
        raise NotImplementedError(
            f"state save / restore of a {ctx.cfg.arch} context: a recurrent or hybrid memory "
            "has no state file format (nor has the JAX package's)")
    if isinstance(ctx.kv, ShardedKVCache):
        raise NotImplementedError(
            "state save / restore of a tensor / data parallel (--tp / --dp) context")
    return ctx.kv


def _write(path, meta: dict, arrays: dict) -> int:
    arrays = {"__meta__": np.frombuffer(json.dumps(meta).encode(), np.uint8), **arrays}
    path = Path(path)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    return path.stat().st_size


def save_state(ctx, path) -> int:
    """Serialize the full context (all lanes). Returns bytes written."""
    kv = _kv_of(ctx)
    meta = {"magic": STATE_MAGIC, "version": STATE_VERSION,
            "fingerprint": _fingerprint(ctx.cfg), "lengths": kv.lengths,
            "seq_ids": kv.seq_ids, "max_seq": kv.max_seq}
    max_len = max(kv.lengths, default=0)
    arrays = {}
    for li in range(len(kv.k)):
        arrays[f"k{li}"] = _dequant_host(kv.k[li], slice(None), max_len)
        arrays[f"v{li}"] = _dequant_host(kv.v[li], slice(None), max_len)
    return _write(path, meta, arrays)


def load_state(ctx, path) -> None:
    kv = _kv_of(ctx)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        _check_header(meta, ctx.cfg)
        kv.lengths = list(meta["lengths"])
        kv.seq_ids = list(meta["seq_ids"])
        # restored seq ids stay live: keep minting unique ones after them
        live = [sid for sid in kv.seq_ids if sid is not None]
        if live and hasattr(ctx, "_next_seq_id"):
            ctx._next_seq_id = max(ctx._next_seq_id, max(live) + 1)
        for li in range(len(kv.k)):
            _store_host(kv.k[li], slice(None), z[f"k{li}"])
            _store_host(kv.v[li], slice(None), z[f"v{li}"])


def save_sequence(ctx, seq_id: int, path, tokens=None) -> int:
    """Serialize one sequence's KV prefix (and its token history, if given).
    Returns bytes written."""
    kv = _kv_of(ctx)
    lane = kv.lane_of(seq_id)
    n = kv.lengths[lane]
    meta = {"magic": STATE_MAGIC, "version": STATE_VERSION,
            "fingerprint": _fingerprint(ctx.cfg), "n_tokens": n,
            "tokens": [int(t) for t in tokens] if tokens is not None else None}
    arrays = {}
    for li in range(len(kv.k)):
        arrays[f"k{li}"] = _dequant_host(kv.k[li], lane, n)
        arrays[f"v{li}"] = _dequant_host(kv.v[li], lane, n)
    return _write(path, meta, arrays)


def load_sequence(ctx, path):
    """Restore a saved sequence into a fresh lane. Returns (seq_id, tokens)."""
    kv = _kv_of(ctx)
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        _check_header(meta, ctx.cfg)
        n = int(meta["n_tokens"])
        if n > kv.max_seq:
            raise ValueError(f"sequence length {n} exceeds context {kv.max_seq}")
        seq_id = ctx.new_sequence()
        lane = kv.lane_of(seq_id)
        for li in range(len(kv.k)):
            _store_host(kv.k[li], lane, z[f"k{li}"])
            _store_host(kv.v[li], lane, z[f"v{li}"])
        kv.lengths[lane] = n
        return seq_id, meta.get("tokens")
