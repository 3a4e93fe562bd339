"""Per-tensor quantization error statistics (tests/test-quantize-stats.cpp +
test-quantize-fns.cpp analog).

For each 2-D weight of a model (GGUF file or fabricated preset) reports,
per format:
  * weight-only reconstruction: relative RMSE and max abs error of
    quantize->dequantize against the f32 weight
    (reference_quantization_error, test-quantize-fns.cpp:58)
  * end-to-end matvec error: rel RMSE of X @ W_q^T against X @ W^T on
    Gaussian activations (dot_product_error, :82) — for TCQ4 this runs the
    FULL W4A4 pipeline (perm gather -> block FWHT -> int4 activation
    quantization -> integer dot -> epilogue scales), so the number reflects
    what perplexity sees.

Formats: TCQ4_K32 (no-reorder), TCQ4_K32 + imatrix per-block reorder
(imatrix synthesized from the sample activations when none is given),
Q4_K, Q8_0. This is the first-principles argument for PPL parity when no
real checkpoint is available (PERF.md).

Port of ``rrs_tpu/tools/quantize_stats.py``. The weight-only errors and the
activation rotation and quantization stay host NumPy, as in the JAX package,
and the TCQ4 ``rmse_dot`` comes, as there, from the integer-exact host oracle
(``ops/tcq4_matmul.py`` ``tcq4_matmul_ref``). Beside it each TCQ4 row
reports ``rmse_dot_b4``: the same matvec through the port's ``tcq4_matmul``
wrapper on ``device`` (the dequantized int4 activations against the K-major
codes and bf16 effective scales; on the card the B4 kernel, on the CPU its
plain version, both with bf16 operands and f32 sums).
"""

from __future__ import annotations

import json

import numpy as np


def _act_quant_rrs(x: np.ndarray):
    """Host mirror of quantize_activations_rrs (tcq4_k32.cu:8-11 formula):
    per-256-block absmax scale (1e-10 floor -> 1.0), q in [-7, 7]."""
    t, k = x.shape
    xb = x.reshape(t, k // 256, 256)
    scale = np.abs(xb).max(-1)
    scale = np.where(scale < 1e-10, 1.0, scale)
    q = np.sign(xb) * np.floor(np.abs(xb) * (7.0 / scale)[..., None] + 0.5)
    return np.clip(q, -7, 7).astype(np.int8).reshape(t, k), scale


def tcq4_matvec(a_q: np.ndarray, a_scale: np.ndarray, qs: np.ndarray, eff: np.ndarray,
                device="cpu") -> np.ndarray:
    """X @ W_q^T from int4 activation codes a_q [T, K] with per-block scales
    [T, K//256] and a TCQ4 weight (qs u8 [K//2, N], eff f32 [K//32, N]),
    through ``tcq4_matmul`` on ``device`` (B4 on the card). Returns f32
    [T, N] on the host."""
    import torch

    from rrs_tpu_torch.formats.tcq4 import dequantize_activations_rrs
    from rrs_tpu_torch.ops.tcq4_matmul import tcq4_matmul

    a = dequantize_activations_rrs(torch.from_numpy(np.ascontiguousarray(a_q)),
                                   torch.from_numpy(np.ascontiguousarray(a_scale, np.float32)))
    qs_t = torch.from_numpy(np.ascontiguousarray(qs)).to(device)
    eff_t = torch.from_numpy(np.ascontiguousarray(eff, np.float32)).to(torch.bfloat16).to(device)
    y = tcq4_matmul(a.to(device).contiguous(), qs_t, eff_t)
    return y.to(torch.float32).cpu().numpy()


def tensor_stats(w: np.ndarray, x: np.ndarray, imatrix=None, device="cpu") -> dict:
    """w: [N, K] f32 weight; x: [T, K] activations. Returns
    {fmt: {rmse_w, max_w, rmse_dot}} with rel values, and for TCQ4 also
    ``rmse_dot_b4``, the matvec through ``tcq4_matmul`` on ``device``."""
    import torch
    from rrs_tpu_torch.formats.fwht import fwht_np
    from rrs_tpu_torch.formats.kquants import (dequantize_q4_k, dequantize_q8_0,
                                               quantize_q4_k, quantize_q8_0)
    from rrs_tpu_torch.formats.tcq4 import dequantize_tcq4, effective_scales, quantize_tcq4
    from rrs_tpu_torch.ops.tcq4_matmul import tcq4_matmul_ref

    n, k = w.shape
    w_norm = np.sqrt(np.mean(w * w))
    y_ref = x @ w.T
    y_norm = np.sqrt(np.mean(y_ref * y_ref))
    out = {}

    def weight_err(wq):
        d = wq - w
        return (float(np.sqrt(np.mean(d * d)) / w_norm),
                float(np.abs(d).max()))

    def dot_err(y):
        return float(np.sqrt(np.mean((y - y_ref) ** 2)) / y_norm)

    # -- TCQ4 (full W4A4 pipeline) --------------------------------------
    def tcq4_stats(perm):
        t = quantize_tcq4(w, perm=perm)
        wq = dequantize_tcq4(t, rotated=False).T        # [N, K] orig domain
        rmse_w, max_w = weight_err(wq)
        xp = x if perm is None else x[:, perm]
        x_rot = fwht_np(xp.reshape(-1, k // 256, 256), axis=-1
                        ).astype(np.float32).reshape(-1, k)
        a_q, a_scale = _act_quant_rrs(x_rot)
        eff = effective_scales(t).astype(np.float32)    # [K//32, N]
        y = tcq4_matmul_ref(torch.from_numpy(a_q), torch.from_numpy(a_scale.astype(np.float32)),
                            torch.from_numpy(np.asarray(t.qs)), torch.from_numpy(eff)).numpy()
        y_b4 = tcq4_matvec(a_q, a_scale, np.asarray(t.qs), eff, device)
        return {"rmse_w": rmse_w, "max_w": max_w, "rmse_dot": dot_err(y),
                "rmse_dot_b4": dot_err(y_b4)}

    out["tcq4"] = tcq4_stats(None)

    im = imatrix
    if im is None:
        im = (x * x).mean(0)                            # Σx²/T per channel
    perm = np.concatenate([
        b * 256 + np.argsort(-im[b * 256:(b + 1) * 256], kind="stable")
        for b in range(k // 256)
    ]).astype(np.int64)
    out["tcq4_reorder"] = tcq4_stats(perm)

    # -- Q4_K / Q8_0 (weight-only formats, f32 activations) -------------
    raw = np.frombuffer(quantize_q4_k(w.reshape(-1)).tobytes(), np.uint8)
    wq = dequantize_q4_k(raw, w.size).reshape(n, k)
    rmse_w, max_w = weight_err(wq)
    out["q4_k"] = {"rmse_w": rmse_w, "max_w": max_w,
                   "rmse_dot": dot_err(x @ wq.T)}

    raw = np.frombuffer(quantize_q8_0(w.reshape(-1)).tobytes(), np.uint8)
    wq = dequantize_q8_0(raw, w.size).reshape(n, k)
    rmse_w, max_w = weight_err(wq)
    out["q8_0"] = {"rmse_w": rmse_w, "max_w": max_w,
                   "rmse_dot": dot_err(x @ wq.T)}
    return out


def run(args) -> None:
    from rrs_tpu_torch.device import resolve_device

    device = resolve_device(getattr(args, "device", None))
    rng = np.random.default_rng(getattr(args, "seed", 0))
    tensors = []
    if getattr(args, "model", None):
        from rrs_tpu_torch.gguf.reader import read_gguf

        with read_gguf(args.model) as g:
            for name, info in g.tensors.items():
                if len(info.shape) != 2 or info.shape[-1] % 256:
                    continue
                w = np.asarray(g.tensor(name), np.float32)
                tensors.append((name, w.reshape(info.shape[0],
                                                info.shape[-1])))
                if len(tensors) >= args.max_tensors:
                    break
    else:
        # synthetic weights with heavy-tailed channel structure (the case
        # RRS reordering exists for: a few high-variance channels per block)
        n, k = 512, 1024
        for i in range(args.max_tensors):
            scale = 0.02 * (1 + 9.0 * (rng.random(k) < 0.02))
            tensors.append((f"synthetic.{i}",
                            (rng.standard_normal((n, k)) * scale[None, :])
                            .astype(np.float32)))

    rows = []
    for name, w in tensors:
        x = rng.standard_normal((args.samples, w.shape[1])).astype(np.float32)
        # activations see the same heavy channels (outlier activations are
        # what RRS smooths)
        x *= 1.0 + 4.0 * (np.abs(w).mean(0) / np.abs(w).mean())[None, :]
        stats = tensor_stats(w, x, device=device)
        rows.append((name, w.shape, stats))

    if getattr(args, "json", False):
        for name, shape, stats in rows:
            print(json.dumps({"tensor": name, "shape": list(shape), **{
                f"{f}_{k}": round(v, 6) for f, s in stats.items()
                for k, v in s.items()}}))
        return
    print(f"{'tensor':32s} {'fmt':14s} {'rel RMSE(w)':>12s} "
          f"{'max|dw|':>10s} {'rel RMSE(y)':>12s}")
    for name, shape, stats in rows:
        for fmt, s in stats.items():
            print(f"{name[:32]:32s} {fmt:14s} {s['rmse_w']:12.5f} "
                  f"{s['max_w']:10.5f} {s['rmse_dot']:12.5f}")
    # aggregate
    for fmt in rows[0][2]:
        dots = [s[fmt]["rmse_dot"] for _, _, s in rows]
        print(f"mean rel RMSE(y) {fmt:14s} {np.mean(dots):.5f}")
