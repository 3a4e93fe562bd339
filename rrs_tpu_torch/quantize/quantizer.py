"""Model quantizer: GGUF -> TCQ4_K32 GGUF, or any ftype of the K-quant menu
(tools/quantize + llama-quant.cpp analog).

Copied host code from ``rrs_tpu/quantize/quantizer.py``, on the port's own
codecs (``formats.kquants``, ``formats.tcq4``, ``formats.tile_codec``), so the
same source file, imatrix and ftype give the JAX package's bytes.

Type policy mirrors llama_tensor_get_type for the TCQ4 ftype
(src/llama-quant.cpp:265-530):
  * token_embd.weight -> Q4_K in the reference; we store Q8_0 (the loader
    keeps Q8_0 tables PACKED on device and dequantizes looked-up rows —
    models/llama.py::embed_rows) — output.weight -> Q8_0 (reference :260-262)
  * 1-D tensors (norms, biases) -> F32
  * 2-D matmul weights with K % 256 == 0 and N % 8 == 0 -> TCQ4_K32,
    else fallback (reference falls to Q4_K; we use Q8_0 for the same reason)
  * channel perms derived from imatrix applied pre-quant and stored as
    ``tcq4.{name}.perm`` int32 arrays + ``tcq4.reorder.enabled``
    (llama-quant.cpp:840-855)
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from rrs_tpu_torch.formats import kquants
from rrs_tpu_torch.formats.tcq4 import quantize_tcq4
from rrs_tpu_torch.formats.tile_codec import encode_tcq4_gguf
from rrs_tpu_torch.gguf.constants import (
    GGMLType,
    KEY_TCQ4_REORDER_ENABLED,
    tcq4_perm_key,
)
from rrs_tpu_torch.gguf.reader import read_gguf
from rrs_tpu_torch.gguf.writer import GGUFWriter


def _is_tcq4_eligible(name: str, shape) -> bool:
    if len(shape) != 2:
        return False
    n, k = shape
    if k % 256 or n % 8:
        return False
    if name in ("token_embd.weight", "output.weight", "per_layer_token_embd.weight"):
        return False
    return name.endswith(".weight") and "norm" not in name


def _is_tcq4_exps_eligible(name: str, shape) -> bool:
    """Stacked MoE expert tensors ([E, N, K], llama.cpp *_exps layout):
    eligible when each expert slice is — both matmul dims must also be
    FWHT-rotatable (% 256) since MoE runs W4A4 on both projections."""
    if len(shape) != 3 or "_exps." not in name:
        return False
    _, n, k = shape
    return (k % 256 == 0 and n % 256 == 0
            and name.endswith(".weight") and "norm" not in name)


# non-TCQ4 output ftypes (the llama-quantize ftype menu analog; reference
# tools/quantize/quantize.cpp:26-78 type table). Each entry: (base
# GGMLType for eligible weights, general.file_type code). Per-tensor
# upgrades on top of the base come from _mix_type (the
# llama_tensor_get_type policy, llama-quant.cpp:265-530).
_OUT_TYPES = {
    "q4_0": (GGMLType.Q4_0, 2),
    "q4_1": (GGMLType.Q4_1, 3),
    "q8_0": (GGMLType.Q8_0, 7),
    "q5_0": (GGMLType.Q5_0, 8),
    "q5_1": (GGMLType.Q5_1, 9),
    "q2_k": (GGMLType.Q2_K, 10),
    "q2_k_s": (GGMLType.Q2_K, 21),
    "q3_k_s": (GGMLType.Q3_K, 11),
    "q3_k_m": (GGMLType.Q3_K, 12),
    "q3_k_l": (GGMLType.Q3_K, 13),
    "q4_k_s": (GGMLType.Q4_K, 14),
    "q4_k": (GGMLType.Q4_K, 15),      # alias of q4_k_m (reference menu)
    "q4_k_m": (GGMLType.Q4_K, 15),
    "q5_k_s": (GGMLType.Q5_K, 16),
    "q5_k_m": (GGMLType.Q5_K, 17),
    "q6_k": (GGMLType.Q6_K, 18),
    "iq4_nl": (GGMLType.IQ4_NL, 25),
    "iq4_xs": (GGMLType.IQ4_XS, 30),
    "mxfp4": (GGMLType.MXFP4, 38),
    "f16": (GGMLType.F16, 1),
}

# GGMLType -> (kquants encoder, block width, takes qw?)
_ENCODERS = {
    GGMLType.Q2_K: ("quantize_q2_k", 256, True),
    GGMLType.Q3_K: ("quantize_q3_k", 256, True),
    GGMLType.Q4_K: ("quantize_q4_k", 256, False),
    GGMLType.Q5_K: ("quantize_q5_k", 256, True),
    GGMLType.Q6_K: ("quantize_q6_k", 256, True),
    GGMLType.IQ4_NL: ("quantize_iq4_nl", 32, True),
    GGMLType.IQ4_XS: ("quantize_iq4_xs", 256, True),
    GGMLType.Q4_0: ("quantize_q4_0", 32, False),
    GGMLType.Q4_1: ("quantize_q4_1", 32, False),
    GGMLType.Q5_0: ("quantize_q5_0", 32, False),
    GGMLType.Q5_1: ("quantize_q5_1", 32, False),
    GGMLType.Q8_0: ("quantize_q8_0", 32, False),
    GGMLType.MXFP4: ("quantize_mxfp4", 32, False),
}


def _use_more_bits(i_layer: int, n_layers: int) -> bool:
    """llama-quant.cpp use_more_bits: first/last 8th of the stack plus
    every third layer in between get the bigger type."""
    return (i_layer < n_layers // 8 or i_layer >= 7 * n_layers // 8
            or (i_layer - n_layers // 8) % 3 == 2)


def _layer_of(name: str) -> int:
    if name.startswith("blk."):
        try:
            return int(name.split(".")[1])
        except ValueError:
            return -1
    return -1


def _mix_type(ftype: str, name: str, shape, hp: dict) -> GGMLType:
    """Per-tensor type for a K-quant-family ftype — the
    llama_tensor_get_type policy (llama-quant.cpp:265-530) restated for
    the formats this repo encodes (the IQ1/IQ2/IQ3 ftypes and the
    70B-model special case are out of scope; their rows fall through to
    the base type).

    hp: {n_layers, n_gqa, n_expert, has_output, has_imatrix}."""
    base, _ = _OUT_TYPES[ftype]
    new_type = base
    n_layers = max(hp.get("n_layers", 1), 1)
    n_gqa = hp.get("n_gqa", 1)
    n_expert = hp.get("n_expert", 0)
    i_layer = _layer_of(name)
    umb = _use_more_bits(i_layer, n_layers) if i_layer >= 0 else False

    if name == "output.weight" or (
            not hp.get("has_output", True) and name == "token_embd.weight"):
        # output head: Q6_K unless the row width breaks 256-blocks
        if shape[-1] % 256:
            new_type = GGMLType.Q8_0
        elif base != GGMLType.Q8_0:
            new_type = GGMLType.Q6_K
    elif name in ("token_embd.weight", "per_layer_token_embd.weight"):
        pass                                   # K-quant ftypes keep base
    elif "attn_v.weight" in name:
        if ftype == "q2_k":
            new_type = GGMLType.Q4_K if n_gqa >= 4 else GGMLType.Q3_K
        elif ftype == "q2_k_s" and n_gqa >= 4:
            new_type = GGMLType.Q4_K
        elif ftype == "q3_k_m":
            new_type = GGMLType.Q5_K if i_layer < 2 else GGMLType.Q4_K
        elif ftype == "q3_k_l":
            new_type = GGMLType.Q5_K
        elif ftype in ("iq4_nl", "iq4_xs") and n_gqa >= 4:
            new_type = GGMLType.Q5_K
        elif ftype in ("q4_k", "q4_k_m", "q5_k_m") and umb:
            new_type = GGMLType.Q6_K
        elif ftype == "q4_k_s" and 0 <= i_layer < 4:
            new_type = GGMLType.Q5_K
        if n_expert == 8:
            new_type = GGMLType.Q8_0
    elif "attn_k.weight" in name:
        if n_expert == 8:
            new_type = GGMLType.Q8_0
    elif "ffn_down" in name:
        if ftype == "q2_k":
            new_type = GGMLType.Q3_K
        elif ftype == "q2_k_s":
            if i_layer < n_layers // 8:
                new_type = GGMLType.Q4_K
        elif ftype == "q3_k_m":
            new_type = (GGMLType.Q5_K if i_layer < n_layers // 16
                        else GGMLType.Q4_K)
        elif ftype == "q3_k_l":
            new_type = GGMLType.Q5_K
        elif ftype in ("q4_k", "q4_k_m"):
            if umb:
                new_type = GGMLType.Q6_K
        elif (i_layer < n_layers // 8 and ftype in ("iq4_nl", "iq4_xs")
              and not hp.get("has_imatrix", False)):
            new_type = GGMLType.Q5_K
        elif ftype == "q5_k_m" and umb:
            new_type = GGMLType.Q6_K
        elif ftype == "q4_k_s" and i_layer < n_layers // 8:
            new_type = GGMLType.Q5_K
        elif ftype in ("q4_0", "q5_0") and hp.get("has_imatrix", False) \
                and i_layer < n_layers // 8:
            new_type = (GGMLType.Q4_1 if ftype == "q4_0"
                        else GGMLType.Q5_1)
    elif "attn_output.weight" in name:
        if n_expert == 8:
            if ftype in ("q2_k", "q3_k_s", "q3_k_m", "iq4_nl", "q4_k_s",
                         "q4_k", "q4_k_m", "iq4_xs"):
                new_type = GGMLType.Q5_K
        else:
            if ftype == "q2_k":
                new_type = GGMLType.Q3_K
            elif ftype == "q3_k_m":
                new_type = GGMLType.Q4_K
            elif ftype == "q3_k_l":
                new_type = GGMLType.Q5_K
    elif "attn_qkv.weight" in name:
        if ftype in ("q3_k_m", "q3_k_l"):
            new_type = GGMLType.Q4_K
        elif ftype in ("q4_k", "q4_k_m"):
            new_type = GGMLType.Q5_K
        elif ftype == "q5_k_m":
            new_type = GGMLType.Q6_K

    # incompatible-row fallback chain (llama-quant.cpp tail): types whose
    # block the row width can't divide step down until one fits
    _, blk, _ = _ENCODERS[new_type]
    if shape[-1] % blk:
        new_type = GGMLType.Q8_0 if shape[-1] % 32 == 0 else GGMLType.F32
    return new_type


def _model_hparams(g) -> dict:
    arch = g.metadata.get("general.architecture", "llama")
    md = g.metadata
    n_head = md.get(f"{arch}.attention.head_count", 1) or 1
    if isinstance(n_head, (list, np.ndarray)):
        n_head = int(np.max(n_head))
    n_kv = md.get(f"{arch}.attention.head_count_kv", n_head) or n_head
    if isinstance(n_kv, (list, np.ndarray)):
        n_kv = int(np.max(n_kv))
    return {
        "n_layers": int(md.get(f"{arch}.block_count", 1) or 1),
        "n_gqa": int(n_head) // max(int(n_kv), 1),
        "n_expert": int(md.get(f"{arch}.expert_count", 0) or 0),
        "has_output": "output.weight" in g.tensors,
    }


def quantize_model(
    src_path: str | Path,
    dst_path: str | Path,
    perms: Optional[dict[str, np.ndarray]] = None,
    verbose: bool = True,
    out_type: str = "tcq4",
    imatrix=None,
    search: bool = False,
) -> dict:
    """Quantize every eligible tensor to ``out_type`` (default TCQ4_K32);
    returns a summary dict. Non-default quantized types follow the same
    tensor policy: 2D/3D .weight tensors get the target type (falling
    back to Q8_0 then F32 on block-width mismatch), token_embd/output
    stay Q8_0, norms/1D stay F32. ``f16`` converts every eligible weight
    (embed/head included — the reference's F16 ftype is a full-precision
    interchange format, not a quantization policy)."""
    if out_type != "tcq4":
        return _quantize_model_simple(src_path, dst_path, out_type, verbose,
                                      imatrix=imatrix)
    g = read_gguf(src_path)
    w = GGUFWriter(dst_path)

    for key, value in g.metadata.items():
        if key == "general.file_type":
            continue
        # preserve original value types for llama.cpp interop
        w.add_kv(key, value, vtype=g.metadata_types.get(key))
    w.add_uint32("general.file_type", 40)  # GGML_FTYPE_MOSTLY_TCQ4_K32 (ggml.h:478)

    if perms:
        w.add_bool(KEY_TCQ4_REORDER_ENABLED, True)
        for name, perm in perms.items():
            w.add_array(tcq4_perm_key(name), np.asarray(perm, np.int32))

    stats = {"tcq4": 0, "q8_0": 0, "f32": 0, "kept": 0, "bytes_in": 0, "bytes_out": 0}
    for name, info in g.tensors.items():
        stats["bytes_in"] += info.nbytes
        if _is_tcq4_eligible(name, info.shape):
            f32 = g.tensor(name).astype(np.float32)
            perm = perms.get(name) if perms else None
            t = quantize_tcq4(f32, perm=perm, search=search)
            payload = encode_tcq4_gguf(t)
            w.add_tensor(name, payload, shape=info.shape, ggml_type=GGMLType.TCQ4_K32)
            stats["tcq4"] += 1
            stats["bytes_out"] += len(payload)
            if verbose:
                bpw = len(payload) * 8 / f32.size
                print(f"  {name}: {info.shape} {info.ggml_type.name} -> TCQ4_K32 ({bpw:.3f} bpw)")
        elif _is_tcq4_exps_eligible(name, info.shape):
            # per-expert TCQ4 payloads, concatenated in expert order (the
            # mul_mat_id weights; llama-quant.cpp quantizes *_exps per type
            # policy the same way)
            f32 = g.tensor(name).astype(np.float32)
            payload = b"".join(
                bytes(encode_tcq4_gguf(quantize_tcq4(f32[ei],
                                                     search=search)))
                for ei in range(info.shape[0]))
            w.add_tensor(name, np.frombuffer(payload, np.uint8),
                         shape=info.shape, ggml_type=GGMLType.TCQ4_K32)
            stats["tcq4"] += 1
            stats["bytes_out"] += len(payload)
            if verbose:
                bpw = len(payload) * 8 / f32.size
                print(f"  {name}: {info.shape} {info.ggml_type.name} -> TCQ4_K32 x{info.shape[0]} experts ({bpw:.3f} bpw)")
        elif len(info.shape) == 2 and info.shape[-1] % 32 == 0:
            f32 = g.tensor(name).astype(np.float32)
            payload = kquants.quantize_q8_0(f32).tobytes()
            w.add_tensor(name, payload, shape=info.shape, ggml_type=GGMLType.Q8_0)
            stats["q8_0"] += 1
            stats["bytes_out"] += len(payload)
        else:
            f32 = g.tensor(name).astype(np.float32)
            w.add_tensor(name, f32, shape=info.shape, ggml_type=GGMLType.F32)
            stats["f32"] += 1
            stats["bytes_out"] += f32.nbytes
    g.close()
    w.write()
    return stats


def _quantize_model_simple(src_path, dst_path, out_type: str,
                           verbose: bool, imatrix=None) -> dict:
    """Non-TCQ4 requantization: the llama-quantize ftype menu. K-quant
    family ftypes (q2_k..q6_k, iq4_nl/xs, legacy q4/q5) apply the
    per-tensor mix policy (_mix_type); ``imatrix`` (per-tensor channel
    second moments from load_imatrix) feeds the weighted encoders'
    qw parameter (make_qkx3/make_qx_quants analog)."""
    gt_base, ftype = _OUT_TYPES[out_type]
    g = read_gguf(src_path)
    w = GGUFWriter(dst_path)
    for key, value in g.metadata.items():
        if key == "general.file_type":
            continue
        w.add_kv(key, value, vtype=g.metadata_types.get(key))
    w.add_uint32("general.file_type", ftype)
    hp = _model_hparams(g)
    hp["has_imatrix"] = bool(imatrix)
    mixed = out_type not in ("f16", "q8_0", "mxfp4")

    # "converted" = tensors that got a quantized type; "q8_0_fallback" =
    # embed/head + block-width fallbacks; "mix" counts per-type choices
    stats = {"type": out_type, "converted": 0, "q8_0_fallback": 0,
             "f32": 0, "bytes_in": 0, "bytes_out": 0, "mix": {}}
    for name, info in g.tensors.items():
        stats["bytes_in"] += info.nbytes
        min_blk = 32 if mixed else _ENCODERS.get(gt_base, (None, 1))[1]
        eligible = (len(info.shape) in (2, 3) and name.endswith(".weight")
                    and "norm" not in name and info.shape[-1] % min_blk == 0)
        f32 = g.tensor(name).astype(np.float32)
        if eligible and out_type == "f16":
            w.add_tensor(name, f32.astype(np.float16), shape=info.shape,
                         ggml_type=GGMLType.F16)
            stats["converted"] += 1
            stats["bytes_out"] += f32.size * 2
            continue
        if eligible and mixed:
            gt = _mix_type(out_type, name, info.shape, hp)
        elif eligible and name not in ("token_embd.weight",
                                       "output.weight"):
            # q8_0/mxfp4 flat policies: embed/head stay Q8_0 below (the
            # reference keeps them higher-precision, llama-quant.cpp:
            # 260-285; also a vocab-padded MXFP4 head could not be
            # column-sharded)
            gt = gt_base
        else:
            gt = None
        if gt is not None and gt != GGMLType.F32:
            fn_name, blk, takes_qw = _ENCODERS[gt]
            qfn = getattr(kquants, fn_name)
            rows = f32.reshape(-1, info.shape[-1])
            kw = {}
            if takes_qw and imatrix is not None and name in imatrix \
                    and imatrix[name].size == info.shape[-1]:
                kw["qw"] = np.broadcast_to(
                    imatrix[name].astype(np.float32), rows.shape)
            # row codecs never cross rows, so 3D expert stacks quantize
            # as flattened [E*N, K]
            payload = qfn(rows, **kw).tobytes()
            w.add_tensor(name, np.frombuffer(payload, np.uint8),
                         shape=info.shape, ggml_type=gt)
            stats["converted"] += 1
            stats["mix"][gt.name] = stats["mix"].get(gt.name, 0) + 1
            stats["bytes_out"] += len(payload)
            if verbose:
                print(f"  {name}: {info.shape} {info.ggml_type.name} -> "
                      f"{gt.name} ({len(payload) * 8 / f32.size:.3f} bpw)")
        elif len(info.shape) == 2 and info.shape[-1] % 32 == 0:
            payload = kquants.quantize_q8_0(f32).tobytes()
            w.add_tensor(name, payload, shape=info.shape,
                         ggml_type=GGMLType.Q8_0)
            stats["q8_0_fallback"] += 1
            stats["bytes_out"] += len(payload)
        else:
            w.add_tensor(name, f32, shape=info.shape,
                         ggml_type=GGMLType.F32)
            stats["f32"] += 1
            stats["bytes_out"] += f32.nbytes
    g.close()
    w.write()
    return stats
