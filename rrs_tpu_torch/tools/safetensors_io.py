"""``*.safetensors`` files without the ``safetensors`` package.

The format: an 8-byte little-endian header length, a JSON header mapping
each tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (begin,
end; relative to the byte after the header) plus an optional
``__metadata__`` map of strings, then the raw little-endian data.

``load_safetensors`` maps the file once and hands out NumPy views of it; a
BF16 tensor becomes f32 exactly (its 16 bits are the high half of the f32
pattern), since NumPy has no bfloat16. ``save_safetensors`` writes the same
format (the header padded with spaces to 8 bytes, as the reference writer
pads it); a torch tensor given to it keeps its dtype, bf16 included.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bfloat16 patterns -> f32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def read_header(path: str | Path) -> tuple[dict, int]:
    """(the JSON header, the file offset of the data)."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
    return header, 8 + n


def load_safetensors(path: str | Path) -> dict[str, np.ndarray]:
    """Every tensor of one file, by name: read-only views of a memory map
    (BF16 decoded to f32 copies)."""
    header, start = read_header(path)
    header.pop("__metadata__", None)
    size = Path(path).stat().st_size
    mm = np.memmap(path, dtype=np.uint8, mode="r") if size > start else np.zeros(0, np.uint8)
    out = {}
    for name, info in header.items():
        b, e = info["data_offsets"]
        raw = mm[start + b:start + e]
        dt = info["dtype"]
        shape = tuple(info["shape"])
        if dt == "BF16":
            out[name] = bf16_to_f32(raw.view(np.uint16)).reshape(shape)
        elif dt in _DTYPES:
            out[name] = raw.view(_DTYPES[dt]).reshape(shape)
        else:
            raise NotImplementedError(f"{path}: tensor {name} has dtype {dt}")
    return out


def save_safetensors(path: str | Path, tensors: dict, metadata: dict | None = None) -> Path:
    """Write ``tensors`` (NumPy arrays or torch tensors) as one file."""
    blobs, header, off = [], {}, 0
    for name, t in tensors.items():
        if hasattr(t, "detach"):                      # a torch tensor
            import torch

            t = t.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                dt, data = "BF16", t.view(torch.int16).numpy().tobytes()
            else:
                arr = t.numpy()
                dt, data = _NAMES[arr.dtype], arr.tobytes()
        else:
            arr = np.asarray(t, order="C")             # keeps a 0-d array 0-d
            dt, data = _NAMES[arr.dtype], arr.tobytes()
        header[name] = {"dtype": dt, "shape": list(t.shape),
                        "data_offsets": [off, off + len(data)]}
        blobs.append(data)
        off += len(data)
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    text = json.dumps(header, separators=(",", ":")).encode()
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(len(text).to_bytes(8, "little"))
        f.write(text)
        for data in blobs:
            f.write(data)
    return Path(path)
