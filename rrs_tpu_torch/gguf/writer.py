"""GGUF writer: v3 files that the port's reader, the JAX package's and
llama.cpp read.

Copied host code from ``rrs_tpu/gguf/writer.py`` (the typed metadata KVs, the
tensor directory with reversed ``ne``, and the aligned data blob), without
the add_* shorthands the port does not call.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

from rrs_tpu_torch.gguf.constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
)

_NP_TO_GGML = {
    np.dtype(np.float32): GGMLType.F32,
    np.dtype(np.float16): GGMLType.F16,
}

_SCALAR_FMT = {
    GGUFValueType.UINT8: "<B",
    GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H",
    GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I",
    GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f",
    GGUFValueType.BOOL: "<?",
    GGUFValueType.UINT64: "<Q",
    GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}


class GGUFWriter:
    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType]] = []
        self._tensors: list[tuple[str, GGMLType, list[int], bytes]] = []

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType) -> None:
        """A metadata KV of the given type; a list of str, float or int is a
        STRING, FLOAT32 or INT32 array."""
        self._kv.append((key, value, vtype))

    def add_tensor(self, name: str, data: np.ndarray) -> None:
        """An F32 or F16 tensor; ``data.shape`` is in NumPy order and is
        stored reversed as the GGUF ne."""
        self._tensors.append((name, _NP_TO_GGML[data.dtype], list(reversed(data.shape)),
                              np.ascontiguousarray(data).tobytes()))

    @staticmethod
    def _write_string(f, s: str) -> None:
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f, value: Any, vtype: GGUFValueType) -> None:
        if vtype == GGUFValueType.STRING:
            self._write_string(f, value)
        elif vtype == GGUFValueType.ARRAY:
            value = list(value)
            if value and isinstance(value[0], str):
                f.write(struct.pack("<IQ", int(GGUFValueType.STRING), len(value)))
                for s in value:
                    self._write_string(f, s)
            elif value and isinstance(value[0], float):
                f.write(struct.pack("<IQ", int(GGUFValueType.FLOAT32), len(value)))
                for v in value:
                    f.write(struct.pack("<f", v))
            else:
                f.write(struct.pack("<IQ", int(GGUFValueType.INT32), len(value)))
                for v in value:
                    f.write(struct.pack("<i", int(v)))
        else:
            f.write(struct.pack(_SCALAR_FMT[vtype], value))

    def write(self) -> Path:
        align = self.alignment
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION, len(self._tensors),
                                len(self._kv)))
            for key, value, vtype in self._kv:
                self._write_string(f, key)
                f.write(struct.pack("<I", int(vtype)))
                self._write_value(f, value, vtype)
            offset = 0
            for name, ggml_type, ne, payload in self._tensors:
                self._write_string(f, name)
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<IQ", int(ggml_type), offset))
                offset += (len(payload) + align - 1) // align * align
            pos = f.tell()
            f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
            for _, _, _, payload in self._tensors:
                f.write(payload)
                f.write(b"\x00" * ((len(payload) + align - 1) // align * align - len(payload)))
        return self.path
