"""GGUF writer: v3 files that the port's reader, the JAX package's and
llama.cpp read.

Copied host code from ``rrs_tpu/gguf/writer.py`` (the write path of
gguf.cpp:gguf_write_to_buf / gguf-py GGUFWriter): typed metadata KVs (a value
keeps the type it is given, so a quantized or split copy keeps the source's
types), NumPy array values such as ``tcq4.*.perm``, tensors given as arrays
or as raw quantized payloads with a ``GGMLType`` and a logical shape, the
tensor directory with reversed ``ne``, and the aligned data blob.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any, Sequence

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
    np.dtype(np.int32): GGMLType.I32,
    np.dtype(np.int8): GGMLType.I8,
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

_NP_TO_VTYPE = {
    np.dtype(np.uint8): GGUFValueType.UINT8,
    np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16,
    np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32,
    np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32,
    np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64,
    np.dtype(np.float64): GGUFValueType.FLOAT64,
    np.dtype(np.bool_): GGUFValueType.BOOL,
}


def _infer_vtype(value: Any) -> GGUFValueType:
    if isinstance(value, bool):
        return GGUFValueType.BOOL
    if isinstance(value, int):
        return GGUFValueType.INT64 if value < 0 else GGUFValueType.UINT64
    if isinstance(value, float):
        return GGUFValueType.FLOAT32
    if isinstance(value, str):
        return GGUFValueType.STRING
    if isinstance(value, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF value type for {type(value)}")


class GGUFWriter:
    def __init__(self, path: str | Path, alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = Path(path)
        self.alignment = alignment
        self._kv: list[tuple[str, Any, GGUFValueType]] = []
        # name -> (ggml_type, gguf ne list, raw bytes)
        self._tensors: list[tuple[str, GGMLType, list[int], bytes]] = []

    # -- metadata ---------------------------------------------------------

    def add_kv(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self._kv.append((key, value, vtype or _infer_vtype(value)))

    def add_uint32(self, key: str, value: int):
        self._kv.append((key, value, GGUFValueType.UINT32))

    def add_int32(self, key: str, value: int):
        self._kv.append((key, value, GGUFValueType.INT32))

    def add_float32(self, key: str, value: float):
        self._kv.append((key, value, GGUFValueType.FLOAT32))

    def add_bool(self, key: str, value: bool):
        self._kv.append((key, value, GGUFValueType.BOOL))

    def add_string(self, key: str, value: str):
        self._kv.append((key, value, GGUFValueType.STRING))

    def add_array(self, key: str, value: Sequence | np.ndarray):
        self._kv.append((key, value, GGUFValueType.ARRAY))

    # -- tensors ----------------------------------------------------------

    def add_tensor(
        self,
        name: str,
        data: np.ndarray | bytes,
        shape: tuple[int, ...] | None = None,
        ggml_type: GGMLType | None = None,
    ):
        """Add a tensor. ``shape`` is in numpy order; stored reversed as GGUF ne.

        For raw quantized payloads pass bytes + explicit shape + ggml_type.
        """
        if isinstance(data, np.ndarray):
            if ggml_type is None:
                ggml_type = _NP_TO_GGML[data.dtype]
            if shape is None:
                shape = data.shape
            payload = np.ascontiguousarray(data).tobytes()
        else:
            assert shape is not None and ggml_type is not None
            payload = bytes(data)
        ne = list(reversed(shape))
        self._tensors.append((name, ggml_type, ne, payload))

    # -- serialization ----------------------------------------------------

    def _write_string(self, f, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _write_value(self, f, value: Any, vtype: GGUFValueType):
        if vtype == GGUFValueType.STRING:
            self._write_string(f, value)
        elif vtype == GGUFValueType.ARRAY:
            if isinstance(value, np.ndarray):
                item_type = _NP_TO_VTYPE[value.dtype]
                f.write(struct.pack("<IQ", int(item_type), value.size))
                f.write(np.ascontiguousarray(value.reshape(-1)).tobytes())
            else:
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
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, GGUF_VERSION,
                                len(self._tensors), len(self._kv)))
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
            pad = (pos + align - 1) // align * align - pos
            f.write(b"\x00" * pad)
            for _, _, _, payload in self._tensors:
                payload_pad = (len(payload) + align - 1) // align * align - len(payload)
                f.write(payload)
                f.write(b"\x00" * payload_pad)
        return self.path
