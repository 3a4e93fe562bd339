"""GGUF reader — memory-mapped, lazy tensor access.

A fresh implementation of the GGUF v2/v3 container (spec as implemented by
ggml/src/gguf.cpp:207-700 and gguf-py/gguf/gguf_reader.py): header, typed KV
metadata (scalars, strings, arrays), tensor directory, aligned data blob.

Dimension convention: GGUF stores ne[0..n_dims) with ne[0] the
fastest-varying (contiguous) axis. We expose ``shape`` in numpy order
(slowest first), i.e. reversed — a llama.cpp weight of ne=[K, N] appears
here as shape (N, K) row-major.
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
from pathlib import Path
from typing import Any, BinaryIO

import numpy as np

from rrs_tpu_torch.gguf.constants import (
    BLOCK_SIZES,
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    row_size,
)

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

_SCALAR_NP = {
    GGUFValueType.UINT8: np.uint8,
    GGUFValueType.INT8: np.int8,
    GGUFValueType.UINT16: np.uint16,
    GGUFValueType.INT16: np.int16,
    GGUFValueType.UINT32: np.uint32,
    GGUFValueType.INT32: np.int32,
    GGUFValueType.FLOAT32: np.float32,
    GGUFValueType.BOOL: np.bool_,
    GGUFValueType.UINT64: np.uint64,
    GGUFValueType.INT64: np.int64,
    GGUFValueType.FLOAT64: np.float64,
}


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, fmt: str):
        size = struct.calcsize(fmt)
        out = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return out[0] if len(out) == 1 else out

    def read_string(self) -> str:
        n = self.read("<Q")
        s = bytes(self.buf[self.pos : self.pos + n])
        self.pos += n
        return s.decode("utf-8")

    def read_value(self, vtype: GGUFValueType) -> Any:
        if vtype == GGUFValueType.STRING:
            return self.read_string()
        if vtype == GGUFValueType.ARRAY:
            item_type = GGUFValueType(self.read("<I"))
            count = self.read("<Q")
            if item_type == GGUFValueType.STRING:
                return [self.read_string() for _ in range(count)]
            if item_type == GGUFValueType.ARRAY:
                return [self.read_value(GGUFValueType.ARRAY) for _ in range(count)]
            dt = np.dtype(_SCALAR_NP[item_type]).newbyteorder("<")
            nbytes = dt.itemsize * count
            # copy: metadata arrays are small and must not pin the mmap open
            arr = np.frombuffer(self.buf, dtype=dt, count=count, offset=self.pos).copy()
            self.pos += nbytes
            return arr
        return self.read(_SCALAR_FMT[vtype])


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: tuple[int, ...]        # numpy order (reversed GGUF ne)
    ggml_type: GGMLType
    offset: int                   # relative to data-section start

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        blck, tsize = BLOCK_SIZES[self.ggml_type]
        # row granularity: last axis must be block aligned (matches ggml nbytes)
        rs = row_size(self.ggml_type, self.shape[-1] if self.shape else 1)
        rows = self.n_elements // (self.shape[-1] if self.shape else 1)
        return rows * rs


class GGUFFile:
    """Parsed GGUF container with lazy mmap'd tensor data."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        cur = _Cursor(self._mm)

        magic = cur.read("<I")
        if magic != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file (magic {magic:#x})")
        self.version = cur.read("<I")
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.read("<Q")
        n_kv = cur.read("<Q")

        self.metadata: dict[str, Any] = {}
        self.metadata_types: dict[str, GGUFValueType] = {}
        for _ in range(n_kv):
            key = cur.read_string()
            vtype = GGUFValueType(cur.read("<I"))
            self.metadata[key] = cur.read_value(vtype)
            self.metadata_types[key] = vtype

        self.tensors: dict[str, GGUFTensorInfo] = {}
        for _ in range(n_tensors):
            name = cur.read_string()
            n_dims = cur.read("<I")
            ne = [cur.read("<Q") for _ in range(n_dims)]
            ttype = GGMLType(cur.read("<I"))
            offset = cur.read("<Q")
            self.tensors[name] = GGUFTensorInfo(
                name=name, shape=tuple(reversed(ne)), ggml_type=ttype, offset=offset
            )

        self.alignment = int(self.metadata.get("general.alignment", GGUF_DEFAULT_ALIGNMENT))
        pos = cur.pos
        self.data_start = (pos + self.alignment - 1) // self.alignment * self.alignment

    # -- tensor access ----------------------------------------------------

    def tensor_bytes(self, name: str) -> np.ndarray:
        """Raw bytes of a tensor as uint8 view into the mmap (zero-copy)."""
        info = self.tensors[name]
        start = self.data_start + info.offset
        return np.frombuffer(self._mm, dtype=np.uint8, count=info.nbytes, offset=start)

    def tensor(self, name: str) -> np.ndarray:
        """Tensor dequantized/viewed as a numpy array in its logical shape.

        Float types are zero-copy views; quantized types are dequantized to
        f32 via rrs_tpu_torch.formats.kquants (CPU reference codecs).
        """
        info = self.tensors[name]
        raw = self.tensor_bytes(name)
        t = info.ggml_type
        if t == GGMLType.F32:
            return raw.view(np.float32).reshape(info.shape)
        if t == GGMLType.F16:
            return raw.view(np.float16).reshape(info.shape)
        if t == GGMLType.BF16:
            x = raw.view(np.uint16).astype(np.uint32) << 16
            return x.view(np.float32).reshape(info.shape)
        if t == GGMLType.I32:
            return raw.view(np.int32).reshape(info.shape)
        if t == GGMLType.I8:
            return raw.view(np.int8).reshape(info.shape)
        from rrs_tpu_torch.formats import kquants

        return kquants.dequantize(raw, t, info.shape)

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views still alive; the mapping is reclaimed
            # when they are garbage-collected
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_gguf(path: str | Path) -> GGUFFile:
    return GGUFFile(path)
