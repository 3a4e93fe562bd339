"""ctypes binding to the port's native host codecs (``csrc/rrs_core.cpp``).

The port's own copy of ``rrs_tpu/native.py``: the library builds with ``g++``
at first use into ``build/`` at the repository root, named by a digest of the
source and flags (built under a temporary name and renamed, so processes that
build at once do not clash). Every entry point has a NumPy fallback in its
caller, so the port works without a compiler. These are host paths (GGUF block dequant, the TCQ4 tile
decode and quantizer, the BPE merge loop), not device ones.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "rrs_core.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
# no -march=native: the library must run on any x86-64 host that reuses a
# build/ directory, and strict ISO C++ contracts no FMA, so the bits are those
# of the JAX package's -march=native build
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"librrs_core_{h.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """Compile ``csrc/rrs_core.cpp`` (reusing a library built from the same
    source and flags). Returns its path, or None where ``g++`` fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        print(f"rrs_core build failed: {e}", file=sys.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, out)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    path = build()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(str(path))
    except OSError:
        return None
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i64p = ctypes.POINTER(ctypes.c_int64)
    for fn, args, res in (
            ("rrs_fwht_rows_f32", [f32p, i64, i64], None),
            ("rrs_tcq4_decode_tiles", [u8p, i64, i64, u8p, f32p], None),
            ("rrs_tcq4_quantize", [f32p, i64, i64, u8p, i8p, u16p, f32p], None),
            ("rrs_dequant_q8_0", [u8p, f32p, i64], None),
            ("rrs_dequant_q4_k", [u8p, f32p, i64], None),
            ("rrs_dequant_q6_k", [u8p, f32p, i64], None),
            ("rrs_bpe_init", [ctypes.c_char_p, i64p, i64, ctypes.c_char_p, i64p, i64], i64),
            ("rrs_bpe_encode", [i64, ctypes.c_char_p, i64, ctypes.POINTER(i32), i64], i64)):
        f = getattr(lib, fn)
        f.argtypes = args
        f.restype = res
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("the native host codec (rrs_tpu_torch/csrc/rrs_core.cpp) is not built")
    return lib


def _ptr(a: np.ndarray, ct):
    return a.ctypes.data_as(ctypes.POINTER(ct))


def fwht_rows(x: np.ndarray) -> np.ndarray:
    """In-place normalized FWHT over the last axis (f32, contiguous)."""
    lib = _lib_or_raise()
    if x.dtype != np.float32 or not x.flags.c_contiguous:
        raise ValueError("fwht_rows takes a contiguous float32 array")
    lib.rrs_fwht_rows_f32(_ptr(x, ctypes.c_float), int(np.prod(x.shape[:-1])), x.shape[-1])
    return x


def tcq4_decode_tiles(raw: np.ndarray, n_rows: int, k: int):
    """block_tcq4_tile bytes -> (qs [K/2, N] u8, eff [K/32, N] f32, computed
    as fp32(S) * sc / 127 in f32)."""
    lib = _lib_or_raise()
    raw = np.ascontiguousarray(raw, np.uint8)
    if n_rows % 8 or k % 256 or raw.size < n_rows // 8 * (k // 256) * 1184:
        raise ValueError(f"TCQ4 payload of {raw.size} bytes for [{n_rows}, {k}]")
    qs = np.zeros((k // 2, n_rows), np.uint8)
    eff = np.zeros((k // 32, n_rows), np.float32)
    lib.rrs_tcq4_decode_tiles(_ptr(raw, ctypes.c_uint8), n_rows, k, _ptr(qs, ctypes.c_uint8),
                              _ptr(eff, ctypes.c_float))
    return qs, eff


def tcq4_quantize(w: np.ndarray):
    """f32 [N, K] -> (qs [K/2, N] u8, sc [K/32, N] i8, S [K/256, N] fp16)."""
    lib = _lib_or_raise()
    w = np.ascontiguousarray(w, np.float32)
    n, k = w.shape
    if k % 256:
        raise ValueError(f"TCQ4 requires K % 256 == 0, got K={k}")
    qs = np.zeros((k // 2, n), np.uint8)
    sc = np.zeros((k // 32, n), np.int8)
    S = np.zeros((k // 256, n), np.uint16)
    scratch = np.zeros((k,), np.float32)
    lib.rrs_tcq4_quantize(_ptr(w, ctypes.c_float), n, k, _ptr(qs, ctypes.c_uint8),
                          _ptr(sc, ctypes.c_int8), _ptr(S, ctypes.c_uint16),
                          _ptr(scratch, ctypes.c_float))
    return qs, sc, S.view(np.float16)


_DEQUANT_BLOCK = {"q8_0": (32, 34), "q4_k": (256, 144), "q6_k": (256, 210)}


def dequant(raw: np.ndarray, kind: str, n: int) -> np.ndarray:
    """Dequantize ``n`` elements of a Q8_0, Q4_K or Q6_K payload to f32."""
    lib = _lib_or_raise()
    elems, nbytes = _DEQUANT_BLOCK[kind]
    raw = np.ascontiguousarray(raw, np.uint8)
    if n % elems or raw.size < n // elems * nbytes:
        raise ValueError(f"{kind} payload of {raw.size} bytes for {n} elements")
    out = np.empty((n,), np.float32)
    fn = {"q8_0": lib.rrs_dequant_q8_0, "q4_k": lib.rrs_dequant_q4_k,
          "q6_k": lib.rrs_dequant_q6_k}[kind]
    fn(_ptr(raw, ctypes.c_uint8), _ptr(out, ctypes.c_float), n)
    return out


def bpe_session(vocab_tokens: list, merges: list) -> Optional[int]:
    """Build a native BPE session for this vocabulary; the caller keeps the
    handle (the JAX package caches it by ``id(vocab_tokens)``, which a later
    list can reuse). Returns the handle, or None without the library."""
    lib = _load()
    if lib is None:
        return None

    def blob(strings):
        enc = [s.encode("utf-8") for s in strings]
        offs = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(b) for b in enc], out=offs[1:])
        return b"".join(enc), offs

    vb, vo = blob(vocab_tokens)
    mb, mo = blob(merges or [])
    return int(lib.rrs_bpe_init(vb, _ptr(vo, ctypes.c_int64), len(vocab_tokens),
                                mb, _ptr(mo, ctypes.c_int64), len(merges or [])))


def bpe_encode(handle: int, fragment: str) -> Optional[list]:
    """Encode one byte-encoded fragment; None where a piece has no id (the
    caller falls back to the Python merge loop)."""
    lib = _load()
    if lib is None:
        return None
    data = fragment.encode("utf-8")
    out = np.empty(len(data) + 8, np.int32)
    n = lib.rrs_bpe_encode(handle, data, len(data), _ptr(out, ctypes.c_int32), out.shape[0])
    if n < 0:
        return None
    return out[:n].tolist()
