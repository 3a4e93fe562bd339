"""Build and bind the port's CUDA kernels (``rrs_tpu_torch/csrc/*.cu``).

Each ``.cu`` file compiles with its own ``nvcc`` process, all started
together, into an object for ``sm_90a``; one link step makes a shared library
under ``build/`` at the repository root, named by a digest of the sources and
flags, so an edited kernel is rebuilt and an unchanged one is reused. The
library has a plain C interface (no PyTorch headers), loaded with ``ctypes``:
every pointer and the stream go as ``c_void_p``, and every entry returns
``cudaGetLastError()``, which ``check`` turns into an exception.

Nothing here runs at import time: the first wrapper that launches a kernel
calls ``lib()``, which builds if needed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
NVCC_FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (see the matching csrc/*.cu).
SIGNATURES = {
    "rrs_tcq4_gx2": [_P, _P, _P, _P, _I, _I, _I, _P],
    "rrs_tcq4_matmul": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rrs_q8_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _P],
    "rrs_flash_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _F, _I, _P],
}

# Launch counts per kernel wrapper: a wrapper adds one where it launches its
# kernel and nowhere else (the plain CPU versions launch nothing).
LAUNCHES: dict[str, int] = {"tcq4_matmul_gx2": 0, "tcq4_matmul": 0, "q8_matmul": 0,
                            "flash_attention": 0}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"librrs_tpu_torch_{_digest()}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link the shared library.
    Returns its path; reuses a library built from the same sources."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    obj_dir = BUILD_DIR / f"obj_{out.stem}_{os.getpid()}"
    obj_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = obj_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    errors = []
    for src, _, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name}:\n{log}")
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    tmp = obj_dir / out.name
    link = subprocess.run(
        [nvcc, ARCH, "-shared", *[str(o) for _, o, _ in procs], "-o", str(tmp)],
        capture_output=True, text=True)
    if link.returncode != 0:
        raise RuntimeError("CUDA kernel link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, out)
    shutil.rmtree(obj_dir, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(name: str, code: int) -> None:
    """Raise if a C entry refused its arguments (< 0) or CUDA reported an
    error; else count the launch under ``name``."""
    if code < 0:
        raise ValueError(f"{name}: arguments refused by the kernel launcher")
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
    LAUNCHES[name] += 1


def check_tensors(name: str, *tensors) -> "torch.device":
    """The common device of ``tensors``, which every kernel takes contiguous
    and 16-byte aligned (its vector loads assume both)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: needs contiguous, 16-byte aligned tensors")
    return dev


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
