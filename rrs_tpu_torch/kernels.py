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
import threading
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
    "rrs_tcq4_gx2": [_P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rrs_tcq4_gx": [_P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P],
    "rrs_tcq4_gx3": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    "rrs_tcq4_a8": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rrs_tcq4_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "rrs_tcq4_i8p": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "rrs_q8_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "rrs_flash_attention": [_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _F, _F, _I, _I, _I, _P, _P, _P],
    "rrs_mxfp4_matmul": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "rrs_mxfp4_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "rrs_mxfp4_all_experts": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rrs_tcq4_experts_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "rrs_tcq4_all_experts": [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "rrs_tcq4_experts_sel": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "rrs_tcq4_pb": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P],
    "rrs_tcq4_fused": [_P, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P],
}

# Launch counts per kernel wrapper: a wrapper adds one where it launches its
# kernel and nowhere else (the plain CPU versions launch nothing). The shards
# of a tensor-parallel mesh launch from threads of their own, so the counts
# move under a lock.
LAUNCHES: dict[str, int] = {"tcq4_matmul_gx2": 0, "tcq4_matmul": 0, "tcq4_matmul_i8p": 0,
                            "q8_matmul": 0, "flash_attention": 0, "flash_attention_q8": 0,
                            "flash_attention_q4hp": 0, "flash_attention_q4": 0,
                            "mxfp4_matmul": 0, "mxfp4_matmul_experts_rows": 0,
                            "mxfp4_matmul_all_experts": 0, "tcq4_matmul_experts_rows": 0,
                            "tcq4_matmul_all_experts": 0, "tcq4_matmul_gx": 0,
                            "tcq4_matmul_gx3": 0, "tcq4_matmul_a8": 0,
                            "tcq4_matmul_experts": 0, "tcq4_matmul_pb": 0,
                            "tcq4_matmul_fused": 0}

_LAUNCH_LOCK = threading.Lock()
# per-thread counts, where a thread asked for them (``count_thread_launches``)
_THREAD = threading.local()
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
    with _LAUNCH_LOCK:
        LAUNCHES[name] += 1
    mine = getattr(_THREAD, "launches", None)
    if mine is not None:
        mine[name] = mine.get(name, 0) + 1


def count_thread_launches(into: Optional[dict]) -> None:
    """From now on, also count this thread's launches into ``into`` (None
    stops); a mesh shard's thread counts its own this way."""
    _THREAD.launches = into


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


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on ``tensors`` (None allowed): grad
    mode on and an input that requires grad."""
    import torch

    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors) -> None:
    """Raise where a kernel wrapper is called under autograd (``needs_grad``):
    its output would carry no ``grad_fn`` and cut the gradient without a
    word. The autograd Functions of ``models/linear.py`` call the wrappers
    from their ``forward``, where grad mode is off."""
    if needs_grad(*tensors):
        raise RuntimeError(f"{name}: called under autograd on an input that requires grad; "
                           "the kernel has no backward (call it from its autograd Function, "
                           "or under torch.no_grad)")


def reset_launches() -> None:
    with _LAUNCH_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
