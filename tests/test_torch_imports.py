"""rrs_tpu_torch stands alone: no JAX, nothing of rrs_tpu, and no quiet CPU
fallback in its entry points."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import rrs_tpu_torch
mods = ["rrs_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    rrs_tpu_torch.__path__, "rrs_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m in ("jax", "rrs_tpu") or m.startswith(("jax.", "rrs_tpu.")))
print(len(mods), "modules;", "forbidden:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_rrs_tpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works here")


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _no_cuda()
    from test_torch_common import torch_cfg, jax_cfg
    from rrs_tpu_torch.__main__ import main
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.models.loader import load_model
    from rrs_tpu_torch.runtime.context import InferenceContext

    cfg = torch_cfg(jax_cfg())
    w = llama.random_weights(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceContext(cfg, w)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama.fabricated_tcq4_weights(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model(tmp_path / "absent.gguf")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["generate", "-m", str(tmp_path / "absent.gguf")])
    # asked for explicitly, the CPU works
    ctx = InferenceContext(cfg, w, max_seq=32, device="cpu")
    assert len(ctx.generate([1, 2, 3], 2)) == 2


def test_kernel_wrappers_count_only_their_launches():
    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    before = dict(kernels.LAUNCHES)
    assert set(before) == {"tcq4_matmul_gx2", "tcq4_matmul", "q8_matmul", "flash_attention"}
    g = torch.Generator().manual_seed(0)
    qs = torch.randint(0, 256, (128, 64), generator=g, dtype=torch.uint8)
    eff = torch.rand((8, 64), generator=g).to(torch.bfloat16)
    tm.tcq4_matmul_gx2(torch.randn(1, 256, generator=g), qs, eff)
    tm.tcq4_matmul(torch.randn(20, 256, generator=g), qs, eff)
    q8.q8_matmul(torch.randn(2, 256, generator=g), torch.zeros(256, 64, dtype=torch.int8),
                 torch.ones(8, 64))
    fa.flash_attention(torch.randn(1, 1, 4, 64), torch.randn(1, 2, 16, 64),
                       torch.randn(1, 2, 16, 64), torch.zeros(1, 1, dtype=torch.int32), 0.125)
    # CPU tensors take the plain versions, which launch nothing
    assert kernels.LAUNCHES == before
