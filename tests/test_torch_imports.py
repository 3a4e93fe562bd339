"""rrs_tpu_torch stands alone: no JAX, nothing of rrs_tpu, no Pillow at import
(the card's machine has none), and no quiet CPU fallback in its entry
points."""

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
for m in ("rrs_tpu_torch.ops.mxfp4_matmul", "rrs_tpu_torch.ops.tcq4_matmul",
          "rrs_tpu_torch.models.moe", "rrs_tpu_torch.formats.kquants",
          "rrs_tpu_torch.tools.bench_sweep", "rrs_tpu_torch.tools.batched_bench",
          "rrs_tpu_torch.tools.perplexity", "rrs_tpu_torch.tools.timing",
          "rrs_tpu_torch.runtime.grammar", "rrs_tpu_torch.runtime.json_schema",
          "rrs_tpu_torch.runtime.speculative", "rrs_tpu_torch.runtime.lookup",
          "rrs_tpu_torch.runtime.dfa_worker", "rrs_tpu_torch.parallel.train_step"):
    assert m in mods, m
ts = importlib.import_module("rrs_tpu_torch.parallel.train_step")
for fn in ("make_train_mesh", "shard_train_weights", "shard_batch", "make_sharded_train_step"):
    assert callable(getattr(ts, fn)), fn
tm = importlib.import_module("rrs_tpu_torch.ops.tcq4_matmul")
for fn in ("tcq4_matmul_fused", "tcq4_matmul_fused_plain", "tcq4_matmul_pb",
           "tcq4_matmul_pb_plain", "pack_gi", "pb_prepare", "tcq4_matmul_experts",
           "tcq4_matmul_experts_plain"):
    assert callable(getattr(tm, fn)), fn
bad = sorted(m for m in sys.modules
             if m in ("jax", "rrs_tpu", "PIL") or m.startswith(("jax.", "rrs_tpu.", "PIL.")))
print(len(mods), "modules;", "forbidden:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_rrs_tpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 20, r.stdout


_WORKER_PROBE = r"""
import sys
from rrs_tpu_torch.runtime.dfa_worker import dfa_worker
bad = sorted(m for m in sys.modules
             if m in ("jax", "rrs_tpu", "torch") or m.startswith(("jax.", "rrs_tpu.", "torch.")))
print("forbidden:", bad)
sys.exit(1 if bad else 0)
"""


def test_dfa_worker_module_imports_neither_torch_nor_jax():
    """The spawned DFA compile's module (and the grammar it imports when it
    runs) loads no torch, no JAX and nothing of rrs_tpu, so the child
    starts in well under a second."""
    probe = _WORKER_PROBE.replace("print(", "import rrs_tpu_torch.runtime.grammar, "
                                  "rrs_tpu_torch.runtime.json_schema\nprint(")
    for code in (_WORKER_PROBE, probe):
        r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stdout + r.stderr


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
    # the measuring verbs too, with a file or with fabricated weights, and tts
    for argv in (["bench", "-m", str(tmp_path / "absent.gguf")], ["bench", "--preset", "tiny"],
                 ["batched-bench", "--preset", "tiny"],
                 ["perplexity", "-m", str(tmp_path / "absent.gguf"), "-f", "t.txt"],
                 ["tts", "-m", str(tmp_path / "absent.gguf"), "-mv", "v.gguf", "-p", "hi"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(argv)
    # the pipeline defaults to the card too; asked for the CPU it runs, here
    # as far as the absent model file
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["perplexity", "-m", "absent.gguf", "-f", "t.txt", "--pp", "2"])
    with pytest.raises(FileNotFoundError):
        main(["perplexity", "-m", str(tmp_path / "absent.gguf"), "-f", "t.txt", "--pp", "2",
              "--device", "cpu"])
    # the training mesh takes the CUDA devices unless given others
    from rrs_tpu_torch.parallel.train_step import make_train_mesh

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_train_mesh(dp=2)
    assert make_train_mesh(devices=["cpu"] * 4, dp=2).shape == {"dp": 2, "tp": 2}
    # asked for explicitly, the CPU works
    ctx = InferenceContext(cfg, w, max_seq=32, device="cpu")
    assert len(ctx.generate([1, 2, 3], 2)) == 2


def test_serving_entry_points_default_to_cuda_and_raise_without_it(tmp_path):
    _no_cuda()
    from test_torch_common import torch_cfg, jax_cfg
    from rrs_tpu_torch.__main__ import main
    from rrs_tpu_torch.models import llama
    from rrs_tpu_torch.runtime.context import InferenceContext
    from rrs_tpu_torch.serving.engine import Engine

    cfg = torch_cfg(jax_cfg())
    w = llama.random_weights(cfg, device="cpu")
    # the engine serves on its context's device, and the context a server
    # builds chooses cuda unless asked for the CPU
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        InferenceContext(cfg, w, n_lanes=4, max_seq=32)
    ctx = InferenceContext(cfg, w, n_lanes=4, max_seq=32, device="cpu")
    for verb in ("serve", "chat"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main([verb, "-m", str(tmp_path / "absent.gguf")])
    # the quantized cache, the slot save path, a draft model, extra routed
    # models, a vision projector (--mmproj, which raised here naming ROADMAP
    # A11) and a tensor / data parallel mesh (--tp / --dp, which raised
    # naming A12b) are ported, and still default to the card; asked for the
    # CPU, --tp gets as far as the absent model file
    with pytest.raises(FileNotFoundError):
        main(["serve", "-m", str(tmp_path / "absent.gguf"), "--device", "cpu", "--tp", "2"])
    for flags in (["--cache-type", "q8"], ["--slot-save-path", str(tmp_path)],
                  ["--model-draft", "d.gguf"], ["--models", "a=b.gguf"],
                  ["--mmproj", "m.gguf"], ["--tp", "2"], ["--tp", "2", "--dp", "2"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["serve", "-m", str(tmp_path / "absent.gguf"), *flags])
    for flags in (["--model-draft", "d.gguf"], ["--lookup"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["generate", "-m", str(tmp_path / "absent.gguf"), *flags])
    eng = Engine(ctx)
    assert eng.ctx is ctx and len(eng.slots) == 4


def test_kernel_wrappers_count_only_their_launches():
    from rrs_tpu_torch import kernels
    from rrs_tpu_torch.ops import flash_attention as fa
    from rrs_tpu_torch.ops import mxfp4_matmul as mx
    from rrs_tpu_torch.ops import q8_matmul as q8
    from rrs_tpu_torch.ops import tcq4_matmul as tm

    before = dict(kernels.LAUNCHES)
    assert set(before) == {"tcq4_matmul_gx2", "tcq4_matmul", "tcq4_matmul_i8p", "q8_matmul",
                           "flash_attention", "flash_attention_q8", "flash_attention_q4hp",
                           "flash_attention_q4", "mxfp4_matmul", "mxfp4_matmul_experts_rows",
                           "mxfp4_matmul_all_experts", "tcq4_matmul_experts_rows",
                           "tcq4_matmul_all_experts", "tcq4_matmul_gx", "tcq4_matmul_gx3",
                           "tcq4_matmul_a8", "tcq4_matmul_experts", "tcq4_matmul_pb",
                           "tcq4_matmul_fused"}
    g = torch.Generator().manual_seed(0)
    qs = torch.randint(0, 256, (128, 64), generator=g, dtype=torch.uint8)
    eff = torch.rand((8, 64), generator=g).to(torch.bfloat16)
    tm.tcq4_matmul_gx2(torch.randn(1, 256, generator=g), qs, eff)
    a_q = torch.randint(-7, 8, (2, 256), generator=g, dtype=torch.int8)
    tm.tcq4_matmul_gx(a_q, torch.rand(2, 1, generator=g) + 0.5, qs, eff)
    tm.tcq4_matmul_gx3(torch.randn(2, 256, generator=g), qs, eff)
    tm.tcq4_matmul_a8(a_q, torch.rand(2, 1, generator=g) + 0.5, qs, eff.float())
    tm.tcq4_matmul(torch.randn(20, 256, generator=g), qs, eff)
    tm.tcq4_matmul_i8p(torch.randint(-7, 8, (4, 256), generator=g, dtype=torch.int8),
                       torch.rand(4, 1, generator=g) + 0.5, *tm.pack_i8p(qs, eff))
    q8.q8_matmul(torch.randn(2, 256, generator=g), torch.zeros(256, 64, dtype=torch.int8),
                 torch.ones(8, 64))
    fa.flash_attention(torch.randn(1, 1, 4, 64), torch.randn(1, 2, 16, 64),
                       torch.randn(1, 2, 16, 64), torch.zeros(1, 1, dtype=torch.int32), 0.125)
    sc = torch.ones(1, 2, 1, 16)
    for fn, codes in ((fa.flash_attention_q8, torch.zeros(1, 2, 16, 64, dtype=torch.int8)),
                      (fa.flash_attention_q4hp, torch.zeros(1, 1, 16, 64, dtype=torch.uint8)),
                      (fa.flash_attention_q4, torch.zeros(1, 2, 16, 32, dtype=torch.uint8))):
        fn(torch.randn(1, 1, 4, 64), codes, sc, codes, sc, torch.zeros(1, 1, dtype=torch.int32),
           0.125)
    mq = torch.randint(0, 256, (2, 64, 64), generator=g, dtype=torch.uint8)
    ms = torch.randint(118, 123, (2, 4, 64), generator=g, dtype=torch.uint8)
    mx.mxfp4_matmul(torch.randn(3, 128, generator=g), mq[0], ms[0])
    mx.mxfp4_matmul_experts_rows(torch.randn(3, 128, generator=g), mq, ms,
                                 torch.tensor([1, 0, 1]))
    mx.mxfp4_matmul_all_experts(torch.randn(3, 128, generator=g), mq, ms)
    tq, te = torch.stack([qs, qs]), torch.stack([eff, eff])
    tm.tcq4_matmul_experts_rows(torch.randn(3, 256, generator=g).to(torch.bfloat16), tq, te,
                                torch.tensor([1, 0, 1]))
    tm.tcq4_matmul_all_experts(torch.randn(2, 3, 256, generator=g), tq, te)
    tm.tcq4_matmul_experts(torch.randn(3, 256, generator=g), tq, te, torch.tensor([1, 0]))
    tm.tcq4_matmul_fused(torch.randn(3, 256, generator=g), torch.eye(256), qs, eff)
    tm.tcq4_matmul_pb(*tm.pb_prepare(torch.randn(3, 256, generator=g)), tm.pack_gi(qs), eff)
    # CPU tensors take the plain versions, which launch nothing
    assert kernels.LAUNCHES == before
