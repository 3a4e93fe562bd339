"""The port's imatrix collection (``rrs_tpu_torch/quantize/imatrix.py`` over
the capture hook of ``models/llama.py``) against the JAX package's, on the
2-layer F16 model of tests/test_torch_quantize.py and text tokenized by its
char vocab, both on the CPU.

The sums are held per tensor within ``SUM_TOL`` relative L2: each is a sum
of squares of bf16 activations accumulated in f32 over 64-token chunks, and
the two packages' forwards differ only in where bf16 rounds (JAX runs the
capture under ``jit``, where XLA's CPU backend fuses some rounding sites
away), a last-bit difference that moves a sum by ~1e-3 relative; a missing
rmsnorm or a wrong layer input moves it by order one. Token counts are
equal. From one imatrix file both packages derive the same permutations,
and ``save_imatrix`` writes JAX's bytes. The capture hook changes no logit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu.quantize import imatrix as jax_imatrix
from rrs_tpu_torch.models import llama
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.quantize import imatrix

from test_torch_common import jax_cfg, tiny_vocab_tokens

ROOT = Path(__file__).resolve().parent.parent
SUM_TOL = 1e-2
CHUNK = 64


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_imatrix")
    path = d / "f16.gguf"
    export_random_gguf(jax_cfg(), path, seed=4, dtype=np.float16,
                       vocab_tokens=tiny_vocab_tokens(256))
    rng = np.random.default_rng(6)
    text = "".join(chr(33 + int(i)) for i in rng.integers(0, 90, 3 * CHUNK + 17))
    (d / "calib.txt").write_text(text, encoding="utf-8")
    toks = [ord(c) - 33 for c in text]
    chunks = [toks[i:i + CHUNK] for i in range(0, len(toks), CHUNK)]
    jcfg, jw, _ = jax_loader.load_model(path)
    ref = jax_imatrix.collect_imatrix(jcfg, jw, chunks, chunk_len=CHUNK)
    return path, chunks, ref


def test_collect_matches_jax(setup):
    path, chunks, ref = setup
    cfg, w, _ = load_model(path, device="cpu")
    got = imatrix.collect_imatrix(cfg, w, chunks, chunk_len=CHUNK)
    assert sorted(got) == sorted(ref) and len(got) == 2 * 7
    worst = 0.0
    for name, (sums, n) in ref.items():
        g, gn = got[name]
        assert gn == n == len(chunks[0]) * 3 + len(chunks[3]) and g.dtype == np.float32
        rel = np.linalg.norm(g - sums) / np.linalg.norm(sums)
        worst = max(worst, rel)
        assert rel < SUM_TOL, (name, rel)
    print(f"\nimatrix sums, port vs JAX: worst rel L2 {worst:.2e} (<= {SUM_TOL})")


def test_perms_and_file_match_jax(setup, tmp_path):
    _, _, ref = setup
    jax_imatrix.save_imatrix(tmp_path / "jax.gguf", ref)
    imatrix.save_imatrix(tmp_path / "port.gguf", ref)
    assert (tmp_path / "port.gguf").read_bytes() == (tmp_path / "jax.gguf").read_bytes()
    im, jim = imatrix.load_imatrix(tmp_path / "jax.gguf"), jax_imatrix.load_imatrix(
        tmp_path / "jax.gguf")
    perms, jperms = imatrix.derive_tcq4_perms(im), jax_imatrix.derive_tcq4_perms(jim)
    assert sorted(perms) == sorted(jperms) and len(perms) == 14
    for k in jperms:
        np.testing.assert_array_equal(perms[k], jperms[k])
        assert perms[k].dtype == np.int32


def test_capture_changes_no_logit(setup):
    path, chunks, _ = setup
    cfg, w, _ = load_model(path, device="cpu")
    toks = np.asarray(chunks[0], np.int32)[None, :]
    pos = np.arange(toks.shape[1], dtype=np.int32)[None, :]
    out = []
    for cap in (None, {}):
        kc, vc = llama.scratch_caches(cfg, 1, toks.shape[1])
        with torch.inference_mode():
            out.append(llama.forward(cfg, w, toks, pos, kc, vc, pos, pos, cap=cap))
        if cap is not None:
            assert len(cap["__counts__"]) == 14
    assert torch.equal(out[0], out[1])


def test_cli_imatrix_on_cpu(setup, tmp_path):
    path, chunks, ref = setup
    dst = tmp_path / "cli.gguf"
    r = subprocess.run([sys.executable, "-m", "rrs_tpu_torch", "imatrix", "-m", str(path),
                        "-f", str(path.parent / "calib.txt"), "-o", str(dst), "--chunk-len",
                        str(CHUNK), "--device", "cpu"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"saved imatrix for 14 tensors -> {dst}" in r.stdout
    im = imatrix.load_imatrix(dst)
    for name, (sums, n) in ref.items():
        rel = np.linalg.norm(im[name] - sums / n) / np.linalg.norm(sums / n)
        assert rel < SUM_TOL, (name, rel)
