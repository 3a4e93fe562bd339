"""Split GGUFs through rrs_tpu_torch against rrs_tpu: ``split_gguf`` /
``merge_gguf`` write JAX's bytes, a shard set written by either package loads
in the port to the unsplit file's weights bit for bit, greedy ``generate``
from the first shard gives the unsplit file's tokens (and JAX's), and the
``gguf-split`` verb splits and merges as JAX's does.

The model is the 2-layer TCQ4 GGUF of tests/test_torch_context.py (JAX's
exporter and quantizer, a char vocab). The JAX context loads through its
NumPy tile decode and runs op by op, for the reasons given there."""

import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.runtime.context import InferenceContext as JaxContext
from rrs_tpu.tools import gguf_split as jax_split
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.tools import gguf_split

from test_torch_common import tcq4_gguf

ROOT = Path(__file__).resolve().parent.parent
PROMPT = [int(t) for t in np.random.default_rng(9).integers(0, 256, 12)]


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    return tcq4_gguf(tmp_path_factory.mktemp("torch_gguf_split"))


def _tensors(w):
    """Every tensor of a weights tree, in field order (bf16 as int16 bits)."""
    import dataclasses

    out = []

    def walk(o):
        if isinstance(o, torch.Tensor):
            out.append(o.view(torch.int16) if o.dtype == torch.bfloat16 else o)
        elif dataclasses.is_dataclass(o):
            for f in dataclasses.fields(o):
                walk(getattr(o, f.name))
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
    walk(w)
    return out


@pytest.mark.parametrize("n_split", [2, 3])
def test_split_and_merge_write_jax_bytes(model, tmp_path, n_split):
    paths = gguf_split.split_gguf(model, tmp_path / "port", n_split)
    jpaths = jax_split.split_gguf(model, tmp_path / "jax", n_split)
    assert [p.name for p in paths] == [f"port-{i + 1:05d}-of-{n_split:05d}.gguf"
                                       for i in range(n_split)]
    for p, jp in zip(paths, jpaths):
        assert p.read_bytes() == Path(jp).read_bytes()
    assert gguf_split.find_shards(paths[1]) == paths
    merged = gguf_split.merge_gguf(paths[0], tmp_path / "merged.gguf")
    jax_split.merge_gguf(jpaths[0], tmp_path / "jax_merged.gguf")
    assert merged.read_bytes() == (tmp_path / "jax_merged.gguf").read_bytes()
    g, jg = gguf_split.MultiGGUF(paths[-1]), jax_split.MultiGGUF(jpaths[0])
    try:
        assert list(g.tensors) == list(jg.tensors) and g.metadata["split.count"] == n_split
        for name in g.tensors:
            assert np.array_equal(g.tensor_bytes(name), jg.tensor_bytes(name)), name
    finally:
        g.close()
        jg.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shard_set_loads_like_unsplit_file(model, tmp_path, writer):
    split = gguf_split.split_gguf if writer == "port" else jax_split.split_gguf
    first = Path(split(model, tmp_path / "m", 2)[0])
    cfg, w, md = load_model(first, device="cpu")
    cfg1, w1, md1 = load_model(model, device="cpu")
    assert cfg == cfg1 and md["general.architecture"] == md1["general.architecture"]
    a, b = _tensors(w), _tensors(w1)
    assert len(a) == len(b) > 20
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    got = InferenceContext(cfg, w, max_seq=64, device="cpu").generate(PROMPT, 6)
    ref = InferenceContext(cfg1, w1, max_seq=64, device="cpu").generate(PROMPT, 6)
    assert len(got) == 6 and got == ref
    with mock.patch.object(jax_native, "available", lambda: False):
        jcfg, jw, _ = jax_loader.load_model(first)
    with jax.disable_jit():
        jref = JaxContext(jcfg, jw, n_lanes=1, max_seq=64).generate(PROMPT, 6)
    assert got == jref


def test_cli_split_then_merge(model, tmp_path):
    run = lambda *a: subprocess.run([sys.executable, "-m", "rrs_tpu_torch", "gguf-split", *a],   # noqa: E731
                                    cwd=ROOT, capture_output=True, text=True, timeout=300)
    r = run("--split", "2", str(model), str(tmp_path / "cli"))
    assert r.returncode == 0, r.stderr
    first = tmp_path / "cli-00001-of-00002.gguf"
    assert str(first) in r.stdout and (tmp_path / "cli-00002-of-00002.gguf").exists()
    r = run("--merge", str(first), str(tmp_path / "back.gguf"))
    assert r.returncode == 0, r.stderr
    jax_split.merge_gguf(jax_split.split_gguf(model, tmp_path / "j", 2)[0], tmp_path / "jb.gguf")
    assert (tmp_path / "back.gguf").read_bytes() == (tmp_path / "jb.gguf").read_bytes()
