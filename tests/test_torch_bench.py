"""The port's measuring verbs on the CPU: the llama-bench analog (``bench``:
the parameter cross product and its five writers, as tests/test_bench_sweep.py
holds the JAX verb), ``batched-bench``, and the device decode loop they time,
``decode_scan``, held to the port's step-by-step ``ctx.decode`` and to the
JAX ``decode_scan`` on the same dense weights (the JAX side op by op under
``jax.disable_jit`` and loaded through its NumPy decode, as
tests/test_torch_context.py loads it)."""

import json
import sqlite3
import subprocess
import sys
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rrs_tpu import native as jax_native
from rrs_tpu.models import llama as jllama
from rrs_tpu.models import loader as jax_loader
from rrs_tpu.models.export import export_random_gguf
from rrs_tpu_torch.__main__ import main
from rrs_tpu_torch.models import llama as tllama
from rrs_tpu_torch.models.loader import load_model
from rrs_tpu_torch.runtime.context import InferenceContext
from rrs_tpu_torch.tools import bench_sweep

from test_torch_common import jax_cfg, tcq4_gguf, torch_cfg

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny_gguf(tmp_path_factory):
    """The dense f32 2-layer model of tests/test_bench_sweep.py."""
    path = tmp_path_factory.mktemp("torch_bench") / "tiny.gguf"
    export_random_gguf(jax_cfg(), path, seed=0, vocab_tokens=[chr(33 + i) for i in range(256)])
    return str(path)


def _bench(capsys, tiny_gguf, *extra):
    main(["bench", "-m", tiny_gguf, "--pp", "4", "--tg", "2", "--pg", "4,2", "-r", "1",
          "--device", "cpu", *extra])
    return capsys.readouterr().out


def test_bench_jsonl_cross_product(capsys, tiny_gguf):
    out = _bench(capsys, tiny_gguf, "--batch", "1", "2", "--ctk", "bf16", "q8_0", "-o", "jsonl")
    rows = [json.loads(line) for line in out.strip().splitlines()]
    assert len(rows) == 12, len(rows)                 # 2 batch x 2 ctk x 3 tests
    assert {r["n_batch"] for r in rows} == {1, 2}
    assert {r["type_k"] for r in rows} == {"bf16", "q8_0"}
    assert {(r["n_prompt"], r["n_gen"]) for r in rows} == {(4, 0), (0, 2), (4, 2)}
    for r in rows:
        assert list(r) == bench_sweep.FIELDS
        assert r["avg_ts"] > 0 and r["avg_ns"] > 0
        assert r["model_n_params"] > 0 and r["model_size"] > 0
        assert r["backends"] == "CPU" and r["gpu_info"] == "cpu"


def test_bench_sql_loads_into_sqlite(capsys, tiny_gguf):
    out = _bench(capsys, tiny_gguf, "-o", "sql")
    db = sqlite3.connect(":memory:")
    db.executescript(out)
    rows = db.execute("SELECT n_prompt, n_gen, avg_ts FROM llama_bench").fetchall()
    assert len(rows) == 3
    assert all(r[2] > 0 for r in rows)


def test_bench_md_varying_columns_and_csv_json(capsys, tiny_gguf):
    out = _bench(capsys, tiny_gguf, "--ctk", "bf16", "q4_0", "-o", "md")
    lines = [line for line in out.strip().splitlines() if line.startswith("|")]
    assert "type_k" in lines[0]                       # a varying parameter gets a column
    assert "n_batch" not in lines[0]                  # constant ones do not
    assert len(lines) == 2 + 6                        # header + sep + 2 ctk x 3 tests
    assert all("±" in line for line in lines[2:])
    csv = _bench(capsys, tiny_gguf, "-o", "csv").strip().splitlines()
    assert csv[0] == ",".join(bench_sweep.FIELDS) and len(csv) == 4
    rows = json.loads(_bench(capsys, tiny_gguf, "-o", "json"))
    assert [list(r) for r in rows] == [bench_sweep.FIELDS] * 3


def test_bench_depth_and_cli(tiny_gguf):
    r = subprocess.run([sys.executable, "-m", "rrs_tpu_torch", "bench", "-m", tiny_gguf,
                        "--pp", "4", "--tg", "2", "-r", "2", "--depth", "16", "--json",
                        "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    rows = [json.loads(line) for line in r.stdout.strip().splitlines()]
    assert len(rows) == 2 and all(row["n_depth"] == 16 for row in rows)
    assert all(row["stddev_ts"] >= 0 for row in rows)


def test_bench_refuses_mixed_kv_and_parallel_flags(tiny_gguf, capsys):
    with pytest.raises(NotImplementedError, match="one layout"):
        main(["bench", "-m", tiny_gguf, "--pp", "4", "--tg", "0", "-r", "1", "--ctk", "q8_0",
              "--ctv", "q4_0", "--device", "cpu"])
    # the parallel flags run: a (dp, tp) mesh of CPU shards, named in the
    # tensor_split column, and --dist-procs without a coordinator (one process)
    for flags, split in ((["--tp", "2"], "tp2/dp1"), (["--dp", "2", "--batch", "2"], "tp1/dp2"),
                         (["--dist-procs", "2"], "1")):
        main(["bench", "-m", tiny_gguf, "--pp", "4", "--tg", "2", "-r", "1", "--json",
              "--device", "cpu", *flags])
        rows = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
        assert [r["tensor_split"] for r in rows] == [split] * 2
    # and they still default to the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["bench", "-m", tiny_gguf, "--tp", "2"])


def test_tree_stats_counts_linears_by_their_codes():
    cfg = torch_cfg(jax_cfg())
    w = tllama.random_weights(cfg, quantize=True, device="cpu")
    size, params = bench_sweep.tree_stats(w)
    e, f, v = cfg.n_embd, cfg.n_ff, cfg.vocab_size
    per_layer = e * (cfg.n_q_dim + 2 * cfg.n_kv_dim) + cfg.n_q_dim * e + 3 * e * f \
        + 2 * e + 2 * cfg.head_dim
    assert params == cfg.n_layers * per_layer + 2 * v * e + e    # tied head counted twice
    assert size > 0


@pytest.fixture(scope="module")
def dense_models(tiny_gguf):
    with mock.patch.object(jax_native, "available", lambda: False):
        jcfg, jw, _ = jax_loader.load_model(tiny_gguf)
    cfg, w, _ = load_model(tiny_gguf, device="cpu")
    return jcfg, jw, cfg, w


def test_decode_scan_matches_jax(dense_models):
    jcfg, jw, cfg, w = dense_models
    first, start, n = [5, 77], [0, 3], 8
    with jax.disable_jit():
        ks, vs = jllama.scratch_caches(jcfg, 2, 32)
        jtoks, jlast, _, _ = jllama.decode_scan(jcfg, jw, jnp.asarray(first, jnp.int32),
                                                jnp.asarray(start, jnp.int32), ks, vs, n)
    kc, vc = tllama.scratch_caches(cfg, 2, 32, device="cpu")
    toks, last, kc2, _ = tllama.decode_scan(cfg, w, torch.tensor(first), start, kc, vc, n)
    assert toks.shape == (2, n) and kc2 is kc
    assert toks[:, 0].tolist() == first
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    np.testing.assert_array_equal(last.numpy(), np.asarray(jlast))


def test_decode_scan_matches_step_by_step_decode(tmp_path):
    """Two lanes at different lengths: the scan's tokens are the greedy
    tokens that ctx.decode gives one step at a time, over the TCQ4 route."""
    cfg, w, _ = load_model(tcq4_gguf(tmp_path), device="cpu")
    prompts = [[3, 17, 42, 99, 5], [8, 250, 1, 77, 64, 12, 200, 31, 9]]
    first, n = [11, 150], 6

    def ctx_with_prompts():
        ctx = InferenceContext(cfg, w, n_lanes=2, max_seq=64, device="cpu")
        seqs = [ctx.new_sequence() for _ in prompts]
        for seq, p in zip(seqs, prompts):
            ctx.prefill(seq, p)
        return ctx, seqs

    ctx, seqs = ctx_with_prompts()
    toks, last, _, _ = tllama.decode_scan(cfg, w, first, list(ctx.kv.lengths), ctx.kv.k,
                                          ctx.kv.v, n)
    ctx, seqs = ctx_with_prompts()
    fed = [list(first)]
    cur = dict(zip(seqs, first))
    for _ in range(n):
        out = ctx.decode(cur)
        cur = {s: int(out[s].argmax()) for s in seqs}
        fed.append([cur[s] for s in seqs])
    assert toks.tolist() == np.asarray(fed[:n]).T.tolist()
    assert last.tolist() == fed[n]


def test_batched_bench_rows(capsys, tiny_gguf):
    from rrs_tpu_torch.tools.batched_bench import run_batched_bench

    cfg, w, _ = load_model(tiny_gguf, device="cpu")
    rows = run_batched_bench(cfg, w, [8], [4], [1, 2])
    assert [(r["PP"], r["TG"], r["B"]) for r in rows] == [(8, 4, 1), (8, 4, 2)]
    for r in rows:
        assert r["S_PP t/s"] > 0 and r["S_TG t/s"] > 0 and r["T s"] > 0
    capsys.readouterr()
    main(["batched-bench", "-m", tiny_gguf, "--pp", "8", "--tg", "2", "--pl", "2", "--json",
          "--device", "cpu"])
    out = [json.loads(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert len(out) == 1 and set(out[0]) == {"PP", "TG", "B", "S_PP t/s", "S_TG t/s", "T s"}
