"""pp / tg / pg throughput sweeps (the llama-bench analog) on the port.

Port of ``rrs_tpu/tools/bench_sweep.py``: the cross product of models x
tests (pp, tg, ``--pg``) x depth x batch x KV cache types, ``reps``
repetitions reported as avg +- stddev, and the five writers (markdown, csv,
json, jsonl, sql) over the same ``FIELDS``. A test is one ``forward`` over
the prompt (at positions depth ... depth + pp - 1, over zeroed caches, as the
JAX bench takes its depth) and / or one ``decode_scan`` of tg greedy steps.
A warm-up call runs first; each rep then takes fresh caches and tokens that
differ from the rep before. On the card each rep is timed with CUDA events
after a synchronize (``tools/timing.py``), on the CPU with the host clock.
``--ctk`` / ``--ctv`` ``bf16`` and ``f16`` both mean a bf16 cache (as the JAX
``_kv_maker`` has it), ``q8_0`` and ``q4_0`` the port's q8 and q4 layouts
(``runtime/kv_cache.py``). ``--tp`` / ``--dp`` run each test over a mesh of
shards (``parallel/sharding.py``; the forward and ``ShardedModel.
decode_scan`` on every shard, a fused model split back per projection); the
``tensor_split`` column then reads ``tp<N>/dp<M>``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

from rrs_tpu_torch.tools.timing import device_name, timed

# the reference's field list (llama-bench.cpp:1416), as the JAX package keeps it
FIELDS = [
    "build_commit", "build_number", "cpu_info", "gpu_info", "backends",
    "model_filename", "model_type", "model_size", "model_n_params",
    "n_batch", "type_k", "type_v", "flash_attn", "tensor_split",
    "n_prompt", "n_gen", "n_depth", "test_time",
    "avg_ns", "stddev_ns", "avg_ts", "stddev_ts",
]
INT_FIELDS = {"build_number", "model_size", "model_n_params", "n_batch",
              "n_prompt", "n_gen", "n_depth", "avg_ns", "stddev_ns",
              "flash_attn"}
FLOAT_FIELDS = {"avg_ts", "stddev_ts"}

# --ctk / --ctv -> the port's KVCache quantization
KV_QUANT = {"bf16": "none", "f16": "none", "q8_0": "q8", "q4_0": "q4"}


def _build_commit():
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=Path(__file__).resolve().parents[2], timeout=5,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def tree_stats(weights) -> tuple[int, int]:
    """(bytes on the device, logical parameter count) of a weights tree: a
    TCQ4 or MXFP4 linear counts two parameters a qs byte, a Q8 linear one a
    code, and every other tensor (embeddings, norms, dense linears, expert
    stacks) its elements; every tensor (packs and scales too) counts its
    bytes."""
    import dataclasses

    from rrs_tpu_torch.models.linear import MXFP4Linear, Q8Linear, TCQ4Linear

    size = params = 0

    def walk(node, counted: bool):
        nonlocal size, params
        if isinstance(node, torch.Tensor):
            size += node.numel() * node.element_size()
            if not counted:
                params += node.numel()
        elif isinstance(node, (TCQ4Linear, MXFP4Linear)):
            params += node.qs.numel() * 2
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), True)
        elif isinstance(node, Q8Linear):
            params += node.q.numel()
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), True)
        elif dataclasses.is_dataclass(node):
            for f in dataclasses.fields(node):
                walk(getattr(node, f.name), counted)
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x, counted)

    walk(weights, False)
    return size, params


def _fmt_test(row):
    if row["n_prompt"] and not row["n_gen"]:
        t = f"pp{row['n_prompt']}"
    elif row["n_gen"] and not row["n_prompt"]:
        t = f"tg{row['n_gen']}"
    else:
        t = f"pp{row['n_prompt']}+tg{row['n_gen']}"
    if row["n_depth"]:
        t += f" @ d{row['n_depth']}"
    return t


def _write(rows, fmt):
    """Print the rows in one of the five formats of the JAX bench."""
    def human_size(b):
        return (f"{b / 1024**3:.2f} GiB" if b >= 1024**3
                else f"{b / 1024**2:.2f} MiB")

    def human_params(p):
        return f"{p / 1e9:.2f} B" if p >= 1e9 else f"{p / 1e6:.2f} M"

    if fmt == "md":
        # parameters that vary across rows get their own column
        # (llama-bench.cpp markdown_printer)
        varying = [f for f in ("n_batch", "type_k", "type_v", "tensor_split")
                   if len({r[f] for r in rows}) > 1]
        hdr = ["model", "size", "params", "backend", *varying, "test", "t/s"]
        print("| " + " | ".join(hdr) + " |")
        print("|" + "|".join("---" for _ in hdr) + "|")
        for r in rows:
            extra = "".join(f" {r[f]} |" for f in varying)
            print(f"| {r['model_type']} | {human_size(r['model_size'])} "
                  f"| {human_params(r['model_n_params'])} | {r['backends']} "
                  f"|{extra} {_fmt_test(r)} "
                  f"| {r['avg_ts']:.2f} ± {r['stddev_ts']:.2f} |")
    elif fmt == "csv":
        print(",".join(FIELDS))
        for r in rows:
            print(",".join(f'"{r[f]}"' if f not in INT_FIELDS
                           and f not in FLOAT_FIELDS else str(r[f])
                           for f in FIELDS))
    elif fmt == "json":
        print(json.dumps([{f: r[f] for f in FIELDS} for r in rows], indent=2))
    elif fmt == "jsonl":
        for r in rows:
            print(json.dumps({f: r[f] for f in FIELDS}))
    elif fmt == "sql":
        cols = []
        for f in FIELDS:
            t = ("INTEGER" if f in INT_FIELDS
                 else "REAL" if f in FLOAT_FIELDS else "TEXT")
            cols.append(f"    {f} {t}")
        print("CREATE TABLE IF NOT EXISTS llama_bench (\n" + ",\n".join(cols) + "\n);")
        for r in rows:
            vals = []
            for f in FIELDS:
                v = r[f]
                vals.append(str(v) if f in INT_FIELDS or f in FLOAT_FIELDS
                            else "'" + str(v).replace("'", "''") + "'")
            print(f"INSERT INTO llama_bench ({', '.join(FIELDS)}) "
                  f"VALUES ({', '.join(vals)});")
    else:
        raise SystemExit(f"unknown output format {fmt!r}")


def run(args) -> list[dict]:
    """The ``bench`` verb: every row of the cross product, written to stdout
    in ``args.output_format`` (jsonl with ``--json``); returns the rows."""
    from rrs_tpu_torch.device import resolve_device, set_matmul_precision
    from rrs_tpu_torch.models import llama as llama_model
    from rrs_tpu_torch.models.config import PRESETS
    from rrs_tpu_torch.parallel.distributed import maybe_initialize, mesh_from_args
    from rrs_tpu_torch.parallel.sharding import ShardedModel

    dev = resolve_device(args.device)
    maybe_initialize(args)
    mesh = mesh_from_args(args)
    set_matmul_precision()
    reps = max(1, args.reps)
    fmt = "jsonl" if args.json else args.output_format

    models = [(m, None) for m in (args.model or [])]
    if not models:
        models = [(None, p) for p in (args.preset or ["qwen3-4b"])]
    pg = []
    for spec in args.pg or []:
        pp_s, tg_s = spec.split(",")
        pg.append((int(pp_s), int(tg_s)))
    tests = [(pp, 0) for pp in args.pp] + [(0, tg) for tg in args.tg] + pg

    base = {"build_commit": _build_commit(), "build_number": 0, "cpu_info": "host",
            "gpu_info": device_name(dev), "backends": "CUDA" if dev.type == "cuda" else "CPU",
            "flash_attn": 1,
            "tensor_split": f"tp{mesh.tp}/dp{mesh.dp}" if mesh is not None else "1"}
    rows = []
    for model_path, preset in models:
        if model_path:
            from rrs_tpu_torch.models.loader import load_model

            cfg, weights, _ = load_model(model_path, device=dev, fuse=mesh is None)
            mname, mtype = model_path, cfg.arch
        else:
            cfg = PRESETS[preset]
            weights = llama_model.fabricated_tcq4_weights(cfg, seed=0, device=dev)
            mname, mtype = f"{preset} (fabricated)", f"{preset} TCQ4_K32"
        size, params = tree_stats(weights)
        sharded = None
        if mesh is not None:
            sharded = ShardedModel(cfg, llama_model.unfused(cfg, weights), mesh)
            weights = None
        for b in args.batch:
            for ct in args.ctk:
                ctv = args.ctv or ct
                for pp, tg in tests:
                    for depth in args.depth:
                        r = run_one(cfg, weights, dev, b, ct, ctv, pp, tg, depth, reps,
                                    sharded=sharded)
                        rows.append({**base, "model_filename": mname, "model_type": mtype,
                                     "model_size": size, "model_n_params": params,
                                     "n_batch": b, "type_k": ct, "type_v": ctv,
                                     "n_prompt": pp, "n_gen": tg, "n_depth": depth, **r})
        del weights
    _write(rows, fmt)
    return rows


@torch.inference_mode()
def run_one(cfg, weights, dev, b, ctk, ctv, pp, tg, depth, reps, sharded=None) -> dict:
    """One test (prefill of pp tokens and / or tg greedy decode steps, from
    position depth, over b lanes), warmed up once and timed reps times.
    ``sharded``: a ``ShardedModel`` to run it on instead of ``weights`` (b a
    multiple of its dp)."""
    from rrs_tpu_torch.models.llama import decode_scan, forward
    from rrs_tpu_torch.runtime.kv_cache import KVCache, ShardedKVCache

    quant = KV_QUANT[ctk]
    if KV_QUANT[ctv] != quant:
        raise NotImplementedError(f"--ctk {ctk} with --ctv {ctv}: the port's attention "
                                  "kernels read K and V in one layout")
    s = depth + pp + tg + 8
    n_work = (pp + tg) * b

    def fresh():
        if sharded is not None:
            return ShardedKVCache.create_sharded(cfg, b, s, sharded.mesh, quant=quant,
                                                 max_chunk=max(pp, 1))
        return KVCache.create(cfg, b, s, device=dev, quant=quant, max_chunk=max(pp, 1))

    positions = torch.arange(depth, depth + pp, dtype=torch.int32, device=dev)[None].repeat(b, 1)

    def fn(toks, kv):
        pos_off = depth
        if pp:
            if sharded is not None:
                sharded.forward(kv.parts, toks, positions, positions, slots=[pos_off] * b)
            else:
                forward(cfg, weights, toks, positions, kv.k, kv.v, positions, None,
                        slots=[pos_off] * b)
            pos_off += pp
        if tg:
            first = toks[:, 0] if pp == 0 else torch.zeros((b,), dtype=torch.int64, device=dev)
            if sharded is not None:
                sharded.decode_scan(kv.parts, first, [pos_off] * b, tg)
            else:
                decode_scan(cfg, weights, first, [pos_off] * b, kv.k, kv.v, tg)

    toks = torch.zeros((b, max(pp, 1)), dtype=torch.int64, device=dev)
    fn(toks, fresh())
    times = []
    for rep in range(reps):
        kv = fresh()
        toks_r = toks + rep + 1
        times.append(timed(dev, lambda: fn(toks_r, kv)))
        del kv
    avg = statistics.mean(times)
    std = statistics.stdev(times) if len(times) > 1 else 0.0
    ts = [n_work / t for t in times]
    return {
        "test_time": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "avg_ns": int(avg * 1e9), "stddev_ns": int(std * 1e9),
        "avg_ts": round(statistics.mean(ts), 2),
        "stddev_ts": round(statistics.stdev(ts) if len(ts) > 1 else 0.0, 2),
    }
