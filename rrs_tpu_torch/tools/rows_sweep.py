"""The K-slice counts of B9 (``tcq4_matmul_experts_rows``) and B12
(``mxfp4_matmul_experts_rows``) on the card, beside the one
``ops/splitk.py rows_plan`` picks.

    python3 -m rrs_tpu_torch.tools.rows_sweep [--json OUT]

At each shape of ``tools/gemm_ab.py``'s ``b12,b9`` subject (B9 at
Qwen3-30B-A3B's gate / up and down at n_sel = 8, 32 and 128; B12 at
gpt-oss-20b's expert projection at n_sel = 4, 16 and 64) the wrapper runs
under every even split of K into 1 .. s slices whose blocks fill at most two
waves of the kernel's resident blocks (2 x ``splitk.ROWS_SLOTS``), each held
to its plain version and timed with CUDA events over id sets that take every
expert in turn, beside ``torch.bmm`` on the selected experts gathered to
bf16 beforehand. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import torch

from rrs_tpu_torch import kernels
from rrs_tpu_torch.ops import mxfp4_matmul as mx
from rrs_tpu_torch.ops import splitk
from rrs_tpu_torch.ops import tcq4_matmul as tm
from rrs_tpu_torch.tools.gemm_ab import n_copies, rel, rotating_ids, time_ms


@contextlib.contextmanager
def slices_forced(module, unit: int, slices: int):
    """``module``'s wrapper launched with K in ``slices`` even slices of
    ``unit`` while open (its ``rows_plan`` replaced)."""
    saved = module.rows_plan

    def forced(n_sel: int, k: int, n: int) -> splitk.Plan:
        strips, units = -(-n // splitk.STRIP), k // unit
        per = -(-units // slices)
        s = -(-units // per)
        return splitk.Plan(strips, s, per, s * n_sel * strips * splitk.STRIP if s > 1 else 0)

    module.rows_plan = forced
    try:
        yield
    finally:
        module.rows_plan = saved


def sweep(label, module, kernel, plain, unit, stacks, exp_bytes, w16_all, top_k, n_sels, gen,
          rows):
    dev = w16_all.device
    e_n, k2, n = stacks[0].shape
    k, units = 2 * k2, 2 * k2 // unit
    for n_sel in n_sels:
        a = torch.randn((n_sel, k), generator=gen, device=dev).to(torch.bfloat16)
        id_sets = rotating_ids(e_n, n_sel // top_k, top_k, n_copies(n_sel * exp_bytes), gen)
        ref = plain(a, *stacks, id_sets[0])
        gathered = [w16_all[i.long()] for i in id_sets[:n_copies(n_sel * k * n * 2)]]
        lib_ms = time_ms(lambda w: torch.bmm(a[:, None, :], w), [(w,) for w in gathered], 40)
        del gathered
        tiles = -(-n // splitk.STRIP) * n_sel
        counts = sorted({-(-units // -(-units // s))
                         for s in range(1, min(units, max(1, 2 * splitk.ROWS_SLOTS // tiles)) + 1)})
        picked = module.rows_plan(n_sel, k, n).slices
        times = {}
        for s in counts:
            with slices_forced(module, unit, s):
                r = rel(kernel(a, *stacks, id_sets[0]), ref)
                if not r <= 1e-3:
                    raise AssertionError(f"{label} n_sel={n_sel} {s} slices: rel {r:.2e}")
                times[s] = time_ms(lambda i: kernel(a, *stacks, i), [(i,) for i in id_sets], 40)
        rows.append({"shape": f"{label} n_sel={n_sel} K={k} N={n} E={e_n}", "blocks_a_slice": tiles,
                     "ms_by_slices": times, "rows_plan_slices": picked, "library_ms": lib_ms})
        print(f"  {label} n_sel={n_sel}: bmm {lib_ms:.4f}; slices (blocks) -> ms: " +
              ", ".join(f"{s} ({s * tiles}) {t:.4f}{' *' if s == picked else ''}"
                        for s, t in times.items()) + "  (* rows_plan)", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", type=Path, help="write the rows here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("rows_sweep: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; {smi}", flush=True)
    kernels.lib()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rows: list[dict] = []
    print("B9 tcq4_matmul_experts_rows, Qwen3-30B-A3B (E = 128, top-8)", flush=True)
    for proj, (k, n) in (("gate/up", (2048, 768)), ("down", (768, 2048))):
        e_n = 128
        stacks = (torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                                dtype=torch.uint8),
                  (torch.rand((e_n, k // 32, n), generator=gen, device=dev) * 0.01 + 0.001
                   ).to(torch.bfloat16))
        w16_all = torch.stack([tm.dequantize_w(stacks[0][e], stacks[1][e]).to(torch.bfloat16)
                               for e in range(e_n)])
        sweep(f"tcq4 rows {proj}", tm, tm.tcq4_matmul_experts_rows,
              tm.tcq4_matmul_experts_rows_plain, tm.TILE_K, stacks,
              k // 2 * n + k // 32 * n * 2, w16_all, 8, (8, 32, 128), gen, rows)
        del stacks, w16_all
        torch.cuda.empty_cache()
    print("B12 mxfp4_matmul_experts_rows, gpt-oss-20b (E = 32, top-4)", flush=True)
    e_n, k, n = 32, 2880, 2944
    stacks = (torch.randint(0, 256, (e_n, k // 2, n), generator=gen, device=dev,
                            dtype=torch.uint8),
              torch.randint(118, 123, (e_n, k // 32, n), generator=gen, device=dev,
                            dtype=torch.uint8))
    sweep("mxfp4 rows", mx, mx.mxfp4_matmul_experts_rows, mx.mxfp4_matmul_experts_rows_plain,
          mx.GROUP, stacks, k // 2 * n + k // 32 * n, mx.dequant_mxfp4(*stacks).to(torch.bfloat16),
          4, (4, 16, 64), gen, rows)
    if args.json:
        args.json.parent.mkdir(parents=True, exist_ok=True)
        args.json.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
