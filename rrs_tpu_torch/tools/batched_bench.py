"""Parallel-decode throughput grid (the batched-bench analog) on the port.

Port of ``rrs_tpu/tools/batched_bench.py``: for each (prompt length PP,
generated length TG, lanes B) it times one prefill ``forward`` of the B
prompts (only the last position reaches the lm_head) and one ``decode_scan``
of TG greedy steps over the B lanes, each after a warm-up call with other
tokens, and reports S_PP t/s, S_TG t/s and their total time T s. On the card
the calls are timed with CUDA events after a synchronize, on the CPU with
the host clock (``tools/timing.py``).
"""

from __future__ import annotations

import json

import torch

from rrs_tpu_torch.tools.timing import timed


@torch.inference_mode()
def run_batched_bench(cfg, weights, pp_list, tg_list, pl_list, as_json=False) -> list[dict]:
    """The PP / TG / B grid over bf16 scratch caches on the weights' device;
    prints one row per cell (JSON with ``as_json``) and returns the rows."""
    from rrs_tpu_torch.device import set_matmul_precision
    from rrs_tpu_torch.models.llama import decode_scan, forward, scratch_caches

    set_matmul_precision()
    dev = weights.device
    rows = []
    for n_pl in pl_list:
        for pp in pp_list:
            for tg in tg_list:
                kc, vc = scratch_caches(cfg, n_pl, pp + tg + 8, device=dev)
                tokens = torch.zeros((n_pl, pp), dtype=torch.int64, device=dev)
                pos = torch.arange(pp, dtype=torch.int32, device=dev)[None].repeat(n_pl, 1)
                last = torch.full((n_pl,), pp - 1, dtype=torch.int64, device=dev)

                def prefill(t):
                    return forward(cfg, weights, t, pos, kc, vc, pos, None, last_idx=last,
                                   slots=[0] * n_pl)

                prefill(tokens)
                t_pp = timed(dev, lambda: prefill(tokens + 1))

                first = torch.zeros((n_pl,), dtype=torch.int64, device=dev)
                decode_scan(cfg, weights, first, [pp] * n_pl, kc, vc, tg)
                t_tg = timed(dev, lambda: decode_scan(cfg, weights, first + 1, [pp] * n_pl,
                                                      kc, vc, tg))
                row = {
                    "PP": pp, "TG": tg, "B": n_pl,
                    "S_PP t/s": round(n_pl * pp / t_pp, 2),
                    "S_TG t/s": round(n_pl * tg / t_tg, 2),
                    "T s": round(t_pp + t_tg, 3),
                }
                rows.append(row)
                print(json.dumps(row) if as_json else row, flush=True)
                del kc, vc
    return rows
