"""Timing of one call on the device the tools run on.

On the card a call is timed with CUDA events recorded after a
``torch.cuda.synchronize()``; the device timeline between the two events
includes the gaps while the host enqueues, so it is what a user waits for.
On the CPU the host clock times it. Every result names its device.
"""

from __future__ import annotations

import time

import torch


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def timed(dev: torch.device, fn) -> float:
    """Seconds that ``fn()`` takes on ``dev``, its work finished."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3
