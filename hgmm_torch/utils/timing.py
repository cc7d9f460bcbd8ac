"""Benchmark timing: device time by CUDA events on the card, host clock on
the CPU, median over the iterations.

Counterpart of ``hgmm/utils/timing.py``. PyTorch returns from a launch before
the device has finished, so a timed call on the card is bracketed by two
events on the current stream and read after a synchronize.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch


def sync(device) -> None:
    """Wait for every kernel queued on `device`; nothing to wait for on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_fn(fn: Callable, *args, device, warmup: int = 2, iters: int = 10, **kwargs):
    """Median time of fn(*args, **kwargs) in seconds: CUDA events around each
    call when `device` is a card, the host clock otherwise. `device` is
    required: the host clock around a function that launches on the card would
    time the launches only. Returns (out, median_s, all_times)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    sync(device)
    times = []
    for _ in range(iters):
        if on_card:
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args, **kwargs)
                end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return out, (float(np.median(times)) if times else float("nan")), times
