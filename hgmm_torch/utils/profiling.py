"""Tracing and metrics: a torch.profiler trace (Chrome trace JSON) and an
append-only JSONL metrics sink.

Counterpart of ``hgmm/utils/profiling.py``, with ``torch.profiler`` in place
of ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block (host, and the card when CUDA is available) and
    write log_dir/trace.json, viewable in Perfetto or chrome://tracing;
    device_busy() reads the device's share back from it. Yields the
    profiler."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(log_dir / "trace.json"))


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace_json: str | Path) -> tuple[float, dict[str, float]]:
    """From a Chrome trace written by trace(): the device's busy time in µs
    (the union of its kernel, memcpy and memset intervals, so overlapping
    streams count once) and the device µs summed by kernel name.
    (key_averages() lists both the host ops and the kernels they launch, so
    summing its device times counts each kernel twice.)"""
    events = json.loads(Path(trace_json).read_text())["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") in DEVICE_CATS and "dur" in e)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    by_name: dict[str, float] = {}
    for e in events:
        if e.get("cat") == "kernel" and "dur" in e:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    return busy, by_name


def device_launches(trace_json: str | Path) -> dict[str, int]:
    """From a Chrome trace written by trace(): the number of kernels, copies
    and memsets the device ran."""
    events = json.loads(Path(trace_json).read_text())["traceEvents"]
    out = {cat: 0 for cat in DEVICE_CATS}
    for e in events:
        if e.get("cat") in out and "dur" in e:
            out[e["cat"]] += 1
    return out


@contextlib.contextmanager
def count_syncs():
    """Within the block, count the operations that make the host wait for the
    card (a value read back, a blocking copy): torch's sync debug mode warns
    on each, and the warnings are counted, not shown. Yields a dict whose
    "syncs" holds the count at the block's end and "sites" the count by the
    Python line that made the call. Explicit torch.cuda.synchronize() calls
    are not counted."""
    import collections
    import warnings

    out = {"syncs": 0, "sites": {}}
    if not torch.cuda.is_available():
        yield out
        return
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield out
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    out["syncs"] = len(syncs)
    out["sites"] = dict(collections.Counter(f"{Path(w.filename).name}:{w.lineno}" for w in syncs))


class MetricsLog:
    """Append-only JSONL metrics sink: one record per line, with wall-clock
    time. Registration results are serialized from their tensors."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: dict) -> None:
        record = {"time": time.time(), **_to_jsonable(record)}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_registration(self, name: str, result) -> None:
        self.log({"event": "registration", "name": name, "logliks": result.logliks,
                  "deltas": result.deltas, "converged": result.converged})


def _to_jsonable(x):
    if isinstance(x, dict):
        return {k: _to_jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if hasattr(x, "shape"):
        arr = np.asarray(x)
        return arr.item() if arr.ndim == 0 else arr.tolist()
    return x
