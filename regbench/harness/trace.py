"""What the benchmark reads from a profiler trace and from torch's sync
debug mode: the arithmetic of the port's ``hgmm_torch/utils/profiling.py``
(``device_busy``, ``device_launches``, ``count_syncs``), copied and frozen,
with the launch calls, the device time inside host spans and the breakdown.

A trace is the event list of a Chrome trace that ``torch.profiler`` wrote:
device events (``kernel``, ``gpu_memcpy``, ``gpu_memset``) and the runtime
and driver calls that enqueued them share an ``args.correlation`` id.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from collections import Counter
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CALL_CATS = ("cuda_runtime", "cuda_driver")
# Runtime and driver calls that put work on the device's queue. A CUDA graph
# is one call, however many kernels it holds.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchKernelEx",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")
COPY_PREFIXES = ("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def busy_union(spans) -> float:
    """The length of the union of [start, end) intervals: overlapping
    intervals count once."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    return busy


def device_events(events) -> list[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]


def is_launch_call(e: dict) -> bool:
    name = e.get("name", "")
    return (e.get("cat") in HOST_CALL_CATS
            and (name in LAUNCH_CALLS or name.startswith(COPY_PREFIXES)))


def launch_calls(events) -> int:
    """Host calls that enqueued device work: kernel and graph launches,
    copies and memsets."""
    return sum(1 for e in events if is_launch_call(e))


def busy_within(events, windows) -> float:
    """Device time (the union) of the work that host calls made inside the
    given host windows [(start, end)] enqueued, matched by correlation id."""
    import bisect

    windows = sorted(windows)
    starts = [a for a, _ in windows]
    corr = set()
    for e in events:
        if is_launch_call(e) and "dur" in e:
            i = bisect.bisect_right(starts, e["ts"]) - 1
            if i >= 0 and e["ts"] < windows[i][1]:
                corr.add(e.get("args", {}).get("correlation"))
    return busy_union((e["ts"], e["ts"] + e["dur"]) for e in device_events(events)
                      if e.get("args", {}).get("correlation") in corr)


def annotations(events, name: str) -> list[tuple[float, float]]:
    """Host windows of a record_function span."""
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name and "dur" in e]


def top_device_ops(events, n: int = 10) -> list[list]:
    """[[name, seconds]] of the device operations that took most time."""
    by = Counter()
    for e in device_events(events):
        by[e["name"][:160]] += e["dur"] * 1e-6
    return [[k, v] for k, v in by.most_common(n)]


def idle_gaps(events, n: int = 10) -> list[list]:
    """[[host activity, seconds]]: the device's idle time between its first
    and last operation, each gap put to the innermost host op or call that
    was running at the gap's middle ("python" where none was), summed by name,
    the longest first."""
    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events(events))
    gaps, end = [], None
    for a, b in dev:
        if end is not None and a > end:
            gaps.append((0.5 * (a + end), a - end))
        end = b if end is None else max(end, b)
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("cat") in ("cpu_op", "user_annotation", *HOST_CALL_CATS) and "dur" in e)
    by, active, i = Counter(), [], 0
    for mid, length in gaps:  # in time order: a sweep over the host events
        while i < len(host) and host[i][0] <= mid:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] > mid]
        name = min(active, key=lambda h: h[1] - h[0])[2][:160] if active else "python"
        by[name] += length * 1e-6
    return [[k, v] for k, v in by.most_common(n)]


class Profile:
    """A torch.profiler run over host and device that can start and stop
    anywhere (inside a callback too). stop() writes the trace to a temporary
    file, reads its events and deletes it."""

    def __init__(self, device: str = "cuda"):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if device == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)

    @classmethod
    def warm(cls, device: str) -> None:
        """Start and stop the profiler once around a little device work: its
        first start initialises the device tracing, which takes seconds."""
        import torch

        prof = cls(device)
        prof.start()
        torch.ones(8, device=device).sum().item()
        prof._prof.stop()

    def start(self) -> None:
        self._prof.start()

    def stop(self) -> list[dict]:
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            return json.loads(Path(path).read_text())["traceEvents"]
        finally:
            os.unlink(path)


class SyncCounter:
    """Counts the operations that make the host wait for the device (a value
    read back, a blocking copy) between start() and stop(): torch's sync
    debug mode warns on each, and the warnings are counted, not shown.
    Explicit torch.cuda.synchronize() calls are not counted. Off the card
    it counts nothing."""

    def __init__(self, device: str = "cuda"):
        self.syncs = 0
        self.on_card = device == "cuda"
        self._catch = None
        self._mode = None

    def start(self) -> None:
        import torch

        if not self.on_card:
            return
        self._mode = torch.cuda.get_sync_debug_mode()
        self._catch = warnings.catch_warnings(record=True)
        self._caught = self._catch.__enter__()
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")

    def stop(self) -> int:
        import torch

        if not self.on_card:
            return self.syncs
        torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(None, None, None)
        self.syncs += sum(1 for w in self._caught if "synchroniz" in str(w.message))
        return self.syncs
