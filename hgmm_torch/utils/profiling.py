"""Tracing and metrics: a torch.profiler trace (Chrome trace JSON), the
program's spans and counters, and an append-only JSONL metrics sink.

Counterpart of ``hgmm/utils/profiling.py``, with ``torch.profiler`` in place
of ``jax.profiler``.

Spans and counters. The program marks its phases with ``span(name)`` (the
names are ``hgmm_torch.fit``, ``.fit.init``, ``.fit.sweeps``, ``.fit.group``,
``hgmm_torch.reg``, ``.reg.cut``, ``.reg.prep``, ``.reg.scan``,
``hgmm_torch.odo.frames``, ``.odo.pair``, ``.odo.upload``, the back end's
``hgmm_torch.odo.closures``, ``.odo.closure``, ``hgmm_torch.pg.refine``,
``hgmm_torch.map``, ``.map.fuse`` and ``.map.fit``) and counts with
``count(name, n)``. Off, a span is one shared object that does nothing.
Under a running ``torch.profiler`` a span is also a ``record_function``, so
it shows in the Chrome trace as a ``user_annotation`` on the device events'
clock. Inside ``with tracing() as tr:`` the spans and counters are kept in
memory, and ``tr.summary()`` after the block gives each request (a span
opened while none was open, with everything inside it) its milliseconds by
span name and its counters.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import threading
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


_clock = time.perf_counter_ns
_profiler_enabled = torch.autograd._profiler_enabled
# The process's tracer while tracing() is on, else None: read it as
# profiling.tracer (a name imported from here would keep its old value).
tracer: "Tracer | None" = None


class _NoSpan:
    """What span() returns while nothing records: enters and exits, and
    does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "tracer", "record", "index")

    def __init__(self, name: str, tracer: "Tracer | None", profiled: bool):
        self.name, self.tracer = name, tracer
        self.record = torch.profiler.record_function(name) if profiled else None

    def __enter__(self):
        if self.record is not None:
            self.record.__enter__()
        if self.tracer is not None:
            self.index = self.tracer._open(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        if self.tracer is not None:
            self.tracer._close(self.index)
        if self.record is not None:
            self.record.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks a phase of the program. With nothing
    recording it is NO_SPAN; under a running torch.profiler it also opens
    record_function(name); inside tracing() the tracer keeps it."""
    on = tracer
    profiled = _profiler_enabled()
    if on is None and not profiled:
        return NO_SPAN
    return _Span(name, on, profiled)


def count(name: str, n=1) -> None:
    """Add n to counter `name` of the request open on this thread, inside
    tracing(); otherwise, or with no span open on this thread, nothing."""
    if tracer is not None:
        tracer._count(name, n)


def count_later(name: str, values: torch.Tensor, index: int) -> None:
    """Inside tracing(): add values[index], as it stands when the tracer's
    summary() is taken, to counter `name` of the request open on this
    thread. A counter that the card keeps is read once, after the work."""
    if tracer is not None:
        tracer._count_later(name, values, index)


class Tracer:
    """The spans and counters kept inside tracing(). spans: [name, start_ns,
    end_ns, parent index (-1 at the top), request id] in the order opened, on
    time.perf_counter_ns. The span stack is per thread: a span opened on a
    thread with none open starts a new request, and a counter on a thread with
    none open counts nothing."""

    def __init__(self):
        self.spans: list[list] = []
        self.counts: dict[int, dict[str, float]] = {}
        self._later: list[tuple] = []  # (request, name, values, index)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._requests = itertools.count()

    def _stack(self) -> list[int]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str) -> int:
        stack = self._stack()
        with self._lock:
            if stack:
                parent = stack[-1]
                request = self.spans[parent][4]
            else:
                parent, request = -1, next(self._requests)
            index = len(self.spans)
            self.spans.append([name, _clock(), None, parent, request])
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self.spans[index][2] = _clock()
        self._stack().pop()

    def _request(self) -> int | None:
        stack = getattr(self._local, "stack", None)
        return self.spans[stack[-1]][4] if stack else None

    def _count(self, name: str, n) -> None:
        request = self._request()
        if request is not None:
            counts = self.counts.setdefault(request, {})
            counts[name] = counts.get(name, 0) + n

    def _count_later(self, name: str, values: torch.Tensor, index: int) -> None:
        request = self._request()
        if request is not None:
            self._later.append((request, name, values, index))

    def summary(self) -> list[dict]:
        """After the tracing() block: for each request in the order opened,
        {"request", "name" (its top span), "ms" and "self_ms" (milliseconds
        by span name: in the span, and in it less its child spans), "spans"
        (how many of each), "counts"}. The counters kept on a device are
        read here, one read each."""
        if tracer is self:
            raise RuntimeError("Tracer.summary(): take it after the tracing() block")
        for request, name, values, index in self._later:
            counts = self.counts.setdefault(request, {})
            v = float(values[index])
            counts[name] = counts.get(name, 0) + (int(v) if v.is_integer() else v)
        self._later = []
        child_ns = [0] * len(self.spans)
        for name, start, end, parent, _ in self.spans:
            if parent >= 0 and end is not None:
                child_ns[parent] += end - start
        out: dict[int, dict] = {}
        for i, (name, start, end, parent, request) in enumerate(self.spans):
            if end is None:
                continue
            r = out.setdefault(request, {"request": request, "name": name, "ms": {}, "self_ms": {},
                                         "spans": {}, "counts": self.counts.get(request, {})})
            r["ms"][name] = r["ms"].get(name, 0.0) + 1e-6 * (end - start)
            r["self_ms"][name] = r["self_ms"].get(name, 0.0) + 1e-6 * (end - start - child_ns[i])
            r["spans"][name] = r["spans"].get(name, 0) + 1
        return [out[k] for k in sorted(out)]


@contextlib.contextmanager
def tracing():
    """Keep the program's spans and counters for the block; yields the
    Tracer, whose summary() is taken after the block. One at a time in a
    process: a second, nested, raises."""
    global tracer
    if tracer is not None:
        raise RuntimeError("profiling.tracing(): a tracer is already on in this process")
    tracer = Tracer()
    try:
        yield tracer
    finally:
        tracer = None


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
