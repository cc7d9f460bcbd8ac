"""The program's own spans and counters in one cell of the benchmark, read
from outside the benchmark's run: the entries do not yet run the stretch that
would let a per-layer metric read them (PERF.md, "Open questions").

    python3 regbench/tools/program_spans.py --workload <cell> --seed <n> [--rounds 4] [--out FILE]

From the root of a checkout, on a card (``--device cpu`` rehearses at the
sizes the layout's files give). The cell's entry is built and set up as
``regbench/run.py`` does it; then, in one process:

1. a profiled stretch as the traced run's (``PROFILE_PAIRS`` requests or
   odometry pairs, no sync between phases): the device's idle share, the
   whole idle-gap table (each gap put to the innermost host span or op open
   at its middle, as the benchmark's breakdown does; and put to the
   innermost span alone), and the device's idle time inside the
   ``hgmm_torch.reg.scan`` spans;
2. the host syncs of ``SYNC_PAIRS`` by program site
   (``hgmm_torch.utils.profiling.count_syncs``);
3. a tracer stretch: ``TRACER_PAIRS`` requests as the window runs them, each
   in a span ``regbench.request`` (odometry: one whole chain, each pair its
   ``hgmm_torch.odo.pair``), inside ``profiling.tracing()``: host ms a pair
   by span, launches by wrapper, ``reg.steps`` and ``reg.live_steps``;
4. the rate with the tracer off and on, in alternating rounds of the same
   stretch;
5. the cost of a span and of a launch count, with nothing recording and
   with the tracer on, and of a record_function.

Prints one JSON object (and writes it to --out).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROFILE_PAIRS = 20
SYNC_PAIRS = 3
TRACER_PAIRS = 16  # two turns of the pool of 8
LEAD_PAIRS = 2


def idle_within(events, windows) -> float:
    """The device's idle seconds inside host windows [(start, end)] (µs):
    each window less the union of the device intervals clipped to it."""
    from regbench.harness import trace

    dev = sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.device_events(events))
    idle = 0.0
    for a, b in windows:
        clipped = [(max(s, a), min(e, b)) for s, e in dev if s < b and e > a]
        idle += (b - a) - trace.busy_union(clipped)
    return idle * 1e-6


def idle_by_span(events) -> list[list]:
    """[[span, seconds]]: the device's idle gaps as trace.idle_gaps finds
    them, each put to the innermost span (user_annotation) open at its
    middle, whatever op ran inside it ("none" where no span was open)."""
    from regbench.harness import trace

    spans = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    gaps = []
    end = None
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in trace.device_events(events)):
        if end is not None and a > end:
            gaps.append((0.5 * (a + end), a - end))
        end = b if end is None else max(end, b)
    by = {}
    for mid, length in gaps:
        open_ = [e for e in spans if e["ts"] <= mid < e["ts"] + e["dur"]]
        name = min(open_, key=lambda e: e["dur"])["name"] if open_ else "none"
        by[name] = by.get(name, 0.0) + length * 1e-6
    return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])


def profiled(events, wall: float, pairs: int) -> dict:
    from regbench.harness import trace

    busy = trace.busy_union((e["ts"], e["ts"] + e["dur"]) for e in trace.device_events(events))
    scans = trace.annotations(events, "hgmm_torch.reg.scan")
    return {"pairs": pairs, "wall_s": wall, "busy_s": busy * 1e-6,
            "device_idle_pct": 100.0 * (1.0 - busy * 1e-6 / wall) if busy > 0 else None,
            "launch_calls_per_pair": trace.launch_calls(events) / pairs,
            "reg_scan_spans": len(scans), "reg_scan_idle_s": idle_within(events, scans),
            "idle_gaps": trace.idle_gaps(events, n=1000), "idle_by_span": idle_by_span(events)}


def by_span(requests: list[dict]) -> dict:
    """Per span name over the requests: the median host ms a request, in
    the span and in it less its children, and the spans a request."""
    names = sorted({k for r in requests for k in r["ms"]})

    def med(key, name):
        return statistics.median(r[key].get(name, 0.0) for r in requests)

    return {n: {"ms": med("ms", n), "self_ms": med("self_ms", n), "spans": med("spans", n)}
            for n in names}


def readings(requests: list[dict], prof: dict) -> dict:
    """The five per-layer numbers of the program's spans and counters."""
    def med_ms(*names):
        v = [sum(r["ms"].get(n, 0.0) for n in names) for r in requests
             if any(n in r["ms"] for n in names)]
        return statistics.median(v) if v else None

    steps = sum(r["counts"].get("reg.steps", 0) for r in requests)
    live = sum(r["counts"].get("reg.live_steps", 0) for r in requests)
    return {"fit_init_ms": med_ms("hgmm_torch.fit.init"),
            "reg_prep_ms": med_ms("hgmm_torch.reg.prep", "hgmm_torch.reg.cut"),
            "reg_scan_ms": med_ms("hgmm_torch.reg.scan"),
            "reg_scan_idle_ms": 1e3 * prof["reg_scan_idle_s"] / prof["pairs"],
            "reg_live_step_pct": 100.0 * live / steps if steps else None}


def counters(requests: list[dict]) -> dict:
    names = sorted({k for r in requests for k in r["counts"]})
    return {n: statistics.median(r["counts"].get(n, 0) for r in requests) for n in names}


_BEFORE = {"launches": {}, "lock": threading.Lock()}


def _count_launch_before(name: str) -> None:
    """fused_em.count_launch's body before it counted for the tracer: the
    same lookups of a module's globals, a lock and an add."""
    with _BEFORE["lock"]:
        _BEFORE["launches"][name] += 1


def costs(n: int = 200_000, reps: int = 5) -> dict:
    """ns a call, the least of `reps` runs of n: with nothing recording, a
    program span's entry and exit, a torch.profiler.record_function's (no
    profiler running), fused_em.count_launch, and count_launch as it was
    before it also counted for the tracer (a lock and an add, on a copy of
    LAUNCHES); inside tracing(), a span within an open span and
    count_launch."""
    import torch

    from hgmm_torch.ops import fused_em
    from hgmm_torch.utils import profiling

    def per_call(fn, m):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            for _ in range(m):
                fn("reg_step")
            best = min(best, (time.perf_counter_ns() - t0) / m)
        return best

    def a_span(name):
        with profiling.span(name):
            pass

    def a_record(name):
        with torch.profiler.record_function(name):
            pass

    _BEFORE["launches"] = dict(fused_em.LAUNCHES)
    saved = dict(fused_em.LAUNCHES)
    out = {"span_off_ns": per_call(a_span, n), "record_function_ns": per_call(a_record, n // 20),
           "count_launch_ns": per_call(fused_em.count_launch, n),
           "count_launch_before_ns": per_call(_count_launch_before, n)}
    with profiling.tracing(), profiling.span("request"):
        out["span_on_ns"] = per_call(a_span, n // 20)
        out["count_launch_on_ns"] = per_call(fused_em.count_launch, n // 20)
    fused_em.LAUNCHES.update(saved)
    return out


def pool_cell(entry, rounds: int) -> dict:
    from hgmm_torch.utils import profiling
    from regbench.harness import trace

    pool, i = len(entry.pool), 0

    def nxt(spans=None):
        nonlocal i
        out = entry.request(i % pool, spans=spans)
        i += 1
        return out

    def stretch():
        for _ in range(TRACER_PAIRS):
            with profiling.span("regbench.request"):
                nxt()

    trace.Profile.warm(entry.device)
    for _ in range(LEAD_PAIRS):
        nxt()
    entry._sync()
    prof = trace.Profile(entry.device)
    t0 = time.perf_counter()
    prof.start()
    for _ in range(PROFILE_PAIRS):
        nxt(spans="mark")
    entry._sync()
    wall = time.perf_counter() - t0
    events = prof.stop()
    with profiling.count_syncs() as syncs:
        for _ in range(SYNC_PAIRS):
            nxt()
    with profiling.tracing() as tr:
        stretch()
    rates = {"off": [], "on": []}
    for r in range(rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            t0 = time.perf_counter()
            with profiling.tracing() if mode == "on" else contextlib.nullcontext():
                stretch()
                entry._sync()
            rates[mode].append(TRACER_PAIRS / (time.perf_counter() - t0))
    return {"profile": profiled(events, wall, PROFILE_PAIRS), "syncs": syncs,
            "requests": tr.summary(), "rates": rates}


def chain_cell(entry, module, rounds: int) -> dict:
    from hgmm_torch.utils import profiling
    from regbench.harness import trace

    if len(entry.scans) - 1 < LEAD_PAIRS + PROFILE_PAIRS + SYNC_PAIRS:
        raise ValueError(f"program_spans: a chain of {len(entry.scans) - 1} pairs is shorter than "
                         f"the stretches' {LEAD_PAIRS + PROFILE_PAIRS + SYNC_PAIRS}")
    prof = trace.Profile(entry.device)
    syncs = profiling.count_syncs()
    got = {}

    def on_pair(k: int) -> None:
        if k == LEAD_PAIRS:
            got["t0"] = time.perf_counter()
            prof.start()
        elif k == LEAD_PAIRS + PROFILE_PAIRS:
            got["wall"] = time.perf_counter() - got["t0"]
            got["events"] = prof.stop()
            got["syncs"] = syncs.__enter__()
        elif k == LEAD_PAIRS + PROFILE_PAIRS + SYNC_PAIRS:
            syncs.__exit__(None, None, None)

    trace.Profile.warm(entry.device)
    entry._chain(module._Hook(on_pair=on_pair))
    with profiling.tracing() as tr:
        entry._chain(module._Hook())
    rates = {"off": [], "on": []}
    for r in range(rounds):
        for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
            hook = module._Hook()
            t0 = time.perf_counter()
            with profiling.tracing() if mode == "on" else contextlib.nullcontext():
                entry._chain(hook)
                entry._sync()
            rates[mode].append(len(hook.pairs) / (time.perf_counter() - t0))
    requests = tr.summary()
    return {"profile": profiled(got["events"], got["wall"], PROFILE_PAIRS), "syncs": got["syncs"],
            "requests": [r for r in requests if r["name"] == "hgmm_torch.odo.pair"],
            "frames": [r for r in requests if r["name"] == "hgmm_torch.odo.frames"],
            "rates": rates}


def run(root: Path, workload: str, seed: int, rounds: int, device: str) -> dict:
    import torch

    from regbench.harness import common, layout

    lay = layout.Layout(root)
    cell = lay.cell(workload)
    traffic = lay.traffic(cell["traffic"])
    module = lay.entry(traffic["entry"])
    entry = module.Entry(lay.config(cell["config"]), traffic, seed, device)
    entry.build()
    entry.setup()
    cost = costs()
    out = pool_cell(entry, rounds) if hasattr(entry, "pool") else chain_cell(entry, module, rounds)
    requests = out.pop("requests")
    out.update(workload=workload, seed=seed, requests=len(requests), by_span=by_span(requests),
               counters=counters(requests), readings=readings(requests, out["profile"]), **cost)
    out["rate_off"] = statistics.median(out["rates"]["off"]) if rounds else None
    out["rate_on"] = statistics.median(out["rates"]["on"]) if rounds else None
    on_card = device == "cuda"
    out["device"] = {"kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                     "power_limit": common.power_limit() if on_card else None}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=4, help="alternating rounds of tracer off and on")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--layout", default=str(ROOT),
                    help="where BENCHMARK.json and regbench/ are read from (default: this checkout)")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from regbench.run import THREADS

    os.environ.update(THREADS)
    import torch

    torch.set_num_threads(1)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("program_spans: CUDA is not available", file=sys.stderr)
        return 2
    out = run(Path(args.layout), args.workload, args.seed, args.rounds, args.device)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
