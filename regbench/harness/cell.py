"""One run of one cell: set-up, the measured window or the traced run, the
check of what the window produced, and the result.

An entry (``regbench/entries/<entry>.py``) defines ``Entry(config, traffic,
seed, device)`` with

- ``build()``: build what the program compiles once a checkout (its
  kernels, its native reader) and return the seconds that took: a
  checkout's first run compiles, every later run finds it built. Those
  seconds are reported apart as ``build_s`` on the information line and left
  out of ``setup_s``;
- ``setup()``: make the inputs from the seed and warm up every shape the
  cell's traffic uses;
- ``window(seconds)``: drive the program in a closed loop for `seconds`
  and return (latencies in s of every pair completed, pairs failed, the
  window's wall time in s);
- ``traced()``: drive it through a short traced stretch and return the
  record the per-layer readers read (see ``regbench/metrics/``);
- ``check()``: after the window, compare what it produced with the plain
  reference and return {number: value}; the cell's limits file holds each
  number's limit.
"""

from __future__ import annotations

import math
import resource
import sys
import time

from regbench.harness import common


class NoCard(RuntimeError):
    pass


def run(layout, workload: str, seed: int, seconds: float, trace: bool, device: str,
        t_process: float) -> dict:
    """Returns the result line's fields. t_process: the host clock (perf_counter)
    at the start of the process, from which set-up is counted."""
    import torch

    cell = layout.cell(workload)
    config = layout.config(cell["config"])
    traffic = layout.traffic(cell["traffic"])
    limits = layout.limits(workload)
    on_card = device == "cuda"
    if on_card and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        raise NoCard(f"the cell needs {cell['chips']} CUDA device(s); "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    entry = layout.entry(traffic["entry"]).Entry(config, traffic, seed, device)
    build_s = entry.build()
    entry.setup()
    guard("before the window")
    setup_s = time.perf_counter() - t_process - build_s

    metrics, info, breakdown, dev_extra = {}, {}, None, {}
    if not trace:
        use0, cpu0 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
        lat, failed, wall = entry.window(seconds)
        use1, cpu1 = resource.getrusage(resource.RUSAGE_SELF), time.process_time()
        attempted = len(lat) + failed
        lat_all = list(lat) + [math.inf] * failed
        values = {"pairs_per_s": common.rate(len(lat), wall), "pair_p95_ms": 1e3 * common.p95(lat_all),
                  "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in layout.end_to_end(workload)}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}
        # The host's share of the window: the process's CPU seconds, and the
        # times it gave up its core (voluntary: waiting on the device) or
        # was taken off it (involuntary: another process ran).
        info = {"pairs": len(lat), "failed": failed, "window_s": wall,
                "pair_p50_ms": 1e3 * float(sorted(lat)[len(lat) // 2]) if lat else None,
                "window_cpu_s": cpu1 - cpu0, "switches": use1.ru_nvcsw - use0.ru_nvcsw,
                "preempted": use1.ru_nivcsw - use0.ru_nivcsw}
    else:
        record = entry.traced()
        attempted, failed = record["attempted"], record["failed"]
        for m in layout.per_layer(workload):
            value = layout.reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        prof = record.get("profile")
        if prof:
            dev_extra = {"busy_s": prof["busy_s"], "window_s": prof["wall_s"]}
            breakdown = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
        info = {"setup_s": setup_s, **{k: v for k, v in record.items() if k != "profile"}}
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
    entry.free()
    t_check = time.perf_counter()
    values = entry.check()
    info["check_s"] = time.perf_counter() - t_check
    info["build_s"] = build_s
    guard("after the check")
    checks = {name: {"value": values.get(name, math.inf), "limit": lim["limit"]}
              for name, lim in limits.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"] if on_card else 0,
                   "memory_peak_bytes": peak if on_card else 0,
                   "power_limit": common.power_limit() if on_card else None, **dev_extra}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return {"result": out, "info": info}


def guard(when: str) -> None:
    """Exit 3, naming what it found, when the process holds jax, jaxlib,
    flax or the JAX package hgmm."""
    found = common.forbidden_modules()
    if found:
        print(f"regbench: {when}, the process holds {found}", file=sys.stderr)
        raise SystemExit(3)
