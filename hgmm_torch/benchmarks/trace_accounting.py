"""Attribute the headline sweep time from a profiler trace.

    python -m hgmm_torch.bench --trace DIR
    python -m hgmm_torch.benchmarks.trace_accounting DIR [--k 512] [--n 2097152]

Counterpart of ``benchmarks/trace_accounting.py``. Reads DIR/trace.json, the
Chrome trace that ``hgmm_torch.utils.profiling.trace`` wrote, and splits the
device time of the traced sweeps into

  kernel      the E+M kernel (``hgmm::em_stats_tiled_kernel`` at K >= 33,
              ``hgmm::em_stats_kernel`` below), per sweep
  reduction   the cross-block sum of the partials (``reduce_partials_kernel``)
  torch       every other device event: the small kernels and copies of the
              wrapper's torch ops (packing W, allocations that memset)
  gap         time inside the window when the device ran nothing

and sets them beside the roofline's per-unit times for one sweep
(``hgmm_torch.eval.roofline``): the HBM stream, the fp32 FMA work and the
SFU's exp2 at their peaks. The sweep count is the number of kernel events in
the trace, so a trace of any chain length attributes correctly.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from hgmm_torch.eval.roofline import (
    FLOP_LOGIT,
    FLOP_STATS,
    H100_FP32_FLOPS,
    H100_HBM_BYTES,
    H100_SFU_OPS,
    estep_attainable,
)
from hgmm_torch.utils.profiling import DEVICE_CATS

KERNELS = ("em_stats_tiled_kernel", "em_stats_kernel")  # csrc/em_stats.cu: K >= 33, K <= 32
REDUCTION = "reduce_partials_kernel"


def account(trace_json: str | Path, k: int = 512, n: int = 1 << 21) -> dict:
    """The per-sweep decomposition (ms) of a trace of the benchmark's sweeps."""
    events = json.loads(Path(trace_json).read_text())["traceEvents"]
    dev = sorted(((e["ts"], e["ts"] + e["dur"], e.get("name", ""), e.get("cat"))
                  for e in events if e.get("cat") in DEVICE_CATS and "dur" in e))
    kern = [e for e in dev if e[3] == "kernel" and any(name in e[2] for name in KERNELS)]
    if not kern:
        raise SystemExit(f"{trace_json}: no {' or '.join(KERNELS)} device event (a CPU trace holds none)")
    # The window of the sweeps: first kernel event to the end of the last
    # device event that starts before the last kernel's reduction ends.
    t0 = kern[0][0]
    red = [e for e in dev if e[3] == "kernel" and REDUCTION in e[2] and e[0] >= t0]
    t1 = max(kern[-1][1], red[-1][1] if red else kern[-1][1])
    inside = [e for e in dev if t0 <= e[0] and e[1] <= t1]
    sweeps = len(kern)
    busy, end = 0.0, float("-inf")
    for a, b, _, _ in inside:
        busy += max(b - max(a, end), 0.0)
        end = max(end, b)
    us = {"kernel": sum(e[1] - e[0] for e in kern),
          "reduction": sum(e[1] - e[0] for e in red if e[1] <= t1)}
    us["torch"] = sum(e[1] - e[0] for e in inside) - us["kernel"] - us["reduction"]
    us["gap"] = (t1 - t0) - busy
    per = {name: v / sweeps * 1e-3 for name, v in us.items()}  # ms a sweep
    att = estep_attainable(k)
    model = {"hbm": 16.0 * n / H100_HBM_BYTES * 1e3,
             "fp32": n * k * (FLOP_LOGIT + FLOP_STATS) / H100_FP32_FLOPS * 1e3,
             "sfu": float(n) * k / H100_SFU_OPS * 1e3}
    total = (t1 - t0) / sweeps * 1e-3
    return {"sweeps": sweeps, "k": k, "n": n, "per_sweep_ms": per, "total_ms": total,
            "model_ms": model, "bound": att.bound,
            "share_of_attainable": n / (total * 1e-3) / att.points_per_sec,
            "fp32_floor_share_of_kernel": model["fp32"] / per["kernel"]}


def print_account(acc: dict) -> None:
    print(f"sweep decomposition, K={acc['k']} N={acc['n']} ({acc['sweeps']} sweeps in the trace):")
    labels = {"kernel": "E+M kernel (trace)", "reduction": "cross-block reduction (trace)",
              "torch": "torch's small kernels and copies (trace)",
              "gap": "gaps: the device ran nothing (trace)"}
    for name, label in labels.items():
        print(f"  {label:44s} {acc['per_sweep_ms'][name]:8.4f} ms")
    for unit, label in (("hbm", "HBM stream floor (model)"), ("fp32", "fp32 FMA floor (model)"),
                        ("sfu", "SFU exp2 floor (model)")):
        print(f"  {label:44s} {acc['model_ms'][unit]:8.4f} ms")
    print(f"  per-sweep device total {acc['total_ms']:.4f} ms = "
          f"{100 * acc['share_of_attainable']:.1f}% of attainable ({acc['bound']}-bound); the fp32 "
          f"floor is {100 * acc['fp32_floor_share_of_kernel']:.1f}% of the kernel's time")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("trace_dir", type=Path)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--n", type=int, default=1 << 21)
    args = ap.parse_args(argv)
    acc = account(args.trace_dir / "trace.json", args.k, args.n)
    print_account(acc)
    return acc


if __name__ == "__main__":
    main()
