"""exp2 + bfloat16-cast rate microbenchmark of the port.

    python -m hgmm_torch.benchmarks.vpu_microbench [--k K] [--t T] [--steps S] [--r1 A] [--r2 B]

Counterpart of ``benchmarks/vpu_microbench.py``. Two chains over one [K, T]
float32 array, each element's chain in a register of one thread, which runs
up to four such chains (``csrc/probes.cu:probe_vpu_kernel`` through
``hgmm_torch.ops.probes.vpu``, launched by ``probes.plan_vpu``):

  exp2-mode iteration:  x <- -(float32(bfloat16(exp2(x))))
      exp2 + the downcast, plus an upcast and a negate (chain glue; values
      converge to the fixed point x* = -exp2(x*) ~ -0.6412).
  cast-mode iteration:  x <- -(float32(bfloat16(x)))
      the same glue without the exp2.

Each mode is timed at reps = r1 and reps = r2 iterations per step;
(t2 - t1) / (r2 - r1) cancels the launch, the load and the store. On the
card a timing is CALLS back-to-back calls between two events with one call
queued ahead, so the events hold device time only: the wrapper's host time
(~0.1 ms a call on an H100, varying from call to call) does not cancel in
the difference. The pair
cost is kept as the reference defines it,

  tau_pair = tau_iter(exp2) - (2/3) tau_iter(cast),

attributing 2 of the cast iteration's ~3 lane instructions to glue. exp2 runs
on the special-function unit, so exp2/s is also reported against that unit's
peak rate (``hgmm_torch.eval.roofline.H100_SFU_OPS``). On the CPU the plain
version runs: a rehearsal, not a device rate.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hgmm_torch.eval.roofline import H100_SFU_OPS
from hgmm_torch.ops import probes
from hgmm_torch.utils.device import resolve_device
from hgmm_torch.utils.timing import time_fn


CALLS = 4  # back-to-back calls between a timing's two events on the card


def seconds_a_call(fn, dev) -> float:
    """Median seconds a call of fn() over five timings (module docstring);
    the host clock (time_fn) on the CPU."""
    if dev.type != "cuda":
        return time_fn(fn, warmup=1, iters=5, device=dev)[1]
    times = []
    with torch.cuda.device(dev):
        fn()
        torch.cuda.synchronize()
        for _ in range(5):
            fn()  # in flight while the timed calls are queued
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(CALLS):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3 / CALLS)
    return float(np.median(times))


def run(k: int = 512, t: int = 512, steps: int = 2048, r1: int = 4, r2: int = 8,
        device=None) -> dict:
    dev = resolve_device(device)
    x = torch.from_numpy(
        (-1.5 + np.random.default_rng(0).uniform(size=(k, t))).astype(np.float32)).to(dev)
    elems = k * t * steps
    report = {"k": k, "t": t, "steps": steps, "r1": r1, "r2": r2, "device": str(dev), "modes": {}}
    tau = {}
    for mode in ("exp2", "cast"):
        t1 = seconds_a_call(lambda: probes.vpu(x, steps, r1, mode), dev)
        t2 = seconds_a_call(lambda: probes.vpu(x, steps, r2, mode), dev)
        tau[mode] = (t2 - t1) / ((r2 - r1) * elems)
        report["modes"][mode] = {"ms_r1": t1 * 1e3, "ms_r2": t2 * 1e3,
                                 "tau_iter_ps": tau[mode] * 1e12, "telem_per_s": 1e-12 / tau[mode]}
    tau_pair = tau["exp2"] - (2.0 / 3.0) * tau["cast"]
    report.update({
        "tau_pair_ps": tau_pair * 1e12, "pair_per_s": 1.0 / tau_pair,
        "exp2_per_s": 1.0 / tau["exp2"], "sfu_peak_per_s": H100_SFU_OPS,
        "exp2_share_of_sfu_peak": 1.0 / tau["exp2"] / H100_SFU_OPS,
    })
    return report


def print_report(report: dict) -> None:
    print(f"device={report['device']} K={report['k']} T={report['t']} steps={report['steps']}")
    for mode, m in report["modes"].items():
        print(f"{mode:>5}: reps {report['r1']}->{report['r2']}: {m['ms_r1']:.2f} -> {m['ms_r2']:.2f} ms, "
              f"tau_iter = {m['tau_iter_ps']:.4f} ps/elem ({m['telem_per_s']:.3f} Telem/s)")
    print(f"pair (exp2 + bf16 downcast): tau = {report['tau_pair_ps']:.4f} ps/elem -> "
          f"{report['pair_per_s']:.4g} pairs/s")
    print(f"exp2 iterations: {report['exp2_per_s']:.4g} /s = "
          f"{100 * report['exp2_share_of_sfu_peak']:.1f}% of the SFU's {report['sfu_peak_per_s']:.4g} /s")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--t", type=int, default=512)
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--r1", type=int, default=4)
    ap.add_argument("--r2", type=int, default=8)
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card (fails without one); cpu rehearses the plain version")
    args = ap.parse_args(argv)
    report = run(args.k, args.t, args.steps, args.r1, args.r2, args.device)
    print_report(report)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
