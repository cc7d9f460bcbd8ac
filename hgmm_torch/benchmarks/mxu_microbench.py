"""Matrix-shape rate microbenchmark of the port (companion of vpu_microbench).

    python -m hgmm_torch.benchmarks.mxu_microbench [--k K] [--t T] [--steps S] [--r1 A] [--r2 B]

Counterpart of ``benchmarks/mxu_microbench.py``. It times the E-step's three
matrix products, each alone in a hand-written kernel (``csrc/probes.cu``
through ``hgmm_torch.ops.probes``), and reports the EFFECTIVE flop/s of each
shape on the whole card:

  logits:  [K, 80] @ [80, T] -> f32 [K, T]
  stats:   [32, T] @ [T, K]  -> f32 [32, K]
  norm:    [8, K]  @ [K, T]  -> f32 [8, T]   (the ones-row sum)

``logits`` and ``stats`` run twice: with bfloat16 operands on the tensor
cores (the arithmetic of the reference's bodies) and with float32 operands as
FMAs from shared memory (what the port's E-step kernels execute today).

Method, as the reference's: every probe repeats its product steps * reps times
inside one launch, operands resident on the SM; it is timed at reps = r1 and
reps = r2 and (t2 - t1) / ((r2 - r1) steps) cancels the launch, the staging
and the write-out. On the card a rep count is timed as calls back to back
from one CUDA graph (``seconds_a_call``), so the events hold device time
only: a call's wrapper time on the host does not cancel in the difference,
and it exceeds the shortest probes' device time (norm at reps = 2). Every rep's full product is added into the accumulator
that is written out, and the A operand is perturbed by eps_r per rep, so the
compiler can neither drop nor hoist a product. Where the kernel adds the
product into its accumulator in a pass of its own, an add-only probe measures
that pass and the report subtracts it (raw and corrected are both printed).
Beside each shape: the time of one ``torch.matmul`` of the same product, the
library's yardstick, twice: ``torch_matmul_us_graph``, the mean of 50 calls
captured in one CUDA graph and replayed (the card's time a call, with no host
work between the launches), and ``torch_matmul_us``, the same 50 calls queued
eagerly (which times the host's dispatch of a call, ~17 µs on an H100's
host, for products of well under 1 µs). Rates are shares of the card's published peaks
(``hgmm_torch.eval.roofline``). On the CPU the plain versions run and the
times are the host's: a rehearsal, not a device rate.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hgmm_torch.benchmarks.kernel_compare import graph_us
from hgmm_torch.eval.roofline import H100_BF16_FLOPS, H100_FP32_FLOPS, H100_SMS
from hgmm_torch.ops import _build, probes
from hgmm_torch.utils.device import resolve_device
from hgmm_torch.utils.timing import time_fn

K = 512
T = 2048  # the reference's tile width; small K needs T >= 8192 so that a rep's
# work stands out of the differencing noise
LIBRARY_CALLS = 50  # torch.matmul calls back to back in one timed run (eager, and one graph)
GRAPH_CALLS = 2  # probe calls in the CUDA graph that times a rep count on the card
GRAPH_REPLAYS = 3  # timed replays of that graph


def make_inputs(k: int, t: int, device, seed: int = 0) -> dict:
    """The reference's operands from a seeded numpy generator: wt, phi normal,
    e uniform, rounded to bfloat16; x normal float32; ones [8, K]."""
    rng = np.random.default_rng(seed)
    f32 = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    wt, phi = f32(rng.standard_normal((k, 80))), f32(rng.standard_normal((80, t)))
    e = f32(rng.uniform(size=(k, t)))
    bf = torch.bfloat16
    ins = {"wt": wt.to(bf), "phi": phi.to(bf), "e": e.to(bf), "x": f32(rng.standard_normal((k, t))),
           "ones": torch.ones((8, k), dtype=bf, device=device)}
    # The float32 mode computes on the same (bfloat16-rounded) values.
    ins.update({name + "_f32": ins[name].to(torch.float32) for name in ("wt", "phi", "e")})
    return ins


def seconds_a_call(fn, device) -> float:
    """Seconds a call of fn(): on the card GRAPH_CALLS calls back to back from
    one CUDA graph (kernel_compare.graph_us, which counts every replay's
    launches in probes.LAUNCHES), the host clock (time_fn) on the CPU."""
    if device.type == "cuda":
        return graph_us(torch, fn, calls=GRAPH_CALLS, replays=GRAPH_REPLAYS, launches=probes.LAUNCHES) * 1e-6
    return time_fn(fn, warmup=1, iters=5, device=device)[1]


def run_case(fn, steps: int, r1: int, r2: int, device) -> float:
    """Seconds per rep of fn(steps, reps), by differencing two rep counts."""
    t1 = seconds_a_call(lambda: fn(steps, r1), device)
    t2 = seconds_a_call(lambda: fn(steps, r2), device)
    return (t2 - t1) / ((r2 - r1) * steps)


def run(k: int = K, t: int = T, steps: int = 1024, r1: int = 2, r2: int = 6,
        device=None) -> dict:
    """Measure every shape once; returns the report as a dict."""
    dev = resolve_device(device)
    ins = make_inputs(k, t, dev)
    sms = _build.sms(dev) if dev.type == "cuda" else H100_SMS  # the CPU rehearsal plans for an H100

    t_add2 = run_case(lambda s, r: probes.addonly(ins["x"], s, r), steps, r1, r2, dev)
    add_ps = t_add2 / 2.0 / (k * t)  # the add-only rep is two adds over K*T

    phi32, phi32_f = ins["phi"][:32], ins["phi_f32"][:32]
    # name: (probe call, matmul operands, flop, output elements, peak, add pass?, plan)
    cases = {
        "logits_bf16": (lambda s, r: probes.logits(ins["wt"], ins["phi"], s, r),
                        (ins["wt"], ins["phi"]), 2.0 * k * 80 * t, k * t, H100_BF16_FLOPS, True,
                        probes.plan_logits(k, t, False, sms)),
        "stats_bf16": (lambda s, r: probes.stats(phi32, ins["e"], s, r),
                       (phi32, ins["e"].T), 2.0 * 32 * k * t, 32 * k, H100_BF16_FLOPS, True,
                       probes.plan_stats(k, t, False, sms)),
        "norm_bf16": (lambda s, r: probes.norm(ins["ones"], ins["e"], s, r),
                      (ins["ones"], ins["e"]), 2.0 * 8 * k * t, 8 * t, H100_BF16_FLOPS, True,
                      probes.plan_norm(k, t, sms)),
        "logits_f32": (lambda s, r: probes.logits(ins["wt_f32"], ins["phi_f32"], s, r),
                       (ins["wt_f32"], ins["phi_f32"]), 2.0 * k * 80 * t, k * t, H100_FP32_FLOPS,
                       True, probes.plan_logits(k, t, True, sms)),
        # The float32 stats kernel accumulates by FMA: no add pass of its own.
        "stats_f32": (lambda s, r: probes.stats(phi32_f, ins["e_f32"], s, r),
                      (phi32_f, ins["e_f32"].T), 2.0 * 32 * k * t, 32 * k, H100_FP32_FLOPS, False,
                      probes.plan_stats(k, t, True, sms)),
    }
    report = {"k": k, "t": t, "steps": steps, "r1": r1, "r2": r2, "device": str(dev),
              "add_ps_per_elem": add_ps * 1e12, "add_telem_per_s": 1e-12 / add_ps, "cases": {}}
    for name, (fn, (a, b), flops, out_elems, peak, has_add, plan) in cases.items():
        per_tile = run_case(fn, steps, r1, r2, dev)
        corr = per_tile - (add_ps * out_elems if has_add else 0.0)
        lib = time_fn(lambda: [torch.matmul(a, b) for _ in range(LIBRARY_CALLS)], warmup=1,
                      iters=5, device=dev)[1] / LIBRARY_CALLS
        lib_graph = (graph_us(torch, lambda: torch.matmul(a, b), calls=LIBRARY_CALLS)
                     if dev.type == "cuda" else None)  # no CUDA graph on the CPU
        report["cases"][name] = {
            "us_per_tile_raw": per_tile * 1e6, "us_per_tile_add_corrected": corr * 1e6,
            "tflops_raw": flops / per_tile / 1e12, "tflops_add_corrected": flops / corr / 1e12,
            "share_of_peak_raw": flops / per_tile / peak, "peak_tflops": peak / 1e12,
            "ps_per_point": per_tile / t * 1e12, "torch_matmul_us": lib * 1e6,
            "torch_matmul_us_graph": lib_graph,
            "grid": list(plan.grid), "threads": plan.threads, "blocks_per_sm": plan.blocks / sms,
        }
    if "norm_bf16" in report["cases"]:
        report["cases"]["norm_bf16"]["note"] = (
            "rate counts the 8 rows a rep; the kernel stacks 16 reps of them along the tensor "
            "cores' N (its transpose), so no row is padding")
    for mode, names in (("bf16", ("logits_bf16", "stats_bf16", "norm_bf16")),
                        ("f32", ("logits_f32", "stats_f32"))):
        total = sum(report["cases"][n]["ps_per_point"] for n in names) * 1e-12
        report[f"serial_{mode}_ps_per_point"] = total * 1e12
        report[f"serial_{mode}_gpts_per_s"] = 1e-9 / total
    return report


def print_report(report: dict) -> None:
    k = report["k"]
    print(f"device={report['device']} K={k} T={report['t']} steps={report['steps']} "
          f"reps {report['r1']}->{report['r2']}")
    print(f"f32 add pass: {report['add_ps_per_elem']:.4f} ps/elem "
          f"({report['add_telem_per_s']:.2f} Telem/s)")
    for name, c in report["cases"].items():
        graph = c["torch_matmul_us_graph"]
        graph = "no graph" if graph is None else f"{graph:.3f} us in a graph"
        print(f"{name:>11}: {c['us_per_tile_raw']:8.2f} us/tile raw, "
              f"{c['us_per_tile_add_corrected']:8.2f} add-corrected -> {c['tflops_raw']:6.1f} "
              f"TFLOP/s effective raw ({100 * c['share_of_peak_raw']:4.1f}% of the "
              f"{c['peak_tflops']:.0f} TFLOP/s peak), {c['ps_per_point']:.3f} ps/pt; "
              f"torch.matmul {graph}, {c['torch_matmul_us']:.2f} us eager; grid {c['grid']} x {c['threads']} "
              f"threads ({c['blocks_per_sm']:.2f} blocks/SM)")
    for mode in ("bf16", "f32"):
        print(f"serial {mode} total {report[f'serial_{mode}_ps_per_point']:.3f} ps/pt -> "
              f"{report[f'serial_{mode}_gpts_per_s']:.3f} Gpts/s matrix-only ceiling at K={k}")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=1024)
    ap.add_argument("--r1", type=int, default=2)
    ap.add_argument("--r2", type=int, default=6)
    ap.add_argument("--k", type=int, default=K, help="component count of the measured shapes")
    ap.add_argument("--t", type=int, default=T,
                    help="tile width (K=64 needs T >= 8192 for a rep to stand out of the noise)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card (fails without one); cpu rehearses the plain versions")
    args = ap.parse_args(argv)
    report = run(args.k, args.t, args.steps, args.r1, args.r2, args.device)
    print_report(report)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    main()
