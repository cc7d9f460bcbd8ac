"""Headline benchmark of the port: fused E+M sweep throughput on one GPU.

    python -m hgmm_torch.bench [--trace DIR] [--device cuda|cpu] [--n N] [--k K] [--sweeps S]

Counterpart of the repository's root ``bench.py``. Prints ONE JSON line on
stdout:
  {"metric": "estep_points_per_sec_chip", "value": N, "unit": "points/s",
   "vs_baseline": r}
where vs_baseline = measured / (0.70 * attainable points/s of
hgmm_torch.eval.roofline.estep_attainable), so vs_baseline >= 1.0 means the
sweep reaches 70 % of the card's roofline. The context (the card's name and
power limit, ms a sweep, the share of the roofline) goes to stderr.

Method: one sweep is ``hgmm_torch.ops.em_stats`` on the prepared point buffer
(N = 2^21 points, a K = 512 mixture: the leaf level of the tree), the M-step
outside the timed work. SWEEPS sweeps are queued back to back on one stream;
the chain is run twice to warm up and five times under CUDA events (the host
clock with --device cpu), and the median is kept.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys

import numpy as np
import torch

N = 1 << 21
K = 512
SWEEPS = 150


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
        return out[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.CalledProcessError) as exc:
        return f"nvidia-smi failed: {exc}"


def bench_problem(n: int = N, k: int = K, seed: int = 0):
    """The benchmark's mixture and points as numpy, from a seeded generator on
    the host: ((pi [K], mu [K,3], sigma [K,3,3]), points [N,3]), float32. The
    recipe of the root bench.py: standard-normal means and points, covariances
    a a^T + 0.05 I with a = 0.3 * normal, softmax-of-normal weights."""
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((k, 3))
    a = 0.3 * rng.standard_normal((k, 3, 3))
    sigma = np.einsum("kij,klj->kil", a, a) + 0.05 * np.eye(3)
    z = rng.standard_normal(k)
    pi = np.exp(z - z.max())
    pi /= pi.sum()
    pts = rng.standard_normal((n, 3), dtype=np.float32)
    return (pi.astype(np.float32), mu.astype(np.float32), sigma.astype(np.float32)), pts


def run_bench(trace_dir=None, device=None, n: int = N, k: int = K, sweeps: int = SWEEPS) -> dict:
    """Run the benchmark, print its JSON line and return it as a dict with
    the last sweep's statistics under "stats" (an EmStats)."""
    from hgmm_torch import convert, ops
    from hgmm_torch.eval.roofline import estep_attainable
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.utils.device import resolve_device
    from hgmm_torch.utils.timing import sync, time_fn

    dev = resolve_device(device)
    if dev.type == "cuda":
        log(f"device={torch.cuda.get_device_name(dev)} ({card_line()})")
    else:
        log("device=cpu: the plain PyTorch sweep; no device rate is measured here")

    mix, pts = bench_problem(n, k)
    W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
    prep = ops.prepare(torch.from_numpy(pts).to(dev))

    def chain():
        stats = None
        for _ in range(sweeps):
            stats = ops.em_stats(prep, W)
        return stats

    for _ in range(2):
        chain()
    sync(dev)
    if trace_dir is not None:
        from hgmm_torch.utils.profiling import trace

        trace_ctx = trace(trace_dir)
        log(f"profiler trace -> {trace_dir}")
    else:
        trace_ctx = contextlib.nullcontext()
    with trace_ctx:
        stats, total, _ = time_fn(chain, warmup=0, iters=5, device=dev)
        sync(dev)
    per_sweep = max(total, 1e-9) / sweeps
    pps = n / per_sweep

    att = estep_attainable(k)
    target = 0.70 * att.points_per_sec
    log(
        f"K={k} N={n}: {per_sweep * 1e3:.3f} ms/sweep over {sweeps} sweeps, {pps / 1e9:.3f} Gpts/s, "
        f"{att.flops_per_point * pps / 1e12:.1f} TFLOP/s needed; attainable "
        f"{att.points_per_sec / 1e9:.3f} Gpts/s ({att.bound}-bound) -> "
        f"{100 * pps / att.points_per_sec:.1f}% of roofline (no-overlap lower bound "
        f"{att.serial_points_per_sec / 1e9:.3f} Gpts/s -> "
        f"{100 * pps / att.serial_points_per_sec:.1f}%)"
    )
    record = {
        "metric": "estep_points_per_sec_chip",
        "value": round(pps),
        "unit": "points/s",
        "vs_baseline": round(pps / target, 4),
    }
    print(json.dumps(record), flush=True)
    return {**record, "ms_per_sweep": per_sweep * 1e3, "device": str(dev), "stats": stats}


def add_arguments(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the timed sweeps to DIR/trace.json")
    ap.add_argument("--n", type=int, default=N, help="points (default 2^21)")
    ap.add_argument("--k", type=int, default=K, help="mixture components (default 512)")
    ap.add_argument("--sweeps", type=int, default=SWEEPS, help="sweeps in one timed chain")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(ap)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("--device cuda: CUDA is not available (--device cpu runs the plain PyTorch path)")
    run_bench(trace_dir=args.trace, device=args.device, n=args.n, k=args.k, sweeps=args.sweeps)


if __name__ == "__main__":
    main()
