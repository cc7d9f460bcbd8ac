"""Throughput of the fused E+M sweep over the engine's hot shapes.

    python -m hgmm_torch.benchmarks.kernel_shapes [--n N] [--device cuda|cpu]

Counterpart of ``benchmarks/kernel_shapes.py``: K in {64, 512} x {unmasked,
masked} at N = 2^21, plus K = 8 unmasked (the tree's level 0), each row
against its own bound from ``hgmm_torch.eval.roofline``.

- K=512 unmasked: the shape of ``hgmm_torch.bench`` (fit and registration at
  leaf resolution).
- K=64 unmasked: a flat K=64 fit. K=8 unmasked: the tree's level-0 EM.
- masked: the tree fit's child-masked E-step (``ops.em_stats_masked``,
  branch 8, parents drawn uniformly over the K/8 parents): a point needs its
  parent's 8 children only, so its bound is the point stream's.

A sweep is one ``ops.em_stats`` / ``ops.em_stats_masked`` call on the prepared
buffer; ``sweeps_for(k)`` sweeps are queued back to back, the chain is warmed
once and timed five times (CUDA events; the host clock on the CPU, where the
plain versions run and the rates are the host's).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from hgmm_torch import convert, ops
from hgmm_torch.bench import bench_problem
from hgmm_torch.eval.roofline import kernel_bound
from hgmm_torch.ops.gaussians import pack_loglik_weights
from hgmm_torch.utils.device import resolve_device
from hgmm_torch.utils.timing import time_fn

N = 1 << 21
BRANCH = 8
SHAPES = ((8, False), (64, False), (64, True), (512, False), (512, True))


def sweeps_for(k: int) -> int:
    """Chain length per K, so that every row's timed chain is tens of
    milliseconds of device time (a K=8 sweep is ~100x shorter than a K=512 one)."""
    return max(20, 10240 // k)


def build_chain(k: int, masked: bool, n: int, device, sweeps: int, seed: int = 0):
    mix, pts = bench_problem(n, k, seed)
    W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=device))
    prep = ops.prepare(torch.from_numpy(pts).to(device))
    if masked:
        par = np.random.default_rng(seed + 1).integers(0, k // BRANCH, n, dtype=np.int32)
        parent = torch.from_numpy(par).to(device)
        sweep = lambda: ops.em_stats_masked(prep, W, parent, BRANCH)  # noqa: E731
    else:
        sweep = lambda: ops.em_stats(prep, W)  # noqa: E731

    def chain():
        out = None
        for _ in range(sweeps):
            out = sweep()
        return out

    return chain


def run(n: int = N, device=None, sweeps: int | None = None) -> list[dict]:
    dev = resolve_device(device)
    rows = []
    for k, masked in SHAPES:
        s = sweeps or sweeps_for(k)
        chain = build_chain(k, masked, n, dev, s)
        _, total, _ = time_fn(chain, warmup=1, iters=5, device=dev)
        per_sweep = max(total, 1e-9) / s
        kb = (kernel_bound("em_stats_masked", n=n, k=k, branch=BRANCH) if masked
              else kernel_bound("em_stats", n=n, k=k))
        rows.append({
            "k": k, "masked": masked, "n": n, "sweeps": s, "ms": per_sweep * 1e3,
            "gpts": n / per_sweep / 1e9, "bound_ms": kb.seconds * 1e3, "bound_by": kb.by,
            "bound_unit": kb.unit, "share_of_bound": kb.seconds / per_sweep, "device": str(dev),
        })
    return rows


def print_rows(rows) -> None:
    for r in rows:
        label = f"K={r['k']:4d} {'masked  ' if r['masked'] else 'unmasked'}"
        print(f"{label}: {r['ms']:.3f} ms/sweep, {r['gpts']:.3f} Gpts/s; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}, {r['bound_unit']}) -> {100 * r['share_of_bound']:.1f}% of the bound")


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--sweeps", type=int, default=None, help="override sweeps_for(k)")
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card (fails without one); cpu rehearses the plain versions")
    args = ap.parse_args(argv)
    rows = run(args.n, args.device, sweeps=args.sweeps)
    print_rows(rows)
    print(json.dumps({"kernel_shapes": rows}), flush=True)
    return rows


if __name__ == "__main__":
    main()
