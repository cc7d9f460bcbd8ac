"""Two trees' kernels on the same card, in one process each: outputs and times.

    python hgmm_torch/benchmarks/kernel_compare.py --root TREE --save A.pt [--device cpu] [--n N]
    python hgmm_torch/benchmarks/kernel_compare.py --diff A.pt B.pt

A change to a kernel is compared with its parent inside one call on one card,
in turns (parent, change, change, parent): two calls may land on two cards.
``--root`` is a checkout of the package (the working tree, or a ``git
archive`` of the parent unpacked beside it); the script is run by path, so
that the ``hgmm_torch`` it imports is TREE's, whichever tree the script itself
lies in. It needs ``hgmm_torch.bench`` in TREE (there since the bench path).

``--save`` runs fixed, seeded inputs through TREE's ``hgmm_torch.ops``:

- ``em_stats`` at K = 8, 12 (plain; weighted with zero-weight rows and an
  outlier logit), K = 64, 512 unmasked (weighted, outlier) and masked (random
  parents, branch 8) at N points (default 437,645),
- ``nearest_neighbor`` of N moved points against the N points,

saves every output to the file, and prints one JSON line with the times of the
bench sweep (``em_stats``, N = 2^21, K = 512) and of the search. ``--diff``
prints, for every output of the two files, ``bit-equal`` or the largest gap.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH_N = 1 << 21
BENCH_K = 512
N = 437_645
BRANCH = 8


def run(root: Path, device, n: int = N, bench_n: int = BENCH_N, bench_k: int = BENCH_K) -> tuple[dict, dict]:
    """TREE's kernels on the fixed inputs: (outputs by name, times in ms)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import hgmm_torch
    from hgmm_torch import bench, convert, ops
    from hgmm_torch.ops import knn
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.utils.device import resolve_device
    from hgmm_torch.utils.timing import time_fn

    if Path(hgmm_torch.__file__).resolve().parent != root / "hgmm_torch":
        raise SystemExit(f"imported hgmm_torch from {hgmm_torch.__file__}, not from {root}")
    dev = resolve_device(device)
    rng = np.random.default_rng(123)
    pts = torch.from_numpy(rng.standard_normal((n, 3), dtype=np.float32)).to(dev)
    w = rng.uniform(size=n).astype(np.float32)
    w[::7] = 0.0
    w = torch.from_numpy(w).to(dev)
    out = {}
    for k in (8, 12, 64, 512):
        mix, _ = bench.bench_problem(1, k, seed=k)
        W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
        if k < 64:
            out[f"em_stats_K{k}"] = tuple(ops.em_stats(ops.prepare(pts), W))
        out[f"em_stats_K{k}_weighted_outlier"] = tuple(ops.em_stats(ops.prepare(pts, w), W, -3.0))
        if k >= 64:
            parent = torch.from_numpy(rng.integers(-1, k // BRANCH, n).astype(np.int32)).to(dev)
            out[f"em_stats_masked_K{k}"] = tuple(ops.em_stats_masked(ops.prepare(pts, w), W, parent, BRANCH))
    moved = (pts + torch.tensor([0.02, -0.01, 0.03], device=dev)).contiguous()
    out["knn"] = tuple(knn.nearest_neighbor(moved, pts))

    mix, bench_pts = bench.bench_problem(bench_n, bench_k)
    W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
    prep = ops.prepare(torch.from_numpy(bench_pts).to(dev))
    _, em_s, _ = time_fn(lambda: ops.em_stats(prep, W), device=dev, warmup=2, iters=20)
    _, knn_s, _ = time_fn(lambda: knn.nearest_neighbor(moved, pts), device=dev, warmup=1, iters=5)
    times = {"em_stats_ms": em_s * 1e3, "em_stats_shape": [bench_n, bench_k],
             "knn_ms": knn_s * 1e3, "knn_shape": [n, n], "device": str(dev),
             "card": bench.card_line() if dev.type == "cuda" else None}
    return {name: tuple(t.cpu() for t in ts) for name, ts in out.items()}, times


def diff(a: dict, b: dict) -> dict:
    """For every output both files hold: "bit-equal", or the largest absolute
    gap over its tensors (and the largest magnitude beside it)."""
    import torch

    report = {}
    for name in sorted(set(a) & set(b)):
        if all(torch.equal(x, y) for x, y in zip(a[name], b[name])):
            report[name] = "bit-equal"
        else:
            gap = max(float((x.double() - y.double()).abs().max()) for x, y in zip(a[name], b[name]))
            top = max(float(x.double().abs().max()) for x in a[name])
            report[name] = {"max_abs_gap": gap, "max_abs_value": top}
    return report


def main(argv=None) -> dict:
    import torch

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", type=Path, default=Path(__file__).resolve().parents[2])
    ap.add_argument("--save", type=Path, help="run TREE's kernels and save their outputs here")
    ap.add_argument("--diff", nargs=2, type=Path, metavar=("A", "B"))
    ap.add_argument("--device", default=None, choices=("cuda", "cpu"),
                    help="default: the card (fails without one); cpu rehearses the plain versions")
    ap.add_argument("--n", type=int, default=N)
    ap.add_argument("--bench-n", type=int, default=BENCH_N)
    ap.add_argument("--bench-k", type=int, default=BENCH_K)
    args = ap.parse_args(argv)
    if (args.save is None) == (args.diff is None):
        ap.error("give either --save FILE or --diff A B")
    if args.diff:
        report = diff(*(torch.load(f) for f in args.diff))
        print(json.dumps({"diff": report}), flush=True)
        return report
    outputs, times = run(args.root.resolve(), args.device, args.n, args.bench_n, args.bench_k)
    torch.save(outputs, args.save)
    print(json.dumps({"root": str(args.root), **times}), flush=True)
    return times


if __name__ == "__main__":
    main()
