"""The ungated reg_stats body at the benchmark cells' shapes: device time a
call, its share of the float32 bound, and the compiler's view of it.

    python3 hgmm_torch/benchmarks/reg_body_times.py --root TREE [--ks 8,64,384,512] [--out FILE]

Run by path from any checkout; it imports TREE's ``hgmm_torch`` (the working
tree, or a ``git archive`` of the parent unpacked beside it), so a parent and
a change are timed in one call on one card, in turns. For each shape, a call
of ``fused_em.reg_partials`` on tables made by ``reg_tables_of`` (no
``top_k``) at a pose near the identity:

- the dragon cells' source, 437,645 points on the seeded trefoil tube, no
  outlier, at each K of ``--ks``;
- the KITTI scans' bucket, 131,072 rows of which 120,000 live (a zero-weight
  tail), outlier -8, at K = 8, 64, 512;
- the odometry bucket, 16,384 points, outlier -8, at K = 8, 64, 512.

It prints one JSON line: for each shape the plan (``RegPlan``), the launch
counter's name (``RegTables.body``), the device µs a call (profiler, by
kernel name, the mean over REPS calls after three warm ones), the bound
(``eval/roofline.kernel_bound("reg_stats")``) and its share, and the float64
sum of the partial rows (so two trees' outputs can be held side by side); and
the ``-Xptxas -v`` registers and spills and the SASS loops of every kernel
named ``reg_stats_lanes`` or ``reg_stats_tiled``.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

REPS = 30
DRAGON_N = 437_645
KITTI_N, KITTI_LIVE = 131_072, 120_000
ODO_N = 16_384
LIDAR_KS = (8, 64, 512)


def _mixture(np, pts: "np.ndarray", k: int, seed: int):
    """K components on the cloud: means at random points, anisotropic
    covariances of 0.005-0.03 a side in random orientations, Dirichlet
    weights, float32 numpy (pi, mu, sigma)."""
    rng = np.random.default_rng(seed)
    mu = pts[rng.choice(len(pts), k, replace=False)]
    q, _ = np.linalg.qr(rng.standard_normal((k, 3, 3)))
    axes = rng.uniform(0.005, 0.03, (k, 3))
    sigma = np.einsum("kij,kj,klj->kil", q, axes ** 2, q)
    pi = rng.dirichlet(np.ones(k))
    return pi.astype(np.float32), mu.astype(np.float32), sigma.astype(np.float32)


def device_us(torch, fn, where: str) -> dict[str, float]:
    """Device µs a call of fn() by kernel name (the port's kernels), the
    mean over REPS calls after three warm ones."""
    from hgmm_torch.utils.profiling import device_busy, trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=where) as d:
        with trace(d):
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        _, by_name = device_busy(Path(d) / "trace.json")
    return {name: v / REPS for name, v in by_name.items() if "hgmm::" in name}


def run(root: Path, ks: list[int], where: str) -> dict:
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import hgmm_torch
    from hgmm_torch.data import synthetic
    from hgmm_torch.eval.roofline import kernel_bound
    from hgmm_torch.ops import _build, fused_em, prepare
    from hgmm_torch.ops.gaussians import MixtureParams

    if Path(hgmm_torch.__file__).resolve().parent != root / "hgmm_torch":
        raise SystemExit(f"imported hgmm_torch from {hgmm_torch.__file__}, not from {root}")
    dev = torch.device("cuda")
    dragon = synthetic.make_cloud_np(DRAGON_N, "trefoil", seed=0)
    shapes = [("dragon", DRAGON_N, k, None, dragon, None, _mixture(np, dragon, k, k)) for k in ks]
    for name, n, live in (("kitti", KITTI_N, KITTI_LIVE), ("odo", ODO_N, ODO_N)):
        for k in LIDAR_KS:
            mix = synthetic.lidar_mixture_np(k, seed=k)
            pts, w = synthetic.lidar_points_np(live, mix, seed=k, pad=0.0)
            pts = np.concatenate([pts, np.zeros((n - live, 3), np.float32)])
            w = np.concatenate([w, np.zeros(n - live, np.float32)])
            shapes.append((name, n, k, -8.0, pts, w, mix))
    c, s = np.cos(0.01), np.sin(0.01)
    pose12 = torch.tensor([c, -s, 0, s, c, 0, 0, 0, 1, 0.003, -0.002, 0.001], dtype=torch.float32, device=dev)
    out = {"device": torch.cuda.get_device_name(dev), "shapes": []}
    for name, n, k, outlier, pts, w, mix in shapes:
        prep = prepare(torch.from_numpy(pts).to(dev), None if w is None else torch.from_numpy(w).to(dev))
        params = MixtureParams(*(torch.from_numpy(a).to(dev).contiguous() for a in mix))
        tab = fused_em.reg_tables_of(prep.pts4, params, None, outlier)
        bound = kernel_bound("reg_stats", n=n, k=k).seconds * 1e6
        by = device_us(torch, lambda: fused_em.reg_partials(tab, pose12), where)
        us = sum(v for kname, v in by.items() if "reg_stats" in kname)
        fused_em.reg_partials(tab, pose12)
        out["shapes"].append({
            "shape": name, "n": n, "k": k, "outlier": outlier, "plan": str(tab.plan), "counter": tab.body,
            "kernels": sorted(kname[:80] for kname in by if "reg_stats" in kname), "device_us": us,
            "bound_us": bound, "pct_of_bound": 100.0 * bound / us,
            "sum": tab.rows.partial.double().sum(0).tolist()})
    out["ptxas"] = {name: v for name, v in _build.kernel_report("reg_stats").items()
                    if "lanes" in name or "tiled" in name}
    try:
        out["sass_loops"] = {name: loops for name, loops in _build.sass_loops("reg_stats").items()
                             if "lanes" in name or "tiled" in name}
    except (RuntimeError, FileNotFoundError) as err:
        out["sass_loops"] = str(err)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", default=".", help="the checkout whose hgmm_torch is timed")
    ap.add_argument("--ks", default="8,64,384,512", help="K of the 437,645-point shapes")
    ap.add_argument("--tmp", default=None, help="where the profiler's traces are written (deleted after)")
    ap.add_argument("--out", help="also write the JSON object here")
    args = ap.parse_args(argv)
    out = run(Path(args.root).resolve(), [int(k) for k in args.ks.split(",")], args.tmp)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
