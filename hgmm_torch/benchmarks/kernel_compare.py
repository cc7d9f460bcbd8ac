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
- ``assign`` at K = 8 and, masked, K = 64, 512,
- ``reg_stats`` at K = 8, 64, 384, 512 (outlier -8) and K = 512 with
  top_k = 8 (outlier 0),
- ``nearest_neighbor`` of N moved points against the N points,
- a flat fit (K = 8, 10 sweeps) and a tree fit (8 x 3, 10 sweeps a level)
  from one init on the odometry bucket (16,384 points at LiDAR scale): the
  parameters and the logliks after the sweeps,

saves every output to the file, and prints one JSON line with the times of the
bench sweep (``em_stats``, N = 2^21, K = 512) and of the search; of
``reg_stats`` (each K, with and without top_k) and the masked ``em_stats`` (K =
64, 512) as a caller makes them (the ops call, its tables included) at N and
at the odometry bucket, 16,384 points at LiDAR scale; the device time a call
of ``em_stats`` at K = 8 and of ``assign`` at K = 8 and, masked, K = 64, 512
(profiler trace, by kernel name) at both sizes, and of ``em_stats`` at K = 16,
32, 33, 63 and 64 at N; and of two pairs, each
with its kernels, copies and memsets (profiler) and host syncs (torch's sync
debug mode): ``register_pair`` (config2_tree_8x3) at N and one odometry pair
(config 4's tree fit and registration on the bucket). ``--diff`` prints, for
every output of the two files, ``bit-equal`` or the largest gap.
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
        out[f"em_stats_K{k}_weighted_outlier"] = tuple(ops.em_stats(ops.prepare(pts, w), W, outlier_logit=-3.0))
        if k >= 64:
            parent = torch.from_numpy(rng.integers(-1, k // BRANCH, n).astype(np.int32)).to(dev)
            out[f"em_stats_masked_K{k}"] = tuple(ops.em_stats_masked(ops.prepare(pts, w), W, parent, BRANCH))
    for k in (8, 64, 512):
        mix, _ = bench.bench_problem(1, k, seed=k)
        W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
        parent = None if k == 8 else torch.from_numpy(rng.integers(-1, k // BRANCH, n).astype(np.int32)).to(dev)
        out[f"assign_K{k}"] = (ops.assign(ops.prepare(pts), W, parent, None if k == 8 else BRANCH),)
    reg = reg_inputs(np, torch, convert, dev, pts)
    for key, (args, kw) in reg.items():
        out[f"reg_stats_{key}"] = tuple(ops.reg_stats(ops.prepare(pts, w), *args, **kw))
    moved = (pts + torch.tensor([0.02, -0.01, 0.03], device=dev)).contiguous()
    out["knn"] = tuple(knn.nearest_neighbor(moved, pts))
    out.update(fit_outputs(np, torch, dev))

    mix, bench_pts = bench.bench_problem(bench_n, bench_k)
    W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
    prep = ops.prepare(torch.from_numpy(bench_pts).to(dev))
    _, em_s, _ = time_fn(lambda: ops.em_stats(prep, W), device=dev, warmup=2, iters=20)
    _, knn_s, _ = time_fn(lambda: knn.nearest_neighbor(moved, pts), device=dev, warmup=1, iters=5)
    times = {"em_stats_ms": em_s * 1e3, "em_stats_shape": [bench_n, bench_k],
             "knn_ms": knn_s * 1e3, "knn_shape": [n, n], "device": str(dev),
             "card": bench.card_line() if dev.type == "cuda" else None}
    times.update(shape_times(np, torch, dev, n))
    times.update(device_times(np, torch, dev, n))
    times.update(pair_counts(np, torch, dev, n))
    return {name: tuple(t.cpu() for t in ts) for name, ts in out.items()}, times


def reg_inputs(np, torch, convert, dev, pts, extent=None):
    """reg_stats arguments by key: K = 8, 64, 384, 512 (outlier -8) and K =
    512 with top_k = 8 (outlier 0), at a fixed pose."""
    from hgmm_torch.models.se3 import so3_exp
    from hgmm_torch.ops.gaussians import pack_loglik_weights, precision_terms, sym_pack
    from hgmm_torch.data.synthetic import lidar_mixture_np

    pose = (so3_exp(torch.tensor([0.02, -0.03, 0.05], device=dev)), torch.tensor([0.05, 0.0, -0.02], device=dev))
    out = {}
    for k, top_k, outlier in ((8, None, -8.0), (64, None, -8.0), (384, None, -8.0), (512, None, -8.0),
                              (512, 8, 0.0)):
        if extent is None:
            params = convert.mixture_from_numpy(*_unit_mixture(np, k), device=dev)
        else:
            params = convert.mixture_from_numpy(*lidar_mixture_np(k, seed=k, extent=extent), device=dev)
        A, b, _ = precision_terms(params)
        key = f"K{k}" + ("" if top_k is None else f"_top{top_k}")
        out[key] = ((pack_loglik_weights(params), params.mu, sym_pack(A), b, pose),
                    dict(top_k=top_k, outlier_logit=outlier))
    return out


def _unit_mixture(np, k):
    rng = np.random.default_rng(k + 100)
    a = 0.3 * rng.standard_normal((k, 3, 3))
    sigma = np.einsum("kij,klj->kil", a, a) + 0.05 * np.eye(3)
    return (np.full(k, 1.0 / k, np.float32), rng.standard_normal((k, 3)).astype(np.float32),
            sigma.astype(np.float32))


def shape_times(np, torch, dev, n) -> dict:
    """ms a call of reg_stats and of the masked em_stats, by K, at n points
    (unit scale) and at the odometry bucket (16,384 points at LiDAR scale,
    30 % zero-weight rows): the ops calls as callers make them."""
    from hgmm_torch import convert, ops
    from hgmm_torch.data.synthetic import lidar_mixture_np, lidar_points_np
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.utils.timing import time_fn

    out = {}
    rng = np.random.default_rng(7)
    reps = dict(warmup=3, iters=20) if dev.type == "cuda" else dict(warmup=0, iters=1)
    for tag, nn, extent in (("n437645", n, None), ("n16384", 16_384, 40.0)):
        if extent is None:
            pts = torch.from_numpy(rng.standard_normal((nn, 3), dtype=np.float32)).to(dev)
            w = None
        else:
            pts_np, w_np = lidar_points_np(nn, lidar_mixture_np(512, seed=3, extent=extent), seed=4,
                                           extent=extent)
            pts, w = torch.from_numpy(pts_np).to(dev), torch.from_numpy(w_np).to(dev)
        prep = ops.prepare(pts, w)
        for key, (args, kw) in reg_inputs(np, torch, convert, dev, pts, extent).items():
            _, sec, _ = time_fn(lambda: ops.reg_stats(prep, *args, **kw), device=dev, **reps)
            out[f"reg_stats_{key}_{tag}_ms"] = sec * 1e3
        for k in (64, 512):
            mix = (_unit_mixture(np, k) if extent is None else lidar_mixture_np(k, seed=k, extent=extent))
            W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=dev))
            coarse = convert.mixture_from_numpy(*(a[::BRANCH] for a in mix), device=dev)
            parent = ops.assign(prep, pack_loglik_weights(coarse))
            _, sec, _ = time_fn(lambda: ops.em_stats_masked(prep, W, parent, BRANCH), device=dev, **reps)
            out[f"em_stats_masked_K{k}_{tag}_ms"] = sec * 1e3
    return out


def fit_outputs(np, torch, dev) -> dict:
    """A flat fit (K = 8, 10 sweeps) and a tree fit (8 x 3, 10 sweeps a level)
    from one numpy init on 16,384 points at LiDAR scale (30 % zero-weight
    rows): parameters and logliks."""
    from hgmm_torch import convert
    from hgmm_torch.data.synthetic import lidar_mixture_np, lidar_points_np
    from hgmm_torch.models.gmm import em_fit
    from hgmm_torch.models.gmm_tree import GmmTree

    pts_np, w_np = lidar_points_np(16_384, lidar_mixture_np(512, seed=3, extent=40.0), seed=4,
                                   extent=40.0)
    pts, w = torch.from_numpy(pts_np).to(dev), torch.from_numpy(w_np).to(dev)
    live = np.flatnonzero(w_np > 0)
    idx = np.random.default_rng(9).choice(live, 8, replace=False)
    init = convert.mixture_from_numpy(np.full(8, 0.125, np.float32), pts_np[idx],
                                      np.broadcast_to(25.0 * np.eye(3, dtype=np.float32), (8, 3, 3)).copy(),
                                      device=dev)
    params, lls = em_fit(pts, init, n_iters=10, point_weights=w)
    tree, tlls = GmmTree.fit(pts, branch=BRANCH, levels=3, em_iters=10, point_weights=w, init0=init)
    out = {"em_fit_K8_n16384": (*params, lls), "tree_fit_n16384_logliks": (tlls,)}
    for lvl, p in enumerate(tree.levels):
        out[f"tree_fit_n16384_level{lvl}"] = tuple(p)
    return out


def device_us(fn, reps: int = 20, where=None) -> tuple[float, dict]:
    """Mean device µs a call of fn() of the port's kernels (names with
    hgmm::), in all and by kernel, from a profiler trace over `reps` calls
    after three warm ones (in a temporary directory under `where`): at small
    sizes back-to-back calls are bound by the wrappers' host time, which CUDA
    events would time. A trace that holds none of the card's kernel records
    (the profiler lost them once in a chip_smoke.py run on the H100) is
    taken again, up to three times. Needs only what every tree's hgmm_torch
    has."""
    import tempfile

    import torch

    from hgmm_torch.utils.profiling import device_busy, trace

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with tempfile.TemporaryDirectory(dir=where) as d:
            with trace(d):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            _, by_name = device_busy(Path(d) / "trace.json")
        mine = {name: v / reps for name, v in by_name.items() if "hgmm::" in name}
        if mine:
            return sum(mine.values()), mine
    raise RuntimeError("device_us: three traces without a kernel of the port")


def device_times(np, torch, dev, n) -> dict:
    """Device µs a call (device_us) of em_stats at K = 8 (its kernel and its
    reduce) and of assign at K = 8 and, masked, K = 64 and 512, at n points
    (unit scale) and at 16,384; with the ops call's ms by CUDA events beside
    them."""
    from hgmm_torch import convert, ops
    from hgmm_torch.ops.gaussians import pack_loglik_weights

    if dev.type != "cuda":
        return {}
    reps = 20
    out = {}

    def timed(key, fn):
        us, by_kernel = device_us(fn, reps)
        out[f"{key}_device_us"] = us
        out[f"{key}_device_us_by_kernel"] = {name[:60]: v for name, v in by_kernel.items()}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        out[f"{key}_call_ms"] = start.elapsed_time(end) / reps

    rng = np.random.default_rng(11)
    for tag, nn in (("n%d" % n, n), ("n16384", 16_384)):
        prep = ops.prepare(torch.from_numpy(rng.standard_normal((nn, 3), dtype=np.float32)).to(dev))
        for k in (8, 64, 512):
            W = pack_loglik_weights(convert.mixture_from_numpy(*_unit_mixture(np, k), device=dev))
            if k == 8:
                timed(f"em_stats_K8_{tag}", lambda: ops.em_stats(prep, W))
                timed(f"assign_K8_{tag}", lambda: ops.assign(prep, W))
            else:
                parent = torch.from_numpy(rng.integers(0, k // BRANCH, nn).astype(np.int32)).to(dev)
                timed(f"assign_K{k}_masked_{tag}", lambda: ops.assign(prep, W, parent, BRANCH))
        if nn == n:
            # 8 < K < 64 on the first body's lanes or the tiled body's 64
            # padded rows, beside the tiled body at K = 64.
            for k in (16, 32, 33, 63, 64):
                W = pack_loglik_weights(convert.mixture_from_numpy(*_unit_mixture(np, k), device=dev))
                timed(f"em_stats_K{k}_{tag}", lambda: ops.em_stats(prep, W))
    return out


def pair_counts(np, torch, dev, n) -> dict:
    """Seconds, kernels, copies, memsets and host syncs of one register_pair
    (config2_tree_8x3 at n points) and one odometry pair (config 4 on a
    16,384-point bucket at LiDAR scale), each once warm."""
    import json as _json
    import tempfile
    import time
    import warnings

    import hgmm_torch
    from hgmm_torch.configs.presets import PRESETS
    from hgmm_torch.data.synthetic import lidar_mixture_np, lidar_points_np, make_cloud
    from hgmm_torch.models.se3 import Pose, so3_exp
    from hgmm_torch.pipelines import odometry
    from hgmm_torch.utils.profiling import trace

    if dev.type != "cuda":
        return {}
    p = PRESETS["config2_tree_8x3"]
    kw = dict(model_kind=p.model_kind, branch=p.branch, levels=p.levels, fit_iters=p.fit_iters,
              complexity_threshold=p.complexity_threshold, n_iters=p.reg_iters, method=p.method,
              top_k=p.top_k, outlier_logit=p.outlier_logit)
    cloud = make_cloud(n, "trefoil", seed=4, device=dev)
    gt = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.25], device=dev)), torch.tensor([0.05, -0.04, 0.06], device=dev))
    source = gt.inverse().apply(cloud)
    pts_np, w_np = lidar_points_np(16_384, lidar_mixture_np(512, seed=3, extent=40.0), seed=5, extent=40.0)
    moved = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.02])), torch.tensor([0.3, 0.05, 0.0]))
    frames = [(pts_np, w_np), (moved.apply(torch.from_numpy(pts_np)).numpy(), w_np)]
    cfg = odometry.OdometryConfig(voxel=0.3, device=dev)
    ident = Pose.identity(device=dev)
    runs = {"register_pair": lambda: hgmm_torch.register_pair(
                source, target=cloud, generator=torch.Generator().manual_seed(0), **kw),
            "odometry_pair": lambda: odometry._register_frames(
                frames[0], frames[1], cfg, odometry.frame_generator(0, 0), ident)}
    out = {}
    for name, fn in runs.items():
        fn()
        torch.cuda.synchronize()
        mode = torch.cuda.get_sync_debug_mode()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            torch.cuda.set_sync_debug_mode(mode)
        with tempfile.TemporaryDirectory() as d:
            with trace(d):
                fn()
                torch.cuda.synchronize()
            events = _json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
        for cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            out[f"{name}_{cat}s"] = sum(1 for e in events if e.get("cat") == cat and "dur" in e)
        out[f"{name}_host_syncs"] = sum("synchroniz" in str(w.message) for w in caught)
        out[f"{name}_s"] = wall
    return out


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
