"""Two trees' kernels on the same card, in one process each: outputs and times.

    python hgmm_torch/benchmarks/kernel_compare.py --root TREE --save A.pt [--device cpu] [--n N]
        [--probes-only | --scan-only]
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
- ``reg_stats`` at K = 8, 64, 384, 512 (outlier -8), K = 64 with top_k = 8
  and K = 512 with top_k = 8 and 32 (outlier 0: both register-list bodies),
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
32, 33, 63 and 64 and the gated ``reg_stats`` calls at N (in trees whose plan
has the top_k body's chunk, ``chunk_times``: that body at each chunk size
too); the two step kernels by their parts (``step_times``:
``reg_step`` on 528 rows and on one, Horn and WLS, an iteration's middle and
last step, a done scan, each also back to back in a CUDA graph; a fit's sweep
by kernel); and of two pairs, each
with its kernels, copies and memsets (profiler) and host syncs (torch's sync
debug mode): ``register_pair`` (config2_tree_8x3) at N and one odometry pair
(config 4's tree fit and registration on the bucket). ``--diff`` prints, for
every output of the two files, ``bit-equal`` or the largest gap.

A level's registration scan (``scan_outputs``, alone with ``--scan-only``):
at the levels of ``dragon_to_map`` (K = 8, 64 and the cut's, no gate) and of
``dragon_config3_topk`` (K = 64, 512, top_k 8, outlier 0), run as the
pipeline runs it (``run_registration_scan``: in a tree with ``ops.reg_scan``
one host call a level) and as the step loop of the wrappers driven from
Python; the state and outputs of both are saved, and the host µs a step of
each timed. ``--scan-only`` needs no ``ops.reg_scan`` in TREE (the pipeline
path then steps from Python), so this script compares a parent without the
one call against the working tree (``--root``).

The unit-rate probes (``probe_times``, alone with ``--probes-only``): at the
two MXU shapes (K = 512, T = 2048 and K = 64, T = 8192) every probe's output
at 3 x 6 and 1,024 x 6 products (the bf16 logits, stats and norm also with
A = 0, norm also with a random A: ``norm_operands``) is saved, and the bf16
logits', stats' and norm's are held to their plain versions within PROBE_TOL
(``probe_twin_gaps``: their tensor cores' sum order is their own); device µs a call (device_us) at 1,024 x 2 and 1,024 x 6 products
(vpu, exp2 and cast modes: 512 x 512, 2,048 x 4 and 2,048 x 8), the bound and its share, and the
library's yardstick: the same 1,024 x 6 ``torch.matmul`` calls in one CUDA
graph (graph_us).
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
# The unit-rate probes: the MXU shapes, the loops saved and timed, and the
# bf16 tolerance against the plain versions (chip_smoke.PROBE_TOL["bf16"]:
# rtol, atol as a share of the largest |reference|) plus 2^-24 for each of
# the float32 adds of a long loop (chip_smoke.probe_checks' chain).
PROBE_SHAPES = ((512, 2048), (64, 8192))
PROBE_SAVED = ((3, 6), (1024, 6))
PROBE_TIMED = ((1024, 2), (1024, 6))
VPU_TIMED = ((2048, 4), (2048, 8))
PROBE_TOL_BF16 = (2e-3, 1e-4)
MAX_SHARE = 1.05  # of a bound: above it a reading is a wrong count (chip_smoke.MAX_SHARE)


def run(root: Path, device, n: int = N, bench_n: int = BENCH_N, bench_k: int = BENCH_K,
        probes_only: bool = False, scan_only: bool = False) -> tuple[dict, dict]:
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
    if probes_only or scan_only:
        out, times = probe_times(torch, dev) if probes_only else scan_outputs(np, torch, dev, n)
        return {name: tuple(t.cpu() for t in ts) for name, ts in out.items()}, times
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
    times.update(chunk_times(np, torch, dev, n))
    times.update(step_times(np, torch, dev, n))
    times.update(pair_counts(np, torch, dev, n))
    scan_out, scan_t = scan_outputs(np, torch, dev, n)
    out.update(scan_out)
    times.update(scan_t)
    probe_out, probe_t = probe_times(torch, dev)
    out.update(probe_out)
    times.update(probe_t)
    return {name: tuple(t.cpu() for t in ts) for name, ts in out.items()}, times


def reg_inputs(np, torch, convert, dev, pts, extent=None):
    """reg_stats arguments by key: K = 8, 64, 384, 512 (outlier -8), K = 64
    with top_k = 8 and K = 512 with top_k = 8 and 32 (outlier 0), at a fixed
    pose."""
    from hgmm_torch.models.se3 import so3_exp
    from hgmm_torch.ops.gaussians import pack_loglik_weights, precision_terms, sym_pack
    from hgmm_torch.data.synthetic import lidar_mixture_np

    pose = (so3_exp(torch.tensor([0.02, -0.03, 0.05], device=dev)), torch.tensor([0.05, 0.0, -0.02], device=dev))
    out = {}
    for k, top_k, outlier in ((8, None, -8.0), (64, None, -8.0), (384, None, -8.0), (512, None, -8.0),
                              (64, 8, 0.0), (512, 8, 0.0), (512, 32, 0.0)):
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
            for key, (args, kw) in reg_inputs(np, torch, convert, dev, prep.points).items():
                if kw["top_k"] is not None:  # the gated body, its tables and its reduce
                    timed(f"reg_stats_{key}_{tag}", lambda: ops.reg_stats(prep, *args, **kw))
    return out


def chunk_times(np, torch, dev, n) -> dict:
    """Device µs a launch (device_us) of reg_stats' top_k body at each chunk
    size of the tree's fused_em.RS_CHUNKS, forced through the plan, at the
    gated reg_inputs at n points (unit scale), beside the plan's own chunk;
    {} in a tree without it or off the card."""
    import dataclasses

    from hgmm_torch import convert, ops
    from hgmm_torch.ops import fused_em

    if dev.type != "cuda" or not hasattr(fused_em, "RS_CHUNKS"):
        return {}
    rng = np.random.default_rng(13)
    pts = torch.from_numpy(rng.standard_normal((n, 3), dtype=np.float32)).to(dev)
    prep = ops.prepare(pts)
    out = {}
    for key, ((W, mu, A6, b3, pose), kw) in reg_inputs(np, torch, convert, dev, pts).items():
        if kw["top_k"] is None:
            continue
        tab = fused_em.reg_tables(prep.pts4, W, mu, A6, b3, **kw)
        pose12 = torch.cat([pose[0].reshape(9), pose[1]]).contiguous()
        out[f"reg_stats_{key}_plan_chunk"] = tab.plan.chunk
        plan = tab.plan
        for chunk in fused_em.RS_CHUNKS:
            tab.plan = dataclasses.replace(plan, chunk=chunk)
            us, _ = device_us(lambda: fused_em.reg_partials(tab, pose12))
            out[f"reg_stats_{key}_chunk{chunk}_device_us"] = us
        tab.plan = plan
    return out


def graph_us(torch, fn, calls: int = 1, replays: int = 10, launches: dict | None = None) -> float:
    """Device µs a call of fn() when `calls` calls run back to back from one
    CUDA graph, with no host work between the launches: CUDA events around
    `replays` replays of the graph, over replays x calls. Beside a kernel's
    own time (device_us) it gives what a launch adds on the card. `launches`,
    the port's launch counts (ops.fused_em.LAUNCHES): a replay runs the
    captured kernels without calling their wrappers, so what the capture
    counted is counted again for each timed replay (the capture's own count
    stands for the replay that follows it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    before = dict(launches or {})
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    captured = {name: launches[name] - n for name, n in before.items()}
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    for name, n in captured.items():
        launches[name] += n * replays
    return start.elapsed_time(end) * 1e3 / (replays * calls)


def step_times(np, torch, dev, n) -> dict:
    """The two step kernels by their parts. reg_step, device µs a launch
    (device_us) and a launch's µs back to back in a CUDA graph (graph_us):
    the [nb, 59] partials of reg_stats at K = 8 on n points (528 rows on the
    H100) against the same sum in one row (nb = 1), and at the odometry
    bucket (16,384 points, lanes); Horn against WLS; an iteration's middle
    step against its last (se3_log, the outputs); and a step on a done scan
    (the launch, one read, nothing else); in a tree whose plan takes a
    cluster past 256 rows, the 528 rows also on one plain block. A fit's sweep, device µs by kernel
    a sweep: the flat K = 8 sweep at n and at 16,384 points and the grouped
    K = 64 one at n, through models.gmm.em_sweeps as a fit runs them; a sweep
    from a graph of a fit's launches (2s sweeps less s, over s); and, in a
    tree whose em_step reads partial rows, em_step on the flat sweep's rows
    against the same sums as one row."""
    from hgmm_torch import convert, ops
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import em_sweeps, init_params, scene_variance, total_weight
    from hgmm_torch.models.gmm_tree import seed_children
    from hgmm_torch.ops import em_ref, fused_em

    if dev.type != "cuda":
        return {}
    out = {}
    rng = np.random.default_rng(17)
    for tag, nn in (("n%d" % n, n), ("n16384", 16_384)):
        pts = torch.from_numpy(rng.standard_normal((nn, 3), dtype=np.float32)).to(dev)
        (W, mu, A6, b3, pose), _ = reg_inputs(np, torch, convert, dev, pts)["K8"]
        prob = fused_em.reg_tables(ops.prepare(pts).pts4, W, mu, A6, b3)
        part = ops.reg_partials(prob, ops.new_scan(prob, pose[0], pose[1], 1)).partial.clone()
        parts = {f"nb{part.shape[0]}": fused_em.reg_rows(part)}
        if nn == n:
            parts["nb1"] = fused_em.reg_rows(part.double().sum(0, keepdim=True).float())
        for nb, p in parts.items():
            for solver, sname in ((0, "horn"), (1, "wls")):
                for last in (False, True):
                    if nn != n and not last:
                        continue
                    scan = ops.new_scan(prob, pose[0], pose[1], 2)
                    fn = lambda: ops.reg_step(p, scan, 1, solver, False, last, 0.0)  # noqa: E731
                    key = f"reg_step_{sname}_{nb}_{'last' if last else 'mid'}_{tag}"
                    out[f"{key}_device_us"] = device_us(fn)[0]
                    out[f"{key}_graph_us"] = graph_us(torch, fn, calls=20)
        if nn == n and fused_em.plan_reg_step(part.shape[0]) > 1:
            # The same 528 rows on one plain block: the C entry's blocks = 1
            # where the plan takes a cluster past 256 rows.
            one_block = parts[f"nb{part.shape[0]}"]._replace(cluster=1)
            for solver, sname in ((0, "horn"), (1, "wls")):
                for last in (False, True):
                    scan = ops.new_scan(prob, pose[0], pose[1], 2)
                    fn = lambda: ops.reg_step(one_block, scan, 1, solver, False, last, 0.0)  # noqa: E731
                    key = f"reg_step_{sname}_nb{part.shape[0]}_one_block_{'last' if last else 'mid'}_{tag}"
                    out[f"{key}_device_us"] = device_us(fn)[0]
                    out[f"{key}_graph_us"] = graph_us(torch, fn, calls=20)
        if nn == n:
            scan = ops.new_scan(prob, pose[0], pose[1], 2)
            scan.state[em_ref.SCAN_DONE] = 1.0  # the kernel reads the flag and returns
            fn = lambda: ops.reg_step(parts[f"nb{part.shape[0]}"], scan, 1, 1, False, True, 0.0)  # noqa: E731
            out[f"reg_step_done_{tag}_device_us"] = device_us(fn)[0]
            out[f"reg_step_done_{tag}_graph_us"] = graph_us(torch, fn, calls=20)

    sweeps = 10
    for tag, nn in (("n%d" % n, n), ("n16384", 16_384)):
        pts = make_cloud(nn, "trefoil", seed=4, device=dev)
        prep = ops.prepare(pts)
        total, cf = total_weight(pts, None), 1e-4 * scene_variance(pts)
        init = init_params(pts, 8, torch.Generator().manual_seed(0))
        cases = {"flat_K8": (prep, init)}
        if nn == n:
            level0 = em_sweeps(prep, init, sweeps, total, cf)
            cases["grouped_K64"] = (ops.group_by_parent(prep, ops.assign(prep, level0.table), 8, 64),
                                    seed_children(level0.params, 8))
        for name, (data, start) in cases.items():
            key = f"sweep_{name}_{tag}"
            us, by_kernel = device_us(lambda: em_sweeps(data, start, sweeps, total, cf))
            out[f"{key}_device_us"] = us / sweeps
            out[f"{key}_device_us_by_kernel"] = {k[:60]: v / sweeps for k, v in by_kernel.items()}
            one, two = (graph_us(torch, lambda s=s: em_sweeps(data, start, s, total, cf))
                        for s in (sweeps, 2 * sweeps))
            out[f"{key}_graph_us"] = (two - one) / sweeps
            if name == "flat_K8":
                fit = ops.new_fit(data, start, 1, total, cf)
                rows = ops.em_partials(fit)
                one_row = fused_em.em_rows(em_ref.partials_of(em_ref.sum_partials(rows)), fit)
                for label, parts in ((f"nb{rows.n_rows}", rows), ("nb1", one_row)):
                    fn = lambda parts=parts: ops.em_step(parts, fit, 0)  # noqa: E731
                    out[f"em_step_{label}_{tag}_device_us"] = device_us(fn)[0]
    return out


SCAN_ITERS, SCAN_METHOD, SCAN_INNER, SCAN_TOL = 50, "horn+wls", 2, 1e-7  # the presets' scan
SCAN_REPS = 5


def scan_outputs(np, torch, dev, n) -> tuple[dict, dict]:
    """One level's scan from the identity, on n trefoil points moved by a
    fixed pose, onto a tree (8 x 3, 12 sweeps) fitted to them on `dev`: at
    `dragon_to_map`'s levels (K = 8, 64, and the cut at 0.02; no gate, no
    outlier) and `dragon_config3_topk`'s gated ones (K = 64, 512, top_k 8,
    outlier 0), SCAN_ITERS iterations of SCAN_METHOD. Two paths from tables
    and a state made alike: "pipeline", run_registration_scan as register_tree
    calls it, and "loop", ops.reg_partials and ops.reg_step a step from
    Python. Outputs: each path's state, logliks and deltas, and the tree's
    levels (the inputs). Times: host µs a step (the call to its return) and
    wall µs a step (to the sync after it), medians of SCAN_REPS runs, and
    whether the two paths' outputs are bit-equal in this tree."""
    import statistics
    import time

    from hgmm_torch import ops
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.models.se3 import Pose, so3_exp
    from hgmm_torch.ops.em_ref import SCAN_LIVE
    from hgmm_torch.pipelines.register import run_registration_scan

    target = make_cloud(n, "trefoil", seed=4, device=dev)
    moved = Pose(so3_exp(torch.tensor([0.03, -0.05, 0.04], device=dev)), torch.tensor([0.02, 0.0, -0.01], device=dev))
    source = moved.apply(target)
    tree, _ = GmmTree.fit(target, branch=BRANCH, levels=3, em_iters=12, generator=torch.Generator().manual_seed(0))
    cut = tree.cut_mixture(0.02)
    levels = {"map_K8": (tree.levels[0], None, None), "map_K64": (tree.levels[1], None, None),
              f"map_K{cut.k}_cut": (cut, None, None), "topk8_K64": (tree.levels[1], 8, 0.0),
              "topk8_K512": (tree.levels[2], 8, 0.0)}
    prep = ops.prepare(source)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    n_horn = SCAN_ITERS // 2
    steps = n_horn + (SCAN_ITERS - n_horn) * SCAN_INNER
    # The step loop's rule written out here, not taken from the tree, so that
    # the "loop" path is the same in a tree without scan_schedule.
    schedule = [(it, 0, True, True) if it < n_horn else (it, 1, s == 0, s == SCAN_INNER - 1)
                for it in range(SCAN_ITERS) for s in range(1 if it < n_horn else SCAN_INNER)]

    def pipeline(problem):
        return run_registration_scan(problem, eye, zero, SCAN_ITERS, SCAN_METHOD, SCAN_TOL, SCAN_INNER)

    def loop(problem):
        scan = ops.new_scan(problem, eye, zero, SCAN_ITERS)
        for it, solver, first, last in schedule:
            ops.reg_step(ops.reg_partials(problem, scan), scan, it, solver, first, last, SCAN_TOL)
        return scan

    out = {f"scan_tree_level{i}": tuple(p) for i, p in enumerate(tree.levels)}
    times = {"scan_steps": steps}
    for key, (params, top_k, outlier) in levels.items():
        problem = ops.reg_problem_of(prep, params, top_k, outlier)
        (R, t, done), lls, deltas = pipeline(problem)
        scan = loop(problem)
        out[f"scan_{key}_pipeline"] = (R, t, done, lls, deltas)
        out[f"scan_{key}_loop"] = (*scan.pose, scan.done, scan.logliks, scan.deltas, scan.state)
        times[f"scan_{key}_paths_bit_equal"] = all(
            torch.equal(a, b) for a, b in zip(out[f"scan_{key}_pipeline"], out[f"scan_{key}_loop"]))
        times[f"scan_{key}_live_steps"] = float(scan.state[SCAN_LIVE])
        for path, fn in (("pipeline", pipeline), ("loop", loop)):
            host, wall = [], []
            for _ in range(SCAN_REPS + 1):
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(problem)
                t1 = time.perf_counter()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                host.append((t1 - t0) * 1e6 / steps)
                wall.append((time.perf_counter() - t0) * 1e6 / steps)
            times[f"scan_{key}_{path}_host_us_a_step"] = statistics.median(host[1:])
            times[f"scan_{key}_{path}_wall_us_a_step"] = statistics.median(wall[1:])
    return out, times


def norm_operands(torch, k: int, dev) -> dict:
    """The norm probe's A operands [8, K] bf16 beside make_inputs' all-ones
    one: "random", seeded standard normal (it varies along K and between
    rows, so a mix-up of the kernel's K-major B tiles or of its output rows
    shows), and "zero" (the result is then every rep's eps_r times e's
    column sums)."""
    g = torch.Generator().manual_seed(k)
    rand = torch.randn(8, k, generator=g).to(torch.bfloat16).to(dev)
    return {"random": rand, "zero": torch.zeros_like(rand)}


def probe_times(torch, dev) -> tuple[dict, dict]:
    """The unit-rate probes at the MXU shapes: (outputs by name, times). See
    the module's docstring. Needs only what every tree since the probes
    were ported has (ops.probes, mxu_microbench.make_inputs, kernel_bound)."""
    from hgmm_torch.benchmarks.mxu_microbench import make_inputs
    from hgmm_torch.eval.roofline import kernel_bound
    from hgmm_torch.ops import _build, probes

    out, times, gaps = {}, {}, {}
    on_card = dev.type == "cuda"
    for k, t in PROBE_SHAPES:
        ins = make_inputs(k, t, dev)
        phi32, phi32_f = ins["phi"][:32], ins["phi_f32"][:32]
        zero_wt, zero_phi32 = torch.zeros_like(ins["wt"]), torch.zeros_like(phi32)
        other = norm_operands(torch, k, dev)
        norm_a = {"norm_bf16": ins["ones"], "norm_bf16_zero_a": other["zero"],
                  "norm_bf16_random": other["random"]}
        calls = {  # name: (probe call of (steps, reps), its plain version or None)
            "logits_bf16": (lambda s, r: probes.logits(ins["wt"], ins["phi"], s, r),
                            lambda s, r: probes.logits_ref(ins["wt"], ins["phi"], s, r)),
            "stats_bf16": (lambda s, r: probes.stats(phi32, ins["e"], s, r),
                           lambda s, r: probes.stats_ref(phi32, ins["e"], s, r)),
            "logits_bf16_zero_a": (lambda s, r: probes.logits(zero_wt, ins["phi"], s, r),
                                   lambda s, r: probes.logits_ref(zero_wt, ins["phi"], s, r)),
            "stats_bf16_zero_a": (lambda s, r: probes.stats(zero_phi32, ins["e"], s, r),
                                  lambda s, r: probes.stats_ref(zero_phi32, ins["e"], s, r)),
            "logits_f32": (lambda s, r: probes.logits(ins["wt_f32"], ins["phi_f32"], s, r), None),
            "stats_f32": (lambda s, r: probes.stats(phi32_f, ins["e_f32"], s, r), None),
            **{name: (lambda s, r, a=a: probes.norm(a, ins["e"], s, r),
                      lambda s, r, a=a: probes.norm_ref(a, ins["e"], s, r)) for name, a in norm_a.items()},
            "addonly": (lambda s, r: probes.addonly(ins["x"], s, r), None),
        }
        if k * t >= 512 * 512:  # vpu_microbench's 512 x 512 elements
            x_vpu = ins["x"].reshape(-1)[: 512 * 512].reshape(512, 512).clamp(-1.5, -0.5)
            calls.update({"vpu_exp2": (lambda s, r: probes.vpu(x_vpu, s, r, "exp2"), None),
                          "vpu_cast": (lambda s, r: probes.vpu(x_vpu, s, r, "cast"), None)})
        for name, (fn, plain) in calls.items():
            for steps, reps in PROBE_SAVED if on_card else ((1, 2),):
                key = f"probe_{name}_K{k}_T{t}_{steps}x{reps}"
                got = fn(steps, reps)
                out[key] = (got,)
                if plain is not None:
                    ref = plain(steps, reps)
                    top = float(ref.abs().max())
                    chain = steps * reps * 2.0 ** -24 if steps > 3 else 0.0
                    rtol, arel = PROBE_TOL_BF16
                    excess = float(((got - ref).abs() - (arel + chain) * top
                                    - (rtol + chain) * ref.abs()).max())
                    gaps[key] = {"max_abs_gap": float((got - ref).abs().max()), "max_abs_ref": top,
                                 "within_probe_tol": excess <= 0.0}
        if not on_card:
            continue
        tag = f"K{k}_T{t}"
        bound_shape = dict(k=k, t=t)
        for name, kernel, dtype, fn, lib in (
                ("logits_bf16", "probe_logits", "bf16", calls["logits_bf16"][0], (ins["wt"], ins["phi"])),
                ("stats_bf16", "probe_stats", "bf16", calls["stats_bf16"][0], (phi32, ins["e"].T)),
                ("logits_f32", "probe_logits", "f32", calls["logits_f32"][0], None),
                ("stats_f32", "probe_stats", "f32", calls["stats_f32"][0], None),
                ("norm_bf16", "probe_norm", None, calls["norm_bf16"][0], (ins["ones"], ins["e"])),
                ("addonly", "probe_addonly", None, calls["addonly"][0], None),
                ("vpu_exp2", "probe_vpu", None, calls.get("vpu_exp2", (None,))[0], None),
                ("vpu_cast", "probe_vpu", None, calls.get("vpu_cast", (None,))[0], None)):
            if fn is None:
                continue
            loops = VPU_TIMED if kernel == "probe_vpu" else PROBE_TIMED
            for steps, reps in loops:
                key = f"probe_{name}_{tag}_{steps}x{reps}"
                extra = ({"dtype": dtype} if dtype else {"mode": name[4:]} if kernel == "probe_vpu"
                         else {})
                shape = dict(k=512, t=512) if kernel == "probe_vpu" else bound_shape
                kb = kernel_bound(kernel, steps=steps, reps=reps, **shape, **extra)
                # A trace that lost a kernel record reads below the bound: take it again.
                for _ in range(3):
                    us, by_kernel = device_us(lambda: fn(steps, reps), reps=5)
                    if kb.seconds * 1e6 / us <= MAX_SHARE:
                        break
                else:
                    raise RuntimeError(f"{key}: {us} µs a call, below its bound {kb.seconds * 1e6} µs")
                times[f"{key}_device_us"] = us
                times[f"{key}_device_us_by_kernel"] = {nm[:60]: v for nm, v in by_kernel.items()}
                times[f"{key}_bound_us"] = kb.seconds * 1e6
                times[f"{key}_share_of_bound"] = kb.seconds * 1e6 / us
            if lib is not None:
                steps, reps = PROBE_TIMED[-1]
                a, b = lib
                res = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=dev)
                per_call = graph_us(torch, lambda: torch.matmul(a, b, out=res), calls=steps * reps, replays=2)
                times[f"probe_{name}_{tag}_{steps}x{reps}_library_graph_us"] = per_call * steps * reps
    times["probe_twin_gaps"] = gaps
    times["probe_plans"] = {f"{name}_K{k}_T{t}": str(plan(k, t, _build.sms(dev)))
                            for k, t in PROBE_SHAPES if on_card
                            for name, plan in (("logits", lambda k, t, s: probes.plan_logits(k, t, False, s)),
                                               ("stats", lambda k, t, s: probes.plan_stats(k, t, False, s)),
                                               ("norm", probes.plan_norm))}
    return out, times


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
    ap.add_argument("--probes-only", action="store_true", help="run and time the unit-rate probes alone")
    ap.add_argument("--scan-only", action="store_true", help="run and time a level's registration scan alone")
    args = ap.parse_args(argv)
    if (args.save is None) == (args.diff is None):
        ap.error("give either --save FILE or --diff A B")
    if args.diff:
        report = diff(*(torch.load(f) for f in args.diff))
        print(json.dumps({"diff": report}), flush=True)
        return report
    outputs, times = run(args.root.resolve(), args.device, args.n, args.bench_n, args.bench_k,
                         args.probes_only, args.scan_only)
    torch.save(outputs, args.save)
    print(json.dumps({"root": str(args.root), **times}), flush=True)
    return times


if __name__ == "__main__":
    main()
