"""hgmm-torch command-line interface: the commands of the JAX package's CLI
(fit-gmm, register, odometry, localize, icp, bench), with the same arguments
and printed lines, run by hgmm_torch on the device that --device names.

    python -m hgmm_torch.cli.main fit-gmm CLOUD [--tree] [--out NPZ] [--device cuda|cpu]
    python -m hgmm_torch.cli.main register SOURCE TARGET [--preset NAME] [--out NPY]
    python -m hgmm_torch.cli.main odometry SEQ_DIR [--poses POSES] [--detect-closures]
                                  [--refine] [--map NPZ] [--checkpoint NPZ] [--metrics JSONL]
    python -m hgmm_torch.cli.main localize SCAN MAP_NPZ [--init NPY] [--out NPY]
    python -m hgmm_torch.cli.main icp SOURCE TARGET [--iters N]
    python -m hgmm_torch.cli.main bench [--trace DIR]

Clouds are .ply, KITTI .bin or .npy files. --device defaults to cuda and
the command fails when CUDA is not available; --device cpu runs the plain
PyTorch path. --sharded (odometry, localize) runs the fits, registrations and
refinement points-sharded over make_mesh(): the default torch.distributed
process group when there is one (under torchrun, every process runs the
command), else a world of one process.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from hgmm_torch.configs.presets import PRESETS

SEED = 0  # of the torch.Generator that draws a fit's initial means


def _load_cloud(path: str, device: torch.device) -> torch.Tensor:
    p = Path(path)
    if p.suffix == ".ply":
        from hgmm_torch.data.ply import load_ply

        pts = load_ply(p)
    elif p.suffix == ".bin":
        from hgmm_torch.data.kitti import load_velodyne_bin

        pts = load_velodyne_bin(p)
    elif p.suffix == ".npy":
        pts = np.load(p)
    else:
        raise SystemExit(f"unsupported cloud format: {p.suffix}")
    return torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).to(device)


def _elapsed(t0: float, device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def cmd_fit_gmm(args) -> None:
    from hgmm_torch.models.gmm import Gmm
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.utils import checkpoint as ckpt

    pts = _load_cloud(args.cloud, args.device)
    t0 = time.perf_counter()
    if args.tree:
        tree, lls = GmmTree.fit(pts, branch=args.branch, levels=args.levels, em_iters=args.iters,
                                generator=_generator())
        ckpt.save_tree(args.out, tree)
        print(f"tree fit: {tree.n_leaves} leaves, loglik/level={lls.cpu().numpy()}")
    else:
        gmm, lls = Gmm.fit(pts, k=args.k, n_iters=args.iters, generator=_generator())
        ckpt.save_mixture(args.out, gmm.params)
        print(f"gmm fit: K={args.k}, final loglik={float(lls[-1]):.2f}")
    print(f"({_elapsed(t0, args.device):.2f}s) saved -> {args.out}")


def cmd_register(args) -> None:
    from hgmm_torch.pipelines.register import register_pair

    preset = PRESETS[args.preset]
    source = _load_cloud(args.source, args.device)
    target = _load_cloud(args.target, args.device)
    t0 = time.perf_counter()
    res = register_pair(
        source,
        target=target,
        model_kind=preset.model_kind,
        k=preset.k,
        branch=preset.branch,
        levels=preset.levels,
        fit_iters=preset.fit_iters,
        complexity_threshold=(
            preset.complexity_threshold
            if args.complexity_threshold is None
            else args.complexity_threshold
        ),
        generator=_generator(),
        n_iters=preset.reg_iters,
        method=preset.method,
        top_k=preset.top_k,
        outlier_logit=preset.outlier_logit,
    )
    dt = _elapsed(t0, args.device)
    T = res.pose.matrix().cpu().numpy()
    print(f"converged={bool(res.converged)} in {dt:.2f}s; transform:")
    print(T)
    if args.out:
        np.save(args.out, T)
        print(f"saved -> {args.out}")
    if args.export_aligned:
        from hgmm_torch.viz.export import export_alignment

        export_alignment(args.export_aligned, source, target, res.pose)
        print(f"aligned clouds -> {args.export_aligned}")


def _outlier_logit(value: float) -> float | None:
    return None if value != value else value  # nan disables


def _mesh(args):
    """make_mesh() on --device with --sharded, else None."""
    if not args.sharded:
        return None
    from hgmm_torch.parallel import make_mesh

    return make_mesh(args.device)


def cmd_odometry(args) -> None:
    from hgmm_torch.data.kitti import (
        load_calib_velo_to_cam,
        load_poses,
        load_velodyne_bin,
        sequence_scan_paths,
    )
    from hgmm_torch.pipelines.odometry import OdometryConfig, refine_odometry, run_odometry
    from hgmm_torch.utils.profiling import MetricsLog

    mesh = _mesh(args)
    paths = sequence_scan_paths(args.sequence)
    if args.max_frames:
        paths = paths[: args.max_frames]
    scans = (load_velodyne_bin(p) for p in paths)
    cfg = OdometryConfig(
        model_kind=args.model,
        voxel=args.voxel,
        bucket=args.bucket,
        fit_iters=args.fit_iters,
        reg_iters=args.reg_iters,
        complexity_threshold=args.complexity_threshold,
        outlier_logit=_outlier_logit(args.outlier_logit),
        device=args.device,
    )
    metrics = MetricsLog(args.metrics) if args.metrics else None
    t0 = time.perf_counter()
    res = run_odometry(scans, cfg, checkpoint_path=args.checkpoint, checkpoint_every=10,
                       metrics=metrics, mesh=mesh, detect_closures=args.detect_closures)
    dt = _elapsed(t0, args.device)
    if res.closures is not None:
        pairs = list(zip(res.closures.i.tolist(), res.closures.j.tolist()))
        print(f"loop closures accepted: {pairs}")
    final_poses = res.abs_poses
    if args.refine:
        refined = refine_odometry(res, mesh=mesh)
        final_poses = refined.poses()
        traj = refined.t.cpu().numpy()
    else:
        traj = torch.stack([p.t for p in res.abs_poses]).cpu().numpy()
    out = args.out or "trajectory.npy"
    np.save(out, traj)
    print(f"{len(res.abs_poses)} poses in {dt:.1f}s -> {out}")

    if args.map:
        # Fuse the scans by the final poses into one global GMM-tree map;
        # reload it with utils.checkpoint.load_tree and localize new scans
        # against it. The scans are read again rather than held through the
        # run (a KITTI sequence is GBs); --voxel 0 passes through as 0.
        from hgmm_torch.pipelines.mapping import MapConfig, build_map
        from hgmm_torch.utils import checkpoint as ckpt

        tree = build_map([load_velodyne_bin(p) for p in paths], final_poses,
                         MapConfig(voxel=args.voxel), mesh=mesh)
        ckpt.save_tree(args.map, tree)
        print(f"global map ({tree.n_leaves} leaves) -> {args.map}")

    calib_path = args.calib or (Path(args.sequence) / "calib.txt")
    if args.plot:
        from hgmm_torch.viz.export import export_trajectory

        gt_traj = None
        if args.poses:
            from hgmm_torch.eval.metrics import kitti_gt_trajectory

            gt_traj = kitti_gt_trajectory(load_poses(args.poses, args.device),
                                          load_calib_velo_to_cam(calib_path, args.device))[: len(final_poses)]
        export_trajectory(args.plot, res.abs_poses, gt_poses=gt_traj,
                          refined_poses=(final_poses if args.refine else None),
                          closures=res.closures)
        print(f"trajectory plot -> {args.plot}")

    if args.poses:
        # ATE of the trajectory written out: refined with --refine, the
        # dead-reckoned chain otherwise.
        from hgmm_torch.eval.metrics import kitti_ate

        err = float(kitti_ate(final_poses, load_poses(args.poses, args.device),
                              load_calib_velo_to_cam(calib_path, args.device)))
        print(f"ATE vs ground truth: {err:.4f} m over {len(final_poses)} frames")
        if metrics is not None:
            metrics.log({"event": "ate", "ate_m": err, "frames": len(final_poses), "wall_s": dt,
                         "refined": bool(args.refine)})


def cmd_localize(args) -> None:
    """Relocalize a scan against a saved global map (pipelines.mapping)."""
    from hgmm_torch.convert import pose_from_numpy
    from hgmm_torch.pipelines.mapping import localize
    from hgmm_torch.utils import checkpoint as ckpt

    mesh = _mesh(args)
    tree = ckpt.load_tree(args.map, device=args.device)
    scan = _load_cloud(args.scan, args.device)
    init = None
    if args.init:
        T = np.load(args.init)
        init = pose_from_numpy(T[:3, :3], T[:3, 3], args.device)
    t0 = time.perf_counter()
    res = localize(scan, tree, init_pose=init, mesh=mesh, n_iters=args.iters,
                   outlier_logit=_outlier_logit(args.outlier_logit))
    dt = _elapsed(t0, args.device)
    T = res.pose.matrix().cpu().numpy()
    print(f"converged={bool(res.converged)} in {dt:.2f}s; scan->map transform:")
    print(T)
    if args.out:
        np.save(args.out, T)
        print(f"saved -> {args.out}")


def cmd_icp(args) -> None:
    from hgmm_torch.baselines.icp import icp

    source = _load_cloud(args.source, args.device)
    target = _load_cloud(args.target, args.device)
    res = icp(source, target, n_iters=args.iters)
    print(res.pose.matrix().cpu().numpy())
    print(f"final match rmse: {float(res.rmse_history[-1]):.6f}")


def cmd_bench(args) -> None:
    """The headline E+M sweep benchmark (hgmm_torch.bench): one JSON line."""
    from hgmm_torch.bench import run_bench

    run_bench(trace_dir=args.trace, device=args.device, n=args.n, k=args.k, sweeps=args.sweeps)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hgmm-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda: the CUDA kernels (fails without a card); cpu: the plain PyTorch path",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit-gmm", parents=[common], help="fit a flat GMM or GMM-tree to a cloud")
    f.add_argument("cloud")
    f.add_argument("--out", default="mixture.npz")
    f.add_argument("--tree", action="store_true")
    f.add_argument("--k", type=int, default=64)
    f.add_argument("--branch", type=int, default=8)
    f.add_argument("--levels", type=int, default=3)
    f.add_argument("--iters", type=int, default=20)
    f.set_defaults(fn=cmd_fit_gmm)

    r = sub.add_parser("register", parents=[common], help="register source cloud onto target")
    r.add_argument("source")
    r.add_argument("target")
    r.add_argument("--preset", default="config2_tree_8x3", choices=sorted(PRESETS))
    r.add_argument(
        "--complexity-threshold", type=float, default=None,
        help="adaptive-cut threshold override (0 = pure leaves)",
    )
    r.add_argument("--out", default=None)
    r.add_argument("--export-aligned", default=None)
    r.set_defaults(fn=cmd_register)

    o = sub.add_parser("odometry", parents=[common], help="KITTI sequence odometry")
    o.add_argument("sequence", help="KITTI sequence dir (with velodyne/)")
    o.add_argument("--max-frames", type=int, default=None)
    o.add_argument("--model", choices=("tree", "flat"), default="tree",
                   help="per-frame target model")
    o.add_argument("--voxel", type=float, default=0.3)
    o.add_argument("--bucket", type=int, default=16384)
    o.add_argument("--fit-iters", type=int, default=10)
    o.add_argument("--reg-iters", type=int, default=30)
    o.add_argument("--complexity-threshold", type=float, default=0.0)
    o.add_argument("--outlier-logit", type=float, default=-8.0,
                   help="uniform outlier log-density (see OdometryConfig); nan disables")
    o.add_argument("--checkpoint", default=None)
    o.add_argument("--refine", action="store_true",
                   help="pose-graph refinement of the chain (+ detected closures)")
    o.add_argument("--detect-closures", action="store_true",
                   help="propose + registration-verify loop closures, feed --refine")
    o.add_argument("--sharded", action="store_true",
                   help="run fits/registrations/refinement points-sharded over make_mesh() (config "
                   "5; the Schur pose-graph path for --refine; under torchrun, the run's process "
                   "group)")
    o.add_argument("--out", default=None)
    o.add_argument("--map", default=None, metavar="NPZ",
                   help="fuse scans by the final poses into a global GMM-tree map and save it "
                   "(localize new scans against it with the localize command)")
    o.add_argument("--plot", default=None, metavar="PNG",
                   help="top-down trajectory plot (odometry vs refined vs ground truth, "
                   "closure chords)")
    o.add_argument("--poses", default=None, help="KITTI poses.txt for ATE eval")
    o.add_argument("--calib", default=None, help="calib.txt (default: sequence dir)")
    o.add_argument("--metrics", default=None, help="JSONL metrics sink path")
    o.set_defaults(fn=cmd_odometry)

    lz = sub.add_parser("localize", parents=[common],
                        help="relocalize a scan against a saved global map")
    lz.add_argument("scan", help="scan cloud (.bin/.ply/.npy)")
    lz.add_argument("map", help="map .npz from `odometry --map`")
    lz.add_argument("--init", default=None,
                    help=".npy 4x4 initial transform guess (e.g. last known pose)")
    lz.add_argument("--iters", type=int, default=40)
    lz.add_argument("--outlier-logit", type=float, default=-8.0,
                    help="uniform outlier log-density; nan disables (scans usually see "
                    "unmapped geometry — keep gating on)")
    lz.add_argument("--sharded", action="store_true",
                    help="register points-sharded over make_mesh()")
    lz.add_argument("--out", default=None, help="save the 4x4 transform (.npy)")
    lz.set_defaults(fn=cmd_localize)

    i = sub.add_parser("icp", parents=[common], help="ICP baseline registration")
    i.add_argument("source")
    i.add_argument("target")
    i.add_argument("--iters", type=int, default=30)
    i.set_defaults(fn=cmd_icp)

    from hgmm_torch.bench import add_arguments as add_bench_arguments

    b = sub.add_parser("bench", parents=[common],
                       help="headline E+M sweep benchmark: one JSON line")
    add_bench_arguments(b)
    b.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: CUDA is not available (--device cpu runs the plain PyTorch path)")
    args.device = torch.device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
