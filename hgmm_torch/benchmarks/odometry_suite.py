"""End-to-end odometry throughput with a per-phase breakdown (config 4).

    python -m hgmm_torch.benchmarks.odometry_suite [--frames 64] [--bucket 16384]
        [--model tree|flat] [--sharded] [--skip-e2e] [--trace DIR] [--device cuda|cpu]

Counterpart of ``benchmarks/odometry_suite.py``: a ~64-frame synthetic
KITTI-scale loop (``make_sequence``) driven through the odometry pipeline
(tree model, bucket 16,384 by default), one JSON line a phase:

  fit          the per-frame target-model fits (``_fit_frame_model``)
  register     the pair registrations onto the previous frame's model,
               warm-started as ``run_odometry`` chains them
  closures     ``detect_loop_closures`` (proposal + verification by
               registration, its own fits)
  refine       pose-graph refinement, warmed once then timed (dense, or the
               distributed Schur solver with --sharded)
  map_build    ``build_map`` of the refined trajectory (fused bucket 2^18)
  localize     ``localize`` of the middle frame against that map
  phases_total fit + register + closures + refine, frames a second
  e2e          one ``run_odometry(detect_closures=True)`` + ``refine_odometry``
               (the frames a second a user gets)

Each phase ends in ``utils.timing.sync`` and is timed by the host clock (the
honest user-facing number). The records keep the reference's keys (less its
tunnel round trip, which the port has no tunnel for), with
``dispatched_calls`` by the reference's count of programs, and add
``launches``: the hand-written kernels the phase launched, by name
(``ops.fused_em.LAUNCHES``; none on the CPU), and, in ``localize``,
``init_vs_refined_t``: the dead-reckoned starting pose's distance to the
refined one, beside the result's ``err_vs_refined_t``. With --trace DIR each phase
also runs under a device-only profiler trace (DIR/<phase>/trace.json; CUPTI
records the kernels, copies and memsets, not the host's ops) and its record
gains ``device_busy_s``. --sharded runs every phase over
``parallel.make_mesh`` (a world of one process unless torchrun started more).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from hgmm_torch.utils.device import resolve_device

# The reference's fixed loop geometry (the 64-frame configuration: a 4.58 m
# radius inside an 8 m scene): more frames sample the same loop more densely,
# so frame counts stay comparable.
RADIUS = 0.45 * 64 / (2 * np.pi)
SCENE_SCALE = 8.0
SCENE_MIN_POINTS = 40_000
YAW_AMPLITUDE = 0.25  # rad
BEARING_CUT = 1.7  # rad either side of the sensor's x axis
NOISE = 0.02  # metres


def make_scene(points_per_frame: int, seed: int = 0) -> np.ndarray:
    """[max(40,000, 3 ppf), 3] float32: the trefoil scaled to metres."""
    from hgmm_torch.data.synthetic import make_cloud_np

    return SCENE_SCALE * make_cloud_np(max(SCENE_MIN_POINTS, 3 * points_per_frame), "trefoil", seed)


def sequence_from_scene(scene: np.ndarray, n_frames: int, seed: int = 0):
    """The frames and true poses of the loop through `scene`: frame k is the
    scene in the sensor's frame at angle 2 pi k / n_frames round the loop,
    yawed by 0.25 sin(angle), within +-1.7 rad of bearing, plus 0.02 m of
    noise from np.random.default_rng(seed). Returns ([F] float32 [N_k, 3],
    [F] Pose)."""
    from hgmm_torch.models.se3 import Pose, so3_exp

    scene_t = torch.from_numpy(np.asarray(scene, np.float32))
    rng = np.random.default_rng(seed)
    gt, frames = [], []
    for k in range(n_frames):
        th = 2 * np.pi * k / n_frames
        t = torch.tensor([RADIUS * np.cos(th) - RADIUS, RADIUS * np.sin(th), 0.0], dtype=torch.float32)
        pose = Pose(so3_exp(torch.tensor([0.0, 0.0, YAW_AMPLITUDE * np.sin(th)], dtype=torch.float32)), t)
        gt.append(pose)
        pts = pose.inverse().apply(scene_t).numpy()
        pts = pts[np.abs(np.arctan2(pts[:, 1], pts[:, 0])) < BEARING_CUT]
        pts = pts + NOISE * rng.standard_normal(pts.shape).astype(np.float32)
        frames.append(pts.astype(np.float32))
    return frames, gt


def make_sequence(n_frames: int, points_per_frame: int, seed: int = 0):
    """KITTI-scale synthetic loop: ~0.45 m steps at 64 frames, a ~15 m scene,
    bearing-sector views (the drift-and-revisit structure of the loop-closure
    tests at metric scale)."""
    return sequence_from_scene(make_scene(points_per_frame, seed), n_frames, seed)


class _Phases:
    """Times the phases and prints a record each."""

    def __init__(self, device: torch.device, trace_dir: Path | None, emit):
        self.device = device
        self.trace_dir = trace_dir
        self.emit = emit
        self.records: list[dict] = []

    @contextlib.contextmanager
    def timed(self, name: str, out: dict):
        """Within the block: the phase's work; out gets wall_s (to the
        device's end), launches and, with a trace, device_busy_s."""
        from hgmm_torch.ops import fused_em
        from hgmm_torch.utils.timing import sync

        before = dict(fused_em.LAUNCHES)
        prof = None
        if self.trace_dir is not None:
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        yield
        sync(self.device)
        out["wall_s"] = time.perf_counter() - t0
        if prof is not None:
            from hgmm_torch.utils.profiling import device_busy

            prof.stop()
            path = self.trace_dir / name / "trace.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(path))
            out["device_busy_s"] = device_busy(path)[0] * 1e-6
        out["launches"] = {k: v - before[k] for k, v in fused_em.LAUNCHES.items() if v > before[k]}

    def report(self, phase: str, wall: float, n_items: int, n_calls: int, measured=None, **extra):
        rec = {"phase": phase, "wall_s": wall, "items": n_items,
               "per_item_ms": 1e3 * wall / max(n_items, 1), "dispatched_calls": n_calls, **extra}
        for key in ("launches", "device_busy_s"):
            if measured and key in measured:
                rec[key] = measured[key]
        self.records.append(rec)
        if self.emit is not None:
            self.emit(rec)


def run(frames: int = 64, bucket: int = 16384, model: str = "tree", sharded: bool = False,
        skip_e2e: bool = False, device=None, trace_dir=None, emit=None) -> list[dict]:
    """The phases on the sequence make_sequence(frames, bucket). Returns the
    records; emit(record) is called as each is made."""
    from hgmm_torch.eval.metrics import ate
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.pipelines.loop_closure import ClosureConfig, detect_loop_closures
    from hgmm_torch.pipelines.mapping import MapConfig, build_map, localize
    from hgmm_torch.pipelines.odometry import (
        OdometryConfig,
        OdometryResult,
        _bucketize,
        _fit_frame_model,
        _register_to_model,
        frame_generator,
        refine_odometry,
        run_odometry,
    )
    from hgmm_torch.utils.timing import sync

    device = resolve_device(device)
    if trace_dir is not None and device.type != "cuda":
        raise ValueError("odometry_suite: a device trace needs the card")
    cfg = OdometryConfig(model_kind=model, bucket=bucket, seed=0, fit_iters=10, reg_iters=30,
                         outlier_logit=-8.0, device=device)
    mesh = None
    if sharded:
        from hgmm_torch.parallel import make_mesh

        mesh = make_mesh(device)
    print(f"device={device} frames={frames} bucket={bucket} model={model} sharded={sharded}",
          file=sys.stderr)
    scans, gt = make_sequence(frames, bucket)
    rng = np.random.default_rng(cfg.seed)
    fr = [_bucketize(s, cfg.bucket, rng) for s in scans]
    f = len(fr)
    ph = _Phases(device, None if trace_dir is None else Path(trace_dir), emit)
    ident = Pose.identity(device=device)

    # Warm-up: builds the kernels and runs frame 0's fit and pair (0, 1).
    t0 = time.perf_counter()
    m0 = _fit_frame_model(fr[0], cfg, frame_generator(cfg.seed, 0), mesh)
    _register_to_model(m0, fr[1], cfg, ident, mesh)
    sync(device)
    print(f"first use + warm-up {time.perf_counter() - t0:.1f} s", file=sys.stderr)

    # The reference's count of dispatched programs: a fit is one program; a
    # registration one on the flat and sharded paths, one a level on the tree.
    levels = cfg.levels if model == "tree" else 1
    reg_calls = 1 if (sharded or model == "flat") else levels

    m = {}
    with ph.timed("fit", m):
        models = [_fit_frame_model(fr[i], cfg, frame_generator(cfg.seed, i), mesh) for i in range(f)]
    ph.report("fit", m["wall_s"], f, f, m)

    m = {}
    rel_poses, lls = [], []
    with ph.timed("register", m):
        prev_rel = ident
        for i in range(f - 1):
            res = _register_to_model(models[i], fr[i + 1], cfg, prev_rel, mesh)
            prev_rel = res.pose
            rel_poses.append(res.pose)
            lls.append(res.logliks[-1])
    ph.report("register", m["wall_s"], f - 1, (f - 1) * reg_calls, m)
    abs_poses = [ident]
    for z in rel_poses:
        abs_poses.append(abs_poses[-1].compose(z))
    result = OdometryResult(abs_poses=abs_poses, rel_poses=rel_poses, logliks=[float(x) for x in lls])

    # Closure verification fits its own models (its cache), so this is the
    # phase's real marginal cost.
    ccfg = ClosureConfig(min_separation=5)
    m = {}
    with ph.timed("closures", m):
        closures = detect_loop_closures(fr, result, cfg, config=ccfg, mesh=mesh)
    n_cl = 0 if closures is None else int(closures.i.shape[0])
    ph.report("closures", m["wall_s"], max(ccfg.max_candidates, 1),
              ccfg.max_candidates * 2 * (1 + reg_calls), m, accepted=n_cl)
    result.closures = closures

    refine_odometry(result, n_iters=10, mesh=mesh)  # warm: the steady-state solve is timed
    sync(device)
    m = {}
    with ph.timed("refine", m):
        refined = refine_odometry(result, n_iters=10, mesh=mesh)
    dead = float(ate(result.abs_poses, gt))
    fixed = float(ate(refined.poses(), gt))
    ph.report("refine", m["wall_s"], 1, 1, m, ate_dead=dead, ate_refined=fixed)
    refine_wall = m["wall_s"]

    mcfg = MapConfig(bucket=1 << 18)
    m = {}
    with ph.timed("map_build", m):
        map_tree = build_map(fr, refined.poses(), mcfg, mesh=mesh)
    ph.report("map_build", m["wall_s"], 1, 1, m, fused_bucket=mcfg.bucket, leaves=map_tree.n_leaves)

    mid = f // 2
    m = {}
    with ph.timed("localize", m):
        loc = localize(torch.from_numpy(fr[mid][0]).to(device), map_tree,
                       init_pose=result.abs_poses[mid], mesh=mesh)
    err = float(torch.linalg.norm(loc.pose.t - refined.t[mid]))
    start = float(torch.linalg.norm(result.abs_poses[mid].t - refined.t[mid]))
    ph.report("localize", m["wall_s"], 1, 1, m, err_vs_refined_t=err, init_vs_refined_t=start)

    walls = {r["phase"]: r["wall_s"] for r in ph.records}
    phases_wall = walls["fit"] + walls["register"] + walls["closures"] + refine_wall
    ph.report("phases_total", phases_wall, f, 0, frames_per_sec=f / phases_wall)
    if skip_e2e:
        return ph.records

    m = {}
    with ph.timed("e2e", m):
        res = run_odometry(scans, cfg, mesh=mesh, detect_closures=True, closure_config=ccfg)
        refined = refine_odometry(res, n_iters=10, mesh=mesh)
    ph.report("e2e", m["wall_s"], f, 0, m, frames_per_sec=f / m["wall_s"],
              ate_dead=float(ate(res.abs_poses, gt)), ate_refined=float(ate(refined.poses(), gt)))
    return ph.records


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--bucket", type=int, default=16384)
    ap.add_argument("--model", choices=("tree", "flat"), default="tree")
    ap.add_argument("--sharded", action="store_true")
    ap.add_argument("--skip-e2e", action="store_true", help="the phase breakdown only")
    ap.add_argument("--trace", default=None, help="a directory for a device trace of each phase")
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    return run(args.frames, args.bucket, args.model, args.sharded, args.skip_e2e, args.device,
               args.trace, emit=lambda rec: print(json.dumps(rec), flush=True))


if __name__ == "__main__":
    main()
