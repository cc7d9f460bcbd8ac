"""The KITTI SLAM back end (loop closures verified by registration, pose-graph
refinement, the global map) through the port's normal path on the CPU, as the
CLI's ``odometry --detect-closures --refine --map`` runs it, against the
benchmark's float64 reference (regbench/reference/slam.py) on a small route
driven twice (regbench/harness/slam_data.py). Also: the benchmark
configuration against the port's defaults, the reference's Gauss-Newton and
registration against the port's on shared inputs, and the route itself."""

from __future__ import annotations

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hgmm_torch.models.se3 import Pose
from hgmm_torch.pipelines import mapping
from hgmm_torch.pipelines.loop_closure import ClosureConfig
from hgmm_torch.pipelines.odometry import OdometryConfig, refine_odometry, run_odometry
from hgmm_torch.pipelines.pose_graph import EdgeList, refine_pose_graph
from regbench.harness import common, data, slam_data
from regbench.reference import odometry as ref_odometry
from regbench.reference import slam

REPO = Path(__file__).resolve().parents[1]
CONFIG = json.loads((REPO / "regbench" / "configs" / "kitti_hdl64_slam.json").read_text())
SEED = 2147483911
# Two laps of 16 frames: at 8 frames a lap a step turns 45 degrees and, at
# these sizes, a registration from the chain's warm start settles in another
# basin in most pairs; at 16 the chain holds. 6,000-point scans for the same
# reason. The reference seeds branch 8 only, so the tree is 8 x 2.
SMALL = dict(frames=32, scan_points=6000, world_points=40000, levels=2)
MAP = dict(CONFIG["map"], levels=2, bucket=16384)
BUCKET = 8192
PER_LAP = SMALL["frames"] // CONFIG["laps"]


def _model():
    return dict(CONFIG, **SMALL)


@pytest.fixture(scope="module")
def route():
    c = _model()
    rng = np.random.default_rng(data.seeds(SEED, 3))
    return slam_data.two_laps(rng, c["world_points"], c["boxes"], c["pillars"], c["frames"],
                              c["laps"], c["scan_points"], c["step_m"], c["range_m"], c["fov_rad"],
                              c["noise_m"], c["lap_growth_m"])


@pytest.fixture(scope="module")
def sequence(route):
    """The port's whole sequence and the reference's back end run from the
    port's own chain."""
    scans, truth = route
    c = _model()
    cfg = OdometryConfig(model_kind="tree", branch=c["branch"], levels=c["levels"],
                         fit_iters=c["fit_iters"], reg_iters=c["reg_iters"], method=c["method"],
                         outlier_logit=c["outlier_logit"], bucket=BUCKET, seed=SEED, device="cpu")
    res = run_odometry(scans, cfg, detect_closures=True, closure_config=ClosureConfig(**c["closures"]))
    refined = refine_odometry(res, n_iters=c["refine"]["n_iters"])
    tree = mapping.build_map(scans, refined.poses(), mapping.MapConfig(**MAP))
    abs_ = [(p.R.double().numpy(), p.t.double().numpy()) for p in res.abs_poses]
    rel = [(p.R.double().numpy(), p.t.double().numpy()) for p in res.rel_poses]
    fr = ref_odometry.frames(scans, None, BUCKET, SEED)
    edges = slam.closures(abs_, res.logliks, fr, {}, c, c["closures"], SEED, torch.float64, "cpu")
    ref_poses = slam.refine(abs_, slam.chain_edges(rel) + edges, c["refine"]["n_iters"])
    prog_refined = list(zip(refined.R.double().numpy(), refined.t.double().numpy()))
    ref_map, _ = slam.build_map(scans, prog_refined, MAP)
    return dict(res=res, refined=prog_refined, tree=tree, edges=edges, ref_poses=ref_poses,
                ref_map=ref_map, abs=abs_, truth=truth)


def _closures(res):
    e = res.closures
    return set() if e is None else set(zip(e.i.tolist(), e.j.tolist()))


def test_the_closures_are_the_references(sequence):
    got = _closures(sequence["res"])
    assert got == {(i, j) for i, j, _, _ in sequence["edges"]}
    assert max(j - i for i, j in got) >= PER_LAP - 1, got  # a revisit of the first lap


# The port refines in float32 (its poses' dtype) from float32 closure edges;
# the reference in float64 from its own float64 verifications of the same
# candidates. A closure edge's pose differs by the float32 rounding of a
# registration over 6,000 points, and the graph spreads that over the loop:
# 1.9e-5 rad and 1.4e-4 m on this route (the worst node), so 2e-4 rad and
# 2e-3 m hold rounding with ten times the room; the dead-reckoned chain lies
# 0.40 rad and 1.68 m from the refined poses (test below).
REFINED_ROT, REFINED_TRANS = 2e-4, 2e-3


def test_the_refined_poses_are_the_references(sequence):
    rot = max(common.rotation_gap(a[0], b[0]) for a, b in zip(sequence["refined"], sequence["ref_poses"]))
    trans = max(common.translation_gap(a[1], b[1])
                for a, b in zip(sequence["refined"], sequence["ref_poses"]))
    assert rot < REFINED_ROT and trans < REFINED_TRANS, (rot, trans)


def test_the_refinement_moves_the_poses_past_the_tolerance(sequence):
    """The comparison above could fail: the dead-reckoned chain lies farther
    from the reference's refined poses than the tolerance."""
    trans = max(common.translation_gap(a[1], b[1]) for a, b in zip(sequence["abs"], sequence["ref_poses"]))
    assert trans > REFINED_TRANS, trans


# The map is fitted in float32 on the port and in float64 in the reference
# from the same fused cloud up to rounding of the transforms (a point within
# rounding of a voxel's face can change voxels), and 12 EM sweeps a level
# carry that: 6.6e-3 at the worst level here. 5e-2, the dragon cells' fit
# limit, holds it; the same map fused by the unrefined poses reads 6.3.
MAP_GAP = 5e-2


def test_the_map_is_the_references(sequence):
    gap = max(common.mixture_gap(tuple(a.numpy() for a in (lv.pi, lv.mu, lv.sigma)),
                                 tuple(a.numpy() for a in r))
              for lv, r in zip(sequence["tree"].levels, sequence["ref_map"]))
    assert gap < MAP_GAP, gap


def test_the_refined_trajectory_is_nearer_the_truth(sequence):
    assert slam_data.ate(sequence["refined"], sequence["truth"]) < slam_data.ate(sequence["abs"],
                                                                                sequence["truth"])


# --- the pieces against the port's, on shared inputs


def _graph(m=12, seed=5):
    """A noisy chain of m poses with two closures, float64."""
    from hgmm_torch.models.se3 import se3_exp

    g = torch.Generator().manual_seed(seed)
    true = [Pose(torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64))]
    for k in range(1, m):
        true.append(true[-1].compose(se3_exp(torch.tensor([0.0, 0.0, 0.3, 1.0, 0.1, 0.0],
                                                          dtype=torch.float64))))
    rel = [true[k].inverse().compose(true[k + 1]).compose(
        se3_exp(0.02 * torch.randn(6, generator=g, dtype=torch.float64))) for k in range(m - 1)]
    abs_ = [true[0]]
    for r in rel:
        abs_.append(abs_[-1].compose(r))
    closures = [(0, m - 1), (2, m - 3)]
    cl = [true[i].inverse().compose(true[j]) for i, j in closures]
    return abs_, rel, closures, cl


def test_gauss_newton_is_the_ports_in_float64():
    """The reference's analytic Jacobians and the port's autodiff ones reach
    the same poses from the same graph: both solve the same normal equations
    to float64 rounding."""
    abs_, rel, closures, cl = _graph()
    R = torch.stack([p.R for p in abs_])
    t = torch.stack([p.t for p in abs_])
    edges = EdgeList(torch.tensor([k for k in range(len(rel))] + [i for i, _ in closures]),
                     torch.tensor([k + 1 for k in range(len(rel))] + [j for _, j in closures]),
                     torch.stack([p.R for p in rel + cl]), torch.stack([p.t for p in rel + cl]),
                     torch.tensor([1.0] * len(rel) + [10.0, 4.0], dtype=torch.float64))
    port = refine_pose_graph(R, t, edges, n_iters=10)
    ref = slam.refine([(p.R.numpy(), p.t.numpy()) for p in abs_],
                      [(int(i), int(j), (Zr.numpy(), Zt.numpy()), float(w))
                       for i, j, Zr, Zt, w in zip(*edges)], 10)
    for m, (Rr, tr) in enumerate(ref):
        assert common.rotation_gap(port.R[m].numpy(), Rr) < 1e-9
        assert common.translation_gap(port.t[m].numpy(), tr) < 1e-9


# The port registers in float32, the reference in float64 on the port's own
# tree: the pose differs by float32 rounding of sums over 8,192 points carried
# through 60 WLS steps (the chain's pairs differ from the float64 chain by
# ~1e-4 rad and ~1e-3 m at these sizes). The log-likelihood's float32 logits
# take squares of coordinates tens of metres out (~1e3) to give log-densities
# of ~5 a point, so each keeps ~1e-5 of relative rounding, and the sum read
# 1.5e-5 apart in one run of the suite: 1e-4 holds it, where a closure's
# acceptance turns on a margin of 1.5 a point (~30 % of the log-likelihood).
REG_ROT, REG_TRANS, REG_LL = 1e-4, 1e-3, 1e-4


def test_registration_reads_what_the_port_reports(route):
    """On the port's own tree, the reference's registration lands on the
    port's pose and log-likelihood, and on its acceptance of the motion."""
    from hgmm_torch import GmmTree
    from hgmm_torch.pipelines.register import register_tree
    from regbench.reference.mixture import Mixture

    scans, _ = route
    c = _model()
    (tp, tw), (sp, sw) = ref_odometry.frames(scans[:2], None, BUCKET, SEED)
    tree, _ = GmmTree.fit(torch.from_numpy(tp), branch=c["branch"], levels=c["levels"],
                          em_iters=c["fit_iters"], generator=torch.Generator().manual_seed(1),
                          point_weights=torch.from_numpy(tw))
    port = register_tree(torch.from_numpy(sp), tree, n_iters=c["reg_iters"], method=c["method"],
                         outlier_logit=c["outlier_logit"], point_weights=torch.from_numpy(sw))
    ref = slam.register((sp, sw), [Mixture(*(a.double() for a in lv)) for lv in tree.levels], c)
    assert common.rotation_gap(port.pose.R.numpy(), ref.pose[0]) < REG_ROT
    assert common.translation_gap(port.pose.t.numpy(), ref.pose[1]) < REG_TRANS
    assert abs(float(port.logliks[-1]) - ref.loglik) < REG_LL * abs(ref.loglik)
    accept = c["closures"]["accept_delta"]
    assert (bool(port.converged) or float(port.deltas[-1]) < accept) == (ref.converged or ref.delta < accept)


def test_candidates_are_the_ports():
    from hgmm_torch.pipelines.loop_closure import propose_candidates

    abs_, _, _, _ = _graph(m=30, seed=2)
    cfg = ClosureConfig(radius_steps=3.0)
    poses = [Pose(p.R.float(), p.t.float()) for p in abs_]
    got = slam.candidates(np.stack([p.t.numpy() for p in poses]), np.stack([p.R.numpy() for p in poses]),
                          vars(cfg))
    assert got and got == propose_candidates(poses, cfg)


# --- the configuration and the route


def test_config_file_is_the_ports_defaults():
    """kitti_hdl64_slam states what the CLI's `odometry --detect-closures
    --refine --map` runs: ClosureConfig's and MapConfig's defaults (the voxel
    is the CLI's --voxel, passed to MapConfig), refine_odometry's 10 steps and
    no robust kernel, and the chain of kitti_hdl64_8x3."""
    assert CONFIG["closures"] == vars(ClosureConfig())
    defaults = vars(mapping.MapConfig())
    assert {k: v for k, v in CONFIG["map"].items() if k != "voxel"} == {
        k: v for k, v in defaults.items() if k != "voxel"}
    assert CONFIG["map"]["voxel"] == 0.3
    sig = inspect.signature(refine_odometry).parameters
    assert CONFIG["refine"]["n_iters"] == sig["n_iters"].default == 10
    assert CONFIG["refine"]["robust_delta"] is sig["robust_delta"].default is None
    chain = json.loads((REPO / "regbench" / "configs" / "kitti_hdl64_8x3.json").read_text())
    shared = [k for k in chain if k not in ("name", "source", "deployment", "frames", "assumed")]
    assert {k: CONFIG[k] for k in shared} == {k: chain[k] for k in shared}
    assert CONFIG["frames"] == 2 * chain["frames"] and CONFIG["laps"] == 2


def test_the_second_lap_revisits_the_first(route):
    scans, truth = route
    c = _model()
    for k in range(PER_LAP):
        (Ra, ta), (Rb, tb) = truth[k], truth[k + PER_LAP]
        assert np.linalg.norm(ta - tb) == pytest.approx(c["lap_growth_m"], rel=1e-9)
        assert common.rotation_gap(Ra, Rb) < 1e-9
    assert all(s.shape == (c["scan_points"], 3) and s.dtype == np.float32 for s in scans)


def test_ate_is_relative_to_frame_zero(route):
    _, truth = route
    R0, t0 = truth[0]
    exact = [(R0.T @ R, R0.T @ (t - t0)) for R, t in truth]
    assert slam_data.ate(exact, truth) < 1e-12
    moved = [(R, t + np.array([0.3, 0.0, 0.4])) for R, t in exact]
    assert slam_data.ate(moved, truth) == pytest.approx(0.5)
