"""hgmm_torch.pipelines.loop_closure against hgmm.pipelines.loop_closure on
the CPU, and the port's dense refinement over the closures it detects.

Both packages run from one numpy init (_torch_parity.same_init) on the loop
sequence of tests/test_loop_closure.py rebuilt with numpy (20 frames, flat
K=24, bucket 1536: the sequence and config of :66-78).
"""

import json

import numpy as np
import pytest
import torch

from _torch_parity import loop_sequence, same_init, to_jax_pose, to_torch_pose  # noqa: F401
from hgmm.pipelines import loop_closure as jlc
from hgmm.pipelines import odometry as jodo
from hgmm_torch.eval.metrics import ate, pose_delta_norm
from hgmm_torch.models import se3 as tse3
from hgmm_torch.pipelines import loop_closure as tlc
from hgmm_torch.pipelines import odometry as todo
from hgmm_torch.utils.profiling import MetricsLog

torch.set_num_threads(2)

CFG = dict(model_kind="flat", k=24, fit_iters=10, reg_iters=8, bucket=1536, outlier_logit=-3.0,
           seed=0)


@pytest.fixture(scope="module")
def detected(same_init, tmp_path_factory):
    frames, gt = loop_sequence(n_frames=20)
    closure = dict(min_separation=5, reg_iters=40)
    ref = jodo.run_odometry(frames, jodo.OdometryConfig(**CFG), detect_closures=True,
                            closure_config=jlc.ClosureConfig(**closure))
    log = tmp_path_factory.mktemp("lc") / "m.jsonl"
    got = todo.run_odometry(frames, todo.OdometryConfig(**CFG), detect_closures=True,
                            closure_config=tlc.ClosureConfig(**closure), metrics=MetricsLog(log))
    return gt, ref, got, log


def test_detect_loop_closures_matches_jax(detected):
    gt, ref, got, log = detected
    assert got.closures is not None and ref.closures is not None, "no loop closure detected"
    assert got.closures.i.tolist() == np.asarray(ref.closures.i).tolist()
    assert got.closures.j.tolist() == np.asarray(ref.closures.j).tolist()
    assert bool(((got.closures.j - got.closures.i) > 5).all())
    np.testing.assert_allclose(got.closures.R.numpy(), np.asarray(ref.closures.R), atol=1e-3)
    np.testing.assert_allclose(got.closures.t.numpy(), np.asarray(ref.closures.t), atol=1e-3)
    np.testing.assert_allclose(got.closures.weight.numpy(), np.asarray(ref.closures.weight),
                               rtol=1e-3)
    for p, q in zip(got.abs_poses, ref.abs_poses):
        assert float(pose_delta_norm(p, to_torch_pose(q))) < 1e-3
    events = [json.loads(line) for line in log.read_text().splitlines()]
    cands = [r for r in events if r["event"] == "loop_closure_candidate"]
    assert [r["event"] for r in events[:19]] == ["registration"] * 19
    assert sum(r["accepted"] for r in cands) == len(got.closures.i)


def test_refinement_over_detected_closures_beats_dead_reckoning(detected):
    """tests/test_loop_closure.py:89: refined ATE < 0.8 x dead-reckoned."""
    gt, _, got, _ = detected
    dead = float(ate(got.abs_poses, gt))
    refined = todo.refine_odometry(got, n_iters=12)
    fixed = float(ate(refined.poses(), gt))
    assert fixed < 0.8 * dead, (dead, fixed)


def test_propose_candidates_matches_jax():
    _, gt = loop_sequence(n_frames=20)
    rng = np.random.default_rng(2)
    drifted = [tse3.Pose(p.R, p.t + torch.from_numpy(
        (0.01 * k * rng.standard_normal(3)).astype(np.float32))) for k, p in enumerate(gt)]
    for poses in (gt, drifted):
        for cfg in ({}, {"min_separation": 5}, {"drift_rate": 0.0}, {"max_heading": 0.1}):
            got = tlc.propose_candidates(poses, tlc.ClosureConfig(**cfg))
            ref = jlc.propose_candidates([to_jax_pose(p) for p in poses], jlc.ClosureConfig(**cfg))
            assert got == ref
    assert tlc.propose_candidates(gt[:6], tlc.ClosureConfig()) == []


@pytest.mark.parametrize("bias,tol", [((0.0, 0.0, 0.01, 0.02, -0.01, 0.0), 0.2),
                                      ((0.0, 0.0, 0.5, 1.0, 0.0, 0.0), 0.2)])
def test_reciprocal_check_matches_jax(bias, tol):
    """tests/test_loop_closure.py:107-127: forward biased by +eps, reverse
    by -eps (consistent), or a reverse estimate far off (gated)."""
    Z = tse3.Pose(tse3.so3_exp(torch.tensor([0.0, 0.1, 0.2])), torch.tensor([0.5, -0.2, 0.1]))
    eps = torch.tensor(bias)
    fwd = Z.compose(tse3.se3_exp(eps))
    rev = Z.compose(tse3.se3_exp(-eps)).inverse()
    ok, fused, d = tlc.reciprocal_check(fwd, rev, tol)
    jok, jfused, jd = jlc.reciprocal_check(to_jax_pose(fwd), to_jax_pose(rev), tol)
    assert ok == jok and ok == (d <= tol)
    np.testing.assert_allclose(d, jd, rtol=1e-5)
    np.testing.assert_allclose(fused.R.numpy(), np.asarray(jfused.R), atol=1e-6)
    np.testing.assert_allclose(fused.t.numpy(), np.asarray(jfused.t), atol=1e-6)
    if ok:  # the antisymmetric bias cancels at the geodesic midpoint
        assert float(torch.linalg.norm(fused.t - Z.t)) < 0.1 * float(torch.linalg.norm(fwd.t - Z.t))


def test_budget_skipped_candidates_are_observable(tmp_path):
    """tests/test_loop_closure.py:158-195: max_candidates=0 verifies nothing,
    warns, and logs every skipped neighbourhood."""
    frames_raw, gt = loop_sequence(n_frames=12)
    rng = np.random.default_rng(0)
    frames = [todo._bucketize(f, 512, rng) for f in frames_raw]
    result = todo.OdometryResult(abs_poses=gt, rel_poses=[], logliks=[0.0] * (len(gt) - 1))
    log = tmp_path / "m.jsonl"
    with pytest.warns(UserWarning, match="verification budget"):
        out = tlc.detect_loop_closures(frames, result, todo.OdometryConfig(model_kind="flat", k=8),
                                       config=tlc.ClosureConfig(min_separation=5, max_candidates=0),
                                       metrics=MetricsLog(log))
    assert out is None
    skipped = [json.loads(line) for line in log.read_text().splitlines()]
    assert skipped and all(r["event"] == "loop_closure_candidate_skipped"
                           and r["reason"] == "verification_budget" for r in skipped)
