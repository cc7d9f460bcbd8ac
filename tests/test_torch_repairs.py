"""Places where the port once diverged from the JAX package or from its own
rules, on the CPU: the child directions of a tree with branch != 8, config
3's top_k gating in a whole registration, the tie rule of the gate, and the
default device of the entry points that take host data (the card, never a
silent CPU run).

Both packages start from the same numpy init0; tolerances are those of
tests/test_torch_models.py (tree fits) and tests/test_torch_register.py
(fit and registration).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.models import gmm_tree as jtree
from hgmm.ops import em_ref as jref
from hgmm.ops import fused_em as jfused
from hgmm.ops import gaussians as jg
from hgmm.pipelines import register as jreg
from hgmm_torch import convert
from hgmm_torch.configs.presets import PRESETS
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.eval.metrics import pose_delta_norm, registration_rmse, rotation_error_deg
from hgmm_torch.models import gmm_tree as ttree
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.ops import em_ref as tref
from hgmm_torch.pipelines import register as treg

torch.set_num_threads(2)


def _init0(pts, k, seed):
    idx = np.random.default_rng(seed).choice(pts.shape[0], k, replace=False)
    span = float(np.max(pts.max(0) - pts.min(0)))
    sigma = np.broadcast_to((span / 2.0) ** 2 * np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    return np.full(k, 1.0 / k, np.float32), pts[idx].copy(), sigma


@pytest.mark.parametrize("branch", [2, 3, 4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16])
def test_child_directions_match_jax(branch):
    got = ttree._child_directions(branch)
    ref = np.asarray(jtree._child_directions(branch))
    assert got.shape == (branch, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


def test_branch4_tree_matches_jax():
    pts = make_cloud_np(3000, "trefoil", 4)
    init0 = _init0(pts, 4, 1)
    tt, tll = ttree.GmmTree.fit(torch.from_numpy(pts), branch=4, levels=3, em_iters=8,
                                init0=convert.mixture_from_numpy(*init0))
    jt, jll = jtree.GmmTree.fit(jnp.asarray(pts), branch=4, levels=3, em_iters=8,
                                init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    assert [lvl.pi.shape[0] for lvl in tt.levels] == [4, 16, 64]
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-3, atol=1e-2)
    for lvl in (0, 1):
        for a, b in zip(tt.levels[lvl], jt.levels[lvl]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_config3_registration_matches_jax():
    """config3_mahalanobis (top_k=8, outlier 0.0) through the tree fit and
    the registration in both packages, from one init0."""
    p3 = PRESETS["config3_mahalanobis"]
    target = make_cloud_np(3000, "trefoil", seed=4)
    gt = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.25])), torch.tensor([0.05, -0.04, 0.06]))
    source = gt.inverse().apply(torch.from_numpy(target))
    init0 = _init0(target, p3.branch, 1)
    kw = dict(n_iters=p3.reg_iters, method=p3.method, top_k=p3.top_k,
              outlier_logit=p3.outlier_logit, complexity_threshold=p3.complexity_threshold)
    tree, _ = ttree.GmmTree.fit(torch.from_numpy(target), branch=p3.branch, levels=p3.levels,
                                em_iters=p3.fit_iters, init0=convert.mixture_from_numpy(*init0))
    res = treg.register_tree(source, tree, **kw)
    jt, _ = jtree.GmmTree.fit(jnp.asarray(target), branch=p3.branch, levels=p3.levels,
                              em_iters=p3.fit_iters, init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    jres = jreg.register_tree(jnp.asarray(source.numpy()), jt, **kw)
    jpose = convert.pose_from_numpy(np.asarray(jres.pose.R), np.asarray(jres.pose.t))
    assert float(registration_rmse(res.pose, source, gt)) < 0.03
    assert float(rotation_error_deg(res.pose, gt)) < 3.0
    assert float(pose_delta_norm(res.pose, gt)) < 0.06
    assert float(pose_delta_norm(res.pose, jpose)) < 1e-4  # tests/test_torch_register.py AGREE_SLICE
    np.testing.assert_allclose(res.logliks[-1].item(), float(jres.logliks[-1]), rtol=1e-4)


def test_top_k_threshold_counts_ties_with_multiplicity():
    """The port gates as em_ref does: the threshold is the top_k-th largest
    logit counted with multiplicity. The TPU kernel's iterative max-remove
    (hgmm/ops/fused_em.py:_top_k_mask) removes tied maxima at once, so its
    threshold is the top_k-th distinct value; the port does not follow it."""
    logits = np.array([[5.0, 5.0, 3.0, 1.0]], np.float32)
    got = tref.top_k_mask_logits(torch.from_numpy(logits), 2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jref.top_k_mask_logits(jnp.asarray(logits), 2)))
    np.testing.assert_array_equal(got > tref.NEG_INF, [[True, True, False, False]])
    tpu = np.asarray(jfused._top_k_mask(jnp.asarray(logits.T), 2)).T  # K on the sublanes
    np.testing.assert_array_equal(tpu > tref.NEG_INF, [[True, True, True, False]])


def _two_frames():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((600, 3)).astype(np.float32) for _ in range(2)]


def test_default_device_is_the_card_not_the_cpu(monkeypatch):
    """OdometryConfig() and run_odometry(frames) resolve to the card and raise
    without one; they never fall back to a CPU run. "cpu" has to be asked for."""
    import hgmm_torch
    from hgmm_torch.pipelines import odometry as todo
    from hgmm_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        todo.OdometryConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        hgmm_torch.run_odometry(_two_frames())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    assert todo.OdometryConfig(device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert todo.OdometryConfig().device == torch.device("cuda")
    assert todo.OdometryConfig(device=torch.device("cpu")).device.type == "cpu"


def test_explicit_cpu_still_runs_the_plain_path():
    from hgmm_torch.ops import fused_em
    from hgmm_torch.pipelines import odometry as todo

    fused_em.reset_launches()
    cfg = todo.OdometryConfig(model_kind="flat", k=4, fit_iters=2, reg_iters=2, bucket=256,
                              device="cpu")
    res = todo.run_odometry(_two_frames(), cfg)
    assert len(res.abs_poses) == 2 and res.abs_poses[1].R.device.type == "cpu"
    assert all(c == 0 for c in fused_em.LAUNCHES.values())


@pytest.mark.parametrize("entry", ["bench", "mxu_microbench", "vpu_microbench", "kernel_shapes"])
def test_bench_entry_points_default_to_the_card(monkeypatch, entry):
    """The bench path's entry points make their data from a seed on the host,
    so they cannot follow an input's device either."""
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "bench":
        from hgmm_torch import bench

        call = lambda: bench.run_bench(n=64, k=8, sweeps=1)  # noqa: E731
    else:
        call = importlib.import_module(f"hgmm_torch.benchmarks.{entry}").run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
