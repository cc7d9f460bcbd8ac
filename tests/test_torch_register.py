"""hgmm_torch.pipelines.register against hgmm.pipelines.register on the CPU.

The slice is register_pair(model_kind="tree") with the config2_tree_8x3
preset. hgmm.register_pair draws its init from jax.random, so the slice's
two steps run in both packages from one numpy init0: GmmTree.fit, then
register_tree with config 2's arguments. Both must meet the bounds of
tests/test_register.py:45-50 against the ground truth and agree with each
other; the port's own register_pair must meet the same bounds.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.models import gmm_tree as jtree
from hgmm.ops import gaussians as jg
from hgmm.pipelines import register as jreg
from hgmm_torch import convert, register_pair
from hgmm_torch.configs.presets import PRESETS
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.eval.metrics import (
    pose_delta_norm,
    registration_rmse,
    rotation_error_deg,
    translation_error,
)
from hgmm_torch.models.gmm import Gmm
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.pipelines import register as treg

torch.set_num_threads(2)

P2 = PRESETS["config2_tree_8x3"]
REG_KW = dict(n_iters=P2.reg_iters, method=P2.method, top_k=P2.top_k,
              outlier_logit=P2.outlier_logit, complexity_threshold=P2.complexity_threshold)
N = 3000
# The two packages' float32 sums differ in order, and over 150 iterations
# (and, in the fit, 36 EM sweeps) that rounding moves the pose: observed
# gaps are ~3e-7 (same tree) and ~3e-6 (fit and registration) at N=3000.
# The bounds leave a 30x margin and sit far below the ground-truth bounds.
AGREE_CARRIED = 1e-5  # same tree, registration only
AGREE_SLICE = 1e-4  # fit and registration


def _gt():
    return Pose(so3_exp(torch.tensor([0.0, 0.0, 0.25])), torch.tensor([0.05, -0.04, 0.06]))


def _assert_bounds(pose, source, gt):
    # tests/test_register.py:45-50
    assert float(registration_rmse(pose, source, gt)) < 0.03
    assert float(rotation_error_deg(pose, gt)) < 3.0
    assert float(translation_error(pose, gt)) < 0.02
    assert float(pose_delta_norm(pose, gt)) < 0.06


def _jpose_to_torch(p):
    return convert.pose_from_numpy(np.asarray(p.R), np.asarray(p.t))


@pytest.fixture(scope="module")
def pair():
    target = make_cloud_np(N, "trefoil", seed=4)
    gt = _gt()
    source = gt.inverse().apply(torch.from_numpy(target)).numpy()
    rng = np.random.default_rng(1)
    idx = rng.choice(N, 8, replace=False)
    span = float(np.max(target.max(0) - target.min(0)))
    init0 = (np.full(8, 1 / 8, np.float32), target[idx].copy(),
             np.broadcast_to((span / 2.0) ** 2 * np.eye(3, dtype=np.float32), (8, 3, 3)).copy())
    return source, target, gt, init0


@pytest.fixture(scope="module")
def jax_slice(pair):
    source, target, _, init0 = pair
    tree, _ = jtree.GmmTree.fit(jnp.asarray(target), branch=P2.branch, levels=P2.levels,
                                em_iters=P2.fit_iters, init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    res = jreg.register_tree(jnp.asarray(source), tree, wls_inner=2, **REG_KW)
    return tree, res


def test_register_tree_on_the_jax_tree(pair, jax_slice):
    source, _, gt, _ = pair
    jtree_fit, jres = jax_slice
    carried = convert.tree_from_numpy(
        [tuple(np.asarray(a) for a in lvl) for lvl in jtree_fit.levels], jtree_fit.branch)
    res = treg.register_tree(torch.from_numpy(source), carried, wls_inner=2, **REG_KW)
    jpose = _jpose_to_torch(jres.pose)
    _assert_bounds(res.pose, torch.from_numpy(source), gt)
    _assert_bounds(jpose, torch.from_numpy(source), gt)
    assert float(pose_delta_norm(res.pose, jpose)) < AGREE_CARRIED
    assert res.logliks.shape == (3 * P2.reg_iters,) == jres.logliks.shape
    np.testing.assert_allclose(res.logliks[-1].item(), float(jres.logliks[-1]), rtol=1e-5)


def test_slice_in_both_packages(pair, jax_slice):
    source, target, gt, init0 = pair
    _, jres = jax_slice
    tree, lls = GmmTree.fit(torch.from_numpy(target), branch=P2.branch, levels=P2.levels,
                            em_iters=P2.fit_iters, init0=convert.mixture_from_numpy(*init0))
    assert lls.shape == (P2.levels,) and bool(torch.isfinite(lls).all())
    res = treg.register_tree(torch.from_numpy(source), tree, wls_inner=2, **REG_KW)
    _assert_bounds(res.pose, torch.from_numpy(source), gt)
    assert float(pose_delta_norm(res.pose, _jpose_to_torch(jres.pose))) < AGREE_SLICE


def test_register_pair_meets_bounds(pair):
    source, target, gt, _ = pair
    res = register_pair(
        torch.from_numpy(source), target=torch.from_numpy(target), model_kind=P2.model_kind,
        branch=P2.branch, levels=P2.levels, fit_iters=P2.fit_iters,
        generator=torch.Generator().manual_seed(0), **REG_KW)
    _assert_bounds(res.pose, torch.from_numpy(source), gt)
    for x in (res.pose.R, res.pose.t, res.logliks, res.deltas):
        assert bool(torch.isfinite(x).all())


def test_converged_scan_re_emits_last_live_values():
    """Slots after convergence repeat the last live (loglik, delta)."""
    cloud = torch.from_numpy(make_cloud_np(1500, "trefoil", seed=10))
    gmm, _ = Gmm.fit(cloud, k=16, n_iters=15, generator=torch.Generator().manual_seed(11))
    res = treg.register_points(cloud, gmm.params, n_iters=40, method="horn", tol=1e-5)
    assert bool(res.converged)
    deltas, lls = res.deltas.numpy(), res.logliks.numpy()
    live = np.flatnonzero(deltas >= 1e-5)
    last_live = (live[-1] + 1) if live.size else 0
    assert last_live < 39, "did not converge early enough to test the tail"
    np.testing.assert_array_equal(lls[last_live:], lls[last_live])
    np.testing.assert_array_equal(deltas[last_live:], deltas[last_live])
    assert lls[-1] != 0.0


def test_done_carries_from_horn_into_wls():
    """A Horn phase that converges skips every WLS iteration, as the JAX
    scan's carry does (hgmm/pipelines/register.py:113-124)."""
    calls = []
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(0))
    P = torch.cat([x, torch.ones(50, 1)], 1)
    horn = P.T @ P  # virtual targets == sources: Horn returns the identity

    def stats_fn(R, t):
        calls.append(1)
        return horn, torch.eye(6), torch.zeros(6), torch.tensor(-1.0)

    (R, t, done), lls, deltas = treg.run_registration_scan(
        stats_fn, torch.eye(3), torch.zeros(3), 10, "horn+wls", 1e-5, 2)
    assert done and len(calls) == 1
    assert lls.shape == (10,) and deltas.shape == (10,)
    np.testing.assert_array_equal(lls.numpy(), -1.0)
    with pytest.raises(ValueError):
        treg.run_registration_scan(stats_fn, torch.eye(3), torch.zeros(3), 4, "icp", 1e-7, 2)
