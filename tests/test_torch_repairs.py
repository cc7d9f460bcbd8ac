"""Two places where the port once diverged from the JAX package, on the CPU:
the child directions of a tree with branch != 8, and config 3's top_k
gating in a whole registration; and the tie rule of the gate.

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
