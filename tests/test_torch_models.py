"""hgmm_torch.models and hgmm_torch.convert against hgmm.models on the CPU.

Random draws cannot match between jax.random and torch, so every fit here
starts both packages from the same explicit numpy init. Fits are compared
through log-likelihoods and parameters with tolerances for float32 EM: the
packages sum in different orders (a [N, K] matmul in XLA versus in torch), and
over the sweeps those ~1e-7 relative differences grow to ~1e-5 in the
log-likelihood. Deep tree levels are compared through log-likelihoods only:
an argmax near-tie can move a point to another parent between packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.models import gmm as jgmm
from hgmm.models import gmm_tree as jtree
from hgmm.models import pose as jpose
from hgmm.models import se3 as jse3
from hgmm.ops import gaussians as jg
from hgmm_torch import convert
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.models import gmm as tgmm
from hgmm_torch.models import gmm_tree as ttree
from hgmm_torch.models import pose as tpose
from hgmm_torch.models import se3 as tse3
from hgmm_torch.ops import gaussians as tg

torch.set_num_threads(2)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)


OMEGAS = [np.zeros(3), np.array([1e-5, -2e-5, 3e-6]), np.array([0.3, -0.2, 0.5]),
          np.array([0.0, 0.0, 2.0])]


@pytest.mark.parametrize("omega", OMEGAS)
def test_se3_maps_and_round_trips(omega):
    om = omega.astype(np.float32)
    v = np.array([0.1, -0.3, 0.2], np.float32)
    xi = np.concatenate([om, v])
    # Elementwise float32 with sin/cos/atan2: a few ulp between packages.
    _close(tse3.so3_exp(torch.from_numpy(om)), jse3.so3_exp(jnp.asarray(om)), 1e-6, 1e-6)
    P = tse3.se3_exp(torch.from_numpy(xi))
    Pj = jse3.se3_exp(jnp.asarray(xi))
    _close(P.R, Pj.R, 1e-6, 1e-6)
    _close(P.t, Pj.t, 1e-6, 1e-6)
    _close(tse3.so3_log(P.R), jse3.so3_log(Pj.R), 1e-5, 1e-6)
    _close(tse3.se3_log(P), xi, 1e-4, 1e-5)
    _close(tse3.se3_log(P), jse3.se3_log(Pj), 1e-5, 1e-6)
    # compose / inverse / apply / matrix
    x = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    ident = P.compose(P.inverse())
    _close(ident.R, np.eye(3), 0, 1e-6)
    _close(ident.t, np.zeros(3), 0, 1e-6)
    _close(P.apply(torch.from_numpy(x)), Pj.apply(jnp.asarray(x)), 1e-6, 1e-6)
    _close(P.matrix(), Pj.matrix(), 1e-6, 1e-6)
    _close(tse3.Pose.from_matrix(P.matrix()).R, P.R, 0, 0)


def _horn_stats(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((100, 3)).astype(np.float32)
    y = x @ np.array([[0.9, -0.3, 0.1], [0.3, 0.95, 0.0], [-0.1, 0.05, 1.0]], np.float32).T + 0.2
    w = rng.uniform(0.1, 1.0, 100).astype(np.float32)
    P = np.concatenate([x, np.ones((100, 1), np.float32)], 1)
    Q = np.concatenate([y * w[:, None], w[:, None]], 1)
    return x, y, w, (P.T @ Q).astype(np.float32)


def test_solve_horn_and_umeyama():
    x, y, w, horn = _horn_stats(1)
    got, ref = tpose.solve_horn(torch.from_numpy(horn)), jpose.solve_horn(jnp.asarray(horn))
    # 3x3 SVD in LAPACK (torch) and in XLA: float32 rounding of the factors.
    _close(got.R, ref.R, 1e-5, 1e-5)
    _close(got.t, ref.t, 1e-5, 1e-5)
    got = tpose.weighted_umeyama(*(torch.from_numpy(a) for a in (x, y, w)))
    ref = jpose.weighted_umeyama(*(jnp.asarray(a) for a in (x, y, w)))
    _close(got.R, ref.R, 1e-5, 1e-5)
    _close(got.t, ref.t, 1e-5, 1e-5)


def test_solve_wls_increment():
    rng = np.random.default_rng(2)
    J = rng.standard_normal((50, 6))
    A = (J.T @ J).astype(np.float32)
    A[0, 0] *= 1e3  # anisotropic, as plane-dominated scenes make it
    b = (10.0 * rng.standard_normal(6)).astype(np.float32)  # a step past the trust region
    got = tpose.solve_wls_increment(torch.from_numpy(A), torch.from_numpy(b))
    ref = jpose.solve_wls_increment(jnp.asarray(A), jnp.asarray(b))
    _close(got, ref, 1e-4, 1e-6)  # 6x6 solve, float32 LU in both
    assert float(torch.linalg.norm(got[:3])) <= 0.3 + 1e-6
    pose = tse3.Pose.identity()
    _close(tpose.apply_wls_increment(pose, got).R, jpose.apply_wls_increment(
        jse3.Pose.identity(), ref).R, 1e-5, 1e-6)


def _cloud(n, seed=4):
    return make_cloud_np(n, "trefoil", seed)


def _init(pts, k, seed):
    """One explicit init for both packages: means drawn with numpy."""
    idx = np.random.default_rng(seed).choice(pts.shape[0], k, replace=False)
    span = float(np.max(pts.max(0) - pts.min(0)))
    var = (span / max(k ** (1 / 3), 1.0)) ** 2
    sigma = np.broadcast_to(var * np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    return np.full(k, 1.0 / k, np.float32), pts[idx].copy(), sigma.astype(np.float32)


def test_em_fit_from_same_init():
    pts = _cloud(2000)
    init = _init(pts, 16, 0)
    tp, tll = tgmm.em_fit(torch.from_numpy(pts), convert.mixture_from_numpy(*init), n_iters=10)
    jp, jll = jgmm.em_fit(jnp.asarray(pts), jg.MixtureParams(*map(jnp.asarray, init)), n_iters=10)
    _close(tll, jll, 1e-4, 1e-2)
    _close(tp.pi, jp.pi, 1e-3, 1e-5)
    _close(tp.mu, jp.mu, 1e-3, 1e-4)
    _close(tp.sigma, jp.sigma, 1e-2, 1e-5)
    assert np.all(np.diff(_np(tll)) > -1e-2)  # EM log-likelihood does not fall
    # The mean log-likelihood helper agrees too.
    _close(tgmm.log_likelihood(tp, torch.from_numpy(pts)),
           jgmm.log_likelihood(jp, jnp.asarray(pts)), 1e-4, 1e-5)


@pytest.mark.parametrize("cov_type,weighted", [("full", True), ("iso", False), ("diag", True)])
def test_em_fit_sweep_loop_from_same_init(cov_type, weighted):
    """em_fit as its sweep loop runs it (em_sweeps: the E-step on the fit's
    packed table, then em_ref.em_step) against hgmm's scan from one init,
    with zero-weight rows and every covariance type."""
    pts = _cloud(1500, seed=5)
    w = None
    if weighted:
        w = np.random.default_rng(6).uniform(0.2, 1.0, 1500).astype(np.float32)
        w[::5] = 0.0
    init = _init(pts, 8, 2)
    tp, tll = tgmm.em_fit(torch.from_numpy(pts), convert.mixture_from_numpy(*init), n_iters=8,
                          cov_type=cov_type, point_weights=None if w is None else torch.from_numpy(w))
    jp, jll = jgmm.em_fit(jnp.asarray(pts), jg.MixtureParams(*map(jnp.asarray, init)), n_iters=8,
                          cov_type=cov_type, point_weights=None if w is None else jnp.asarray(w))
    assert tll.shape == (8,)
    _close(tll, jll, 1e-4, 1e-2)
    _close(tp.pi, jp.pi, 1e-3, 1e-5)
    _close(tp.mu, jp.mu, 1e-3, 1e-4)
    _close(tp.sigma, jp.sigma, 1e-2, 1e-5)


def test_tree_fit_sweep_loop_weighted_diag():
    """The tree's levels on the sweep loop (level 0 unmasked, level 1 on the
    points grouped by parent), weighted, diagonal covariances, against hgmm
    from one init0: the logliks of both levels and level 0's parameters."""
    pts = _cloud(2000, seed=7)
    w = np.random.default_rng(8).uniform(0.5, 1.0, 2000).astype(np.float32)
    w[::6] = 0.0
    init0 = _init(pts, 8, 3)
    tt, tll = ttree.GmmTree.fit(torch.from_numpy(pts), branch=8, levels=2, em_iters=6, cov_type="diag",
                                point_weights=torch.from_numpy(w), init0=convert.mixture_from_numpy(*init0))
    jt, jll = jtree.GmmTree.fit(jnp.asarray(pts), branch=8, levels=2, em_iters=6, cov_type="diag",
                                point_weights=jnp.asarray(w), init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    _close(tll, jll, 1e-3, 1e-2)
    for a, b in zip(tt.levels[0], jt.levels[0]):
        _close(a, b, 1e-3, 1e-4)
    assert [lvl.pi.shape[0] for lvl in tt.levels] == [8, 64]


def test_init_params_and_scene_variance():
    pts = torch.from_numpy(_cloud(500))
    a = tgmm.init_params(pts, 8, torch.Generator().manual_seed(3))
    b = tgmm.init_params(pts, 8, torch.Generator().manual_seed(3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)  # deterministic given the generator
    w = torch.ones(500)
    w[:480] = 0.0  # only 20 live points: every mean must be one of them
    c = tgmm.init_params(pts, 8, torch.Generator().manual_seed(3), point_weights=w)
    live = pts[480:]
    assert all(bool((live == m).all(1).any()) for m in c.mu)
    with pytest.raises(ValueError):
        tgmm.init_params(pts, 32, torch.Generator(), point_weights=w)
    _close(tgmm.scene_variance(pts), jgmm.scene_variance(jnp.asarray(pts.numpy())), 1e-6, 0)
    _close(tgmm.scene_variance(pts, w), jgmm.scene_variance(jnp.asarray(pts.numpy()),
                                                            jnp.asarray(w.numpy())), 1e-5, 0)


def test_seed_children():
    m = tuple(np.asarray(a) for a in jg.MixtureParams(
        np.array([0.25, 0.75], np.float32), np.array([[0, 0, 0], [1, 2, 3]], np.float32),
        np.stack([np.eye(3), np.diag([0.5, 0.2, 0.1])]).astype(np.float32)))
    got = ttree.seed_children(convert.mixture_from_numpy(*m), 8)
    ref = jtree.seed_children(jg.MixtureParams(*map(jnp.asarray, m)), 8)
    for a, b in zip(got, ref):
        _close(a, b, 1e-6, 1e-6)
    # branch != 8 draws its directions from numpy: unit norm, mass preserved.
    other = ttree.seed_children(convert.mixture_from_numpy(*m), 5)
    assert other.mu.shape == (10, 3)
    _close(other.pi.sum(), 1.0, 1e-6, 0)


@pytest.fixture(scope="module")
def trees():
    """The same 3-level tree fitted by both packages from one init0."""
    pts = _cloud(3000)
    init0 = _init(pts, 8, 1)
    tt, tll = ttree.GmmTree.fit(torch.from_numpy(pts), branch=8, levels=3, em_iters=8,
                                init0=convert.mixture_from_numpy(*init0))
    jt, jll = jtree.GmmTree.fit(jnp.asarray(pts), branch=8, levels=3, em_iters=8,
                                init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    return pts, tt, tll, jt, jll


def test_tree_fit_from_same_init0(trees):
    pts, tt, tll, jt, jll = trees
    assert [lvl.pi.shape[0] for lvl in tt.levels] == [8, 64, 512]
    _close(tll, jll, 1e-3, 1e-2)
    for a, b in zip(tt.levels[0], jt.levels[0]):
        _close(a, b, 1e-3, 1e-4)
    for lvl in tt.levels:
        _close(lvl.pi.sum(), 1.0, 1e-5, 0)


def test_cut_and_compact(trees):
    _, tt, _, jt, _ = trees
    _close(ttree.node_complexity(tt.levels[1]), jtree.node_complexity(jt.levels[1]), 1e-2, 1e-3)
    # The same (JAX) tree carried across gives the same cut.
    carried = convert.tree_from_numpy(
        [tuple(np.asarray(a) for a in lvl) for lvl in jt.levels], jt.branch)
    thr = float(np.quantile(_np(ttree.node_complexity(carried.levels[1])), 0.5))
    got = carried.cut_mixture(thr)
    ref = jt.cut_mixture(thr)
    assert got.pi.shape[0] == ref.pi.shape[0] and got.pi.shape[0] % 64 == 0
    assert got.pi.shape[0] < carried.n_leaves
    for a, b in zip(got, ref):
        _close(a, b, 1e-5, 1e-6)
    assert carried.cut_mixture(0.0) is carried.levels[-1]


def test_convert_round_trips():
    rng = np.random.default_rng(5)
    m = (rng.uniform(size=4).astype(np.float32), rng.standard_normal((4, 3)).astype(np.float32),
         np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)))
    back = convert.mixture_to_numpy(convert.mixture_from_numpy(*m))
    for a, b in zip(back, m):
        np.testing.assert_array_equal(a, b)
    R = jse3.so3_exp(jnp.array([0.1, 0.2, 0.3]))
    R2, t2 = convert.pose_to_numpy(convert.pose_from_numpy(np.asarray(R), np.array([1, 2, 3])))
    np.testing.assert_array_equal(R2, np.asarray(R))
    np.testing.assert_array_equal(t2, np.array([1, 2, 3], np.float32))
    tree = convert.tree_from_numpy([m, m], branch=2)
    assert tree.branch == 2 and len(tree.levels) == 2 and tree.n_leaves == 4
