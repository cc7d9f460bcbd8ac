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
    return convert.pose_from_numpy(np.asarray(p.R), np.asarray(p.t), device="cpu")


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
        [tuple(np.asarray(a) for a in lvl) for lvl in jtree_fit.levels], jtree_fit.branch, device="cpu")
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
                            em_iters=P2.fit_iters, init0=convert.mixture_from_numpy(*init0, device="cpu"))
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


def test_done_carries_from_horn_into_wls(monkeypatch):
    """A Horn phase that converges skips every WLS iteration, as the JAX
    scan's carry does (hgmm/pipelines/register.py:113-124): the statistics
    are asked for every step of the fixed-count scan, live only once, and
    the WLS steps, whose statistics would move the pose, change nothing.
    The statistics are a stand-in for ops.reg_partials, which the scan looks
    up at each step."""
    from hgmm_torch import ops
    from hgmm_torch.ops import em_ref

    live = []
    x = torch.randn(50, 3, generator=torch.Generator().manual_seed(0))
    P = torch.cat([x, torch.ones(50, 1)], 1)
    horn = P.T @ P  # virtual targets == sources: Horn returns the identity
    row = em_ref.pack_reg(em_ref.RegStats(horn, torch.eye(6), torch.ones(6), torch.tensor(-1.0)))

    def stats_fn(problem, scan):
        live.append(not bool(scan.done))
        return em_ref.RegPartials(row)

    monkeypatch.setattr(ops, "reg_partials", stats_fn)
    (R, t, done), lls, deltas = treg.run_registration_scan(
        None, torch.eye(3), torch.zeros(3), 10, "horn+wls", 1e-5, 2)
    assert bool(done) and sum(live) == 1 and len(live) == 5 + 5 * 2
    assert lls.shape == (10,) and deltas.shape == (10,)
    np.testing.assert_array_equal(lls.numpy(), -1.0)
    assert float(deltas[0]) < 1e-5
    np.testing.assert_array_equal(deltas.numpy(), deltas[0].item())  # re-emitted
    torch.testing.assert_close(R, torch.eye(3), rtol=0, atol=1e-6)
    torch.testing.assert_close(t, torch.zeros(3), rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        treg.run_registration_scan(None, torch.eye(3), torch.zeros(3), 4, "icp", 1e-7, 2)


@pytest.mark.parametrize("n_iters,method,wls_inner,want", [
    (5, "horn+wls", 2, [(0, 0, 1, 1), (1, 0, 1, 1), (2, 1, 1, 0), (2, 1, 0, 1), (3, 1, 1, 0), (3, 1, 0, 1),
                        (4, 1, 1, 0), (4, 1, 0, 1)]),
    (2, "wls", 3, [(0, 1, 1, 0), (0, 1, 0, 0), (0, 1, 0, 1), (1, 1, 1, 0), (1, 1, 0, 0), (1, 1, 0, 1)]),
    (2, "wls", 0, [(0, 1, 1, 1), (1, 1, 1, 1)]),
    (3, "horn", 4, [(0, 0, 1, 1), (1, 0, 1, 1), (2, 0, 1, 1)]),
    (1, "horn+wls", 2, [(0, 1, 1, 0), (0, 1, 0, 1)]),
    (0, "horn+wls", 2, []),
])
def test_scan_schedule_is_the_step_loops_order(n_iters, method, wls_inner, want):
    """The steps of a scan, (it, solver, first, last) each, in the order the
    step loop ran them: Horn for the first n_iters // 2 iterations of
    horn+wls, one step an iteration; a WLS iteration max(wls_inner, 1) steps,
    its first recording the start and its last writing the outputs."""
    got = treg.scan_schedule(n_iters, method, wls_inner)
    assert [tuple(map(int, step)) for step in got] == want
    assert treg.scan_schedule(n_iters, method, wls_inner) is got  # made once, then shared


# --------------------------------------------------------------------------
# the fixed-count scan with `done` carried, and its step's plain twin


@pytest.mark.parametrize("method,tol,n_iters", [("horn+wls", 1e-7, 30), ("horn", 1e-5, 40),
                                                ("wls", 1e-6, 25)])
def test_scan_matches_jax_register_points(pair, jax_slice, method, tol, n_iters):
    """register_points on one level of the JAX tree, from one init, in both
    packages: (pose, logliks, deltas, converged). A scan that converges early
    re-emits its last live (loglik, delta) to the end in both."""
    source, _, _, _ = pair
    jtree_fit, _ = jax_slice
    lvl = jtree_fit.levels[1]
    params = convert.mixture_from_numpy(*(np.asarray(a) for a in lvl), device="cpu")
    init = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.2])), torch.tensor([0.03, -0.03, 0.05]))
    res = treg.register_points(torch.from_numpy(source), params, init_pose=init, n_iters=n_iters,
                               method=method, tol=tol)
    jinit = type(jax_slice[1].pose)(jnp.asarray(init.R.numpy()), jnp.asarray(init.t.numpy()))
    jres = jreg.register_points(jnp.asarray(source), lvl, init_pose=jinit, n_iters=n_iters,
                                method=method, tol=tol)
    assert float(pose_delta_norm(res.pose, _jpose_to_torch(jres.pose))) < AGREE_CARRIED
    np.testing.assert_allclose(res.logliks.numpy(), np.asarray(jres.logliks), rtol=1e-5)
    d, jd = res.deltas.numpy(), np.asarray(jres.deltas)
    np.testing.assert_allclose(d, jd, rtol=1e-3, atol=1e-6)
    assert bool(res.converged) == bool(jres.converged)
    if bool(res.converged):
        last = int(np.flatnonzero(d < tol)[0])
        assert last < n_iters - 1  # early: the re-emit contract is exercised
        np.testing.assert_array_equal(d[last:], d[last])
        np.testing.assert_array_equal(res.logliks.numpy()[last:], res.logliks.numpy()[last])


def _twin_step(h, A, b, R, t, solver, first, last, tol=1e-7, done=False, n_iters=2):
    from hgmm_torch.ops import em_ref

    scan = em_ref.new_scan(R, t, n_iters)
    if done:
        scan.state[em_ref.SCAN_DONE] = 1.0
        scan.state[em_ref.SCAN_LL_LAST] = -5.0
        scan.state[em_ref.SCAN_D_LAST] = 0.25
    row = em_ref.pack_reg(em_ref.RegStats(h, A, b, torch.tensor(-3.0, dtype=R.dtype)))
    em_ref.reg_step(torch.cat([row / 2, row / 2]), scan, 1, solver, first, last, tol)
    return scan


def _moments(rng, planar=1.0):
    x = rng.standard_normal((200, 3))
    x[:, 2] *= planar
    y = x @ so3_exp(torch.from_numpy(rng.uniform(-1, 1, 3))).numpy().T + rng.uniform(-1, 1, 3)
    P = np.concatenate([x, np.ones((200, 1))], 1)
    return torch.from_numpy(P.T @ np.concatenate([y, np.ones((200, 1))], 1))


@pytest.mark.parametrize("case", ["random", "planar", "tiny_angle"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reg_step_twin_is_the_pose_code(case, dtype):
    """The twin's Horn and Gauss-Newton steps, delta and outputs are
    models/pose.py's and models/se3.py's on the summed rows; a done scan
    changes nothing and re-emits."""
    from hgmm_torch.models.pose import apply_wls_increment, solve_horn, solve_wls_increment
    from hgmm_torch.models.se3 import se3_log
    from hgmm_torch.ops import em_ref

    rng = np.random.default_rng(len(case))
    h = _moments(rng, 1e-4 if case == "planar" else 1.0).to(dtype)
    J = torch.from_numpy(rng.standard_normal((30 if case != "planar" else 3, 6))).to(dtype)
    A, b = J.T @ J, torch.from_numpy(rng.standard_normal(6) * (1e-6 if case == "tiny_angle" else 1.0)).to(dtype)
    R0, t0 = so3_exp(torch.tensor([0.1, 0.2, -0.3], dtype=dtype)), torch.tensor([0.5, -0.2, 0.1], dtype=dtype)
    # Horn: one step is the iteration
    scan = _twin_step(h, A, b, R0, t0, 0, True, True)
    want = solve_horn(h)
    torch.testing.assert_close(scan.pose[0], want.R, rtol=0, atol=0)
    torch.testing.assert_close(scan.pose[1], want.t, rtol=0, atol=0)
    delta = torch.linalg.norm(se3_log(want.compose(Pose(R0, t0).inverse())))
    assert float(scan.deltas[1]) == float(delta) and float(scan.logliks[1]) == -3.0
    # Gauss-Newton: a first step records the start; a last step the delta
    scan = _twin_step(h, A, b, R0, t0, 1, True, False)
    want = apply_wls_increment(Pose(R0, t0), solve_wls_increment(A, b))
    torch.testing.assert_close(scan.pose[0], want.R, rtol=0, atol=0)
    assert float(scan.deltas[1]) == 0.0 and float(scan.state[em_ref.SCAN_LL]) == -3.0
    torch.testing.assert_close(scan.state[em_ref.SCAN_START:em_ref.SCAN_START + 9].reshape(3, 3), R0)
    em_ref.reg_step(em_ref.pack_reg(em_ref.RegStats(h, A, b, torch.tensor(-9.0, dtype=dtype))), scan,
                    1, 1, False, True, 1e-7)
    want = apply_wls_increment(want, solve_wls_increment(A, b))
    torch.testing.assert_close(scan.pose[0], want.R, rtol=0, atol=0)
    assert float(scan.logliks[1]) == -3.0  # the iteration's first statistics
    delta = torch.linalg.norm(se3_log(want.compose(Pose(R0, t0).inverse())))
    assert float(scan.deltas[1]) == float(delta)
    assert bool(scan.done) == bool(delta < 1e-7)
    # done: nothing moves, the last live values come again
    scan = _twin_step(h, A, b, R0, t0, 1, True, True, done=True)
    torch.testing.assert_close(scan.pose[0], R0, rtol=0, atol=0)
    assert float(scan.logliks[1]) == -5.0 and float(scan.deltas[1]) == 0.25


@pytest.mark.parametrize("entry", ["register_tree", "register_points"])
def test_the_source_is_prepared_once_a_registration(pair, entry, monkeypatch):
    """register_tree builds the source buffer once for its three levels
    (register_points once for its one), and on the CPU each level's tables
    come from model_terms: precision_terms twice a level, through
    pack_loglik_weights and directly."""
    from hgmm_torch import ops
    from hgmm_torch.ops import gaussians

    source, target, _, _ = pair
    tree, _ = GmmTree.fit(torch.from_numpy(target), levels=3, em_iters=3,
                          generator=torch.Generator().manual_seed(2))
    calls = {"prepare": 0, "inverse": 0}
    prepare, inverse = ops.prepare, gaussians._inv_and_logdet_3x3

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ops, "prepare", counted("prepare", prepare))
    monkeypatch.setattr(gaussians, "_inv_and_logdet_3x3", counted("inverse", inverse))
    src = torch.from_numpy(source)
    if entry == "register_tree":
        res = treg.register_tree(src, tree, n_iters=4, complexity_threshold=0.02)
        levels = 3
    else:
        res = treg.register_points(src, tree.levels[1], n_iters=4)
        levels = 1
    assert calls == {"prepare": 1, "inverse": 2 * levels}
    assert res.logliks.shape == (4 * levels,)


@pytest.mark.parametrize("case", ["on_the_cpu", "k_past_max", "pi_shape", "mu_shape", "sigma_shape",
                                  "points_shape"])
def test_reg_tables_of_refuses_what_the_kernel_does_not_take(case):
    """fused_em.reg_tables_of takes the card's tensors alone, K in [1, MAX_K]
    and pi [K], mu [K, 3], sigma [K, 3, 3], pts4 [4, N]; the dispatch sends
    CPU tensors to the plain path instead."""
    from hgmm_torch import ops
    from hgmm_torch.ops import fused_em
    from hgmm_torch.ops.gaussians import MixtureParams

    k = fused_em.MAX_K + 1 if case == "k_past_max" else 16
    params = MixtureParams(torch.full((k,), 1.0 / k), torch.zeros(k, 3), torch.eye(3).repeat(k, 1, 1))
    prep = ops.prepare(torch.zeros(10, 3))
    pts4 = prep.pts4
    match = {"on_the_cpu": "CUDA tensor", "k_past_max": "outside", "pi_shape": "pi of shape",
             "mu_shape": "mu of shape", "sigma_shape": "sigma of shape", "points_shape": "pts4"}[case]
    if case == "pi_shape":
        params = params._replace(pi=params.pi[:, None])
    elif case == "mu_shape":
        params = params._replace(mu=params.mu[:, :2])
    elif case == "sigma_shape":
        params = params._replace(sigma=params.sigma.reshape(k, 9))
    elif case == "points_shape":
        pts4 = pts4[:3]
    with pytest.raises(ValueError, match=match):
        fused_em.reg_tables_of(pts4, params)
    if case == "on_the_cpu":
        assert isinstance(ops.reg_problem_of(prep, params), ops.RegProblem)
