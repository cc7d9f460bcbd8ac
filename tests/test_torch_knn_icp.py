"""hgmm_torch.ops.knn and hgmm_torch.baselines against the JAX package on
the CPU.

The clouds are made with numpy and handed to both packages. The port's knn
twin computes the JAX twin's factored distance in float32, so the two agree
up to rounding: indices may flip on near-ties, and the chosen neighbour's
distance agrees to the tolerances of tests/test_knn_icp.py:15-34. ICP poses
differ by float32 rounding of the 3x3 SVD and the sums; the bounds below
leave a wide margin over what was observed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.baselines import icp as jicp
from hgmm.baselines import numpy_em as jnem
from hgmm.models.se3 import Pose as JPose
from hgmm.ops import knn as jknn
from hgmm_torch import convert
from hgmm_torch.baselines import icp as ticp
from hgmm_torch.baselines import numpy_em as tnem
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.ops import fused_em
from hgmm_torch.ops import knn as tknn

torch.set_num_threads(2)


def _pair(nq, nt, seed, ties):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((nq, 3)).astype(np.float32)
    t = rng.standard_normal((nt, 3)).astype(np.float32)
    if ties:  # every target twice: each query's nearest distance is an exact tie
        t = np.concatenate([t, t])
        q[: nq // 4] = t[: nq // 4]  # and some queries sit on targets
    return q, t


def _check_knn(q, t, idx, d2, ref_idx, ref_d2):
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    assert np.mean(idx == ref_idx) >= 0.98
    chosen = np.sum((q.astype(np.float64) - t[idx].astype(np.float64)) ** 2, axis=1)
    np.testing.assert_allclose(chosen, np.asarray(ref_d2), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(np.asarray(d2), np.asarray(ref_d2), rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("nq,nt,ties", [(500, 700, False), (500, 700, True), (3000, 2500, False)])
def test_knn_ref_matches_jax(nq, nt, ties):
    q, t = _pair(nq, nt, nq + nt, ties)
    idx, d2 = tknn.nearest_neighbor(torch.from_numpy(q), torch.from_numpy(t))
    assert idx.dtype == torch.int32 and idx.shape == d2.shape == (nq,)
    assert float(d2.min()) >= 0.0
    ref_idx, ref_d2 = jknn.nearest_neighbor_ref(jnp.asarray(q), jnp.asarray(t))
    _check_knn(q, t, idx.numpy(), d2.numpy(), ref_idx, ref_d2)
    if ties:  # of equal distances the lowest index wins
        assert np.all(idx.numpy() < t.shape[0] // 2)
    if nq <= 500:  # the Pallas kernel, in interpret mode on the CPU
        p_idx, p_d2 = jknn.nearest_neighbor_pallas(jnp.asarray(q), jnp.asarray(t),
                                                   q_tile=256, t_tile=256)
        _check_knn(q, t, idx.numpy(), d2.numpy(), p_idx, p_d2)


def test_knn_identity_and_cpu_dispatch():
    t = np.random.default_rng(2).standard_normal((300, 3)).astype(np.float32)
    fused_em.reset_launches()
    idx, d2 = tknn.nearest_neighbor(torch.from_numpy(t), torch.from_numpy(t))
    np.testing.assert_array_equal(idx.numpy(), np.arange(300))
    np.testing.assert_allclose(d2.numpy(), 0.0, atol=1e-5)
    assert fused_em.LAUNCHES["knn"] == 0
    with pytest.raises(ValueError, match="CUDA"):  # the kernel wrapper never falls back
        tknn.nearest_neighbor_cuda(torch.from_numpy(t), torch.from_numpy(t))


def _icp_case(n, kind, seed):
    """Target cloud and a noisy, subsampled source moved by a pose inside
    ICP's basin. The noise keeps the final RMS well above float32 rounding."""
    rng = np.random.default_rng(seed)
    target = make_cloud_np(n, kind, seed)
    omega = rng.uniform(-0.08, 0.08, 3).astype(np.float32)
    trans = rng.uniform(-0.03, 0.03, 3).astype(np.float32)
    gt = Pose(so3_exp(torch.from_numpy(omega)), torch.from_numpy(trans))
    keep = rng.permutation(n)[: (4 * n) // 5]
    source = gt.inverse().apply(torch.from_numpy(target[keep])).numpy()
    source = (source + 0.02 * rng.standard_normal(source.shape)).astype(np.float32)
    return source, target


@pytest.mark.parametrize("n,kind,kw", [
    (1500, "trefoil", {}),
    (800, "helix", {}),
    (1500, "trefoil", {"max_dist": 0.05}),
    (800, "helix", {"init_pose": (np.array([0.02, -0.01, 0.03], np.float32),
                                  np.array([0.01, 0.0, -0.01], np.float32))}),
])
def test_icp_matches_jax(n, kind, kw):
    source, target = _icp_case(n, kind, n + len(kw))
    tkw, jkw = dict(kw), dict(kw)
    if "init_pose" in kw:
        omega, trans = kw["init_pose"]
        R = so3_exp(torch.from_numpy(omega))
        tkw["init_pose"] = Pose(R, torch.from_numpy(trans))
        jkw["init_pose"] = JPose(jnp.asarray(R.numpy()), jnp.asarray(trans))
    got = ticp.icp(torch.from_numpy(source), torch.from_numpy(target), n_iters=25, **tkw)
    ref = jicp.icp(jnp.asarray(source), jnp.asarray(target), n_iters=25, **jkw)
    R, t = convert.pose_to_numpy(got.pose)
    np.testing.assert_allclose(R, np.asarray(ref.pose.R), atol=1e-4)
    np.testing.assert_allclose(t, np.asarray(ref.pose.t), atol=1e-4)
    assert got.rmse_history.shape == (25,)
    np.testing.assert_allclose(got.rmse_history.numpy(), np.asarray(ref.rmse_history), rtol=1e-4)
    assert bool(got.converged) == bool(ref.converged)


def test_icp_freezes_like_the_scan():
    """After convergence the pose stays and every later entry is the RMS at
    the frozen pose (one search after convergence, then re-emitted)."""
    source, target = _icp_case(600, "trefoil", 3)
    res = ticp.icp(torch.from_numpy(source), torch.from_numpy(target), n_iters=40, tol=1e-4)
    ref = jicp.icp(jnp.asarray(source), jnp.asarray(target), n_iters=40, tol=1e-4)
    assert bool(res.converged) and bool(ref.converged)
    h = res.rmse_history.numpy()
    assert h[-1] == h[-2] == h[-3]
    np.testing.assert_allclose(h, np.asarray(ref.rmse_history), rtol=1e-4)


def test_icp_numpy_matches_jax():
    source, target = _icp_case(800, "helix", 6)
    got = ticp.icp_numpy(source, target, n_iters=25)
    ref = jicp.icp_numpy(source, target, n_iters=25)
    assert got.R.dtype == torch.float32
    np.testing.assert_array_equal(got.R.numpy(), np.asarray(ref.R))
    np.testing.assert_array_equal(got.t.numpy(), np.asarray(ref.t))


def test_numpy_em_copy_is_bit_for_bit():
    pts = make_cloud_np(400, "trefoil", 7)
    got = tnem.em_fit_numpy(pts, 6, n_iters=8, seed=1)
    ref = jnem.em_fit_numpy(pts, 6, n_iters=8, seed=1)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    pi, mu, sigma, _ = got
    source = pts[::2] + np.float32(0.01)
    for a, b in zip(tnem.register_numpy(source, pi, mu, sigma, n_iters=5),
                    jnem.register_numpy(source, pi, mu, sigma, n_iters=5)):
        np.testing.assert_array_equal(a, b)
