"""hgmm_torch.pipelines.pose_graph and the batched SE(3) maps against
hgmm.pipelines.pose_graph on the CPU.

The JAX package takes its per-edge Jacobians with jax.vmap(jax.jacfwd); the
port with torch.func.vmap(torch.func.jacfwd). Both are exact derivatives of
the same float32 residual, so they agree to float32 rounding. The dense solve
at the 1e8 gauge weight is ill-conditioned in float32, so refined poses are
held to the tolerance of the JAX package's own dense-vs-Schur tests
(tests/test_pose_graph.py:104, atol 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import vmap

from hgmm.models import se3 as jse3
from hgmm.pipelines import pose_graph as jpg
from hgmm_torch.models import se3 as tse3
from hgmm_torch.pipelines import pose_graph as tpg

torch.set_num_threads(2)


def _random_poses(rng, n, angle=0.5, trans=2.0):
    omega = (angle * rng.standard_normal((n, 3))).astype(np.float32)
    R = np.stack([np.asarray(jse3.so3_exp(jnp.asarray(o))) for o in omega])
    return R, (trans * rng.standard_normal((n, 3))).astype(np.float32)


def _compose(a, b):
    return a[0] @ b[0], a[0] @ b[1] + a[1]


def _inverse(a):
    return a[0].T, -(a[0].T @ a[1])


@pytest.mark.parametrize("consistent", [False, True])
def test_res_and_jacs_match_jax(consistent):
    """Residuals and both 6x6 Jacobians at xi = 0, for random edges and for
    edges whose measurement equals the relative pose (residual 0)."""
    rng = np.random.default_rng(3)
    e = 16
    TiR, Tit = _random_poses(rng, e)
    TjR, Tjt = _random_poses(rng, e)
    ZR, Zt = _random_poses(rng, e, angle=0.2, trans=0.5)
    if consistent:
        rel = [_compose(_inverse((TiR[k], Tit[k])), (TjR[k], Tjt[k])) for k in range(e)]
        ZR = np.stack([r[0] for r in rel]).astype(np.float32)
        Zt = np.stack([r[1] for r in rel]).astype(np.float32)
    args = (TiR, Tit, TjR, Tjt, ZR, Zt)
    ref = jpg._res_and_jacs(*map(jnp.asarray, args))
    got = tpg._res_and_jacs(*map(torch.from_numpy, args))
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5)


def _circle(m, radius=5.0):
    out = []
    for k in range(m):
        th = 2 * np.pi * k / m
        R = np.asarray(jse3.so3_exp(jnp.array([0.0, 0.0, th], jnp.float32)))
        out.append((R, np.array([radius * np.cos(th), radius * np.sin(th), 0.0], np.float32)))
    return out


def _noisy_graph(m=12, seed=1):
    """A 12-node circle: dead-reckoned from noisy odometry, with two loop
    closures (one exact, one a gross outlier that robust_delta switches off)."""
    rng = np.random.default_rng(seed)
    gt = _circle(m)
    noiseR, noiset = _random_poses(rng, m - 1, angle=0.03, trans=0.03)
    rel = [_compose(_compose(_inverse(gt[k]), gt[k + 1]), (noiseR[k], noiset[k]))
           for k in range(m - 1)]
    init = [gt[0]]
    for z in rel:
        init.append(_compose(init[-1], z))
    lc_good = _compose(_inverse(gt[m - 1]), gt[0])
    bad_R, bad_t = _random_poses(rng, 1, angle=0.4, trans=1.0)
    lc_bad = _compose(_compose(_inverse(gt[8]), gt[2]), (bad_R[0], bad_t[0]))
    edges = dict(
        i=np.array(list(range(m - 1)) + [m - 1, 8]),
        j=np.array(list(range(1, m)) + [0, 2]),
        R=np.stack([r[0] for r in rel] + [lc_good[0], lc_bad[0]]).astype(np.float32),
        t=np.stack([r[1] for r in rel] + [lc_good[1], lc_bad[1]]).astype(np.float32),
        weight=np.array([1.0] * (m - 1) + [10.0, 10.0], np.float32),
    )
    R0 = np.stack([p[0] for p in init]).astype(np.float32)
    t0 = np.stack([p[1] for p in init]).astype(np.float32)
    return R0, t0, edges


@pytest.mark.parametrize("robust_delta", [None, 0.1])
def test_refine_pose_graph_matches_jax(robust_delta):
    R0, t0, e = _noisy_graph()
    jedges = jpg.EdgeList(i=jnp.asarray(e["i"], jnp.int32), j=jnp.asarray(e["j"], jnp.int32),
                          R=jnp.asarray(e["R"]), t=jnp.asarray(e["t"]),
                          weight=jnp.asarray(e["weight"]))
    tedges = tpg.EdgeList(*(torch.from_numpy(e[f]) for f in tpg.EdgeList._fields))
    ref = jpg.refine_pose_graph(jnp.asarray(R0), jnp.asarray(t0), jedges, n_iters=8,
                                robust_delta=robust_delta)
    got = tpg.refine_pose_graph(torch.from_numpy(R0), torch.from_numpy(t0), tedges, n_iters=8,
                                robust_delta=robust_delta)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    np.testing.assert_allclose(got.residual_history.numpy(), np.asarray(ref.residual_history),
                               rtol=1e-3)
    assert got.residual_history[-1] < got.residual_history[0]
    poses = got.poses()
    assert len(poses) == 12 and torch.equal(poses[5].t, got.t[5])


def test_chain_edges_and_concat():
    rng = np.random.default_rng(4)
    R, t = _random_poses(rng, 5)
    rel = [tse3.Pose(torch.from_numpy(R[k]), torch.from_numpy(t[k])) for k in range(5)]
    chain = tpg.odometry_chain_edges(rel)
    assert chain.i.tolist() == [0, 1, 2, 3, 4] and chain.j.tolist() == [1, 2, 3, 4, 5]
    assert torch.equal(chain.weight, torch.ones(5))
    both = tpg.concat_edge_lists(chain, chain)
    assert both.R.shape == (10, 3, 3) and both.i.tolist() == [0, 1, 2, 3, 4] * 2
    jchain = jpg.odometry_chain_edges([jse3.Pose(jnp.asarray(R[k]), jnp.asarray(t[k]))
                                       for k in range(5)])
    np.testing.assert_array_equal(chain.t.numpy(), np.asarray(jchain.t))


@pytest.mark.parametrize("i,j", [([0, 1], [1, 3]), ([-1, 0], [0, 1])])
def test_out_of_range_edges_raise(i, j):
    R = torch.eye(3).expand(3, 3, 3).clone()
    t = torch.zeros(3, 3)
    edges = tpg.EdgeList(torch.tensor(i), torch.tensor(j), torch.eye(3).expand(2, 3, 3),
                         torch.zeros(2, 3), torch.ones(2))
    with pytest.raises(ValueError, match="out of range"):
        tpg.refine_pose_graph(R, t, edges)


def test_batched_se3_maps_equal_unbatched():
    rng = np.random.default_rng(5)
    xi = torch.from_numpy((0.4 * rng.standard_normal((9, 6))).astype(np.float32))
    xi[0] = 0.0
    xi[1, :3] = 1e-5
    P = vmap(tse3.se3_exp)(xi)
    for k in range(9):
        one = tse3.se3_exp(xi[k])
        torch.testing.assert_close(P.R[k], one.R, rtol=0, atol=1e-7)
        torch.testing.assert_close(P.t[k], one.t, rtol=0, atol=1e-7)
    logs = vmap(tse3.se3_log)(P)
    for k in range(9):
        torch.testing.assert_close(logs[k], tse3.se3_log(tse3.Pose(P.R[k], P.t[k])), rtol=0,
                                   atol=1e-7)
    torch.testing.assert_close(logs, xi, rtol=1e-4, atol=1e-5)
    # hat on a batch: [E, 3] -> [E, 3, 3]
    H = tse3.hat(xi[:, :3])
    assert H.shape == (9, 3, 3)
    torch.testing.assert_close(H[4], tse3.hat(xi[4, :3]))
    v = torch.randn(3)
    torch.testing.assert_close(H[4] @ v, torch.linalg.cross(xi[4, :3], v))
