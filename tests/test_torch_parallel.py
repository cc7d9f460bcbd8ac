"""hgmm_torch.parallel and the sharded pose-graph solver against
hgmm.parallel (on the 8 fake CPU devices of tests/conftest.py) and against
the port's unsharded results, on the CPU.

The port's meshes here: a gloo world of one process on an in-process store
(the module fixture `world`), and 3 and 8 ranks emulated in this process
(EmulatedMesh). Inputs are numpy draws from a seed and explicit numpy inits,
passed to both packages. Tolerances: tests/test_parallel.py:36-39 for the
fits and registrations, tests/test_pose_graph.py's sharded-vs-dense ones
for the pose graph.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from hgmm import parallel as jpar
from hgmm.models import gmm_tree as jtree
from hgmm.ops import gaussians as jg
from hgmm.pipelines import pose_graph as jpg
from hgmm_torch import convert
from hgmm_torch import parallel as tpar
from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.models.gmm import em_fit, log_likelihood
from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.parallel import EmulatedMesh
from hgmm_torch.pipelines import pose_graph as tpg
from hgmm_torch.pipelines.register import register_points, register_tree

torch.set_num_threads(2)

MESHES = ["world", 3, 8]
# tests/test_parallel.py:36-39 (rtol, atol).
TOL = {"pi": (1e-4, 1e-6), "mu": (1e-4, 1e-5), "sigma": (1e-3, 1e-5), "ll": (1e-5, 0.0)}
POSE_TOL = (1e-3, 1e-4)  # tests/test_parallel.py:59-60


@pytest.fixture(scope="module")
def world():
    """A gloo world of one process, made (and taken down) by this module:
    xdist's --dist loadfile runs several files in one worker."""
    made = not dist.is_initialized()
    mesh = tpar.make_mesh("cpu")
    yield mesh
    if made:
        dist.destroy_process_group()


def _mesh(world, kind):
    return world if kind == "world" else EmulatedMesh(kind, "cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, tol):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=tol[0], atol=tol[1])


def _init(pts, k, seed):
    """(pi, mu, sigma) numpy: means drawn with numpy, the bounding box's
    isotropic covariance (hgmm/models/gmm.py:init_params)."""
    idx = np.random.default_rng(seed).choice(pts.shape[0], k, replace=False)
    var = (float(np.max(pts.max(0) - pts.min(0))) / max(k ** (1 / 3), 1.0)) ** 2
    sigma = np.broadcast_to(var * np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    return np.full(k, 1.0 / k, np.float32), pts[idx].copy(), sigma.astype(np.float32)


def _jmix(m):
    return jg.MixtureParams(*map(jnp.asarray, m))


def _mix_points(n, seed):
    """tests/test_parallel.py:_mix with numpy draws: three anisotropic blobs."""
    rng = np.random.default_rng(seed)
    mu = np.array([[0.0, 0.0, 0.0], [4.0, 0.0, 0.0], [0.0, 4.0, 4.0]], np.float32)
    comp = rng.choice(3, size=n, p=[0.5, 0.3, 0.2])
    scale = np.sqrt(np.array([0.2, 0.1, 0.3], np.float32))
    return (mu[comp] + scale[comp, None] * rng.standard_normal((n, 3))).astype(np.float32)


# --------------------------------------------------------------------------
# the meshes


def test_make_mesh_is_a_world_of_one_on_gloo(world):
    assert (world.rank, world.size, world.device) == (0, 1, torch.device("cpu"))
    assert "gloo" in str(dist.get_backend())
    t = torch.tensor([1.5, -2.0])
    assert world.all_reduce_(t) is t and t.tolist() == [1.5, -2.0]
    with pytest.raises(ValueError, match="mesh on"):
        world.all_reduce_(torch.zeros(2, device="meta"))
    assert tpar.replicated(world) == world.device and tpar.POINTS_AXIS == "points"


def test_a_card_mesh_is_nccl_or_raises(world, monkeypatch):
    """No fallback: without NCCL a mesh on the card raises, and so does a
    card mesh over a process group that runs gloo alone."""
    with pytest.raises(RuntimeError, match="gloo"):
        monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
        tpar.make_mesh("cuda")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    for call in (lambda: tpar.make_mesh("cuda"), lambda: tpar.initialize_multihost(device="cuda")):
        with pytest.raises(RuntimeError, match="NCCL"):
            call()


def test_make_mesh_joins_a_torchrun_group():
    """With torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT) and no group, make_mesh joins that group (env://), as the
    CLI's --sharded does under torchrun."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    prog = ("import torch.distributed as dist\n"
            "from hgmm_torch.parallel import make_mesh\n"
            "m = make_mesh('cpu')\n"
            "assert dist.is_initialized() and (m.rank, m.size) == (0, 1)\n"
            "store = dist.distributed_c10d._get_default_store()\n"
            "assert not isinstance(store, dist.HashStore), type(store)\n"
            "dist.destroy_process_group()\n"
            "print('joined')\n")
    r = subprocess.run([sys.executable, "-c", prog], env=env, capture_output=True, text=True,
                       timeout=120, cwd=str(Path(__file__).resolve().parents[1]))
    assert r.returncode == 0 and "joined" in r.stdout, r.stderr


def test_emulated_all_reduce_sums_in_rank_order():
    """Each rank holds the float32 sum ((x0 + x1) + x2), the same bits."""
    vals = [1e8, 1.0, -1e8]

    def prog(m):
        return m.all_reduce_(torch.tensor([vals[m.rank], float(m.rank)]))

    out = EmulatedMesh(3, "cpu").run(prog)
    want = torch.tensor(vals[0]) + torch.tensor(vals[1]) + torch.tensor(vals[2])
    for t in out:
        assert t[0].item() == want.item() and t[1].item() == 3.0


def test_emulated_rank_failure_reaches_the_caller():
    def prog(m):
        if m.rank == 1:
            raise KeyError("rank 1")
        return m.all_reduce_(torch.ones(2))

    with pytest.raises(KeyError, match="rank 1"):
        EmulatedMesh(4, "cpu").run(prog)
    with pytest.raises(ValueError, match="ranks hold"):
        EmulatedMesh(2, "cpu").run(lambda m: m.all_reduce_(torch.ones(m.rank + 1)))


@pytest.mark.parametrize("n,size", [(10, 3), (16, 8), (5, 1)])
def test_pad_and_points_sharding(n, size):
    mesh = EmulatedMesh(size, "cpu")
    pts = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
    padded, w = tpar.pad_points_for_mesh(pts, mesh)
    jp, jw = jpar.pad_points_for_mesh(jnp.asarray(pts.numpy()), jpar.make_mesh(jax.devices()[:size]))
    np.testing.assert_array_equal(padded.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    rows = mesh.run(lambda m: tpar.points_sharding(m, padded.shape[0]))
    assert [r.start for r in rows] == [i * padded.shape[0] // size for i in range(size)]
    assert len({r.stop - r.start for r in rows}) == 1


# --------------------------------------------------------------------------
# sharded_em_fit


def _em_case(name):
    """tests/test_parallel.py's three fits: 4096 points / 8 sweeps; ragged
    4001 / 6; weighted 1001 helix points (some weights 0) / 3 sweeps."""
    if name == "base":
        pts = _mix_points(4096, 0)
        return pts, None, _init(pts, 4, 1), 8
    if name == "ragged":
        pts = _mix_points(4001, 2)
        return pts, None, _init(pts, 4, 3), 6
    pts = make_cloud_np(1001, "helix", seed=0)
    w = np.random.default_rng(4).uniform(0.2, 1.0, 1001).astype(np.float32)
    w[::7] = 0.0
    return pts, w, _init(pts, 8, 1), 3


EM_CASES = ("base", "ragged", "weighted")


@pytest.fixture(scope="module")
def em_refs():
    """Each case through hgmm.parallel.sharded_em_fit on the 8 fake devices."""
    out = {}
    for name in EM_CASES:
        pts, w, init, iters = _em_case(name)
        out[name] = jpar.sharded_em_fit(jnp.asarray(pts), _jmix(init), jpar.make_mesh(), n_iters=iters,
                                        point_weights=None if w is None else jnp.asarray(w))
    return out


@pytest.mark.parametrize("case", EM_CASES)
@pytest.mark.parametrize("kind", MESHES)
def test_sharded_em_fit(world, em_refs, kind, case):
    pts, w, init, iters = _em_case(case)
    tw = None if w is None else torch.from_numpy(w)
    tinit = convert.mixture_from_numpy(*init)
    got, ll = tpar.sharded_em_fit(torch.from_numpy(pts), tinit, _mesh(world, kind), n_iters=iters,
                                  point_weights=tw)
    single, ll_s = em_fit(torch.from_numpy(pts), tinit, n_iters=iters, point_weights=tw)
    ref, ll_r = em_refs[case]
    for other, other_ll in ((single, ll_s), (ref, ll_r)):
        for key in ("pi", "mu", "sigma"):
            _close(getattr(got, key), getattr(other, key), TOL[key])
        _close(ll, other_ll, TOL["ll"])


def test_points_from_each_host(world):
    """Each rank wraps its own rows (shard_points_from_host, unequal shares):
    the fit equals the whole cloud's; a tree fit of such rows needs init0."""
    pts, _, init, iters = _em_case("ragged")
    tinit = convert.mixture_from_numpy(*init)
    cuts = [0, 1000, 2500, 4001]

    def prog(m):
        local = tpar.shard_points_from_host(pts[cuts[m.rank]:cuts[m.rank + 1]], m)
        assert local.n == 4001 and local.local.shape[0] == cuts[m.rank + 1] - cuts[m.rank]
        return tpar.sharded_em_fit(local, tinit, m, n_iters=iters)

    (got, ll), *_ = EmulatedMesh(3, "cpu").run(prog)
    single, ll_s = em_fit(torch.from_numpy(pts), tinit, n_iters=iters)
    for key in ("pi", "mu", "sigma"):
        _close(getattr(got, key), getattr(single, key), TOL[key])
    _close(ll, ll_s, TOL["ll"])
    with pytest.raises(ValueError, match="init0"):
        tpar.sharded_tree_fit(tpar.shard_points_from_host(pts, world), world, levels=2)


# --------------------------------------------------------------------------
# sharded_tree_fit and the registrations


@pytest.fixture(scope="module")
def tree_refs():
    """tests/test_parallel.py:64-74's helix tree (2,048 points, branch 8, 2
    levels, 6 sweeps) from one numpy init0, by hgmm.parallel."""
    pts = make_cloud_np(2048, "helix", seed=7)
    init0 = _init(pts, 8, 5)
    ref = jpar.sharded_tree_fit(jnp.asarray(pts), jpar.make_mesh(), branch=8, levels=2, em_iters=6,
                                init0=_jmix(init0))
    return pts, init0, ref


@pytest.mark.parametrize("kind", MESHES)
def test_sharded_tree_fit(world, tree_refs, kind):
    """Against hgmm.parallel and GmmTree.fit: each level's per-point loglik
    (rtol 1e-3, tests/test_torch_models.py's tree tolerance) and level 0's
    parameters; the leaves model the data better than the root."""
    pts, init0, ref = tree_refs
    tp = torch.from_numpy(pts)
    got = tpar.sharded_tree_fit(tp, _mesh(world, kind), branch=8, levels=2, em_iters=6,
                                init0=convert.mixture_from_numpy(*init0))
    single, _ = GmmTree.fit(tp, branch=8, levels=2, em_iters=6, init0=convert.mixture_from_numpy(*init0))
    carried = convert.tree_from_numpy([tuple(np.asarray(a) for a in lvl) for lvl in ref.levels], 8)
    assert [lvl.pi.shape[0] for lvl in got.levels] == [8, 64]
    for other in (single, carried):
        for a, b in zip(got.levels, other.levels):
            _close(log_likelihood(a, tp), log_likelihood(b, tp), (1e-3, 0.0))
        for key in ("pi", "mu", "sigma"):
            _close(getattr(got.levels[0], key), getattr(other.levels[0], key), (1e-3, 1e-4))
    assert float(log_likelihood(got.levels[1], tp)) > float(log_likelihood(got.levels[0], tp))


def _trefoil_problem():
    """tests/test_parallel.py:46-56: a trefoil, a known pose, a K=16 fit."""
    cloud = make_cloud_np(2048, "trefoil", seed=4)
    gt = Pose(so3_exp(torch.tensor([0.05, -0.1, 0.15])), torch.tensor([0.03, -0.02, 0.04]))
    source = gt.inverse().apply(torch.from_numpy(cloud))
    params, _ = em_fit(torch.from_numpy(cloud), convert.mixture_from_numpy(*_init(cloud, 16, 6)),
                       n_iters=15)
    tree, _ = GmmTree.fit(torch.from_numpy(cloud), branch=8, levels=2, em_iters=8,
                          init0=convert.mixture_from_numpy(*_init(cloud, 8, 7)))
    return source, gt, params, tree


@pytest.fixture(scope="module")
def reg_refs():
    source, gt, params, tree = _trefoil_problem()
    jsrc = jnp.asarray(source.numpy())
    jparams = jg.MixtureParams(*(jnp.asarray(_np(a)) for a in params))
    jt = jtree.GmmTree(levels=tuple(jg.MixtureParams(*(jnp.asarray(_np(a)) for a in lvl))
                                    for lvl in tree.levels), branch=8)
    points = jpar.sharded_register_points(jsrc, jparams, jpar.make_mesh(), n_iters=25)
    tree_res = jpar.sharded_register_tree(jsrc, jt, jpar.make_mesh(), n_iters=20, method="horn+wls")
    return (source, gt, params, tree), points, tree_res


def _pose_close(got, ref):
    _close(got.R, ref.R, POSE_TOL)
    _close(got.t, ref.t, POSE_TOL)


@pytest.mark.parametrize("kind", MESHES)
def test_sharded_register_points(world, reg_refs, kind):
    (source, gt, params, _), ref, _ = reg_refs
    got = tpar.sharded_register_points(source, params, _mesh(world, kind), n_iters=25)
    single = register_points(source, params, n_iters=25)
    _pose_close(got.pose, single.pose)
    _pose_close(got.pose, ref.pose)
    assert got.logliks.shape == got.deltas.shape == (25,)
    assert float(torch.linalg.norm(got.pose.t - gt.t)) < 0.05


@pytest.mark.parametrize("kind", MESHES)
def test_sharded_register_tree(world, reg_refs, kind):
    (source, gt, _, tree), _, ref = reg_refs
    got = tpar.sharded_register_tree(source, tree, _mesh(world, kind), n_iters=20, method="horn+wls")
    single = register_tree(source, tree, n_iters=20, method="horn+wls")
    _pose_close(got.pose, single.pose)
    _pose_close(got.pose, ref.pose)
    assert got.logliks.shape == (40,) and bool(got.converged) == bool(single.converged)
    assert float(torch.linalg.norm(got.pose.t - gt.t)) < 0.02


def test_generator_draws_are_the_same_on_every_rank(world):
    """An EmulatedMesh gives each rank but 0 its own copy of a generator
    argument: the default init draws the same means on every rank, and the
    caller's generator advances by one draw, as in GmmTree.fit."""
    pts = torch.from_numpy(make_cloud_np(1500, "trefoil", seed=2))
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    a = tpar.sharded_tree_fit(pts, EmulatedMesh(3, "cpu"), levels=2, em_iters=4, generator=g1)
    b = tpar.sharded_tree_fit(pts, world, levels=2, em_iters=4, generator=g2)
    _close(a.levels[0].mu, b.levels[0].mu, TOL["mu"])
    assert torch.equal(g1.get_state(), g2.get_state())


# --------------------------------------------------------------------------
# the sharded Schur pose-graph solver


def test_chain_segmentation_equals_the_reference():
    rng = np.random.default_rng(0)
    cases = [(m, s, ()) for m in (2, 3, 9, 17, 40) for s in (1, 2, 3, 8)]
    for m, s in ((25, 3), (83, 8), (40, 2), (2000, 8)):
        for c in (2, 6, 20):
            cases.append((m, s, rng.choice(m, size=min(c, m), replace=False).tolist()))
    cases.append((2000, 8, (10 + np.arange(60) * 2).tolist()))
    for m, s, cl in cases:
        got, ref = tpg._chain_segmentation(m, s, cl), jpg._chain_segmentation(m, s, cl)
        assert tpg._can_shard_chain(m, s) == jpg._can_shard_chain(m, s) == (got is not None)
        if ref is None:
            assert got is None
            continue
        assert got.keys() == ref.keys()
        for key, value in ref.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=f"{key} m={m} s={s}")
            else:
                assert got[key] == value, key


def _circle(m, radius=5.0):
    return [Pose(so3_exp(torch.tensor([0.0, 0.0, 2 * np.pi * k / m])),
                 torch.tensor([radius * np.cos(2 * np.pi * k / m), radius * np.sin(2 * np.pi * k / m),
                               0.0], dtype=torch.float32)) for k in range(m)]


def _step_noise(rng, angle, trans):
    """A small pose drawn with numpy: rotation vector and translation uniform
    within the bounds."""
    return Pose(so3_exp(torch.from_numpy(rng.uniform(-angle, angle, 3).astype(np.float32))),
                torch.from_numpy(rng.uniform(-trans, trans, 3).astype(np.float32)))


def _chain(m, seed, noise):
    """tests/test_pose_graph.py's noisy circle chain: the measured steps are
    the true ones times noise, the initial poses their composition."""
    rng = np.random.default_rng(seed)
    gt = _circle(m)
    rel = [gt[k].inverse().compose(gt[k + 1]).compose(_step_noise(rng, noise, noise))
           for k in range(m - 1)]
    init = [gt[0]]
    for z in rel:
        init.append(init[-1].compose(z))
    return gt, rel, init


def _closures(gt, pairs, weight):
    lc = [gt[a].inverse().compose(gt[b]) for a, b in pairs]
    return tpg.EdgeList(torch.tensor([a for a, _ in pairs]), torch.tensor([b for _, b in pairs]),
                        torch.stack([p.R for p in lc]), torch.stack([p.t for p in lc]),
                        torch.full((len(pairs),), float(weight)))


def _pg_case(name, s):
    """(chain length, closures, robust_delta, atol) of the cases of
    tests/test_pose_graph.py:86-400 at S ranks."""
    if name == "arbitrary_length":
        return 2 * s + 4, [], None, 1e-3
    if name == "loop_closure":
        return 2 * s + 5, lambda m: [(m - 1, 0)], None, 1e-3
    if name == "interior_closure":
        return 3 * s + 2, lambda m: [(3, m - 4)], None, 1e-3
    if name == "many_closures":
        def pairs(m):
            rng = np.random.default_rng(5)
            out = set()
            for c in range(20):
                if c % 2 == 0:
                    i = int(rng.integers(0, m - 25))
                    out.add((i, int(rng.integers(i + 20, m))))
                else:
                    i = int(rng.integers(0, m - 8))
                    out.add((i, i + int(rng.integers(2, 7))))
            return sorted(out)
        return 10 * s + 3 if s > 1 else 33, pairs, None, 2e-3
    if name == "robust_false_closure":
        return 2 * s + 3, "false", 0.1, 1e-3
    raise KeyError(name)


PG_ITERS = 6  # Gauss-Newton steps (tests/test_pose_graph.py:290's sweep)


PG_CASES = ("arbitrary_length", "loop_closure", "interior_closure", "many_closures",
            "robust_false_closure")


@pytest.mark.parametrize("s", [1, 3, 8])
@pytest.mark.parametrize("case", PG_CASES)
def test_refine_chain_sharded(world, case, s):
    """Against the dense refine_pose_graph (same edges) and hgmm's
    refine_chain_sharded on an s-device mesh."""
    m, pairs, robust, atol = _pg_case(case, s)
    iters = PG_ITERS
    gt, rel, init = _chain(m, 40 + s + len(case), 0.02)
    if pairs == "false":  # claims node m-2 sits at node 1 (tests/test_pose_graph.py:243)
        closures = tpg.EdgeList(torch.tensor([1]), torch.tensor([m - 2]), torch.eye(3)[None],
                                torch.zeros(1, 3), torch.tensor([10.0]))
    else:
        closures = _closures(gt, pairs(m), 4.0) if pairs else None
    R0, t0 = torch.stack([p.R for p in init]), torch.stack([p.t for p in init])
    chain = tpg.odometry_chain_edges(rel)
    edges = chain if closures is None else tpg.concat_edge_lists(chain, closures)
    damping = 1e-6 if robust else 1e-8
    dense = tpg.refine_pose_graph(R0, t0, edges, n_iters=iters, damping=damping, robust_delta=robust)
    mesh = world if s == 1 else EmulatedMesh(s, "cpu")
    got = tpg.refine_chain_sharded(R0, t0, chain.R, chain.t, mesh, n_iters=iters, damping=damping,
                                   closures=closures, robust_delta=robust)
    _close(got.t, dense.t, (0.0, atol))
    _close(got.R, dense.R, (0.0, atol))
    if robust is None:
        _close(got.residual_history, dense.residual_history, (1e-3, 1e-5))
    jcl = None if closures is None else jpg.EdgeList(*(jnp.asarray(_np(x)) for x in closures))
    ref = jpg.refine_chain_sharded(jnp.asarray(R0.numpy()), jnp.asarray(t0.numpy()),
                                   jnp.asarray(chain.R.numpy()), jnp.asarray(chain.t.numpy()),
                                   jpar.make_mesh(jax.devices()[:s]), n_iters=iters, damping=damping,
                                   closures=jcl, robust_delta=robust)
    _close(got.t, ref.t, (0.0, atol))
    _close(got.R, ref.R, (0.0, atol))


@pytest.mark.parametrize("s", [3, 8])
def test_short_chain_falls_back_to_dense(s):
    """M - 1 < S: the dense solver (tests/test_pose_graph.py:201)."""
    m = max(3, s - 2)
    gt, rel, init = _chain(m, 7, 0.03)
    R0, t0 = torch.stack([p.R for p in init]), torch.stack([p.t for p in init])
    chain = tpg.odometry_chain_edges(rel)
    dense = tpg.refine_pose_graph(R0, t0, chain, n_iters=6)
    got = tpg.refine_chain_sharded(R0, t0, chain.R, chain.t, EmulatedMesh(s, "cpu"), n_iters=6)
    _close(got.t, dense.t, (0.0, 1e-5))


@pytest.mark.parametrize("s", [1, 3, 8])
def test_out_of_range_closure_raises(world, s):
    m = 2 * s + 3
    gt, rel, init = _chain(m, 1, 0.01)
    R0, t0 = torch.stack([p.R for p in init]), torch.stack([p.t for p in init])
    chain = tpg.odometry_chain_edges(rel)
    bad = tpg.EdgeList(torch.tensor([0]), torch.tensor([m]), torch.eye(3)[None], torch.zeros(1, 3),
                       torch.ones(1))
    with pytest.raises(ValueError, match="out of range"):
        tpg.refine_chain_sharded(R0, t0, chain.R, chain.t, world if s == 1 else EmulatedMesh(s, "cpu"),
                                 n_iters=2, closures=bad)
    with pytest.raises(ValueError, match="out of range"):
        jpg.refine_chain_sharded(jnp.asarray(R0.numpy()), jnp.asarray(t0.numpy()),
                                 jnp.asarray(chain.R.numpy()), jnp.asarray(chain.t.numpy()),
                                 jpar.make_mesh(jax.devices()[:s]), n_iters=2,
                                 closures=jpg.EdgeList(*(jnp.asarray(_np(x)) for x in bad)))


def test_pose_graph_gathers_every_node_once():
    """Every node of the chain is owned by exactly one rank's rows (an
    interior of one segment, or retained and written by rank 0), so the
    final sum over the mesh adds each pose to zeros once."""
    for m, s, cl in ((17, 3, [2, 9]), (40, 8, [0, 5, 39, 11]), (9, 8, [])):
        seg = tpg._chain_segmentation(m, s, cl)
        owned = [x for d in range(s) for x in seg["int_scatter"][d].tolist() if x < m]
        owned += [x for x in seg["gnode"].tolist() if x < m]
        assert sorted(owned) == list(range(m))



# --------------------------------------------------------------------------
# two processes over gloo


@pytest.mark.slow
def test_two_process_gloo_run(tmp_path):
    """The twin of tests/test_multiprocess.py: two CPU processes join a gloo
    group through initialize_multihost, each holding its half of the cloud
    (shard_points_from_host); the sharded EM, registration and Schur
    refinement match one process's em_fit, register_points and the dense
    solver."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from _torch_mp_case import chain_case, cloud_case, gt_pose

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "mp.npz"
    worker = Path(__file__).with_name("_torch_mp_worker.py")
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    procs = [subprocess.Popen([sys.executable, str(worker), f"127.0.0.1:{port}", "2", str(i), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for i in range(2)]
    logs = [p.communicate(timeout=300)[0].decode(errors="replace") for p in procs]
    assert all(p.returncode == 0 for p in procs), logs
    got = np.load(out)
    pts, init = cloud_case()
    params, lls = em_fit(torch.from_numpy(pts), convert.mixture_from_numpy(*init), n_iters=5)
    _close(got["lls"], lls, (2e-4, 0.0))  # tests/test_multiprocess.py:74-76
    _close(got["pi"], params.pi, (0.0, 2e-4))
    _close(got["mu"], params.mu, (0.0, 2e-3))
    gt = gt_pose()
    src = gt.inverse().apply(torch.from_numpy(pts))
    mp_params = convert.mixture_from_numpy(got["pi"], got["mu"], got["sigma"])
    res = register_points(src, mp_params, n_iters=20, method="horn")
    _close(got["R"], res.pose.R, (0.0, 1e-4))
    _close(got["t"], res.pose.t, (0.0, 1e-4))
    R0, t0, chain, closures = chain_case(7)
    dense = tpg.refine_pose_graph(R0, t0, tpg.concat_edge_lists(chain, closures), n_iters=6,
                                  damping=1e-8, robust_delta=5.0)
    _close(got["pg_t"], dense.t, (0.0, 1e-3))
    _close(got["pg_R"], dense.R, (0.0, 1e-3))
