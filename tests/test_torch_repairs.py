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
                                init0=convert.mixture_from_numpy(*init0, device="cpu"))
    jt, jll = jtree.GmmTree.fit(jnp.asarray(pts), branch=4, levels=3, em_iters=8,
                                init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    assert [lvl.pi.shape[0] for lvl in tt.levels] == [4, 16, 64]
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-3, atol=1e-2)
    for lvl in (0, 1):
        for a, b in zip(tt.levels[lvl], jt.levels[lvl]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


def test_branch16_tree_fit_and_registration_match_jax():
    """Branch 16, two levels (K = 16, 256): on the card the wide masked
    body's level; here the fit's logliks and level 0, then register_tree's
    pose, against the JAX package from one init0."""
    pts = make_cloud_np(3000, "trefoil", 4)
    gt = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.2])), torch.tensor([0.04, -0.03, 0.05]))
    source = gt.inverse().apply(torch.from_numpy(pts))
    init0 = _init0(pts, 16, 2)
    tt, tll = ttree.GmmTree.fit(torch.from_numpy(pts), branch=16, levels=2, em_iters=8,
                                init0=convert.mixture_from_numpy(*init0, device="cpu"))
    jt, jll = jtree.GmmTree.fit(jnp.asarray(pts), branch=16, levels=2, em_iters=8,
                                init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    assert [lvl.pi.shape[0] for lvl in tt.levels] == [16, 256]
    np.testing.assert_allclose(tll.numpy(), np.asarray(jll), rtol=1e-3, atol=1e-2)
    for a, b in zip(tt.levels[0], jt.levels[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)
    res = treg.register_tree(source, tt, n_iters=30)
    jres = jreg.register_tree(jnp.asarray(source.numpy()), jt, n_iters=30)
    jpose = convert.pose_from_numpy(np.asarray(jres.pose.R), np.asarray(jres.pose.t), device="cpu")
    assert float(pose_delta_norm(res.pose, gt)) < 0.06
    assert float(pose_delta_norm(res.pose, jpose)) < 1e-3  # two fits 1e-3 apart (tolerances above)


def test_config3_registration_with_top_k_64_matches_jax():
    """config3_mahalanobis at top_k = 64 of its 512 leaves (on the card the
    select body): the registration from one tree in both packages. The
    source points whose gate float32 rounding decides, at the start pose or
    at the truth (em_ref.top_k_near_ties), are left out, and the top 65
    logits of those kept hold no exact tie among the live components: the
    JAX kernel gates at the top_k-th distinct logit, em_ref and the port
    with multiplicity, and without ties the two agree."""
    from hgmm_torch.ops.gaussians import pack_loglik_weights

    p3 = PRESETS["config3_mahalanobis"]
    target = make_cloud_np(3000, "trefoil", seed=4)
    gt = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.25])), torch.tensor([0.05, -0.04, 0.06]))
    init0 = _init0(target, p3.branch, 1)
    tree, _ = ttree.GmmTree.fit(torch.from_numpy(target), branch=p3.branch, levels=p3.levels,
                                em_iters=p3.fit_iters, init0=convert.mixture_from_numpy(*init0, device="cpu"))
    jt = jtree.GmmTree(levels=tuple(jg.MixtureParams(*(jnp.asarray(a.numpy()) for a in lvl))
                                    for lvl in tree.levels), branch=tree.branch)
    W = pack_loglik_weights(tree.levels[-1])
    source = gt.inverse().apply(torch.from_numpy(target))
    near = tref.top_k_near_ties(source, W, (torch.eye(3), torch.zeros(3)), 64)
    near |= tref.top_k_near_ties(source, W, gt, 64)
    assert float(near.double().mean()) < 0.02  # < 1 % at each of the two poses
    source = source[~near].contiguous()
    top = torch.topk(tref._logits(source, W), 65).values
    assert bool(((top[:, 1:] < top[:, :-1]) | (top[:, 1:] <= tref.NEG_INF)).all())
    kw = dict(n_iters=p3.reg_iters, method=p3.method, top_k=64, outlier_logit=p3.outlier_logit,
              complexity_threshold=p3.complexity_threshold)
    res = treg.register_tree(source, tree, **kw)
    jres = jreg.register_tree(jnp.asarray(source.numpy()), jt, **kw)
    jpose = convert.pose_from_numpy(np.asarray(jres.pose.R), np.asarray(jres.pose.t), device="cpu")
    assert float(registration_rmse(res.pose, source, gt)) < 0.03
    assert float(pose_delta_norm(res.pose, gt)) < 0.06
    assert float(pose_delta_norm(res.pose, jpose)) < 1e-4  # tests/test_torch_register.py AGREE_SLICE
    np.testing.assert_allclose(res.logliks[-1].item(), float(jres.logliks[-1]), rtol=1e-4)


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
                                em_iters=p3.fit_iters, init0=convert.mixture_from_numpy(*init0, device="cpu"))
    res = treg.register_tree(source, tree, **kw)
    jt, _ = jtree.GmmTree.fit(jnp.asarray(target), branch=p3.branch, levels=p3.levels,
                              em_iters=p3.fit_iters, init0=jg.MixtureParams(*map(jnp.asarray, init0)))
    jres = jreg.register_tree(jnp.asarray(source.numpy()), jt, **kw)
    jpose = convert.pose_from_numpy(np.asarray(jres.pose.R), np.asarray(jres.pose.t), device="cpu")
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


def _data_entry(name, tmp_path):
    """A call of the data entry point `name` that takes `device`, on files
    it writes into tmp_path: (call(device) -> tensors)."""
    from hgmm_torch.data import kitti, synthetic
    from hgmm_torch.models import se3
    from hgmm_torch.utils import checkpoint as ckpt

    fixture = "tests/fixtures/kitti_mini"
    mix = (np.full(4, 0.25, np.float32), np.zeros((4, 3), np.float32), np.tile(np.eye(3, dtype=np.float32), (4, 1, 1)))
    mixture = convert.mixture_from_numpy(*mix, device="cpu")
    ckpt.save_mixture(tmp_path / "m.npz", mixture)
    ckpt.save_tree(tmp_path / "t.npz", ttree.GmmTree(levels=(mixture,), branch=4))
    ident = Pose.identity(device="cpu")
    ckpt.save_odometry(tmp_path / "o.npz", 1, [ident], [ident, ident], [0.0])
    calls = {
        "make_cloud": lambda d: [synthetic.make_cloud(10, device=d)],
        "random_pose": lambda d: list(se3.random_pose(torch.Generator().manual_seed(0), device=d)),
        "Pose.identity": lambda d: list(Pose.identity(device=d)),
        "load_poses": lambda d: [x for pose in kitti.load_poses(f"{fixture}/poses.txt", device=d) for x in pose],
        "load_calib_velo_to_cam": lambda d: list(kitti.load_calib_velo_to_cam(f"{fixture}/calib.txt", device=d)),
        "load_odometry": lambda d: [x for pose in ckpt.load_odometry(tmp_path / "o.npz", device=d)[2] for x in pose],
        "load_mixture": lambda d: list(ckpt.load_mixture(tmp_path / "m.npz", device=d)),
        "load_tree": lambda d: list(ckpt.load_tree(tmp_path / "t.npz", device=d).levels[0]),
        "mixture_from_numpy": lambda d: list(convert.mixture_from_numpy(*mix, device=d)),
        "tree_from_numpy": lambda d: list(convert.tree_from_numpy([mix], 4, device=d).levels[0]),
        "pose_from_numpy": lambda d: list(convert.pose_from_numpy(np.eye(3), np.zeros(3), device=d)),
        "probe_inputs_from_numpy": lambda d: list(convert.probe_inputs_from_numpy(np.ones(4), device=d)),
    }
    return calls[name]


@pytest.mark.parametrize("entry", ["make_cloud", "random_pose", "Pose.identity", "load_poses",
                                   "load_calib_velo_to_cam", "load_odometry", "load_mixture", "load_tree",
                                   "mixture_from_numpy", "tree_from_numpy", "pose_from_numpy",
                                   "probe_inputs_from_numpy"])
def test_data_entry_points_default_to_the_card(monkeypatch, tmp_path, entry):
    """The entry points that make tensors from host data (a seed, a file,
    numpy) put them on the card when `device` is None, and raise without
    one; they run on the CPU only when asked (the reference's arrays land on
    the default device, the chip)."""
    call = _data_entry(entry, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call(None)
    got = call("cpu")
    assert got and all(t.device.type == "cpu" for t in got)
    assert all(t.device.type == "cpu" for t in call(torch.device("cpu")))


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


# --------------------------------------------------------------------------
# names of the reference's API that the port lacked (ROADMAP Queue 3, closed)


def test_reference_names_are_exported_and_fit_gmm_fits():
    """hgmm exports Gmm, GmmParams, fit_gmm; so does the port. fit_gmm is
    Gmm.fit, and in both packages it runs n_iters sweeps of an EM whose
    log-likelihood does not fall, from each package's own random init."""
    import hgmm
    import hgmm_torch
    from hgmm_torch.ops.gaussians import MixtureParams

    assert hgmm_torch.GmmParams is MixtureParams
    assert {"Gmm", "GmmParams", "fit_gmm"} <= set(dir(hgmm_torch)) & set(dir(hgmm))
    pts = make_cloud_np(2000, "trefoil", seed=3)
    gmm, lls = hgmm_torch.fit_gmm(torch.from_numpy(pts), k=16, n_iters=20,
                                  generator=torch.Generator().manual_seed(1))
    same, _ = hgmm_torch.Gmm.fit(torch.from_numpy(pts), k=16, n_iters=20,
                                 generator=torch.Generator().manual_seed(1))
    assert all(torch.equal(a, b) for a, b in zip(gmm.params, same.params))
    jgmm, jlls = hgmm.fit_gmm(jnp.asarray(pts), k=16, n_iters=20)
    for ll, p in ((lls.numpy(), gmm.params), (np.asarray(jlls), jgmm.params)):
        assert ll.shape == (20,) and np.isfinite(ll).all()
        assert np.all(np.diff(ll) > -1e-3 * np.abs(ll[1:]))
        assert abs(float(np.sum(np.asarray(p.pi))) - 1.0) < 1e-5
    # Two fits of one cloud from two inits: per point within a tenth of a nat.
    assert abs(lls[-1].item() - float(jlls[-1])) / pts.shape[0] < 0.1


def test_random_pose_has_the_reference_distribution():
    import jax

    from hgmm.models import se3 as jse3
    from hgmm_torch.models.se3 import random_pose, so3_log

    g = torch.Generator().manual_seed(0)
    mine = [random_pose(g, max_angle=0.5, max_trans=0.3, device="cpu") for _ in range(400)]
    theirs = jax.vmap(lambda k: jse3.random_pose(k, 0.5, 0.3))(jax.random.split(jax.random.PRNGKey(0), 400))
    ang = np.array([float(torch.linalg.norm(so3_log(p.R))) for p in mine])
    jang = np.linalg.norm(np.stack([np.asarray(jse3.so3_log(r)) for r in theirs.R]), axis=1)
    t, jt = np.stack([p.t.numpy() for p in mine]), np.asarray(theirs.t)
    for a, tt in ((ang, t), (jang, jt)):
        assert a.max() <= 0.5 + 1e-5 and np.abs(tt).max() <= 0.3 + 1e-6
        assert abs(a.mean() - 0.25) < 0.03  # |angle| uniform on [0, 0.5]
        assert np.all(np.abs(tt.mean(0)) < 0.04) and np.all(np.abs(tt.std(0) - 0.3 / np.sqrt(3)) < 0.02)
    for p in mine[:20]:
        np.testing.assert_allclose((p.R @ p.R.T).numpy(), np.eye(3), atol=1e-6)
        assert abs(float(torch.linalg.det(p.R)) - 1.0) < 1e-6


def test_sample_gmm_has_the_reference_moments():
    from hgmm.data import synthetic as jsyn
    from hgmm_torch.data.synthetic import sample_gmm
    from hgmm_torch.ops.gaussians import MixtureParams

    pi = np.array([0.2, 0.5, 0.3], np.float32)
    mu = np.array([[0.0, 0.0, 0.0], [2.0, -1.0, 0.5], [-1.0, 1.5, 2.0]], np.float32)
    a = np.random.default_rng(4).standard_normal((3, 3, 3)).astype(np.float32) * 0.3
    sigma = (np.einsum("kij,klj->kil", a, a) + 0.05 * np.eye(3)).astype(np.float32)
    n = 40_000
    mine = sample_gmm(MixtureParams(*map(torch.from_numpy, (pi, mu, sigma))), n,
                      torch.Generator().manual_seed(5)).numpy()
    import jax

    theirs = np.asarray(jsyn.sample_gmm(jax.random.PRNGKey(5), jg.MixtureParams(*map(jnp.asarray, (pi, mu, sigma))), n))
    mean = (pi[:, None] * mu).sum(0)
    cov = sum(p * (s + np.outer(m - mean, m - mean)) for p, m, s in zip(pi, mu, sigma))
    for x in (mine, theirs):
        assert x.shape == (n, 3) and x.dtype == np.float32
        np.testing.assert_allclose(x.mean(0), mean, atol=0.03)
        np.testing.assert_allclose(np.cov(x.T), cov, atol=0.06)


def test_make_cloud_blob():
    """A sample of a random 12-component mixture in both packages: the same
    family (means in [-1, 1]^3, spread ~0.15), other draws."""
    import jax

    from hgmm.data import synthetic as jsyn
    from hgmm_torch.data.synthetic import make_cloud

    mine = make_cloud(5000, "blob", seed=2, device="cpu").numpy()
    theirs = np.asarray(jsyn.make_cloud(jax.random.PRNGKey(2), 5000, kind="blob"))
    for x in (mine, theirs):
        assert x.shape == (5000, 3) and x.dtype == np.float32 and np.isfinite(x).all()
        assert np.abs(x).max() < 3.0 and np.all((x.std(0) > 0.35) & (x.std(0) < 0.95))
    np.testing.assert_allclose(mine.std(0), theirs.std(0), atol=0.3)
    with pytest.raises(ValueError):
        make_cloud(10, "cube", device="cpu")


def test_dispatch_takes_point_weights_in_the_reference_position():
    """ops.em_stats(points, W, point_weights), em_stats_masked(..., branch,
    point_weights) and reg_stats(..., pose, point_weights) as in hgmm.ops;
    weights beside a Prepared raise, as there."""
    from hgmm import ops as jops
    from hgmm_torch import ops as tops
    from hgmm_torch.ops import gaussians as tg

    rng = np.random.default_rng(6)
    pts = rng.standard_normal((300, 3)).astype(np.float32)
    w = rng.uniform(size=300).astype(np.float32)
    k = 16
    mu = rng.standard_normal((k, 3)).astype(np.float32)
    sigma = np.broadcast_to(0.5 * np.eye(3, dtype=np.float32), (k, 3, 3)).copy()
    pi = np.full(k, 1.0 / k, np.float32)
    jp, tp = jg.MixtureParams(*map(jnp.asarray, (pi, mu, sigma))), tg.MixtureParams(*map(torch.from_numpy, (pi, mu, sigma)))
    jW, tW = jg.pack_loglik_weights(jp), tg.pack_loglik_weights(tp)
    tpts, tw = torch.from_numpy(pts), torch.from_numpy(w)
    parent = rng.integers(-1, k // 8, 300).astype(np.int32)

    def same(a, b, rtol=1e-4, atol=1e-4):
        for x, y in zip(a, b):
            np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64), rtol=rtol, atol=atol)

    same(tops.em_stats(tpts, tW, tw), jops.em_stats(jnp.asarray(pts), jW, jnp.asarray(w)))
    same(tops.em_stats_masked(tpts, tW, torch.from_numpy(parent), 8, tw),
         jops.em_stats_masked(jnp.asarray(pts), jW, jnp.asarray(parent), 8, jnp.asarray(w)))
    tA, tb, _ = tg.precision_terms(tp)
    jA, jb, _ = jg.precision_terms(jp)
    tpose = (so3_exp(torch.tensor([0.1, 0.0, -0.2])), torch.tensor([0.1, 0.2, 0.0]))
    jpose = (jnp.asarray(tpose[0].numpy()), jnp.asarray(tpose[1].numpy()))
    got = tops.reg_stats(tpts, tW, tp.mu, tg.sym_pack(tA), tb, tpose, tw)
    ref = jops.reg_stats(jnp.asarray(pts), jW, jp.mu, jg.sym_pack(jA), jb, jpose, jnp.asarray(w))
    same(got, ref, atol=2e-3)
    assert not torch.allclose(got.loglik, tops.reg_stats(tpts, tW, tp.mu, tg.sym_pack(tA), tb, tpose).loglik)
    prep = tops.prepare(tpts, tw)
    for call in (lambda: tops.em_stats(prep, tW, tw), lambda: tops.em_stats_masked(prep, tW, torch.from_numpy(parent), 8, tw),
                 lambda: tops.reg_stats(prep, tW, tp.mu, tg.sym_pack(tA), tb, tpose, tw)):
        with pytest.raises(ValueError, match="Prepared"):
            call()


# --------------------------------------------------------------------------
# the sub-packages' re-exports (hgmm/models/__init__.py, hgmm/ops/__init__.py)

# Names of the reference's packages that the port does not copy (ROADMAP,
# "What not to copy"): the TPU's feature padding and the backend switch.
DO_NOT_COPY = {"PHI_PAD", "set_backend", "get_backend"}
# What the port's packages have besides the reference's: in ops the fit state
# and the registration scan on the card, their types, a scan's tables built
# from the level's mixture (reg_problem_of), a scan's steps from one call
# (reg_scan), and a sharded sweep's and scan step's one summed row (em_row,
# reg_row); in parallel the in-process
# emulation of R ranks and the type of a rank's own rows (shard_points_from_
# host returns it where the reference returns a global jax.Array).
PORT_EXTRAS = {
    "models": set(),
    "ops": {"EmFit", "EmPartials", "Grouped", "Packed", "RegProblem", "RegScan", "em_partials",
            "em_row", "em_stats_grouped", "em_step", "group_by_parent", "new_fit", "new_scan",
            "reg_partials", "reg_problem_of", "reg_row", "reg_scan", "reg_step"},
    "parallel": {"EmulatedMesh", "ShardedPoints"},
}
REEXPORTS = [
    ("models", "se3", ("Pose", "se3_exp", "se3_log")),
    ("models", "gmm", ("Gmm", "GmmParams", "fit_gmm")),
    ("models", "gmm_tree", ("GmmTree", "fit_gmm_tree")),
    ("ops", "gaussians", ("PHI_DIM", "MixtureParams", "features", "mstep_update", "pack_loglik_weights",
                          "precision_terms", "sym_pack", "sym_unpack", "unpack_suffstats")),
    ("ops", "em_ref", ("EmStats", "RegStats")),
]


def _public(mod) -> set:
    """A package's public names other than modules (a submodule becomes an
    attribute of its package once anything imports it; the re-exported
    module `pose` is checked on its own) and typing's or __future__'s."""
    import types

    return {name for name, obj in vars(mod).items()
            if not name.startswith("_") and not isinstance(obj, types.ModuleType)
            and getattr(obj, "__module__", None) not in ("typing", "__future__")}


@pytest.mark.parametrize("sub", ["models", "ops", "parallel"])
def test_subpackage_names_match_the_reference(sub):
    import importlib

    ref = _public(importlib.import_module(f"hgmm.{sub}"))
    port = _public(importlib.import_module(f"hgmm_torch.{sub}"))
    missing = {n for n in ref - port if n not in DO_NOT_COPY and not n.startswith("HGMM_")}
    assert not missing, f"hgmm_torch.{sub} lacks {sorted(missing)}"
    assert port - ref == PORT_EXTRAS[sub]


@pytest.mark.parametrize("sub,module,name", [(s, m, n) for s, m, names in REEXPORTS for n in names])
def test_reexport_is_the_defining_modules_object(sub, module, name):
    import importlib

    pkg = importlib.import_module(f"hgmm_torch.{sub}")
    assert getattr(pkg, name) is getattr(importlib.import_module(f"hgmm_torch.{sub}.{module}"), name)
    assert hasattr(importlib.import_module(f"hgmm.{sub}"), name)


def test_models_reexports_the_pose_module_and_imports_without_a_cycle():
    import subprocess
    import sys

    from hgmm_torch import models
    from hgmm_torch.models import pose

    assert models.pose is pose and pose.__name__ == "hgmm_torch.models.pose"
    for mod in ("hgmm_torch.models.se3", "hgmm_torch.models", "hgmm_torch.ops", "hgmm_torch"):
        done = subprocess.run([sys.executable, "-c", f"import {mod}"], capture_output=True, text=True)
        assert done.returncode == 0, done.stderr
