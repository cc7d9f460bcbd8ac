"""The CUDA kernels of hgmm_torch against their plain PyTorch versions, on
the card. Every test here needs a CUDA device and skips without one.

On a machine with a card and without jax, run them without the suite's
conftest (which sets up jax for the other files):

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tolerances are the strict ones of tests/test_fused_em.py (:55-56 and
:196-198), which that file states for N=300 points; the sums here run over N
points, so atol is scaled by N / 300. The plain versions run in full float32
(hgmm_torch turns TF32 off).
"""

import pytest
import torch

import hgmm_torch  # noqa: F401  (sets the float32 matmul flags)
from hgmm_torch.models.se3 import so3_exp
from hgmm_torch.ops import em_ref, fused_em, prepare
from hgmm_torch.ops.gaussians import MixtureParams, pack_loglik_weights, precision_terms, sym_pack

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mixture(k, seed, dev, dead=()):
    g = torch.Generator().manual_seed(seed)
    a = 0.3 * torch.randn(k, 3, 3, generator=g)
    pi = torch.softmax(torch.randn(k, generator=g), 0)
    pi[list(dead)] = 0.0
    params = MixtureParams(pi / pi.sum(), torch.randn(k, 3, generator=g),
                           a @ a.transpose(1, 2) + 0.05 * torch.eye(3))
    return MixtureParams(*(x.to(dev) for x in params))


def _inputs(n, seed, dev):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, generator=g).to(dev), torch.rand(n, generator=g).to(dev)


def _close(got, ref, rtol, atol):
    torch.testing.assert_close(got.double(), ref.double(), rtol=rtol, atol=atol)


def _check_em(got, ref, n):
    _close(got.S, ref.S, 2e-3, 2e-4 * n / 300)
    _close(got.loglik, ref.loglik, 1e-4, 0.0)


@pytest.mark.parametrize("k", [8, 12, 64, 512])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -3.0)])
def test_em_stats(cuda, k, weighted, outlier):
    n = 20_000
    pts, w = _inputs(n, k, cuda)
    w = w if weighted else None
    W = pack_loglik_weights(_mixture(k, k + 1, cuda, dead=(1,)))
    got = fused_em.em_stats(prepare(pts, w).pts4, W, outlier)
    _check_em(got, em_ref.em_stats(pts, W, w, outlier), n)
    assert float(got.S[1].abs().max()) == 0.0  # pi = 0 stays inert


@pytest.mark.parametrize("k", [64, 512])
def test_em_stats_masked(cuda, k):
    n = 20_000
    pts, w = _inputs(n, k + 2, cuda)
    par = torch.randint(-1, k // 8, (n,), generator=torch.Generator().manual_seed(k)).to(cuda)
    W = pack_loglik_weights(_mixture(k, k + 3, cuda))
    got = fused_em.em_stats_masked(prepare(pts, w).pts4, W, par, 8)
    _check_em(got, em_ref.em_stats_masked(pts, W, par, 8, w), n)


@pytest.mark.parametrize("k", [8, 64, 512])
def test_assign(cuda, k):
    n = 20_000
    pts, _ = _inputs(n, k + 4, cuda)
    par = torch.randint(-1, k // 8, (n,), generator=torch.Generator().manual_seed(k)).to(cuda)
    W = pack_loglik_weights(_mixture(k, k + 5, cuda))
    for parent, branch in ((None, None), (par, 8)):
        got = fused_em.assign(prepare(pts).pts4, W, parent, branch)
        ref = em_ref.assign(pts, W, parent, branch)
        bad = (got != ref).nonzero().flatten()
        if bad.numel():  # only near-ties may flip: the plain logits differ by < 1e-4
            logits = em_ref._logits(pts[bad], W)
            if parent is not None:
                logits = em_ref.child_mask_logits(logits, parent[bad], branch)
            rows = torch.arange(bad.numel(), device=cuda)
            gap = logits[rows, ref[bad].long()] - logits[rows, got[bad].long()]
            assert float(gap.max()) < 1e-4


def _check_reg_stats(cuda, params, n, seed, weighted, top_k, outlier):
    pts, w = _inputs(n, seed, cuda)
    w = w if weighted else None
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=cuda)),
            torch.tensor([0.05, 0.0, -0.1], device=cuda))
    if top_k is not None and top_k < W.shape[1]:
        # A point whose gate float32 rounding decides may keep a component in
        # one version and not in the other: weigh those (< 1 %) 0 in both.
        near = em_ref.top_k_near_ties(pts, W, pose, top_k)
        assert float(near.double().mean()) < 0.01
        w = (torch.ones_like(pts[:, 0]) if w is None else w) * (~near)
    got = fused_em.reg_stats(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, pose, top_k,
                             outlier)
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, top_k, outlier)
    s = n / 300
    _close(got.horn, ref.horn, 2e-3, 2e-3 * s)
    _close(got.A, ref.A, 2e-3, 2e-2 * s)
    _close(got.b, ref.b, 2e-3, 2e-2 * s)
    _close(got.loglik, ref.loglik, 1e-4, 0.0)


@pytest.mark.parametrize("k", [8, 64, 384])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -2.0)])
@pytest.mark.parametrize("top_k", [None, 1, 8, 32])
def test_reg_stats(cuda, k, weighted, outlier, top_k):
    """top_k >= K gates nothing (the kernel's plain path), as in em_ref."""
    _check_reg_stats(cuda, _mixture(k, k + 7, cuda, dead=(2,)), 20_000, k + 6, weighted, top_k,
                     outlier)


@pytest.mark.parametrize("top_k", [1, 8, 32])
def test_reg_stats_top_k_keeps_exact_ties(cuda, top_k):
    """Every component twice: the top_k-th logit ties exactly with another
    one, and both are kept (em_ref counts the threshold with multiplicity)."""
    half = _mixture(96, 15, cuda, dead=(5,))
    params = MixtureParams(torch.cat([half.pi, half.pi]) / 2, torch.cat([half.mu, half.mu]),
                           torch.cat([half.sigma, half.sigma]))
    _check_reg_stats(cuda, params, 20_000, 16, True, top_k, 0.0)


def test_results_are_reproducible(cuda):
    """The cross-block sums run in a fixed order: two runs agree bit for bit."""
    pts, w = _inputs(300_000, 9, cuda)
    W = pack_loglik_weights(_mixture(512, 10, cuda))
    p = prepare(pts, w).pts4
    a, b = fused_em.em_stats(p, W), fused_em.em_stats(p, W)
    assert torch.equal(a.S, b.S) and torch.equal(a.loglik, b.loglik)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pts, _ = _inputs(100, 11, cuda)
    params = _mixture(8, 12, cuda)
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    p = prepare(pts).pts4
    pose = (torch.eye(3, device=cuda), torch.zeros(3, device=cuda))
    p64 = _mixture(64, 12, cuda)
    A64, b64, _ = precision_terms(p64)
    with pytest.raises(ValueError, match="top_k"):  # 32 < top_k < K
        fused_em.reg_stats(p, pack_loglik_weights(p64), p64.mu, sym_pack(A64), b64, pose,
                           top_k=fused_em.MAX_TOP_K + 1)
    with pytest.raises(ValueError):
        fused_em.em_stats(p.double(), W)
    with pytest.raises(ValueError):
        fused_em.em_stats(p[:, ::2], W)  # not contiguous
    with pytest.raises(ValueError):
        fused_em.em_stats(p, torch.zeros(10, fused_em.MAX_K + 1, device=cuda))


@pytest.mark.parametrize("nq,nt,ties", [(1, 1, False), (500, 700, False), (3000, 5000, True),
                                        (1025, 1023, False), (70_000, 3, False), (3, 70_000, True)])
def test_knn(cuda, nq, nt, ties):
    """The kernel's neighbour is as near as the twin's (float64 distances;
    the twin's factored form cancels at close range), indices agree but for
    near-ties, and of exact ties the lowest index wins."""
    from hgmm_torch.ops import knn

    g = torch.Generator().manual_seed(nq + nt)
    q, t = torch.randn(nq, 3, generator=g), torch.randn(nt, 3, generator=g)
    if ties:
        t = torch.cat([t, t])
        q[: nq // 4] = t[: nq // 4]
    q, t = q.to(cuda), t.to(cuda)
    idx, d2 = knn.nearest_neighbor_cuda(q, t)
    ref_idx, ref_d2 = knn.nearest_neighbor_ref(q, t)
    assert idx.dtype == torch.int32 and idx.shape == d2.shape == (nq,)
    q64, t64 = q.double(), t.double()
    mine = ((q64 - t64[idx.long()]) ** 2).sum(1)
    theirs = ((q64 - t64[ref_idx.long()]) ** 2).sum(1)
    assert bool((mine <= theirs + 1e-6 * (1 + (q64 ** 2).sum(1))).all())
    _close(d2, mine, 1e-5, 1e-7)
    assert float((idx == ref_idx).double().mean()) >= 0.98
    if ties:
        assert int(idx.max()) < t.shape[0] // 2


def test_dispatch_sends_cuda_tensors_to_the_kernels(cuda):
    from hgmm_torch import ops
    from hgmm_torch.ops import knn

    pts, _ = _inputs(1000, 13, cuda)
    W = pack_loglik_weights(_mixture(8, 14, cuda))
    fused_em.reset_launches()
    ops.em_stats(pts, W)
    ops.assign(pts, W)
    knn.nearest_neighbor(pts, pts)
    assert fused_em.LAUNCHES["em_stats"] == 1 and fused_em.LAUNCHES["assign"] == 1
    assert fused_em.LAUNCHES["knn"] == 1


def test_build_map_fits_on_the_poses_device(cuda):
    """build_map takes its device from the poses: poses on the card put the
    map fit on the card's kernels, whatever the frames (numpy) are."""
    from hgmm_torch.data.synthetic import make_cloud_np
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.pipelines.mapping import MapConfig, build_map

    frames = [make_cloud_np(3000, "trefoil", seed=s) for s in range(3)]
    poses = [Pose.identity(device=cuda) for _ in frames]
    fused_em.reset_launches()
    tree = build_map(frames, poses, MapConfig(levels=2, em_iters=4, bucket=8192, voxel=0))
    assert tree.levels[-1].mu.device.type == "cuda"
    assert fused_em.LAUNCHES["em_stats"] > 0 and fused_em.LAUNCHES["em_stats_masked"] > 0


def _lidar(n, k, seed, dev, extent):
    """LiDAR-like inputs (hgmm_torch.data.synthetic.lidar_*): coordinates in
    +-extent metres, near-planar covariances with a 0.02 m minor axis, 30 %
    zero-weight rows at the origin (the odometry bucket's padding)."""
    from hgmm_torch.data.synthetic import lidar_mixture_np, lidar_points_np

    mix = lidar_mixture_np(k, seed, extent=extent)
    pts, w = lidar_points_np(n, mix, seed + 1, extent=extent)
    params = MixtureParams(*(torch.from_numpy(a).to(dev) for a in mix))
    return torch.from_numpy(pts).to(dev), torch.from_numpy(w).to(dev), params


# At 40 m the expanded quadratic form's terms reach ~1e6 and float32 rounds
# them at ~0.1 nat, so the kernel and its twin round differently: there the
# kernel is held to the float64 direct form (em_ref.*_direct) within the
# strict tolerance widened by twice the twin's own gap. At 2 m both meet the
# strict kernel-vs-twin tolerances (chip_smoke.py, LIDAR_STRICT_EXTENT).
EXTENTS = [2.0, 40.0]


def _check_scaled(got, ref, ref64, tols):
    for f, (rtol, atol) in tols.items():
        g, r, e = (getattr(v, f).double().cpu() for v in (got, ref, ref64))
        limit = 2.0 * float((r - e).abs().max()) + atol + rtol * float(e.abs().max())
        assert float((g - e).abs().max()) <= limit, f


def _hold(got, ref, ref64, extent, tols):
    if extent <= 2.0:
        for f, (rtol, atol) in tols.items():
            _close(getattr(got, f), getattr(ref, f), rtol, atol)
    _check_scaled(got, ref, ref64, tols)


@pytest.mark.parametrize("extent", EXTENTS)
@pytest.mark.parametrize("k", [8, 64, 512])
@pytest.mark.parametrize("outlier", [None, -8.0])
def test_em_stats_lidar_scale(cuda, extent, k, outlier):
    n = 16_384
    pts, w, params = _lidar(n, k, k, cuda, extent)
    W = pack_loglik_weights(params)
    _hold(fused_em.em_stats(prepare(pts, w).pts4, W, outlier), em_ref.em_stats(pts, W, w, outlier),
          em_ref.em_stats_direct(pts, params, w, outlier), extent,
          {"S": (2e-3, 2e-4 * n / 300), "loglik": (1e-4, 0.0)})


@pytest.mark.parametrize("extent", EXTENTS)
@pytest.mark.parametrize("k", [64, 512])
def test_em_stats_masked_and_assign_lidar_scale(cuda, extent, k):
    n = 16_384
    pts, w, params = _lidar(n, k, k + 1, cuda, extent)
    W = pack_loglik_weights(params)
    prep = prepare(pts, w)
    parent = em_ref.assign(pts, pack_loglik_weights(MixtureParams(
        torch.full((k // 8,), 8.0 / k, device=cuda), params.mu[::8], params.sigma[::8] * 4.0)))
    _hold(fused_em.em_stats_masked(prep.pts4, W, parent, 8), em_ref.em_stats_masked(pts, W, parent, 8, w),
          em_ref.em_stats_direct(pts, params, w, None, parent, 8), extent,
          {"S": (2e-3, 2e-4 * n / 300), "loglik": (1e-4, 0.0)})
    for par, branch in ((None, None), (parent, 8)):
        got, ref = fused_em.assign(prep.pts4, W, par, branch), em_ref.assign(pts, W, par, branch)
        bad = (got != ref).nonzero().flatten()
        if bad.numel():  # near-ties only: within rounding of the logit's terms
            logits = em_ref._logits(pts[bad], W)
            if par is not None:
                logits = em_ref.child_mask_logits(logits, par[bad], branch)
            rows = torch.arange(bad.numel(), device=cuda)
            gap = logits[rows, ref[bad].long()] - logits[rows, got[bad].long()]
            scale = 0.5 * (em_ref.features(pts[bad]).abs() @ W[:10].abs()).amax(1)
            assert bool((gap < 1e-4 + 2e-6 * scale).all())


@pytest.mark.parametrize("extent", EXTENTS)
@pytest.mark.parametrize("k", [8, 64, 512])
def test_reg_stats_lidar_scale(cuda, extent, k):
    """The odometry registration: wls terms, outlier logit -8, padded source."""
    n = 16_384
    pts, w, params = _lidar(n, k, k + 2, cuda, extent)
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.0, 0.0, 0.05], device=cuda)),
            torch.tensor([0.3, -0.1, 0.02], device=cuda))
    s = float((w > 0).sum()) / 300
    _hold(fused_em.reg_stats(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, pose, None, -8.0),
          em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, None, -8.0),
          em_ref.reg_stats_direct(pts, params, pose, w, -8.0), extent,
          {"horn": (2e-3, 2e-3 * s), "A": (2e-3, 2e-2 * s), "b": (2e-3, 2e-2 * s),
           "loglik": (1e-4, 0.0)})


def test_refine_pose_graph_on_the_card(cuda):
    """Dense refinement on the card: its Hessian assembly sums with atomics,
    so two runs may differ in the last bits (<= 1e-6); it agrees with the CPU
    to the 1e-3 of the JAX package's dense-vs-Schur tests."""
    from hgmm_torch.models.se3 import se3_exp
    from hgmm_torch.pipelines.pose_graph import EdgeList, refine_pose_graph

    g = torch.Generator().manual_seed(3)
    m = 40
    xi = torch.zeros(m - 1, 6)
    xi[:, 2] = 2 * torch.pi / m
    xi[:, 3] = 1.0
    noisy = xi + 0.01 * torch.randn(m - 1, 6, generator=g)
    steps = [se3_exp(x) for x in noisy]
    R, t = [torch.eye(3)], [torch.zeros(3)]
    for s in steps:
        R.append(R[-1] @ s.R)
        t.append(R[-2] @ s.t + t[-1])
    closure = se3_exp(xi[0])
    edges = EdgeList(torch.arange(m), torch.cat([torch.arange(1, m), torch.tensor([0])]),
                     torch.stack([s.R for s in steps] + [closure.R]),
                     torch.stack([s.t for s in steps] + [closure.t]),
                     torch.cat([torch.ones(m - 1), torch.tensor([10.0])]))
    R0, t0 = torch.stack(R), torch.stack(t)
    cpu = refine_pose_graph(R0, t0, edges, n_iters=10)
    on = [refine_pose_graph(R0.to(cuda), t0.to(cuda), EdgeList(*(e.to(cuda) for e in edges)),
                            n_iters=10) for _ in range(2)]
    for a, b in ((on[0].R, on[1].R), (on[0].t, on[1].t)):
        _close(a, b, 0.0, 1e-6)
    _close(on[0].R.cpu(), cpu.R, 0.0, 1e-3)
    _close(on[0].t.cpu(), cpu.t, 0.0, 1e-3)
    _close(on[0].residual_history.cpu(), cpu.residual_history, 1e-3, 1e-6)
