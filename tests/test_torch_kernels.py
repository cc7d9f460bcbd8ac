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

import dataclasses

import pytest
import torch

import hgmm_torch  # noqa: F401  (sets the float32 matmul flags)
from hgmm_torch.models.se3 import so3_exp
from hgmm_torch.ops import em_ref, fused_em, prepare
from hgmm_torch.ops.gaussians import (
    MixtureParams,
    features,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
)

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
    _close(got.S, ref.S, 2e-3, 2e-4 * max(n, 300) / 300)  # the tolerance is stated for N = 300
    _close(got.loglik, ref.loglik, 1e-4, 0.0)


@pytest.mark.parametrize("k", [8, 12, 33, 63, 64, 65, 100, 512, 513, 1024, 2048])
@pytest.mark.parametrize("n", [1, 31, 300, 4097, 20_000])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -3.0)])
def test_em_stats(cuda, k, n, weighted, outlier):
    """K <= 32: the first kernel body; K >= 33: the register-tiled one, with K
    on and off its tiling (33, 63, 65, 100, 513 pad with floor rows) and N
    down to one ragged tile."""
    pts, w = _inputs(n, k, cuda)
    if weighted:
        w[::5] = 0.0  # zero-weight rows, as the odometry bucket pads
    else:
        w = None
    W = pack_loglik_weights(_mixture(k, k + 1, cuda, dead=(1,)))
    got = fused_em.em_stats(prepare(pts, w).pts4, W, outlier)
    _check_em(got, em_ref.em_stats(pts, W, w, outlier), n)
    assert float(got.S[1].abs().max()) == 0.0  # pi = 0 stays inert


@pytest.mark.parametrize("k", [8, 100, 512])
def test_em_stats_all_components_dead(cuda, k):
    """Every logit at the mask floor: every point is dead, S and loglik are 0."""
    pts, _ = _inputs(3000, k, cuda)
    mix = _mixture(k, k + 1, cuda)
    W = pack_loglik_weights(MixtureParams(torch.zeros_like(mix.pi), mix.mu, mix.sigma))
    got = fused_em.em_stats(prepare(pts).pts4, W)
    assert float(got.S.abs().max()) == 0.0 and float(got.loglik) == 0.0


def test_the_bunny_shape_bodies_against_their_twins(cuda):
    """BASELINE config 1's shapes (35,947 points, K = 64, no outlier): the
    plans put the fit's E-step on the register-tiled body (em_stats_tiled,
    one block an SM over 141 tiles) and the registration's statistics on the
    one-lane, one-point lanes body (reg_stats_lanes_kernel<1, 1>, counted as
    reg_stats, 141 blocks); each against its plain twin with test_em_stats'
    and test_reg_stats_every_lane_count's tolerances, one launch each,
    counted under its body."""
    n, k = 35_947, 64
    sms = fused_em._build.sms(cuda)
    params = _mixture(k, 71, cuda, dead=(3,))
    pts, _ = _inputs(n, 72, cuda)
    p4 = prepare(pts).pts4
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=cuda)),
            torch.tensor([0.05, 0.0, -0.1], device=cuda))
    body = fused_em.flat_body(p4, k)
    tab = fused_em.reg_tables(p4, W, params.mu, sym_pack(A), b)
    assert (body.name, body.entry, body.parts.n_rows) == ("em_stats_tiled", "hgmm_em_stats_tiled",
                                                          min(sms, 141))
    assert tab.body == "reg_stats" and tab.plan == fused_em.plan_reg_stats(n, k, None, sms)
    if sms == 132:
        assert tab.plan == fused_em.RegPlan(lanes=1, blocks=141, kmax=0, chunk=1, points=1)
    names = ("em_stats", "em_stats_tiled", "reg_stats", "reg_stats_tiled")
    before = dict(fused_em.LAUNCHES)
    got = fused_em.em_stats(p4, W)
    out = torch.empty(59, device=cuda)
    fused_em.reg_partials(tab, torch.cat([pose[0].reshape(9), pose[1]]).contiguous(), out=out)
    assert {name: fused_em.LAUNCHES[name] - before[name] for name in names} == {
        "em_stats": 0, "em_stats_tiled": 1, "reg_stats": 1, "reg_stats_tiled": 0}
    _check_em(got, em_ref.em_stats(pts, W), n)
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose)
    s = n / 300
    _close(out[:16].view(4, 4), ref.horn, 2e-3, 2e-3 * s)
    _close(out[16:52].view(6, 6), ref.A, 2e-3, 2e-2 * s)
    _close(out[52:58], ref.b, 2e-3, 2e-2 * s)
    _close(out[58], ref.loglik, 1e-4, 1e-6)


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


def _reg_stats_at_chunk(pts4, W, mu, A6, b3, pose, top_k, outlier, chunk):
    """fused_em.reg_stats with the top_k body's chunk forced through the plan."""
    tab = fused_em.reg_tables(pts4, W, mu, A6, b3, top_k, outlier)
    assert tab.plan.kmax > 0
    tab.plan = dataclasses.replace(tab.plan, chunk=chunk)
    out = torch.empty(59, device=pts4.device)
    fused_em.reg_partials(tab, torch.cat([pose[0].reshape(9), pose[1]]).contiguous(), out=out)
    return em_ref.RegStats(horn=out[:16].view(4, 4), A=out[16:52].view(6, 6), b=out[52:58], loglik=out[58])


def _check_reg_stats(cuda, params, n, seed, weighted, top_k, outlier, chunk=None):
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
    if chunk is None:
        got = fused_em.reg_stats(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, pose, top_k,
                                 outlier)
    else:
        got = _reg_stats_at_chunk(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, pose, top_k,
                                  outlier, chunk)
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, top_k, outlier)
    s = n / 300
    _close(got.horn, ref.horn, 2e-3, 2e-3 * s)
    _close(got.A, ref.A, 2e-3, 2e-2 * s)
    _close(got.b, ref.b, 2e-3, 2e-2 * s)
    _close(got.loglik, ref.loglik, 1e-4, 0.0)


@pytest.mark.parametrize("k", [8, 64, 384, 512])
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
    """The cross-block sums run in a fixed order: two runs agree bit for bit,
    in both em_stats bodies (K = 8 and K = 100, 512) and in knn with target
    splits."""
    from hgmm_torch.ops import knn

    pts, w = _inputs(300_000, 9, cuda)
    p = prepare(pts, w).pts4
    for k in (8, 100, 512):
        W = pack_loglik_weights(_mixture(k, 10, cuda))
        a, b = fused_em.em_stats(p, W), fused_em.em_stats(p, W)
        assert torch.equal(a.S, b.S) and torch.equal(a.loglik, b.loglik)
    q, t = pts[:50_000].contiguous(), pts[100_000:160_000].contiguous()
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    assert knn.plan_knn(q.shape[0], t.shape[0], sms).splits > 1
    a, b = knn.nearest_neighbor_cuda(q, t), knn.nearest_neighbor_cuda(q, t)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    pts, _ = _inputs(100, 11, cuda)
    params = _mixture(8, 12, cuda)
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    p = prepare(pts).pts4
    pose = (torch.eye(3, device=cuda), torch.zeros(3, device=cuda))
    p64 = _mixture(64, 12, cuda)
    A64, b64, _ = precision_terms(p64)
    for top_k in (0, -1):  # top_k outside [1, K); every top_k in it runs
        with pytest.raises(ValueError, match="top_k"):
            fused_em.reg_stats(p, pack_loglik_weights(p64), p64.mu, sym_pack(A64), b64, pose,
                               top_k=top_k)
    with pytest.raises(ValueError):
        fused_em.em_stats(p.double(), W)
    with pytest.raises(ValueError):
        fused_em.em_stats(p[:, ::2], W)  # not contiguous
    with pytest.raises(ValueError):
        fused_em.em_stats(p, torch.zeros(10, fused_em.MAX_K + 1, device=cuda))


@pytest.mark.parametrize("nq,nt,ties", [(1, 1, False), (500, 700, False), (3000, 5000, True),
                                        (1025, 1023, False), (70_000, 3, False), (3, 70_000, True),
                                        (1, 5000, False), (5000, 15, True), (2000, 513, True),
                                        (16_384, 16_384, True), (120_000, 20_000, True)])
def test_knn(cuda, nq, nt, ties):
    """The kernel's neighbour is as near as the twin's (float64 distances;
    the twin's factored form cancels at close range), indices agree but for
    near-ties, and of exact ties the lowest index wins: with fewer targets
    than a chunk, one query, ragged tiles, and several target splits (the copy
    of a target then lies in another chunk, tile and split)."""
    from hgmm_torch.ops import knn

    g = torch.Generator().manual_seed(nq + nt)
    q, t = torch.randn(nq, 3, generator=g), torch.randn(nt, 3, generator=g)
    if ties:
        t = torch.cat([t, t])
        m = min(nq // 4, t.shape[0])
        q[:m] = t[:m]
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


@pytest.mark.parametrize("nq,nt", [(1, 33), (3000, 70_000), (40_000, 1025), (16_384, 16_384)])
def test_knn_equal_targets_go_to_index_zero(cuda, nq, nt):
    """Every target the same point: ties across every chunk, tile and split."""
    from hgmm_torch.ops import knn

    q = torch.randn(nq, 3, generator=torch.Generator().manual_seed(nq)).to(cuda)
    t = torch.full((nt, 3), 0.25, device=cuda)
    idx, d2 = knn.nearest_neighbor_cuda(q, t)
    assert int(idx.abs().max()) == 0
    _close(d2, ((q.double() - 0.25) ** 2).sum(1), 1e-5, 1e-7)


def test_knn_nan_target_row_never_wins(cuda):
    from hgmm_torch.ops import knn

    g = torch.Generator().manual_seed(21)
    q, t = torch.randn(3000, 3, generator=g).to(cuda), torch.randn(5000, 3, generator=g).to(cuda)
    t[2500] = float("nan")
    t[77, 2] = float("nan")
    idx, d2 = knn.nearest_neighbor_cuda(q, t)
    far = t.clone()
    far[2500] = far[77] = 1e6
    ref_idx, _ = knn.nearest_neighbor_ref(q, far)
    assert not bool(((idx == 2500) | (idx == 77)).any()) and bool(torch.isfinite(d2).all())
    assert float((idx == ref_idx).double().mean()) >= 0.98


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


# ---- the unit-rate probes (csrc/probes.cu) against hgmm_torch.ops.probes.*_ref.
# bfloat16 operands carry identical bits in kernel and plain version and only
# the float32 sum order differs (rtol 2e-3 + 1e-4 of the largest |sum|);
# float32 operands: rtol 1e-5 + 1e-5 of the largest |sum|.

PROBE_TOL = {torch.bfloat16: (2e-3, 1e-4), torch.float32: (1e-5, 1e-5)}


def _probe_inputs(k, t, dev, dtype):
    from hgmm_torch.benchmarks.mxu_microbench import make_inputs

    ins = make_inputs(k, t, dev, seed=k + t)
    sfx = "" if dtype == torch.bfloat16 else "_f32"
    return ins["wt" + sfx], ins["phi" + sfx], ins["e" + sfx], ins["ones"], ins["x"]


def _probe_close(got, ref, dtype):
    rtol, arel = PROBE_TOL[dtype]
    _close(got, ref, rtol, arel * float(ref.abs().max()))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k,t", [(64, 256), (128, 384), (512, 2048), (64, 8192)])
@pytest.mark.parametrize("steps,reps", [(3, 2), (1, 5), (1, 7)])
def test_probe_logits_and_stats(cuda, k, t, steps, reps, dtype):
    from hgmm_torch.ops import probes

    wt, phi, e, _, _ = _probe_inputs(k, t, cuda, dtype)
    fused_em.reset_launches()
    _probe_close(probes.logits(wt, phi, steps, reps), probes.logits_ref(wt, phi, steps, reps), dtype)
    _probe_close(probes.stats(phi[:32], e, steps, reps), probes.stats_ref(phi[:32], e, steps, reps),
                 dtype)
    assert fused_em.LAUNCHES["probe_logits"] == 1 and fused_em.LAUNCHES["probe_stats"] == 1


@pytest.mark.parametrize("k,t", [(64, 256), (128, 384), (512, 2048), (64, 8192)])
@pytest.mark.parametrize("steps,reps", [(1, 1), (3, 6), (2, 64)])
def test_probe_zero_a_sees_every_rep_eps(cuda, k, t, steps, reps):
    """bf16 logits and stats with A = 0 (wt, phi32): every rep's eps_r shows
    in the result (steps * sum_r eps_r times B's column sums); equal bits on
    two launches."""
    from hgmm_torch.ops import probes

    _, phi, e, _, _ = _probe_inputs(k, t, cuda, torch.bfloat16)
    wt0, phi32_0 = torch.zeros((k, 80), dtype=torch.bfloat16, device=cuda), torch.zeros_like(phi[:32])
    got = probes.logits(wt0, phi, steps, reps)
    _probe_close(got, probes.logits_ref(wt0, phi, steps, reps), torch.bfloat16)
    assert torch.equal(got, probes.logits(wt0, phi, steps, reps))
    got = probes.stats(phi32_0, e, steps, reps)
    _probe_close(got, probes.stats_ref(phi32_0, e, steps, reps), torch.bfloat16)
    assert torch.equal(got, probes.stats(phi32_0, e, steps, reps))


# Every shape the norm probe runs at on the card (tests/test_torch_probes.py:
# CARD_NORM_SHAPES): T = 48 leaves the last 64-row tile of T partial.
NORM_SHAPES = [(64, 256), (128, 48), (256, 2048), (512, 2048), (64, 8192)]


@pytest.mark.parametrize("k,t", NORM_SHAPES)
def test_probe_norm(cuda, k, t):
    from hgmm_torch.ops import probes

    _, _, e, ones, _ = _probe_inputs(k, t, cuda, torch.bfloat16)
    ones = (ones * torch.linspace(0.5, 1.5, 8, device=cuda)[:, None]).to(torch.bfloat16)
    _probe_close(probes.norm(ones, e, 3, 2), probes.norm_ref(ones, e, 3, 2), torch.bfloat16)


@pytest.mark.parametrize("k,t", NORM_SHAPES)
@pytest.mark.parametrize("steps,reps", [(3, 2), (1, 7), (2, 20), (1, 49)])
def test_probe_norm_random_operand(cuda, k, t, steps, reps):
    """ones [8, K] seeded standard normal, so that it varies along K and
    between rows: a mix-up of the kernel's K-major B tiles or of its output
    rows shows (constant rows hide both). The loops cover the 16 reps a wgmma
    and tails of 1 to 8 reps, one and several steps."""
    from hgmm_torch.ops import probes

    _, _, e, _, _ = _probe_inputs(k, t, cuda, torch.bfloat16)
    g = torch.Generator().manual_seed(k + t)
    ones = torch.randn(8, k, generator=g).to(torch.bfloat16).to(cuda)
    fused_em.reset_launches()
    got = probes.norm(ones, e, steps, reps)
    assert fused_em.LAUNCHES["probe_norm"] == 1
    _probe_close(got, probes.norm_ref(ones, e, steps, reps), torch.bfloat16)


@pytest.mark.parametrize("k,t", NORM_SHAPES)
@pytest.mark.parametrize("steps,reps", [(1, 1), (3, 6), (2, 64)])
def test_probe_norm_zero_a_sees_every_rep_eps(cuda, k, t, steps, reps):
    """bf16 norm with ones = 0: every rep's eps_r shows in the result (steps
    * sum_r eps_r times e's column sums); equal bits on two launches. The
    twin of test_probe_zero_a_sees_every_rep_eps."""
    from hgmm_torch.ops import probes

    _, _, e, ones, _ = _probe_inputs(k, t, cuda, torch.bfloat16)
    zero = torch.zeros_like(ones)
    got = probes.norm(zero, e, steps, reps)
    _probe_close(got, probes.norm_ref(zero, e, steps, reps), torch.bfloat16)
    assert torch.equal(got, probes.norm(zero, e, steps, reps))


@pytest.mark.parametrize("steps,reps", [(0, 1), (3, 2), (64, 7)])
def test_probe_addonly_and_vpu(cuda, steps, reps):
    from hgmm_torch.ops import probes

    x = _probe_inputs(64, 256, cuda, torch.bfloat16)[4]
    assert torch.equal(probes.addonly(x, steps, reps), probes.addonly_ref(x, steps, reps))
    x = x.clamp(-1.5, -0.5)
    for mode in ("exp2", "cast"):
        got, ref = probes.vpu(x, steps, reps, mode), probes.vpu_ref(x, steps, reps, mode)
        ulp = (got.to(torch.bfloat16).view(torch.int16).int()
               - ref.to(torch.bfloat16).view(torch.int16).int()).abs()
        assert int(ulp.max()) <= (1 if mode == "exp2" else 0)
        assert float((ulp > 0).float().mean()) < 0.01


@pytest.mark.parametrize("shape", [(512, 2048), (64, 8192), (4,), (1000,), (33, 48)])
@pytest.mark.parametrize("steps,reps", [(2, 1), (2, 2), (1, 3), (2, 5), (3, 6), (1, 7), (2, 64)])
def test_probe_addonly_plans(cuda, shape, steps, reps):
    """addonly through plan_addonly (four float4 a thread, whole waves of
    blocks) at the timed shapes and below a thread a float4, with every
    remainder of its four reps a trip: bit-equal to the plain version."""
    from hgmm_torch.ops import probes

    g = torch.Generator().manual_seed(len(shape) + steps)
    x = torch.randn(shape, generator=g).to(cuda)
    fused_em.reset_launches()
    assert torch.equal(probes.addonly(x, steps, reps), probes.addonly_ref(x, steps, reps))
    assert fused_em.LAUNCHES["probe_addonly"] == 1


def test_graph_timed_probe_counts_every_launch(cuda):
    """mxu_microbench times a rep count from a CUDA graph: the warm-up call,
    the captured calls' first replay and every timed replay each launch the
    kernel, and each counts once."""
    from hgmm_torch.benchmarks import mxu_microbench
    from hgmm_torch.ops import probes

    x = torch.randn(4096, device=cuda)
    fused_em.reset_launches()
    assert mxu_microbench.seconds_a_call(lambda: probes.addonly(x, 1, 2), cuda) > 0
    calls, replays = mxu_microbench.GRAPH_CALLS, mxu_microbench.GRAPH_REPLAYS
    assert fused_em.LAUNCHES["probe_addonly"] == 1 + calls * (1 + replays)


def _bf16_ulp(got, ref):
    return (got.to(torch.bfloat16).view(torch.int16).int()
            - ref.to(torch.bfloat16).view(torch.int16).int()).abs()


def test_probe_vpu_cast_every_float32(cuda):
    """Cast mode, one step, over every float32 bit pattern but the NaNs (in
    chunks of 2^28): bit-equal to the plain version (torch's rounding to
    bfloat16, to nearest even) on the card."""
    from hgmm_torch.ops import probes

    chunk = 1 << 28
    for c in range((1 << 32) // chunk):
        bits = torch.arange(c * chunk, (c + 1) * chunk, dtype=torch.int64, device=cuda)
        x = torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(torch.int32).view(torch.float32)
        x = x[~torch.isnan(x)]
        got = probes.vpu_cuda(x, 1, 1, "cast")
        ref = probes.vpu_ref(x, 1, 1, "cast")
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), f"chunk {c}"


@pytest.mark.parametrize("n", [1, 5, 31, 33, 127, 129, 4 * 32 * 16 + 3, 262_147])
def test_probe_vpu_exp2_edges(cuda, n):
    """Exp2 mode where exp2 gives a denormal (inputs in [-149, -126]), inf
    (large inputs) and exactly 1 (±0), at element counts off the chain
    width: within one bfloat16 ulp of the plain version, finite where it
    is, NaN where it is; cast mode bit-equal."""
    from hgmm_torch.ops import probes

    g = torch.Generator().manual_seed(n)
    pools = [-149.0 + 23.0 * torch.rand(n, generator=g), 120.0 + 10.0 * torch.rand(n, generator=g),
             -1.5 + torch.rand(n, generator=g)]
    pick = torch.randint(0, 3, (n,), generator=g)
    x = torch.stack(pools)[pick, torch.arange(n)]
    x[: min(n, 4)] = torch.tensor([0.0, -0.0, float("nan"), -149.0])[: min(n, 4)]
    x = x.to(cuda)
    for steps, reps in ((1, 1), (3, 2)):
        got, ref = probes.vpu_cuda(x, steps, reps, "exp2"), probes.vpu_ref(x, steps, reps, "exp2")
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(got), nan)
        assert int(_bf16_ulp(got[~nan], ref[~nan]).max()) <= 1
        assert bool(torch.isfinite(got[torch.isfinite(ref)]).all())
        got, ref = probes.vpu_cuda(x, steps, reps, "cast"), probes.vpu_ref(x, steps, reps, "cast")
        assert torch.equal(got[~nan].view(torch.int32), ref[~nan].view(torch.int32))
        assert bool(torch.isnan(got[nan]).all())


def test_probe_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from hgmm_torch.ops import probes

    wt, phi, e, ones, x = _probe_inputs(64, 256, cuda, torch.bfloat16)
    with pytest.raises(ValueError):
        probes.logits_cuda(wt, phi.float(), 1, 1)  # mixed types
    with pytest.raises(ValueError):
        probes.logits_cuda(wt[:48].contiguous(), phi, 1, 1)  # K % 64
    with pytest.raises(ValueError):
        probes.stats_cuda(phi[:32], e, 1, probes.MAX_REPS + 1)
    with pytest.raises(ValueError):
        probes.norm_cuda(ones.float(), e, 1, 1)
    with pytest.raises(ValueError):
        probes.vpu_cuda(x, 1, 1, "log2")


def test_bench_on_the_card(cuda, capsys):
    """run_bench at a small size on the card: the sweep launches the kernel
    (the register-tiled body at K = 64, counted as em_stats_tiled) and agrees
    with the plain version."""
    from hgmm_torch import bench, convert

    fused_em.reset_launches()
    res = bench.run_bench(device="cuda", n=1 << 16, k=64, sweeps=3)
    assert fused_em.LAUNCHES["em_stats_tiled"] == 3 * 7  # 2 warm-up chains + 5 timed
    assert fused_em.LAUNCHES["em_stats"] == 0
    mix, pts = bench.bench_problem(1 << 16, 64)
    W = pack_loglik_weights(convert.mixture_from_numpy(*mix, device=cuda))
    _check_em(res["stats"], em_ref.em_stats(torch.from_numpy(pts).to(cuda), W), 1 << 16)
    assert 0 < res["vs_baseline"] <= 1.05
    assert len(capsys.readouterr().out.strip().splitlines()) == 1


# --------------------------------------------------------------------------
# the registration scan on the card: reg_stats lanes, reg_step, the grouped
# masked E-step


@pytest.mark.parametrize("k", [8, 12, 64, 512])
@pytest.mark.parametrize("n", [1, 33, 16_384])
def test_reg_stats_every_lane_count(cuda, k, n):
    """The lanes body at every lane count the plan can give, K on and off
    it, a ragged last warp."""
    params = _mixture(k, k + 21, cuda, dead=(1,))
    pts, w = _inputs(n, k + 22, cuda)
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=cuda)),
            torch.tensor([0.05, 0.0, -0.1], device=cuda))
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, None, -2.0)
    tab = fused_em.reg_tables(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, None, -2.0)
    pose12 = torch.cat([pose[0].reshape(9), pose[1]]).contiguous()
    s = max(n, 300) / 300
    for lanes in (1, 2, 4, 8, 16, 32):
        tab.plan = fused_em.RegPlan(lanes=lanes, blocks=tab.plan.blocks, kmax=0)
        out = torch.empty(59, device=cuda)
        fused_em.reg_partials(tab, pose12, out=out)
        _close(out[:16].view(4, 4), ref.horn, 2e-3, 2e-3 * s)
        _close(out[16:52].view(6, 6), ref.A, 2e-3, 2e-2 * s)
        _close(out[52:58], ref.b, 2e-3, 2e-2 * s)
        _close(out[58], ref.loglik, 1e-4, 1e-6)


def _tiled_problem(k, n, outlier, dev):
    """Tables at K (two dead components), n points (131,072: a zero-weight
    tail past 120,000, as the KITTI bucket pads), a pose, and em_ref's
    reg_stats on them."""
    params = _mixture(k, k + 41, dev, dead=(1, k // 2) if k > 2 else (1,))
    pts, w = _inputs(n, k + 42, dev)
    if n == 131_072:
        w[120_000:] = 0.0
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=dev)), torch.tensor([0.05, 0.0, -0.1], device=dev))
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, None, outlier)
    tab = fused_em.reg_tables(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, None, outlier)
    return tab, torch.cat([pose[0].reshape(9), pose[1]]).contiguous(), ref


def _with_plan(tab, plan):
    """tab on another plan, with partial rows of its own."""
    rows = fused_em.reg_rows(torch.empty((plan.blocks, em_ref.REG_OUT), device=tab.pts4.device))
    return dataclasses.replace(tab, plan=plan, body=fused_em.reg_stats_body(tab.gate, plan), rows=rows)


@pytest.mark.parametrize("points", [fused_em.RS_TILE_POINTS])
@pytest.mark.parametrize("k", [8, 12, 64, 384, 512])
@pytest.mark.parametrize("n", [1, 33, 1000, 131_072, 437_645])
@pytest.mark.parametrize("outlier", [None, -2.0])
def test_reg_stats_tiled_at_every_point_count(cuda, points, k, n, outlier):
    """The tiled lanes body at the points a thread the plan gives, K on and
    off its chunk of 8 (its inert padding rows), dead components, the
    outlier on and off; one block at small N (a thread's 1, or 3 and 4
    points: the tile, then 2 and 1 at a time), one wave of 132 at the
    KITTI bucket (with its zero-weight tail) and the dragon's N: within
    test_reg_stats_every_lane_count's tolerances of em_ref, and its partial
    rows bit-equal to the one-point lanes body's on the same grid (the same
    points a thread, added in the same order), counted as reg_stats_tiled."""
    tab, pose12, ref = _tiled_problem(k, n, outlier, cuda)
    blocks = 1 if n <= 1000 else 132
    tiled = _with_plan(tab, fused_em.RegPlan(lanes=1, blocks=blocks, kmax=0, points=points))
    one = _with_plan(tab, fused_em.RegPlan(lanes=1, blocks=blocks, kmax=0))
    assert (tiled.body, one.body) == ("reg_stats_tiled", "reg_stats")
    s = max(n, 300) / 300
    before = dict(fused_em.LAUNCHES)
    out = torch.empty(59, device=cuda)
    fused_em.reg_partials(tiled, pose12, out=out)
    assert fused_em.LAUNCHES["reg_stats_tiled"] == before["reg_stats_tiled"] + 1
    _close(out[:16].view(4, 4), ref.horn, 2e-3, 2e-3 * s)
    _close(out[16:52].view(6, 6), ref.A, 2e-3, 2e-2 * s)
    _close(out[52:58], ref.b, 2e-3, 2e-2 * s)
    _close(out[58], ref.loglik, 1e-4, 1e-6)
    fused_em.reg_partials(one, pose12)
    assert torch.equal(tiled.rows.partial, one.rows.partial)


@pytest.mark.parametrize("points", [fused_em.RS_TILE_POINTS])
def test_reg_stats_tiled_done_writes_nothing(cuda, points):
    """With the scan's done flag set the tiled body returns at once: the
    partial rows keep what they held."""
    tab, pose12, _ = _tiled_problem(64, 131_072, -8.0, cuda)
    tiled = _with_plan(tab, fused_em.RegPlan(lanes=1, blocks=132, kmax=0, points=points))
    tiled.rows.partial.fill_(float("nan"))
    fused_em.reg_partials(tiled, pose12, torch.ones(1, device=cuda))
    assert bool(torch.isnan(tiled.rows.partial).all())
    fused_em.reg_partials(tiled, pose12, torch.zeros(1, device=cuda))
    assert bool(torch.isfinite(tiled.rows.partial).all())


@pytest.mark.parametrize("top_k", [1, 8, 32])
def test_reg_stats_top_k_list_overflows_on_many_ties(cuda, top_k):
    """Every component nine times over: more logits tie at the threshold
    than the kernel's list holds, and the point recomputes them all."""
    base = _mixture(8, 23, cuda)
    params = MixtureParams(base.pi.repeat(9) / 9, base.mu.repeat(9, 1), base.sigma.repeat(9, 1, 1))
    _check_reg_stats(cuda, params, 5000, 24, True, top_k, 0.0)


@pytest.mark.parametrize("chunk", fused_em.RS_CHUNKS)
@pytest.mark.parametrize("k", [64, 384, 512])
@pytest.mark.parametrize("top_k", [1, 8, 32])
@pytest.mark.parametrize("weighted,outlier", [(True, -2.0), (False, None)])
def test_reg_stats_top_k_at_every_chunk(cuda, chunk, k, top_k, weighted, outlier):
    """The top_k body at every chunk size the plan can give, forced through
    the plan (K = 64 with C = 16 or top_k = 32 leaves fewer chunks than the
    list holds: every point takes every chunk)."""
    _check_reg_stats(cuda, _mixture(k, k + 7, cuda, dead=(2,)), 20_000, k + 6, weighted, top_k,
                     outlier, chunk)


def _chunk_layout_mixture(layout, dev):
    """K = 512 mixtures whose kept components sit in chunks in a chosen way:
    "one_chunk", 32 tight groups of 16 consecutive components (a point's
    top 8 in one chunk of 16); "own_chunks", the same groups with component j
    in group j % 32 (each kept component in a chunk of its own at every chunk
    size); "straddling_ties", 256 components each twice, at 2i + 1 and 2i + 2
    (and the first at 0 and 511), so exact ties straddle every chunk boundary
    and, where a tied pair is the top_k-th, two chunks' maxima tie at the
    list's top_k-th entry."""
    g = torch.Generator().manual_seed({"one_chunk": 41, "own_chunks": 42, "straddling_ties": 43}[layout])
    if layout == "straddling_ties":
        base = _mixture(256, 44, "cpu")
        order = torch.cat([torch.tensor([0]), torch.arange(1, 256).repeat_interleave(2), torch.tensor([0])])
        params = MixtureParams(base.pi[order] / 2, base.mu[order], base.sigma[order])
    else:
        centers = 1.5 * torch.randn(32, 3, generator=g)
        group = torch.arange(512) // 16 if layout == "one_chunk" else torch.arange(512) % 32
        a = 0.2 * torch.randn(512, 3, 3, generator=g)
        params = MixtureParams(torch.softmax(torch.randn(512, generator=g), 0),
                               centers[group] + 0.15 * torch.randn(512, 3, generator=g),
                               a @ a.transpose(1, 2) + 0.05 * torch.eye(3))
    return MixtureParams(*(x.to(dev) for x in params))


@pytest.mark.parametrize("chunk", fused_em.RS_CHUNKS)
@pytest.mark.parametrize("top_k", [1, 8, 32])
@pytest.mark.parametrize("layout", ["one_chunk", "own_chunks", "straddling_ties"])
def test_reg_stats_top_k_chunk_layouts(cuda, chunk, top_k, layout):
    _check_reg_stats(cuda, _chunk_layout_mixture(layout, cuda), 20_000, 45, True, top_k, 0.0, chunk)


def _top_k_counts(cuda, params, n, top_k, passes=1):
    """The top_k body's counters over `passes` launches of fused_em.reg_stats
    inside profiling.tracing(), and the host syncs the launches made."""
    from hgmm_torch.utils import profiling

    pts, w = _inputs(n, 47, cuda)
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=cuda)),
            torch.tensor([0.05, 0.0, -0.1], device=cuda))
    p = prepare(pts, w).pts4
    with profiling.count_syncs(), profiling.tracing():  # the first call's set-up, and the sync mode's
        with profiling.span("warm"):
            fused_em.reg_stats(p, W, params.mu, sym_pack(A), b, pose, top_k, 0.0)
    with profiling.count_syncs() as syncs, profiling.tracing() as tr:
        with profiling.span("request"):
            for _ in range(passes):
                fused_em.reg_stats(p, W, params.mu, sym_pack(A), b, pose, top_k, 0.0)
    return tr.summary()[0]["counts"], syncs["sites"]


@pytest.mark.parametrize("top_k", [1, 8, 32])
def test_top_k_counters_on_generic_data(cuda, top_k):
    """Every point of every pass is gated; a point takes between top_k and
    KMAX - 1 chunks, or every chunk where the list cannot tell (chunk maxima
    that differ only in the keys' cut bits: 4 to 56 points of 40,000 on the
    H100); the counters add no host sync before the tracer's summary()."""
    n, k, passes = 20_000, 512, 2
    counts, syncs = _top_k_counts(cuda, _mixture(k, 46, cuda), n, top_k, passes)
    plan = fused_em.plan_reg_stats(n, k, top_k, 132)
    every = counts["reg.topk_fallback_points"]
    assert counts["reg.topk_points"] == passes * n
    assert every <= 1e-2 * passes * n
    assert (top_k * (passes * n - every) <= counts["reg.topk_rechunks"] - every * (k // plan.chunk)
            <= (plan.kmax - 1) * (passes * n - every))
    assert counts["launch.reg_stats_top_k"] == passes and syncs == {}


@pytest.mark.parametrize("top_k", [1, 8, 32])
def test_top_k_counters_count_fallbacks_on_many_ties(cuda, top_k):
    """The nine-copies mixture of ..._list_overflows_on_many_ties: at the
    plan's chunk more chunk maxima tie than the list holds, and points take
    every chunk."""
    base = _mixture(8, 23, cuda)
    params = MixtureParams(base.pi.repeat(9) / 9, base.mu.repeat(9, 1), base.sigma.repeat(9, 1, 1))
    counts, _ = _top_k_counts(cuda, params, 5000, top_k)
    assert counts["reg.topk_points"] == 5000
    assert counts["reg.topk_fallback_points"] > 0


def test_top_k_counters_off_outside_tracing(cuda):
    """Outside profiling.tracing() the tables hold no counters, and the
    tables and a launch make no host sync."""
    from hgmm_torch.utils import profiling

    pts, W, mu, A6, b3 = _scan_inputs(cuda, k=512)
    p = prepare(pts).pts4
    pose12 = torch.cat([torch.eye(3, device=cuda).reshape(9), torch.zeros(3, device=cuda)])
    fused_em.reg_tables(p, W, mu, A6, b3, 8, 0.0)  # the library is loaded
    with profiling.count_syncs() as syncs:
        tab = fused_em.reg_tables(p, W, mu, A6, b3, 8, 0.0)
        fused_em.reg_partials(tab, pose12)
    assert tab.counters is None and syncs["sites"] == {}


def test_top_k_points_count_the_live_scan_steps(cuda):
    """In a converging registration scan a gated pass runs only before done:
    the points counted are N times the live steps."""
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import Gmm
    from hgmm_torch.pipelines.register import register_points
    from hgmm_torch.utils import profiling

    target = make_cloud(5000, "trefoil", seed=4, device=cuda)
    params = Gmm.fit(target, k=64, n_iters=10, generator=torch.Generator().manual_seed(5))[0].params
    R0 = so3_exp(torch.tensor([0.03, -0.05, 0.04], device=cuda))
    source = (target - torch.tensor([0.02, 0.0, -0.01], device=cuda)) @ R0
    with profiling.tracing() as tr:
        with profiling.span("request"):
            register_points(source, params, n_iters=20, method="wls", top_k=8, outlier_logit=0.0, tol=1e-5)
    counts = tr.summary()[0]["counts"]
    assert 0 < counts["reg.live_steps"] < counts["reg.steps"]
    assert counts["reg.topk_points"] == 5000 * counts["reg.live_steps"]


def _scan_inputs(cuda, k=64, n=5000, seed=25):
    params = _mixture(k, seed, cuda)
    pts, _ = _inputs(n, seed + 1, cuda)
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    return pts, W, params.mu, sym_pack(A), b


def _split_rows(part, nb, seed):
    """The float64 sum of part's rows split into nb float32 rows by random
    positive shares: other partial rows of about the same statistics."""
    g = torch.Generator().manual_seed(seed)
    share = torch.rand(nb, generator=g, dtype=torch.float64).to(part.device) + 0.5
    return (part.double().sum(0)[None] * (share / share.sum())[:, None]).float().contiguous()


@pytest.mark.parametrize("solver", [0, 1])
@pytest.mark.parametrize("first,last", [(True, True), (True, False), (False, True)])
@pytest.mark.parametrize("nb", [None, 1, 33, 528])
def test_reg_step_against_its_twin(cuda, solver, first, last, nb):
    """On reg_stats' own rows (None) and on 1, 33 and 528 rows of the same
    statistics (528: the rows of a 437,645-point scan; the kernel reads 16
    rows a pass, so 33 leaves a ragged pass); two launches from one state
    give equal bits."""
    from hgmm_torch import ops

    pts, W, mu, A6, b3 = _scan_inputs(cuda)
    prob = fused_em.reg_tables(prepare(pts).pts4, W, mu, A6, b3)
    scan = ops.new_scan(prob, so3_exp(torch.tensor([0.05, 0.1, -0.1], device=cuda)),
                        torch.tensor([0.1, 0.0, 0.2], device=cuda), 4)
    scan.state[em_ref.SCAN_START:em_ref.SCAN_START + 12] = scan.state[:12] + 0.01
    scan.state[em_ref.SCAN_LL] = -7.0
    twin = em_ref.RegScan(*(t.cpu().clone() for t in scan))
    part = ops.reg_partials(prob, scan).partial.clone()
    if nb is not None:
        part = _split_rows(part, nb, nb)
    rows = fused_em.reg_rows(part)
    again = em_ref.RegScan(*(t.clone() for t in scan))
    before = fused_em.LAUNCHES["reg_step"]
    ops.reg_step(rows, scan, 2, solver, first, last, 1e-7)
    assert fused_em.LAUNCHES["reg_step"] == before + 1
    ops.reg_step(rows, again, 2, solver, first, last, 1e-7)
    assert all(torch.equal(a, b) for a, b in zip(scan, again))
    em_ref.reg_step(part.cpu(), twin, 2, solver, first, last, 1e-7)
    # float64 in the kernel, float32 in the twin: the pose to float32 rounding
    torch.testing.assert_close(scan.state.cpu()[:24], twin.state[:24], rtol=0, atol=2e-5)
    torch.testing.assert_close(scan.logliks.cpu(), twin.logliks, rtol=1e-6, atol=0)
    torch.testing.assert_close(scan.deltas.cpu(), twin.deltas, rtol=1e-3, atol=1e-6)


def test_reg_step_done_changes_nothing(cuda):
    from hgmm_torch import ops

    pts, W, mu, A6, b3 = _scan_inputs(cuda)
    prob = fused_em.reg_tables(prepare(pts).pts4, W, mu, A6, b3)
    scan = ops.new_scan(prob, torch.eye(3, device=cuda), torch.zeros(3, device=cuda), 3)
    scan.state[em_ref.SCAN_DONE] = 1.0
    scan.state[em_ref.SCAN_LL_LAST] = -5.0
    scan.state[em_ref.SCAN_D_LAST] = 0.25
    prob.rows.partial.fill_(float("nan"))
    before = scan.state.clone()
    part = ops.reg_partials(prob, scan)  # returns at once: the partials stay NaN
    assert bool(torch.isnan(part.partial).all())
    ops.reg_step(part, scan, 1, 1, True, True, 1e-7)
    assert torch.equal(scan.state, before)
    assert scan.logliks.tolist() == [0.0, -5.0, 0.0] and scan.deltas.tolist() == [0.0, 0.25, 0.0]


def test_a_scan_state_of_the_wrong_dtype_is_refused_where_it_is_made(cuda):
    """reg_step checks nothing: scan_of, which new_scan goes through, refuses
    a state that is not float32."""
    pts, W, mu, A6, b3 = _scan_inputs(cuda)
    tab = fused_em.reg_tables(prepare(pts).pts4, W, mu, A6, b3)
    scan = fused_em.new_scan(tab, torch.eye(3, device=cuda), torch.zeros(3, device=cuda), 4)
    with pytest.raises(ValueError, match="state: expected torch.float32"):
        fused_em.scan_of(tab, scan.state.double(), scan.logliks, scan.deltas)


def test_tables_and_a_scan_on_different_devices_are_refused_where_the_scan_is_made(cuda):
    """reg_partials checks nothing: new_scan refuses a pose off the tables'
    card (a state made there would be)."""
    from hgmm_torch import ops

    pts, W, mu, A6, b3 = _scan_inputs(cuda)
    tab = fused_em.reg_tables(prepare(pts).pts4, W, mu, A6, b3)
    with pytest.raises(ValueError, match="state: expected a CUDA tensor"):
        ops.new_scan(tab, torch.eye(3), torch.zeros(3), 4)
    if torch.cuda.device_count() > 1:
        other = torch.device("cuda", 1)
        with pytest.raises(ValueError, match="state on cuda:1"):
            ops.new_scan(tab, torch.eye(3, device=other), torch.zeros(3, device=other), 4)


@pytest.mark.parametrize("k", [8, 40])
def test_a_fit_table_of_the_wrong_row_count_is_refused_where_the_fit_is_made(cuda, k):
    """em_partials and em_step check nothing: bind_fit, which ops.new_fit
    goes through, refuses a table of other rows than the unmasked body reads
    (table_rows: K = 40 reads 64) and a state that is not float32."""
    p = _mixture(k, k + 3, cuda)
    body = fused_em.flat_body(prepare(_inputs(1000, k, cuda)[0]).pts4, k)
    total, cf = torch.tensor(1000.0, device=cuda), torch.tensor(1e-4, device=cuda)
    fused_em.bind_fit(body, em_ref.new_fit(p, 2, total, cf, fused_em.table_rows(k)))
    with pytest.raises(ValueError, match="rows"):
        fused_em.bind_fit(body, em_ref.new_fit(p, 2, total, cf, fused_em.table_rows(k) + 1))
    with pytest.raises(ValueError, match="pi: expected torch.float32"):
        fused_em.bind_fit(body, em_ref.new_fit(MixtureParams(*(a.double() for a in p)), 2, total, cf,
                                               fused_em.table_rows(k)))


@pytest.mark.parametrize("n,one_point", [(16_384, False), (437_645, True), (437_645, False)])
def test_reg_step_counts_live_steps_as_its_twin(cuda, n, one_point):
    """SCAN_LIVE, the steps run with done unset, from the kernel and from its
    twin on the same scan: each step of a converging scan (4 Horn iterations, then WLS) on the
    card, the twin stepped from the card's state before it on the same rows.
    437,645 points on the one-point lanes body's 528 blocks give the
    clustered step (past 256 rows); on the plan's tiled body, 132 rows and
    one block. The count after the scan is the live iterations (up to and
    including the first delta below tol) in steps: a Horn iteration one, a
    WLS iteration wls_inner."""
    from hgmm_torch import ops
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import Gmm

    target = make_cloud(n, "trefoil", seed=4, device=cuda)
    params = Gmm.fit(target, k=64, n_iters=10, generator=torch.Generator().manual_seed(5))[0].params
    R0 = so3_exp(torch.tensor([0.03, -0.05, 0.04], device=cuda))
    source = (target - torch.tensor([0.02, 0.0, -0.01], device=cuda)) @ R0
    prob = ops.reg_problem_of(source, params)
    if one_point:
        blocks = fused_em.RS_BLOCKS_PER_SM * fused_em._build.sms(cuda)
        prob = _with_plan(prob, fused_em.RegPlan(lanes=1, blocks=blocks, kmax=0))
    n_iters, n_horn, wls_inner, tol = 20, 4, 2, 1e-5
    scan = ops.new_scan(prob, torch.eye(3, device=cuda), torch.zeros(3, device=cuda), n_iters)
    rows = ops.reg_partials(prob, scan).partial.shape[0]
    assert (fused_em.plan_reg_step(rows) == fused_em.STEP_CLUSTER) == one_point
    for it in range(n_iters):
        solver = 0 if it < n_horn else 1
        steps = 1 if solver == 0 else wls_inner
        for s in range(steps):
            part = ops.reg_partials(prob, scan)
            twin = em_ref.RegScan(*(t.cpu().clone() for t in scan))
            ops.reg_step(part, scan, it, solver, s == 0, s == steps - 1, tol)
            em_ref.reg_step(part.partial.cpu(), twin, it, solver, s == 0, s == steps - 1, tol)
            assert float(scan.state[em_ref.SCAN_LIVE]) == float(twin.state[em_ref.SCAN_LIVE])
    deltas = scan.deltas.tolist()
    live = next((i + 1 for i, d in enumerate(deltas) if d < tol), n_iters)
    assert live < n_iters  # the scan converged: the done steps are exercised
    want = min(live, n_horn) + max(live - n_horn, 0) * wls_inner
    assert float(scan.state[em_ref.SCAN_LIVE]) == want


_SCAN_PROBLEMS = {}


def _scan_problem(cuda, n, k):
    """A moved trefoil of n points and a K-component fit of it (made once a
    shape): a scan that converges as a level's does."""
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import Gmm

    if (n, k) not in _SCAN_PROBLEMS:
        target = make_cloud(n, "trefoil", seed=4, device=cuda)
        params = Gmm.fit(target, k=k, n_iters=10, generator=torch.Generator().manual_seed(5))[0].params
        R0 = so3_exp(torch.tensor([0.03, -0.05, 0.04], device=cuda))
        _SCAN_PROBLEMS[n, k] = ((target - torch.tensor([0.02, 0.0, -0.01], device=cuda)) @ R0, params)
    return _SCAN_PROBLEMS[n, k]


# body: (points, K, top_k, outlier, the plan's lanes, reg_step's blocks)
SCAN_BODIES = {
    "lanes1": (50_000, 64, None, None, 1, 1),
    "tiled": (437_645, 64, None, None, 1, 1),  # one wave of 132 blocks: 132 rows
    "tiled_kitti": (131_072, 512, None, -8.0, 1, 1),
    "lanes4": (16_384, 64, None, -3.0, 4, 1),
    "top_k8": (437_645, 64, 8, 0.0, 1, fused_em.STEP_CLUSTER),
    "top_k32": (16_384, 64, 32, 0.0, 1, 1),
    "select64": (16_384, 128, 64, 0.0, 32, fused_em.STEP_CLUSTER),  # a warp a point: 528 rows
}


@pytest.mark.parametrize("tol", [1e-4, 0.0])
@pytest.mark.parametrize("method,wls_inner", [("horn", 2), ("wls", 1), ("wls", 3), ("horn+wls", 2)])
@pytest.mark.parametrize("body", list(SCAN_BODIES))
def test_reg_scan_from_one_call_is_the_step_loop(cuda, body, method, wls_inner, tol):
    """ops.reg_scan (one host call, hgmm_reg_scan) against the wrappers
    driven a step at a time from Python, each from tables and a state made
    the same way: the whole state (pose, start, SCAN_LIVE, done), logliks,
    deltas, the last partial rows and the gated body's counters bit-equal,
    and the same launches counted, in LAUNCHES and as launch.<name>. Each
    body: the lanes body at 1 and 4 lanes and tiled (the dragon's N, and
    the KITTI bucket's at K = 512), the top_k body at top_k 8 and 32,
    the select body at 64; reg_step on its cluster (past 256 rows) and on
    one block; tol 1e-4 stops early, tol 0 never."""
    from hgmm_torch import ops
    from hgmm_torch.pipelines.register import scan_schedule
    from hgmm_torch.utils import profiling

    n, k, top_k, outlier, lanes, blocks = SCAN_BODIES[body]
    source, params = _scan_problem(cuda, n, k)
    n_iters = 24
    steps = scan_schedule(n_iters, method, wls_inner)
    R0, t0 = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)
    runs, launched = [], []
    with profiling.tracing() as tr:
        for name in ("loop", "one_call"):
            with profiling.span(name):
                tab = ops.reg_problem_of(source, params, top_k, outlier)
                assert (tab.plan.lanes, tab.rows.cluster) == (lanes, blocks)
                scan = ops.new_scan(tab, R0, t0, n_iters)
                before = dict(fused_em.LAUNCHES)
                if name == "loop":
                    for it, solver, first, last in steps:
                        ops.reg_step(ops.reg_partials(tab, scan), scan, it, solver, first, last, tol)
                else:
                    ops.reg_scan(tab, scan, steps, tol)
                launched.append({key: v - before[key] for key, v in fused_em.LAUNCHES.items() if v != before[key]})
                runs.append((tab, scan))
    (loop_tab, loop_scan), (tab, scan) = runs
    for a, b in zip(loop_scan, scan):
        assert torch.equal(a, b)
    assert torch.equal(loop_tab.rows.partial, tab.rows.partial)
    assert (loop_tab.counters is None) == (top_k is None or top_k > fused_em.MAX_TOP_K)
    if loop_tab.counters is not None:
        assert torch.equal(loop_tab.counters, tab.counters)
    assert launched[0] == launched[1] == {tab.body: len(steps), "reg_step": len(steps)}
    loop_counts, counts = (r["counts"] for r in tr.summary())
    assert counts == {**loop_counts, "reg.native_steps": len(steps)}
    live = float(scan.state[em_ref.SCAN_LIVE])
    assert (live < len(steps)) == (tol > 0) and bool(scan.done) == (tol > 0)


@pytest.mark.parametrize("tol", [1e-7, 0.0])
def test_reg_scan_tiled_75_steps_is_the_step_loop(cuda, tol):
    """A dragon level's scan on the tiled body (50 horn+wls iterations with
    2 WLS steps: 75 steps) from one host call lands on the state, logliks
    and deltas of the same steps launched from Python, bit for bit."""
    from hgmm_torch import ops
    from hgmm_torch.pipelines.register import scan_schedule

    source, params = _scan_problem(cuda, 437_645, 64)
    steps = scan_schedule(50, "horn+wls", 2)
    assert len(steps) == 75
    runs = []
    for one_call in (False, True):
        tab = ops.reg_problem_of(source, params)
        assert tab.body == "reg_stats_tiled"
        scan = ops.new_scan(tab, torch.eye(3, device=cuda), torch.zeros(3, device=cuda), 50)
        if one_call:
            ops.reg_scan(tab, scan, steps, tol)
        else:
            for it, solver, first, last in steps:
                ops.reg_step(ops.reg_partials(tab, scan), scan, it, solver, first, last, tol)
        runs.append(scan)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_reg_scan_raises_with_the_failed_step(cuda):
    """A launch the library refuses raises with its step: a lanes count of
    no body at step 0 (before any launch), a solver of no step at step 3."""
    from hgmm_torch import ops
    from hgmm_torch.pipelines.register import ScanStep, scan_schedule

    source, params = _scan_problem(cuda, 16_384, 64)
    tab = ops.reg_problem_of(source, params)
    scan = ops.new_scan(tab, torch.eye(3, device=cuda), torch.zeros(3, device=cuda), 6)
    steps = scan_schedule(6, "horn", 2)
    odd = dataclasses.replace(tab, plan=dataclasses.replace(tab.plan, lanes=3))
    before = dict(fused_em.LAUNCHES)
    with pytest.raises(RuntimeError, match="reg_scan: CUDA error 1 at step 0"):
        ops.reg_scan(odd, scan, steps, 0.0)
    with pytest.raises(RuntimeError, match="reg_scan: CUDA error 1 at step 3"):
        ops.reg_scan(tab, scan, steps[:3] + (ScanStep(3, 2, True, True),) + steps[4:], 0.0)
    assert fused_em.LAUNCHES == before
    torch.cuda.synchronize()


@pytest.mark.parametrize("method", ["horn", "wls", "horn+wls"])
def test_register_points_on_the_card_matches_the_cpu(cuda, method):
    """The whole scan with no host read: the pose within the float32/float64
    gap of the step, the same outputs' shapes; the iteration counts may
    differ by the one near-tie of delta < tol."""
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.eval.metrics import pose_delta_norm
    from hgmm_torch.models.gmm import Gmm
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.pipelines.register import register_points

    cloud = make_cloud(3000, "trefoil", seed=10, device="cpu")
    gmm, _ = Gmm.fit(cloud, k=16, n_iters=15, generator=torch.Generator().manual_seed(11))
    init = Pose(so3_exp(torch.tensor([0.0, 0.05, 0.2])), torch.tensor([0.02, -0.03, 0.01]))
    cpu = register_points(cloud, gmm.params, init_pose=init, n_iters=30, method=method, tol=1e-6)
    params = type(gmm.params)(*(a.to(cuda) for a in gmm.params))
    before = dict(fused_em.LAUNCHES)
    card = register_points(cloud.to(cuda), params, init_pose=Pose(init.R.to(cuda), init.t.to(cuda)),
                           n_iters=30, method=method, tol=1e-6)
    steps = 30 if method == "horn" else (15 + 30 if method == "horn+wls" else 60)
    assert fused_em.LAUNCHES["reg_step"] - before["reg_step"] == steps
    assert fused_em.LAUNCHES["reg_stats"] - before["reg_stats"] == steps
    gap = float(pose_delta_norm(Pose(card.pose.R.cpu(), card.pose.t.cpu()), cpu.pose))
    assert gap < 1e-4
    assert bool(card.converged) == bool(cpu.converged)
    torch.testing.assert_close(card.logliks.cpu()[-1], cpu.logliks[-1], rtol=1e-4, atol=0)


@pytest.mark.parametrize("n", [20_000, 140_000])
@pytest.mark.parametrize("top_k", [None, 8, 64])
def test_register_tree_counts_each_reg_stats_body(cuda, top_k, n):
    """A tree registration (K = 8, 64, 512) launches one reg_stats a step,
    counted by body: the lanes body where nothing gates (K <= top_k, or no
    top_k), tiled (reg_stats_tiled) where the points also fill the card
    twice over (140,000 points), reg_stats_top_k where 1 <= top_k <=
    MAX_TOP_K < K gates, reg_stats_select past it; the four add up to the
    steps."""
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.pipelines.register import register_tree

    cloud = make_cloud(n, "trefoil", seed=12, device=cuda)
    tree, _ = GmmTree.fit(cloud, branch=8, levels=3, em_iters=4, generator=torch.Generator().manual_seed(13))
    names = ("reg_stats", "reg_stats_tiled", "reg_stats_top_k", "reg_stats_select")
    before = dict(fused_em.LAUNCHES)
    register_tree(cloud, tree, n_iters=10, method="horn+wls", top_k=top_k, outlier_logit=0.0)
    torch.cuda.synchronize()
    got = {name: fused_em.LAUNCHES[name] - before[name] for name in names}
    steps = 5 + 5 * 2  # a level: 5 Horn steps, then 5 WLS iterations of 2 steps
    free = "reg_stats_tiled" if fused_em.plan_reg_stats(n, 8, None, fused_em._build.sms(cuda)).points > 1 else "reg_stats"
    assert (free == "reg_stats_tiled") == (n == 140_000)
    body = {None: [free] * 3, 8: [free] + ["reg_stats_top_k"] * 2,
            64: [free] * 2 + ["reg_stats_select"]}[top_k]
    assert got == {name: steps * body.count(name) for name in names}
    assert sum(got.values()) == fused_em.LAUNCHES["reg_step"] - before["reg_step"] == 3 * steps


def _plain_reg_tables(params):
    """The kernel's twin: model_terms, pack_table of W and [mu | A6 | b3]."""
    W, mu, A6, b3 = em_ref.model_terms(params)
    return em_ref.pack_table(W).wn, torch.cat([mu, A6, b3], dim=1)


def _reg_tables_mixture(case, cuda):
    """(params, the pi = 0 rows): K = 8 to 2,048 with a dead component; a
    compacted cut of K = 384 whose last 41 rows are padding (pi 0, mu 0,
    Sigma I, as compact_mixture pads); K = 384 with covariances at the 1e-9
    floor, and with covariances of condition number 1e6."""
    if case.startswith("k"):
        k = int(case[1:])
        return _mixture(k, k + 61, cuda, dead=(k // 2,)), [k // 2]
    k = 384
    pi, mu, sigma = _mixture(k, 63, "cpu")
    if case == "cut384":
        dead = list(range(k - 41, k))
        pi, mu, sigma = pi.clone(), mu.clone(), sigma.clone()
        pi[dead], mu[dead], sigma[dead] = 0.0, 0.0, torch.eye(3)
        pi = pi / pi.sum()
    else:
        g = torch.Generator().manual_seed(62)
        q, _ = torch.linalg.qr(torch.randn(k, 3, 3, generator=g))
        ev = (1e-9 * (1 + torch.rand(k, 3, generator=g)) if case == "floor" else
              torch.tensor([1e-6, 1e-3, 1.0]).expand(k, 3))
        sigma = q @ torch.diag_embed(ev) @ q.transpose(1, 2)
        sigma, dead = 0.5 * (sigma + sigma.transpose(1, 2)), []
    return MixtureParams(pi.to(cuda), mu.to(cuda), sigma.contiguous().to(cuda)), dead


@pytest.mark.parametrize("case", ["k8", "k64", "k512", "k2048", "cut384", "floor", "cond1e6"])
def test_reg_tables_against_the_plain_tables(cuda, case):
    """One launch writes wn and aux as model_terms + pack_table + the cat.
    Against a float64 run of the plain tables: the kernel is float64 inside
    and rounds each value once to float32 (at most 2^-24 relative), so 2^-23
    of the value, plus 1e-9 of its row's largest entry for what float64's
    own order of operations moves. Against the float32 plain tables (what
    the CPU path uses): the plain Cholesky and sums lose a few float32
    roundings times the covariance's condition, so 4e-6 of the row's largest
    entry; at condition 1e6 the float32 plain is itself ~4 % of a row off
    float64, and only the float64 comparison holds there. Dead and padding
    rows (pi = 0) are inert: the bias at the floor, -1e30."""
    params, dead = _reg_tables_mixture(case, cuda)
    k = params.k
    pts, _ = _inputs(100, 64, cuda)
    before = fused_em.LAUNCHES["reg_tables"]
    tab = fused_em.reg_tables_of(prepare(pts).pts4, params)
    assert fused_em.LAUNCHES["reg_tables"] == before + 1
    assert tab.wn.shape == tab.aux.shape == (k, 12)
    p64 = MixtureParams(*(a.cpu().double() for a in params))
    p32 = MixtureParams(*(a.cpu() for a in params))
    for got, ref64, ref32 in zip((tab.wn.cpu().double(), tab.aux.cpu().double()), _plain_reg_tables(p64),
                                 _plain_reg_tables(p32)):
        top = ref64.abs().amax(1, keepdim=True)
        assert bool(((got - ref64).abs() <= 2.0 ** -23 * ref64.abs() + 1e-9 * top).all())
        if case != "cond1e6":
            assert bool(((got - ref32.double()).abs() <= 4e-6 * top).all())
    wn = tab.wn.cpu()
    assert bool((wn[dead, 9] < -1e29).all()) and bool((wn[:, 10:] == 0).all())
    live = torch.ones(k, dtype=torch.bool)
    live[dead] = False
    assert bool((wn[live, 9] > -1e29).all())


def test_reg_tables_of_refuses_what_the_kernel_does_not_take(cuda):
    pts = prepare(_inputs(100, 65, cuda)[0]).pts4
    params = _mixture(64, 66, cuda)
    for bad in (MixtureParams(params.pi.double(), params.mu, params.sigma),
                MixtureParams(params.pi, params.mu, params.sigma.transpose(1, 2)),  # not contiguous
                MixtureParams(params.pi, params.mu.cpu(), params.sigma)):
        with pytest.raises(ValueError):
            fused_em.reg_tables_of(pts, bad)


def test_register_tree_on_the_card_builds_each_level_in_one_launch(cuda, monkeypatch):
    """register_tree with the dragon cells' settings (branch 8, 3 levels,
    horn+wls, 50 iterations a level, cut 0.02) on the card against the same
    registration on the CPU through the plain path: one reg_tables launch a
    level, no precision_terms call on the card (the CPU path makes two a
    level), and the pose within the dragon_to_map cell's limits on the
    program's pose (regbench/limits/dragon_to_map.json, read)."""
    import json
    from pathlib import Path

    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.ops import gaussians
    from hgmm_torch.pipelines.register import register_tree

    limits = json.loads((Path(__file__).resolve().parents[1] / "regbench" / "limits" /
                         "dragon_to_map.json").read_text())
    target = make_cloud(60_000, "trefoil", seed=3, device="cpu")
    gt = Pose(so3_exp(torch.tensor([0.05, -0.1, 0.15])), torch.tensor([0.03, -0.02, 0.04]))
    source = gt.inverse().apply(target)
    tree, _ = GmmTree.fit(target, levels=3, em_iters=8, generator=torch.Generator().manual_seed(0))
    inverses = []
    real = gaussians._inv_and_logdet_3x3
    monkeypatch.setattr(gaussians, "_inv_and_logdet_3x3", lambda s: inverses.append(s.device) or real(s))
    kw = dict(n_iters=50, method="horn+wls", complexity_threshold=0.02)
    cpu = register_tree(source, tree, **kw)
    assert inverses == [torch.device("cpu")] * 6
    card_tree = GmmTree(levels=[MixtureParams(*(a.to(cuda) for a in lv)) for lv in tree.levels],
                        branch=tree.branch)
    inverses.clear()
    before = fused_em.LAUNCHES["reg_tables"]
    card = register_tree(source.to(cuda), card_tree, **kw)
    torch.cuda.synchronize()
    assert fused_em.LAUNCHES["reg_tables"] == before + 3 and inverses == []
    R = card.pose.R.cpu().double() @ cpu.pose.R.double().T
    rot = float(torch.atan2(0.5 * torch.linalg.vector_norm(torch.stack(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])), 0.5 * (torch.trace(R) - 1.0)))
    trans = float(torch.linalg.vector_norm(card.pose.t.cpu().double() - cpu.pose.t.double()))
    assert rot <= limits["pose_rot_gap"]["limit"] and trans <= limits["pose_trans_gap"]["limit"]


@pytest.mark.parametrize("k", [64, 68, 512])
@pytest.mark.parametrize("n", [1, 300, 20_000])
def test_em_stats_masked_by_parent_chunks(cuda, k, n):
    """Parents -1 and past K, zero-weight rows, a dead child, K off the
    branch; a grouping reused by two sweeps; two launches give equal bits."""
    pts, w = _inputs(n, k + 30, cuda)
    w[::7] = 0.0
    n_par = -(-k // 8)
    par = torch.randint(-1, n_par + 2, (n,), generator=torch.Generator().manual_seed(k)).to(cuda)
    W = pack_loglik_weights(_mixture(k, k + 31, cuda, dead=(3,)))
    prep = prepare(pts, w)
    groups = fused_em.group_by_parent(prep.pts4, par, 8, k)
    got = fused_em.em_stats_grouped(groups, W)
    _check_em(got, em_ref.em_stats_masked(pts, W, par, 8, w), n)
    assert float(got.S[3].abs().max()) == 0.0
    again = fused_em.em_stats_grouped(groups, W)
    assert torch.equal(got.S, again.S) and torch.equal(got.loglik, again.loglik)
    W2 = pack_loglik_weights(_mixture(k, k + 32, cuda))
    _check_em(fused_em.em_stats_grouped(groups, W2), em_ref.em_stats_masked(pts, W2, par, 8, w), n)
    for branch, kk in ((0, k), (8, fused_em.MAX_K + 1)):  # what still raises: branch < 1, K > MAX_K
        with pytest.raises(ValueError):
            fused_em.group_by_parent(prep.pts4, par, branch, kk)


@pytest.mark.parametrize("branch,k", [(9, 81), (12, 144), (12, 1728), (16, 256), (16, 250), (33, 1089),
                                      (16, 10)])
@pytest.mark.parametrize("n", [1, 300, 20_000])
def test_em_stats_grouped_wide(cuda, branch, k, n):
    """Branch > 8: the wide body, groups of 8 children after the normaliser
    over all of them; branch 12 and 33 leave a partial group, K = 250 and 10
    a parent short of children; parents -1 and past K, zero-weight rows, a
    dead child; a grouping reused gives equal bits."""
    pts, w = _inputs(n, k + 70, cuda)
    w[::7] = 0.0
    n_par = -(-k // branch)
    par = torch.randint(-1, n_par + 2, (n,), generator=torch.Generator().manual_seed(k)).to(cuda)
    W = pack_loglik_weights(_mixture(k, k + 71, cuda, dead=(3,)))
    groups = fused_em.group_by_parent(prepare(pts, w).pts4, par, branch, k)
    before = fused_em.LAUNCHES["em_stats_masked_wide"]
    got = fused_em.em_stats_grouped(groups, W)
    assert fused_em.LAUNCHES["em_stats_masked_wide"] == before + 1
    _check_em(got, em_ref.em_stats_masked(pts, W, par, branch, w), n)
    assert float(got.S[3].abs().max()) == 0.0
    again = fused_em.em_stats_grouped(groups, W)
    assert torch.equal(got.S, again.S) and torch.equal(got.loglik, again.loglik)


@pytest.mark.parametrize("k", [512, 256])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -2.0)])
@pytest.mark.parametrize("top_k", [33, 64, 128, -1])
def test_reg_stats_select_body(cuda, k, weighted, outlier, top_k):
    """32 < top_k < K (-1: K - 1): the select body, a warp a point, against
    the plain version with the points whose gate rounding decides weighed 0
    in both."""
    _check_reg_stats(cuda, _mixture(k, k + 8, cuda, dead=(2,)), 20_000, k + 9, weighted,
                     k - 1 if top_k < 0 else top_k, outlier)


@pytest.mark.parametrize("top_k", [33, 64, 95, 191])
def test_reg_stats_select_keeps_exact_ties(cuda, top_k):
    """Every component twice (K = 192): the top_k-th logit ties exactly with
    another one, and both are kept; K - 1 keeps all but the one lowest pair."""
    half = _mixture(96, 17, cuda, dead=(5,))
    params = MixtureParams(torch.cat([half.pi, half.pi]) / 2, torch.cat([half.mu, half.mu]),
                           torch.cat([half.sigma, half.sigma]))
    _check_reg_stats(cuda, params, 20_000, 18, True, top_k, 0.0)


def test_reg_stats_select_at_the_largest_k(cuda):
    """K = MAX_K, top_k = K - 1 and 64: the select body's shared memory at
    its largest (above 48 KB, set by the attribute); the dead components'
    logits at the mask floor sort last."""
    k = fused_em.MAX_K
    for top_k in (k - 1, 64):
        _check_reg_stats(cuda, _mixture(k, 19, cuda, dead=(0, 7)), 3000, 20, True, top_k, None)


def test_em_stats_masked_with_no_live_point(cuda):
    pts, _ = _inputs(100, 33, cuda)
    W = pack_loglik_weights(_mixture(64, 34, cuda))
    got = fused_em.em_stats_masked(prepare(pts).pts4, W, torch.full((100,), -1, device=cuda), 8)
    assert float(got.S.abs().max()) == 0.0 and float(got.loglik) == 0.0


# --------------------------------------------------------------------------
# the fit's sweeps on the card: the first em_stats body (K <= 32), assign,
# em_step


@pytest.mark.parametrize("k", [1, 3, 8, 9, 16, 17, 24, 32])
@pytest.mark.parametrize("n", [1, 31, 4097, 100_000])
def test_em_stats_first_body_every_lane_count(cuda, k, n):
    """K <= 32 on 1, 2 and 4 lanes a point (K on and off a lane's eight
    components), zero-weight rows, an outlier logit, a dead component, a
    ragged last warp; the packed table gives the bits of W; two launches
    give equal bits."""
    pts, w = _inputs(n, k + 40, cuda)
    w[::5] = 0.0
    W = pack_loglik_weights(_mixture(k, k + 41, cuda, dead=(0,) if k > 1 else ()))
    p4 = prepare(pts, w).pts4
    for outlier in (None, -3.0):
        got = fused_em.em_stats(p4, W, outlier)
        _check_em(got, em_ref.em_stats(pts, W, w, outlier), n)
        again = fused_em.em_stats(p4, em_ref.pack_table(W), outlier)
        assert torch.equal(got.S, again.S) and torch.equal(got.loglik, again.loglik)
        if k > 1:
            assert float(got.S[0].abs().max()) == 0.0


def _sequential_assign(points, W, parent, branch):
    """The assign kernel before its redesign, in torch: per point, a scan of
    the visible components in index order with a strict '>' (a NaN or -inf
    logit never wins), then the fallback to the lowest masked-out index when
    the best visible logit does not exceed the mask floor. The logits in
    float64 from the packed table: exact for the inputs of _exact_inputs."""
    k = W.shape[1]
    wn = em_ref.pack_table(W).wn[:, :10].double().cpu()
    logits = features(points.double().cpu()) @ wn.T
    n = logits.shape[0]
    j = torch.arange(k)
    if parent is None:
        j0, j1 = torch.zeros(n, dtype=torch.long), torch.full((n,), k)
    else:
        p = parent.long().cpu()
        off = (p < 0) | (p * branch >= k)
        j0 = torch.where(off, 0, p * branch)
        j1 = torch.where(off, 0, torch.clamp(p * branch + branch, max=k))
    vis = (j[None] >= j0[:, None]) & (j[None] < j1[:, None])
    lv = torch.where(vis & ~torch.isnan(logits), logits, torch.tensor(-float("inf"), dtype=torch.float64))
    best = lv.max(1).values
    idx = torch.where(best > -float("inf"), torch.argmax(lv, 1), -1)
    masked_idx = torch.where(j0 > 0, 0, torch.where(j1 < k, j1, -1))
    fall = (masked_idx >= 0) & ~(best > em_ref.NEG_INF)
    keep_low = (best == em_ref.NEG_INF) & (idx >= 0)
    idx = torch.where(fall, torch.where(keep_low, torch.minimum(idx, masked_idx), masked_idx), idx)
    return torch.clamp(idx, min=0).to(torch.int32)


def _exact_inputs(n, k, seed, dev, ties=False, nan=False):
    """Quarter-integer points and 1/16-integer weights: every product and sum
    of a logit is exact in float32, so any order of evaluation gives the same
    bits. ties: the second half of the components repeats the first; nan:
    component 1's logit is NaN for every point."""
    g = torch.Generator().manual_seed(seed)
    pts = torch.randint(-8, 9, (n, 3), generator=g).float() / 4
    W = torch.randint(-8, 9, (10, k), generator=g).float() / 16
    if ties:
        W[:, k // 2:] = W[:, : k - k // 2].clone()
    if nan and k > 1:
        W[0, 1] = float("nan")
    return pts.to(dev), W.to(dev)


@pytest.mark.parametrize("k,branch", [(1, None), (5, None), (8, None), (64, 8), (64, 3), (100, 8),
                                      (512, 8), (256, 16), (144, 12), (1089, 33)])
@pytest.mark.parametrize("ties,nan", [(False, False), (True, False), (True, True)])
@pytest.mark.parametrize("n", [1, 33, 50_000])
def test_assign_bit_equal_to_the_sequential_scan(cuda, k, branch, ties, nan, n):
    """On exact inputs (random, tied, with a NaN logit) the lanes' merge gives
    the index of the previous body's one-thread scan, parents -1 and past K
    included; without a NaN, that of the plain version too."""
    pts, W = _exact_inputs(n, k, k + n, cuda, ties, nan)
    parent = None
    if branch is not None:
        g = torch.Generator().manual_seed(k)
        parent = torch.randint(-1, -(-k // branch) + 2, (n,), generator=g, dtype=torch.int32).to(cuda)
    got = fused_em.assign(prepare(pts).pts4, W, parent, branch)
    assert torch.equal(got.cpu(), _sequential_assign(pts, W, parent, branch))
    assert torch.equal(fused_em.assign(prepare(pts).pts4, em_ref.pack_table(W), parent, branch), got)
    if not nan:
        assert torch.equal(got, em_ref.assign(pts, W, parent, branch))


@pytest.mark.parametrize("k", [1, 8, 40, 64, 100, 512])
@pytest.mark.parametrize("cov_type", ["full", "iso", "diag"])
def test_em_step_against_its_twin(cuda, k, cov_type):
    """One launch; the parameters and the next table against a float64 run
    of the twin (the kernel is float64 inside): within a few float32
    roundings of each value, the table's near-zero entries against the
    row's largest; an empty component: pi 0, Sigma I, its bias at the floor;
    floor rows past K (K = 40 and 100: 64 and 128 rows); loglik[it]."""
    from hgmm_torch import ops

    n = 20_000
    pts, w = _inputs(n, k + 50, cuda)
    w[::4] = 0.0
    p = _mixture(k, k + 51, cuda, dead=(0,))
    st = em_ref.em_stats(pts, pack_loglik_weights(p), w)
    total, cf = w.sum(), torch.tensor(1e-4, device=cuda)
    fit = ops.new_fit(prepare(pts, w), p, 3, total, cf)
    rows = fit.table.wn.shape[0]
    assert rows == fused_em.table_rows(k)
    f64 = em_ref.new_fit(MixtureParams(*(a.cpu().double() for a in p)), 3, total.cpu().double(),
                         cf.cpu().double(), rows)
    before = fused_em.LAUNCHES["em_step"]
    ops.em_step(fused_em.em_rows(em_ref.partials_of(st), fit), fit, 1, 1e-6, cov_type)
    assert fused_em.LAUNCHES["em_step"] == before + 1
    em_ref.em_step(em_ref.EmStats(st.S.cpu().double(), st.loglik.cpu().double()), f64, 1, 1e-6, cov_type)
    for name in ("pi", "mu", "sigma"):
        got, ref = getattr(fit, name).cpu().double(), getattr(f64, name)
        _close(got, ref, 1e-6, 1e-6 * float(ref.abs().max()))
    live = f64.pi > 0
    got, ref = fit.table.wn.cpu().double(), f64.table.wn
    assert float(fit.pi[0]) == 0.0 and torch.equal(fit.sigma[0].cpu(), torch.eye(3))
    row_top = ref[:k].abs().amax(1, keepdim=True)
    err = (got[:k] - ref[:k]).abs()[live]
    assert bool((err <= 1e-6 * ref[:k][live].abs() + 1e-6 * row_top[live]).all())
    assert bool((got[:k, 9][~live] < -1e29).all())
    assert bool((got[:, 10:] == 0).all())
    pad = fit.table.wn.cpu()[k:]  # float32, as pack_table writes NEG_INF
    assert bool((pad[:, :9] == 0).all()) and bool((pad[:, 9] == em_ref.NEG_INF).all())
    assert fit.logliks.cpu().tolist() == [0.0, float(st.loglik), 0.0]


@pytest.mark.parametrize("k", [8, 40, 64, 100, 512])
@pytest.mark.parametrize("layout", ["plain", "grouped", "grouped16"])
@pytest.mark.parametrize("cov_type", ["full", "iso", "diag"])
def test_em_step_on_partial_rows_against_its_twin(cuda, k, layout, cov_type):
    """em_step on the rows of the em_stats bodies (plain: the first body at
    K = 8, the tiled one at K >= 40; grouped: the masked body by parent
    chunks; grouped16: the wide body at branch 16, rows of width 161), one
    launch: against a float64 run of the twin on the
    rows' float32 sums (em_ref.sum_partials), within a few float32 roundings
    of each value (the table's entries against their row's largest); the
    loglik within a float32 rounding of the rows' sum; the floor rows (K =
    40, 100: 64 and 128 rows); two launches give equal bits."""
    from hgmm_torch import ops

    n = 20_000
    pts, w = _inputs(n, k + 60, cuda)
    w[::4] = 0.0
    p = _mixture(k, k + 61, cuda, dead=(0,))
    W = pack_loglik_weights(p)
    data = prepare(pts, w)
    if layout == "plain":
        table = em_ref.pack_table(W, fused_em.table_rows(k))
        parts = fused_em.em_partials(fused_em.flat_body(data.pts4, k), table.wn)
    else:
        branch = 16 if layout == "grouped16" else 8
        parent = torch.randint(-1, -(-k // branch), (n,), generator=torch.Generator().manual_seed(k)).to(cuda)
        data = fused_em.group_by_parent(data.pts4, parent, branch, k)
        parts = fused_em.em_partials_grouped(data, em_ref.pack_table(W).wn)
    host = parts._replace(partial=parts.partial.cpu(),
                          parent_off=None if parts.parent_off is None else parts.parent_off.cpu())
    st = em_ref.sum_partials(host)
    total, cf = w.sum(), torch.tensor(1e-4, device=cuda)
    fits = [ops.new_fit(data, p, 2, total, cf) for _ in range(2)]
    rows = fits[0].table.wn.shape[0]
    f64 = em_ref.new_fit(MixtureParams(*(a.cpu().double() for a in p)), 2, total.cpu().double(),
                         cf.cpu().double(), rows)
    before = fused_em.LAUNCHES["em_step"]
    for fit in fits:
        ops.em_step(parts, fit, 1, 1e-6, cov_type)
    assert fused_em.LAUNCHES["em_step"] == before + 2
    for a, b in zip((*fits[0].params, fits[0].table.wn, fits[0].logliks),
                    (*fits[1].params, fits[1].table.wn, fits[1].logliks)):
        assert torch.equal(a, b)
    fit = fits[0]
    em_ref.em_step(em_ref.EmStats(st.S.double(), st.loglik.double()), f64, 1, 1e-6, cov_type)
    for name in ("pi", "mu", "sigma"):
        got, ref = getattr(fit, name).cpu().double(), getattr(f64, name)
        _close(got, ref, 1e-6, 1e-6 * float(ref.abs().max()))
    live = f64.pi > 0
    got, ref = fit.table.wn.cpu().double(), f64.table.wn
    row_top = ref[:k].abs().amax(1, keepdim=True)
    err = (got[:k] - ref[:k]).abs()[live]
    assert bool((err <= 1e-6 * ref[:k][live].abs() + 1e-6 * row_top[live]).all())
    assert float(fit.pi[0]) == 0.0 and bool((got[:k, 9][~live] < -1e29).all())
    pad = fit.table.wn.cpu()[k:]
    assert bool((pad[:, :9] == 0).all()) and bool((pad[:, 9] == em_ref.NEG_INF).all())
    lls = fit.logliks.cpu()
    assert float(lls[0]) == 0.0 and abs(float(lls[1]) - float(st.loglik)) <= 2.0 ** -23 * abs(float(st.loglik))


@pytest.mark.parametrize("case", ["flat8", "flat64", "grouped64"])
def test_fit_sweeps_on_the_card_make_no_host_sync(cuda, case):
    """A level's sweeps on the card: the E-step (the first body at K = 8, the
    tiled one at K = 64 on its padded table, the grouped one masked) and
    em_step, one launch of each a sweep, no host sync inside the loop (torch's
    sync debug mode set to raise), two kernels a sweep by the profiler (the
    body, then em_step on its partial rows: the kernels of 2s sweeps less
    those of s, over s); the per-point loglik after the sweeps against the
    same loop on the CPU through the plain versions."""
    import json
    import tempfile
    from pathlib import Path

    from hgmm_torch.utils.profiling import trace
    from hgmm_torch import ops
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import em_sweeps, init_params, scene_variance, total_weight
    from hgmm_torch.models.gmm_tree import seed_children

    pts = make_cloud(20_000, "trefoil", seed=12, device="cpu")
    w = torch.rand(20_000, generator=torch.Generator().manual_seed(13))
    w[::6] = 0.0
    k0 = 64 if case == "flat64" else 8
    init = init_params(pts, k0, torch.Generator().manual_seed(14), point_weights=w)
    sweeps = 8
    fits = {}
    for dev in (cuda, torch.device("cpu")):
        p, ww = pts.to(dev), w.to(dev)
        prep = ops.prepare(p, ww)
        total, cf = total_weight(p, ww), 1e-3 * scene_variance(p, ww)
        start = MixtureParams(*(a.to(dev) for a in init))
        data = prep
        if case == "grouped64":
            level0 = em_sweeps(prep, start, 4, total, cf)
            parent = ops.assign(prep, level0.table)
            data = ops.group_by_parent(prep, parent, 8, 64)
            start = seed_children(level0.params, 8)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            before = dict(fused_em.LAUNCHES)
            torch.cuda.set_sync_debug_mode("error")
            try:
                fit = em_sweeps(data, start, sweeps, total, cf)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            estep = {"flat8": "em_stats", "flat64": "em_stats_tiled", "grouped64": "em_stats_masked"}[case]
            assert fused_em.LAUNCHES[estep] - before[estep] == sweeps
            assert fused_em.LAUNCHES["em_step"] - before["em_step"] == sweeps
            kernels = []
            for s_ in (sweeps, 2 * sweeps):
                with tempfile.TemporaryDirectory() as d:
                    with trace(d):
                        em_sweeps(data, start, s_, total, cf)
                        torch.cuda.synchronize()
                    events = json.loads((Path(d) / "trace.json").read_text())["traceEvents"]
                kernels.append(sum(1 for e in events if e.get("cat") == "kernel" and "dur" in e))
            assert (kernels[1] - kernels[0]) / sweeps == 2
        else:
            fit = em_sweeps(data, start, sweeps, total, cf)
        fits[dev.type] = (fit.logliks.cpu() / total.cpu(), fit)
    card, cpu = fits["cuda"][0], fits["cpu"][0]
    assert bool(torch.isfinite(card).all())
    torch.testing.assert_close(card[-1], cpu[-1], rtol=1e-3, atol=0)


# --------------------------------------------------------------------------
# the sharded path (hgmm_torch.parallel) on the card


@pytest.fixture(scope="module")
def nccl_world():
    """The NCCL world of one process that make_mesh starts without a process
    group, taken down at the end of the module if this module made it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from hgmm_torch.parallel import make_mesh

    made = not dist.is_initialized()
    mesh = make_mesh("cuda")
    yield mesh
    if made:
        dist.destroy_process_group()


def _sharded_meshes(world):
    from hgmm_torch.parallel import EmulatedMesh

    return {"nccl_1": world, "emulated_4": EmulatedMesh(4, "cuda")}


@pytest.mark.parametrize("mesh_kind", ["nccl_1", "emulated_4"])
@pytest.mark.parametrize("k,weighted", [(8, False), (64, True), (512, False)])
def test_sharded_em_fit_on_the_card(cuda, nccl_world, mesh_kind, k, weighted):
    """sharded_em_fit over NCCL at world size 1 and on 4 emulated ranks
    against the unsharded em_fit on the card from one init, with the
    tolerances of tests/test_parallel.py:36-39; one E-step launch (body and
    reduce, counted by body) and one em_step a sweep on each rank."""
    from hgmm_torch.models.gmm import em_fit
    from hgmm_torch.parallel import sharded_em_fit

    mesh = _sharded_meshes(nccl_world)[mesh_kind]
    pts, w = _inputs(40_003, 30 + k, cuda)
    w = w if weighted else None
    init = _mixture(k, 31, cuda)
    ref, ll_ref = em_fit(pts, init, n_iters=6, point_weights=w)
    fused_em.reset_launches()
    got, ll = sharded_em_fit(pts, init, mesh, n_iters=6, point_weights=w)
    torch.cuda.synchronize()
    ranks = mesh.size
    body = "em_stats" if k < fused_em.EMT_MIN_K else "em_stats_tiled"
    assert fused_em.LAUNCHES[body] == 6 * ranks and fused_em.LAUNCHES["em_step"] == 6 * ranks
    _close(got.pi, ref.pi, 1e-4, 1e-6)
    _close(got.mu, ref.mu, 1e-4, 1e-5)
    _close(got.sigma, ref.sigma, 1e-3, 1e-5)
    _close(ll, ll_ref, 1e-5, 0.0)


@pytest.mark.parametrize("mesh_kind", ["nccl_1", "emulated_4"])
def test_sharded_tree_and_registration_on_the_card(cuda, nccl_world, mesh_kind):
    """sharded_tree_fit and sharded_register_tree on the card against
    GmmTree.fit and register_tree there (one init0): each level's per-point
    loglik within 1e-3, the pose within tests/test_parallel.py:59-60's
    tolerance; the tree kernels all launched."""
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import init_params, log_likelihood
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.models.se3 import Pose
    from hgmm_torch.parallel import sharded_register_tree, sharded_tree_fit
    from hgmm_torch.pipelines.register import register_tree

    mesh = _sharded_meshes(nccl_world)[mesh_kind]
    target = make_cloud(60_000, "trefoil", seed=3, device=cuda)
    gt = Pose(so3_exp(torch.tensor([0.0, 0.0, 0.2], device=cuda)), torch.tensor([0.03, -0.02, 0.04], device=cuda))
    source = gt.inverse().apply(target)
    init0 = init_params(target, 8, torch.Generator().manual_seed(0))
    ref, _ = GmmTree.fit(target, levels=3, em_iters=8, init0=init0)
    fused_em.reset_launches()
    tree = sharded_tree_fit(target, mesh, levels=3, em_iters=8, init0=init0)
    res = sharded_register_tree(source, tree, mesh, n_iters=30, complexity_threshold=0.02)
    torch.cuda.synchronize()
    for name in ("em_stats", "em_stats_masked", "em_step", "assign", "reg_stats", "reg_step"):
        assert fused_em.LAUNCHES[name] > 0, name
    for a, b in zip(tree.levels, ref.levels):
        _close(log_likelihood(a, target), log_likelihood(b, target), 1e-3, 0.0)
    single = register_tree(source, ref, n_iters=30, method="horn+wls", complexity_threshold=0.02)
    _close(res.pose.R, single.pose.R, 1e-3, 1e-4)
    _close(res.pose.t, single.pose.t, 1e-3, 1e-4)


def test_sharded_sweeps_and_scan_steps_never_sync(cuda, nccl_world):
    """Under torch's sync debug mode "error": a sharded sweep (body, reduce,
    NCCL all-reduce, em_step) and a sharded scan step (reg_stats, reduce,
    all-reduce, reg_step) make the host wait nowhere."""
    from hgmm_torch import ops
    from hgmm_torch.models.gmm import em_sweeps
    from hgmm_torch.parallel.sharded import _mesh_scalars, _scan

    pts, _ = _inputs(30_000, 41, cuda)
    init = _mixture(64, 42, cuda)
    prep = ops.prepare(pts)
    total, floor = _mesh_scalars(prep, nccl_world, 1e-4)
    from hgmm_torch.models.se3 import Pose

    pose = Pose.identity(device=cuda)
    w = torch.ones(pts.shape[0], device=cuda)
    for run in (lambda: em_sweeps(prep, init, 4, total, floor, mesh=nccl_world),
                lambda: _scan(ops.prepare(pts, w), init, nccl_world, pose, 6, "horn+wls", 1e-7, None, None,
                              2)):
        run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
