"""Config 3 (CONFIG3_MAHALANOBIS: full covariances, the Mahalanobis pose
solve, each point's responsibilities gated to its top_k components, a
uniform outlier logit) through the port's normal path, on the CPU, against
the benchmark's float64 gated reference (regbench/reference/register_gated.py),
on partial, cluttered views (regbench/harness/partial_views.py). Also: the
benchmark configuration against the preset, the launch counter of each
reg_stats body, and the gated roofline against the port's kernel_bound."""

from __future__ import annotations

import inspect
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hgmm_torch.configs.presets import CONFIG3_MAHALANOBIS
from hgmm_torch.eval import roofline as port_roofline
from hgmm_torch.ops import em_ref, fused_em
from hgmm_torch.ops.gaussians import MixtureParams
from regbench.harness import common, data, partial_views, roofline_gated
from regbench.reference import mixture, register_gated

REPO = Path(__file__).resolve().parents[1]
SEED = 2147483901
# A small config-3 problem: branch 4 and 3 levels (K = 4, 16, 64), top_k 3,
# so the gate drops components at every level.
N, BRANCH, LEVELS, TOP_K = 4000, 4, 3, 3
REG = dict(n_iters=50, method="horn+wls", outlier_logit=0.0, wls_inner=2, tol=1e-7, complexity_threshold=0.0)
# The port runs this problem in float32 and the reference in float64 on the
# port's own tree, so the poses differ by float32 rounding of sums over N
# points carried through 150 iterations (3.5e-7 rad, 7.5e-8 here); a
# component gated on one side and not on the other (a near-tie at the
# threshold) moves a pose by more. 2e-5 rad and 2e-5 in translation (the cloud
# is ~2 units across) holds rounding; the same problem with the gate taken out
# moves the pose by 7.2e-4 rad and 3.3e-4.
POSE_TOL = 2e-5


@pytest.fixture(scope="module")
def problem():
    from hgmm_torch import GmmTree

    rng = np.random.default_rng(data.seeds(SEED, 0))
    model = data.trefoil(rng, N)
    tree, _ = GmmTree.fit(torch.from_numpy(model), branch=BRANCH, levels=LEVELS, em_iters=10,
                          generator=torch.Generator().manual_seed(7))
    pair = partial_views.partial_pool(SEED, N, 1, model, 0.7, 0.1, 0.1, 0.2, 0.06, 0.002)[0]
    levels = [mixture.Mixture(*(a.double() for a in lv)) for lv in tree.levels]
    R, t = register_gated.register_tree(torch.from_numpy(pair.source), None, levels, BRANCH,
                                        REG["n_iters"], REG["method"], REG["outlier_logit"],
                                        REG["complexity_threshold"], TOP_K, tol=REG["tol"])
    return tree, pair, (R, t)


def _port_pose(tree, pair, top_k):
    from hgmm_torch import register_pair

    res = register_pair(torch.from_numpy(pair.source), model=tree, top_k=top_k, **REG)
    return res.pose.R.numpy(), res.pose.t.numpy()


def _gaps(a, b):
    return common.rotation_gap(a[0], b[0]), common.translation_gap(a[1], b[1])


def test_gated_registration_matches_the_reference(problem):
    tree, pair, ref = problem
    rot, trans = _gaps(_port_pose(tree, pair, TOP_K), ref)
    assert rot < POSE_TOL and trans < POSE_TOL, (rot, trans)
    # Both land near the pose the view was made with; a partial view with
    # clutter is not held to it exactly (its centroid is not the model's).
    rot, trans = _gaps(ref, (pair.R, pair.t))
    assert rot < 0.05 and trans < 0.05, (rot, trans)


def test_the_comparison_fails_with_the_gate_taken_out(problem):
    """The gate is no no-op at this size: the port without it lands outside
    the tolerance, by more than ten times it."""
    tree, pair, ref = problem
    rot, trans = _gaps(_port_pose(tree, pair, None), ref)
    assert max(rot, trans) > 10 * POSE_TOL, (rot, trans)


@pytest.mark.parametrize("outlier", [None, 0.0])
@pytest.mark.parametrize("top_k", [1, 3, 8, 16])
def test_gated_statistics_match_the_port(top_k, outlier):
    """The reference's gated statistics against the port's plain reg_stats
    (em_ref) with the same top_k, in float64, on exact ties too: every
    component twice, so the top_k-th logit ties with its copy."""
    g = torch.Generator().manual_seed(top_k)
    k = 8
    a = 0.3 * torch.randn(k, 3, 3, generator=g, dtype=torch.float64)
    pi = torch.softmax(torch.randn(k, generator=g, dtype=torch.float64), 0)
    mu = torch.randn(k, 3, generator=g, dtype=torch.float64)
    sigma = a @ a.mT + 0.05 * torch.eye(3, dtype=torch.float64)
    m = mixture.Mixture(torch.cat([pi, pi]) / 2, torch.cat([mu, mu]), torch.cat([sigma, sigma]))
    x = torch.randn(500, 3, generator=g, dtype=torch.float64)
    w = torch.rand(500, generator=g, dtype=torch.float64)
    R, t = np.eye(3), np.array([0.1, -0.2, 0.05])
    horn, A, b = register_gated.statistics(x, w, register_gated.model_terms(m), R, t, outlier, top_k)
    W, mu_, A6, b3 = em_ref.model_terms(MixtureParams(*m))
    want = em_ref.reg_stats(x, W, mu_, A6, b3, (torch.eye(3, dtype=torch.float64), torch.tensor(t)), w,
                            top_k, outlier)
    for got, ref in ((horn, want.horn), (A, want.A), (b, want.b)):
        np.testing.assert_allclose(got, ref.numpy(), rtol=1e-9, atol=1e-9)


def test_gate_keeps_ties_like_the_port():
    logits = torch.tensor([[3.0, 1.0, 3.0, 2.0, 2.0], [0.0, 0.0, 0.0, 0.0, -1.0]], dtype=torch.float64)
    for top_k in range(1, 6):
        assert torch.equal(register_gated.gate(logits, top_k), em_ref.top_k_mask_logits(logits, top_k))
    assert torch.equal(register_gated.gate(logits, None), logits)


def test_config_file_is_the_preset():
    """The benchmark's config-3 configuration holds CONFIG3_MAHALANOBIS's
    values, and the registration defaults the preset leaves to
    register_pair (wls_inner, tol)."""
    from hgmm_torch.pipelines.register import register_tree

    cfg = json.loads((REPO / "regbench" / "configs" / "dragon_mahal_topk8.json").read_text())
    p = CONFIG3_MAHALANOBIS
    assert (cfg["branch"], cfg["levels"], cfg["fit_iters"], cfg["reg_iters"], cfg["method"]) == (
        p.branch, p.levels, p.fit_iters, p.reg_iters, p.method)
    assert (cfg["top_k"], cfg["outlier_logit"], cfg["complexity_threshold"]) == (
        p.top_k, p.outlier_logit, p.complexity_threshold)
    defaults = inspect.signature(register_tree).parameters
    assert cfg["wls_inner"] == defaults["wls_inner"].default
    assert cfg["tol"] == defaults["tol"].default
    assert p.model_kind == "tree" and p.cov_type == "full"
    assert cfg["points"] == cfg["published_points"] == 437_645 and cfg["reduced"] == []
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == cfg["name"])
    assert entry["file"] == "regbench/configs/dragon_mahal_topk8.json" and entry["reduced"] == []
    assert entry["source"] == cfg["source"]


@pytest.mark.parametrize("gate", [0, 1, 8, 9, 32, 33, 64, 511])
def test_each_gate_counts_under_its_body(gate):
    """0 (no gate) counts as reg_stats (reg_stats_tiled at the dragon's N,
    where the plan tiles it) and past MAX_TOP_K as reg_stats_select, as
    before reg_stats_top_k existed; the register-list body, and only it,
    counts as reg_stats_top_k. The plan agrees: one thread a point and a
    register list exactly there."""
    plan = fused_em.plan_reg_stats(437_645, 512, gate or None, 132)
    name = fused_em.reg_stats_body(gate, plan)
    assert name in fused_em.LAUNCHES
    want = "reg_stats_tiled" if gate == 0 else ("reg_stats_top_k" if gate <= fused_em.MAX_TOP_K
                                               else "reg_stats_select")
    assert name == want
    assert fused_em.reg_stats_body(gate, fused_em.plan_reg_stats(16_384, 512, gate or None, 132)) == (
        "reg_stats" if gate == 0 else want)
    assert (plan.kmax > 0) == (name == "reg_stats_top_k")
    assert (plan.lanes == 32) == (name == "reg_stats_select")


@pytest.mark.parametrize("top_k,bodies", [
    (None, ["reg_stats_tiled"] * 3),
    (8, ["reg_stats_tiled", "reg_stats_top_k", "reg_stats_top_k"]),
    (64, ["reg_stats_tiled", "reg_stats_tiled", "reg_stats_select"]),
    (512, ["reg_stats_tiled"] * 3),
])
def test_a_tree_registration_counts_its_levels_by_body(top_k, bodies):
    """Levels K = 8, 64, 512 at the config-3 cell's 437,645 points: the body
    each level's gate (fused_em._top_k) and plan select. An ungated level
    counts under reg_stats_tiled, the lanes body a thread takes several
    points through; the config-3 preset (top_k 8) counts its K = 64 and 512
    levels under reg_stats_top_k, and the names add up to the steps."""
    got = [fused_em.reg_stats_body(fused_em._top_k(top_k, k), fused_em.plan_reg_stats(437_645, k, top_k, 132))
           for k in (8, 64, 512)]
    assert got == bodies
    assert roofline_gated.top_k_body(8, top_k) is False
    assert [roofline_gated.top_k_body(k, top_k) for k in (8, 64, 512)] == [
        b == "reg_stats_top_k" for b in bodies]


def test_partial_views_crop_clutter_and_pose():
    n, keep, share, margin = 5000, 0.7, 0.1, 0.1
    rng = np.random.default_rng(data.seeds(SEED, 9))
    model = data.trefoil(rng, n)
    pair = partial_views.partial_pool(SEED, n, 2, model, keep, share, margin, 0.2, 0.06, 0.002)
    again = partial_views.partial_pool(SEED, n, 2, model, keep, share, margin, 0.2, 0.06, 0.002)
    for a, b in zip(pair, again):  # the same inputs for a seed, twice
        for x, y in zip(a[:4], b[:4]):
            np.testing.assert_array_equal(x, y)
    other = partial_views.partial_pool(SEED + 1, n, 1, model, keep, share, margin, 0.2, 0.06, 0.002)
    assert not np.array_equal(other[0].source, pair[0].source)
    for j, p in enumerate(pair):
        # The composition, drawn in the generator's order: the view of
        # n - 500 points, then 500 clutter points, shuffled.
        r = np.random.default_rng(data.seeds(SEED, 5, j))
        n_clutter = round(share * n)
        view = partial_views.view(r, n - n_clutter, keep)
        clutter = partial_views.clutter(r, n_clutter, model, margin)
        want = np.concatenate([view, clutter])[r.permutation(n)]
        np.testing.assert_array_equal(p.target, want.astype(np.float32))
        assert p.source.shape == (n, 3) and p.source.dtype == np.float32
        # The pose is held: R source + t lands on the points up to the noise.
        moved = p.source.astype(np.float64) @ p.R.T + p.t
        assert np.abs(moved - p.target).max() < 6 * 0.002 + 1e-5
        angle = common.rotation_gap(np.eye(3), p.R)
        assert angle <= 0.2 + 1e-9 and np.abs(p.t).max() <= 0.06
        # Clutter inside the model's box grown by the margin on each side.
        lo, hi = model.min(0), model.max(0)
        pad = margin * (hi - lo)
        assert (clutter >= lo - pad).all() and (clutter <= hi + pad).all()


def test_a_view_keeps_the_share_farthest_along_its_direction():
    n, keep = 3500, 0.7
    got = partial_views.view(np.random.default_rng(4), n, keep)
    r = np.random.default_rng(4)
    d = r.standard_normal(3)
    d /= np.linalg.norm(d)
    sample = data.trefoil(r, int(np.ceil(n / keep))).astype(np.float64)
    assert got.shape == (n, 3)
    assert n / sample.shape[0] == pytest.approx(keep, abs=1e-3)
    along = np.sort(sample @ d)
    np.testing.assert_array_equal(np.sort(got @ d), along[-n:])


@pytest.mark.parametrize("n,k,top_k", [(437_645, 512, 8), (437_645, 64, 8), (437_645, 8, 8),
                                       (1000, 512, None), (437_645, 512, 64), (20_000, 384, 1)])
def test_gated_roofline_is_the_ports_kernel_bound(n, k, top_k):
    mine = roofline_gated.reg_stats(n, k, top_k)
    port = port_roofline.kernel_bound("reg_stats", n=n, k=k, top_k=top_k)
    assert mine.seconds == pytest.approx(port.seconds, rel=1e-12)
    assert mine.flops == pytest.approx(port.flops, rel=1e-12)


def test_gated_roofline_counts_the_gate():
    assert roofline_gated.reg_stats(1, 512, 8).flops == 10_640
    assert roofline_gated.reg_stats(1, 512, None).flops == 23_240
    assert roofline_gated.MAX_TOP_K == fused_em.MAX_TOP_K
    live, n_iters = [12, 30, 50], 50
    passes = [roofline_gated.passes(m, n_iters, "horn+wls", 2) for m in live]
    assert passes == [12, 25 + 5 * 2, 25 + 25 * 2]
    # Level 0 (K = 8 = top_k) runs the lanes body: no pass of it counts.
    bound = roofline_gated.top_k_passes(1000, [8, 64, 512], live, n_iters, "horn+wls", 2, 8)
    assert bound.seconds == pytest.approx(35 * roofline_gated.reg_stats(1000, 64, 8).seconds
                                          + 75 * roofline_gated.reg_stats(1000, 512, 8).seconds)
