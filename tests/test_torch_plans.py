"""The launch plans of the two redesigned kernels and CPU emulations of their
reduction orders.

csrc/knn.cu and csrc/em_stats.cu:em_stats_tiled_kernel run on the card only;
what surrounds them is Python and is tested here:

- ``ops.knn.plan_knn`` and ``ops.fused_em.plan_em_tiles`` over a grid of
  sizes: every query, target and component is covered exactly once, padding
  is floor rows only, shared memory and register state stay inside the card's
  limits by the plans' own arithmetic, and K < 64 and masked calls keep the
  first kernel body;
- the kernels' reduction orders, emulated in plain torch from the same plans
  and held against the plain versions: chunk minimum, rescan for the first
  target at that distance, merge over target splits (exact ties on chunk,
  tile and split boundaries go to the lowest index; a NaN row never wins);
  tile by tile E-step with padded floor rows, a thread's 8 x 8 tile, the
  group-wise max and sum, dead points, zero-weight rows and an outlier logit.

Tolerances of the emulated E-step are the strict ones of
tests/test_fused_em.py:55-56 (atol scaled by N / 300, with a floor of one).
"""

import math

import numpy as np
import pytest
import torch

from hgmm_torch.ops import _build, em_ref, fused_em, knn
from hgmm_torch.ops.fused_em import EMT_CT, EMT_PT, EMT_THREADS, SMEM_LIMIT, plan_em_tiles
from hgmm_torch.ops.gaussians import MixtureParams, features, pack_loglik_weights
from hgmm_torch.ops.knn import KNN_QPB, KNN_TILE, MAX_SPLITS, plan_knn

torch.set_num_threads(2)

SIZES = (1, 31, 500, 16_384, 437_645)
KS = (64, 65, 100, 384, 512, 513, 1024, 2048)
SMS = 132
KNN_CHUNK = 32  # csrc/knn.cu:KNN_CHUNK


# --------------------------------------------------------------------------
# plans


@pytest.mark.parametrize("nt", SIZES)
@pytest.mark.parametrize("nq", SIZES)
def test_plan_knn_covers_every_query_and_target_once(nq, nt):
    plan = plan_knn(nq, nt, SMS)
    # queries: whole blocks, the last one not empty
    assert (plan.query_blocks - 1) * KNN_QPB < nq <= plan.query_blocks * KNN_QPB
    # targets: runs of `span` in index order, none empty, none overlapping
    runs = [(s * plan.span, min(nt, (s + 1) * plan.span)) for s in range(plan.splits)]
    assert runs[0][0] == 0 and runs[-1][1] == nt
    assert all(a < b for a, b in runs)
    assert all(runs[i][1] == runs[i + 1][0] for i in range(len(runs) - 1))
    assert plan.span % KNN_TILE == 0 and 1 <= plan.splits <= MAX_SPLITS
    assert plan.blocks == plan.query_blocks * plan.splits
    # two float4 tiles of static shared memory, far inside the limit
    assert 2 * KNN_TILE * 16 <= 48 * 1024 < SMEM_LIMIT


def test_plan_knn_fills_the_card_and_small_searches_too():
    big = plan_knn(437_645, 437_645, SMS)
    assert big.blocks >= SMS * knn.KNN_RESIDENT
    assert knn._balance(big.blocks, SMS) >= 0.98  # 428 blocks alone would be 0.81
    assert knn._balance(428, SMS) < 0.82
    small = plan_knn(500, 16_384, SMS)
    assert small.splits == MAX_SPLITS  # one query block: the targets are split instead
    assert plan_knn(1, 1, SMS) == knn.KnnPlan(1, 1, KNN_TILE)
    with pytest.raises(ValueError):
        plan_knn(0, 5, SMS)
    with pytest.raises(ValueError):
        plan_knn(5, 0, SMS)


@pytest.mark.parametrize("k", KS)
def test_plan_em_tiles_covers_every_component_once(k):
    plan = plan_em_tiles(k)
    assert plan.k == k <= plan.k_pad and plan.k_pad in (64, 128, 256, 512, 1024, 2048)
    assert plan.k_pad < 2 * k  # the smallest tiling that holds K
    assert plan.comp_groups * plan.point_groups == EMT_THREADS
    assert plan.comp_groups * EMT_CT == plan.k_pad and plan.point_groups * EMT_PT == plan.points
    comps = [j for cg in range(plan.comp_groups) for j in plan.components(cg)]
    assert sorted(comps) == list(range(plan.k_pad))
    rows = [i for pg in range(plan.point_groups) for i in plan.tile_points(pg)]
    assert rows == list(range(plan.points))
    # a thread's two runs of four components are 16-byte words of a weight row
    for cg in (0, plan.comp_groups - 1):
        c = plan.components(cg)
        assert c[:4] == list(range(c[0], c[0] + 4)) and c[0] % 4 == 0
        assert c[4:] == list(range(c[4], c[4] + 4)) and c[4] % 4 == 0
    assert plan.smem_bytes <= SMEM_LIMIT
    assert EMT_PT * EMT_CT + EMT_CT * 10 <= plan.state_registers <= 255
    for n in (0, 1, plan.points, plan.points + 1, 437_645, 1 << 21):
        nb = plan.blocks(n, SMS)
        assert 1 <= nb <= SMS and nb <= max(1, math.ceil(n / plan.points))


@pytest.mark.parametrize("k", KS)
def test_padding_rows_are_floor_rows(k):
    rng = np.random.default_rng(k)
    W = torch.from_numpy(rng.standard_normal((10, k)).astype(np.float32))
    plan = plan_em_tiles(k)
    wn = fused_em._pack_w(W, "cpu", plan.k_pad)
    assert wn.shape == (plan.k_pad, 12)
    torch.testing.assert_close(wn[:k, :10], -0.5 * W.T)
    assert bool((wn[:, 10:] == 0).all())
    pad = wn[k:]
    assert bool((pad[:, :9] == 0).all()) and bool((pad[:, 9] == em_ref.NEG_INF).all())
    assert torch.equal(fused_em._pack_w(W, "cpu"), wn[:k])  # unpadded: the table as before


@pytest.mark.parametrize("k,masked", [(1, False), (8, False), (12, False), (63, False),
                                      (8, True), (64, True), (512, True), (2048, True)])
def test_small_k_and_masked_calls_keep_the_first_body(k, masked):
    assert plan_em_tiles(k, masked=masked) is None


def test_plan_em_tiles_refuses_k_past_the_tables():
    with pytest.raises(ValueError):
        plan_em_tiles(fused_em.MAX_K + 1)


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN4hgmm21em_stats_tiled_kernelILi64EEEvPKfiS2_iifPf' for 'sm_90a'
ptxas info    : Function properties for _ZN4hgmm21em_stats_tiled_kernelILi64EEEvPKfiS2_iifPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 246 registers, used 16 barriers
ptxas info    : Compile time = 900.1 ms
ptxas info    : Compiling entry function '_ZN4hgmm10knn_kernelEPKfiS1_iiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN4hgmm10knn_kernelEPKfiS1_iiPiPf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 96 registers, used 1 barriers, 16384 bytes smem
"""


def test_ptxas_log_gives_registers_and_spills_by_kernel():
    """What chip_smoke.py's build line prints and fails on."""
    rep = _build.parse_ptxas_log(PTXAS_LOG)
    assert len(rep) == 2
    tiled = _build.parse_ptxas_log(PTXAS_LOG, "em_stats_tiled_kernel")
    assert list(tiled.values()) == [{"stack_bytes": 0, "spill_store_bytes": 0,
                                     "spill_load_bytes": 0, "registers": 246}]
    (spilled,) = _build.parse_ptxas_log(PTXAS_LOG, "knn_kernel").values()
    assert spilled == {"stack_bytes": 8, "spill_store_bytes": 4, "spill_load_bytes": 12,
                       "registers": 96}
    assert _build.parse_ptxas_log(PTXAS_LOG, "no_such_kernel") == {}


# --------------------------------------------------------------------------
# knn: chunk minimum, rescan, merge over splits


def _dist2(q, t):
    """csrc/knn.cu:dist2 for q [Nq, 3] against t [M, 3] -> [Nq, M], float32."""
    d = q[:, None, :] - t[None, :, :]
    return d[..., 2] * d[..., 2] + (d[..., 1] * d[..., 1] + d[..., 0] * d[..., 0])


def emulate_knn(q, t, plan):
    """The kernel's order: per split, tiles of KNN_TILE targets padded with
    +inf rows to whole chunks; inside a chunk only cmin = fmin(cmin, d); after
    it, where cmin < best, the first target of the chunk with d == cmin; then
    the splits merged in order on a strict <."""
    nq, nt = q.shape[0], t.shape[0]
    parts = []
    for s in range(plan.splits):
        begin, end = s * plan.span, min(nt, (s + 1) * plan.span)
        best = torch.full((nq,), float("inf"))
        cmin = best.clone()
        arg = torch.zeros(nq, dtype=torch.int64)
        for t0 in range(begin, end, KNN_TILE):
            cnt = min(KNN_TILE, end - t0)
            for c0 in range(0, cnt, KNN_CHUNK):
                chunk = torch.full((KNN_CHUNK, 3), float("inf"))
                m = min(KNN_CHUNK, cnt - c0)
                chunk[:m] = t[t0 + c0: t0 + c0 + m]
                d = _dist2(q, chunk)
                for j in range(KNN_CHUNK):
                    cmin = torch.fmin(cmin, d[:, j])  # fminf: a NaN distance is ignored
                need = cmin < best
                first = (d == cmin[:, None]).int().argmax(1)
                arg = torch.where(need, t0 + c0 + first, arg)
                best = torch.where(need, cmin, best)
        parts.append((best, arg))
    best, arg = parts[0]
    for d, a in parts[1:]:
        better = d < best
        best, arg = torch.where(better, d, best), torch.where(better, a, arg)
    return arg.to(torch.int32), best


def _exact(q, t):
    """Lowest index at the smallest float32 direct-form distance, NaN ignored."""
    d = _dist2(q, t)
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return d.argmin(1).to(torch.int32), d.amin(1)


@pytest.mark.parametrize("nq,nt,sms", [(1, 1, 132), (7, 31, 132), (40, 33, 132), (300, 1025, 132),
                                       (300, 1600, 1), (50, 3000, 132), (1100, 700, 2)])
def test_knn_emulation_matches_the_plain_version(nq, nt, sms):
    rng = np.random.default_rng(nq + nt)
    q = torch.from_numpy(rng.standard_normal((nq, 3)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((nt, 3)).astype(np.float32))
    plan = plan_knn(nq, nt, sms)
    idx, d2 = emulate_knn(q, t, plan)
    ex_idx, ex_d2 = _exact(q, t)
    assert torch.equal(idx, ex_idx) and torch.equal(d2, ex_d2)
    ref_idx, ref_d2 = knn.nearest_neighbor_ref(q, t)
    assert float((idx == ref_idx).double().mean()) >= 0.98
    torch.testing.assert_close(d2, ref_d2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("gap", [1, KNN_CHUNK, KNN_TILE, 1024])
def test_knn_emulation_sends_exact_ties_to_the_lowest_index(gap):
    """Every target twice, the copy `gap` rows later: one inside the chunk, one
    a chunk, a tile and (with two splits of two tiles) a split further on."""
    rng = np.random.default_rng(gap)
    base = torch.from_numpy(rng.standard_normal((gap, 3)).astype(np.float32))
    t = torch.cat([base, base, base[: 2048 - 2 * gap]]) if gap < 1024 else torch.cat([base, base])
    q = base[:: max(1, gap // 64)] + 0.0
    plan = plan_knn(q.shape[0], t.shape[0], 2)
    assert gap < 1024 or plan.splits > 1
    idx, d2 = emulate_knn(q, t, plan)
    assert bool((d2 == 0).all())
    assert torch.equal(idx, torch.arange(0, gap, max(1, gap // 64), dtype=torch.int32))
    same = torch.full((t.shape[0], 3), 0.25)
    assert int(emulate_knn(q, same, plan)[0].abs().max()) == 0


def test_knn_emulation_ignores_a_nan_target_row():
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((200, 3)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal((700, 3)).astype(np.float32))
    t[40] = float("nan")
    t[600, 1] = float("nan")
    idx, d2 = emulate_knn(q, t, plan_knn(200, 700, 1))
    ex_idx, ex_d2 = _exact(q, t)
    assert torch.equal(idx, ex_idx) and torch.equal(d2, ex_d2)
    assert not bool(((idx == 40) | (idx == 600)).any()) and bool(torch.isfinite(d2).all())


# --------------------------------------------------------------------------
# em_stats: tile by tile, a thread's 8 x 8 tile, the group-wise max and sum

LOG2E = 1.4426950408889634


def emulate_em_stats(points, W, weights, outlier, sms=3):
    """The tiled kernel's order in plain torch: the padded table, tiles of
    plan.points points dealt to `nb` blocks grid-stride, the max and the sum
    over a thread's components and then over the component groups, exp2 once a
    pair, the scale once a point, float32 statistics per (block, point group,
    component), the point groups summed in order, the blocks in float64."""
    n, k = points.shape[0], W.shape[1]
    plan = plan_em_tiles(k)
    wn = fused_em._pack_w(W, "cpu", plan.k_pad)[:, :10]
    comps = torch.tensor([plan.components(cg) for cg in range(plan.comp_groups)])  # [NCG, 8]
    psi = features(points)  # [N, 10], psi[:, 9] == 1
    w = torch.ones(n) if weights is None else weights.float()
    nb = plan.blocks(n, sms)
    acc = torch.zeros(nb, plan.point_groups, plan.k_pad, 10)
    ll = torch.zeros(nb)
    floor = torch.tensor(em_ref.NEG_INF)
    for tile in range(-(-n // plan.points)):
        rows = slice(tile * plan.points, min(n, (tile + 1) * plan.points))
        p_t, w_t = psi[rows], w[rows]
        logits = p_t @ wn.T  # [p, k_pad]
        by_thread = logits[:, comps]  # [p, NCG, 8]
        m = by_thread.amax(2).amax(1)
        if outlier is not None:
            m = torch.maximum(m, torch.tensor(float(outlier)))
        live = m > floor
        m2 = torch.where(live, m * LOG2E, torch.full_like(m, float("inf")))
        e = torch.exp2(logits * LOG2E - m2[:, None])
        s = e[:, comps].sum(2).sum(1)
        if outlier is not None:
            s = s + torch.exp2(float(outlier) * LOG2E - torch.maximum(m, floor) * LOG2E)
        ss = torch.clamp(s, min=1e-38)
        scale = torch.where(live, w_t / ss, torch.zeros_like(ss))
        lse = torch.where(live, w_t * (torch.maximum(m, floor) + torch.log(ss)), torch.zeros_like(ss))
        gamma = e * scale[:, None]
        b = tile % nb
        for pg in range(plan.point_groups):
            own = [i for i in plan.tile_points(pg) if i < p_t.shape[0]]
            if own:
                acc[b, pg] += gamma[own].T @ p_t[own]
        ll[b] += lse.sum()
    S = acc.sum(1).double().sum(0)[:k].float()  # rows k.. are the floor rows: dropped
    return em_ref.EmStats(S=S, loglik=ll.double().sum().float())


def _mixture(k, seed, dead=()):
    rng = np.random.default_rng(seed)
    a = 0.3 * rng.standard_normal((k, 3, 3))
    z = rng.standard_normal(k)
    pi = np.exp(z - z.max())
    pi[list(dead)] = 0.0
    pi /= max(pi.sum(), 1e-30)
    sigma = np.einsum("kij,klj->kil", a, a) + 0.05 * np.eye(3)
    return MixtureParams(*(torch.from_numpy(x.astype(np.float32))
                           for x in (pi, rng.standard_normal((k, 3)), sigma)))


def _check_em(got, ref, n):
    torch.testing.assert_close(got.S.double(), ref.S.double(), rtol=2e-3, atol=2e-4 * max(n, 300) / 300)
    torch.testing.assert_close(got.loglik.double(), ref.loglik.double(), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("k", [64, 65, 100, 513])
@pytest.mark.parametrize("n", [1, 31, 300, 1000])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -3.0)])
def test_em_emulation_matches_the_plain_version(k, n, weighted, outlier):
    rng = np.random.default_rng(k + n)
    pts = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    w = None
    if weighted:
        w = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
        w[::3] = 0.0  # zero-weight pads add nothing
    W = pack_loglik_weights(_mixture(k, k, dead=(3,)))
    got = emulate_em_stats(pts, W, w, outlier)
    _check_em(got, em_ref.em_stats(pts, W, w, outlier), n)
    assert float(got.S[3].abs().max()) == 0.0  # pi = 0 stays inert


@pytest.mark.parametrize("k", [65, 100])
@pytest.mark.parametrize("outlier", [None, -3.0])
def test_em_emulation_dead_points_and_floor_rows(k, outlier):
    """Every component dead: without an outlier logit every point is dead (S
    and loglik exactly 0, no NaN from the floor's residue); with one the
    outlier takes all the mass. The floor rows never make a dead point live."""
    rng = np.random.default_rng(k)
    pts = torch.from_numpy(rng.standard_normal((300, 3)).astype(np.float32))
    mix = _mixture(k, k + 1)
    W = pack_loglik_weights(MixtureParams(torch.zeros_like(mix.pi), mix.mu, mix.sigma))
    got = emulate_em_stats(pts, W, None, outlier)
    ref = em_ref.em_stats(pts, W, None, outlier)
    assert bool(torch.isfinite(got.S).all()) and float(got.S.abs().max()) == 0.0
    _check_em(got, ref, 300)
    if outlier is None:
        assert float(got.loglik) == 0.0
