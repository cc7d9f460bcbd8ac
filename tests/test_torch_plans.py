"""The launch plans of the two redesigned kernels and CPU emulations of their
reduction orders.

csrc/knn.cu and csrc/em_stats.cu:em_stats_tiled_kernel run on the card only;
what surrounds them is Python and is tested here:

- ``ops.knn.plan_knn`` and ``ops.fused_em.plan_em_tiles`` over a grid of
  sizes: every query, target and component is covered exactly once, padding
  is floor rows only, shared memory and register state stay inside the card's
  limits by the plans' own arithmetic, and K <= 32 and masked calls keep the
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

import dataclasses
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
KS = (33, 63, 64, 65, 100, 384, 512, 513, 1024, 2048)
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
    wn = em_ref.pack_table(W, plan.k_pad).wn
    assert wn.shape == (plan.k_pad, 12)
    torch.testing.assert_close(wn[:k, :10], -0.5 * W.T)
    assert bool((wn[:, 10:] == 0).all())
    pad = wn[k:]
    assert bool((pad[:, :9] == 0).all()) and bool((pad[:, 9] == em_ref.NEG_INF).all())
    assert torch.equal(em_ref.pack_table(W).wn, wn[:k])  # unpadded: the table as before


@pytest.mark.parametrize("k,masked", [(1, False), (8, False), (12, False), (32, False),
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


WGMMA_LOG = """\
ptxas info    : Compiling entry function '_ZN4hgmm24probe_logits_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_iiiPf' for 'sm_90a'
ptxas info    : (C7517) warpgroup.wait is injected in around line 6231 by compiler to allow use of registers defined by GMMA in function '_ZN4hgmm24probe_logits_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_iiiPf'
ptxas info    : (C7514) Potential Performance Loss: wgmma.mma_async instructions are serialized due to non wgmma instructions reading accumulator registers of  a wgmma between start and end of the pipeline stage in the function '_ZN4hgmm24probe_logits_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_iiiPf'
ptxas info    : Function properties for _ZN4hgmm24probe_logits_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_iiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 118 registers, used 1 barriers, 10368 bytes smem
ptxas info    : Compiling entry function '_ZN4hgmm23probe_stats_bf16_kernelILi64ELi2EEEvPK13__nv_bfloat16S3_S3_iiiiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN4hgmm23probe_stats_bf16_kernelILi64ELi2EEEvPK13__nv_bfloat16S3_S3_iiiiPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 190 registers, used 1 barriers, 128 bytes smem
"""


def test_ptxas_log_marks_a_serialized_wgmma():
    """ptxas's C7514 note (it runs every wgmma of the kernel one at a time)
    marks the kernel it names, which chip_smoke.py's build check refuses;
    the C7517 note that comes with it names no other kernel."""
    rep = _build.parse_ptxas_log(WGMMA_LOG, "probe_")
    logits = next(v for name, v in rep.items() if "logits" in name)
    stats = next(v for name, v in rep.items() if "stats" in name)
    assert logits == {"wgmma_serialized": 1, "stack_bytes": 0, "spill_store_bytes": 0,
                      "spill_load_bytes": 0, "registers": 118}
    assert "wgmma_serialized" not in stats and stats["registers"] == 190


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN4hgmm24probe_logits_bf16_kernelILi64EEEvPK13__nv_bfloat16S3_S3_iiiPf
        /*0b30*/                   WARPGROUP.ARRIVE ;
        /*0b40*/                   HGMMA.64x64x16.F32.BF16 R24, R152, gdesc[UR4], RZ, !UPT ;
        /*0b50*/                   HGMMA.64x64x16.F32.BF16 R24, R156, gdesc[UR8], R24, gsb0 ;
        /*0b60*/                   WARPGROUP.DEPBAR.LE gsb0, 0x1 ;
\t\tFunction : _ZN4hgmm22probe_norm_bf16_kernelILi4EEEvPK13__nv_bfloat16S3_S3_iiiiPf
        /*0300*/                   HMMA.16816.F32.BF16 R24, R152, R4, R24 ;
        /*0310*/                   HMMA.16816.F32.BF16 R28, R152, R6, R28 ;
\t\tFunction : _ZN4hgmm16probe_vpu_kernelILb1EEEvPKfiiPf
        /*0100*/                   MUFU.EX2 R3, R2 ;
"""


def test_sass_counts_tensor_core_instructions_by_kernel():
    """HGMMA is the warpgroup instruction (wgmma), HMMA the warp one
    (mma.sync, wmma): what chip_smoke.py's build line prints and checks."""
    rep = _build.parse_sass(SASS)
    counts = {name.split("hgmm")[1][2:14]: ops for name, ops in rep.items()}
    assert counts == {"probe_logits": {"HGMMA": 2, "HMMA": 0},
                      "probe_norm_b": {"HGMMA": 0, "HMMA": 2},
                      "probe_vpu_ke": {"HGMMA": 0, "HMMA": 0}}
    assert list(_build.parse_sass(SASS, "norm").values()) == [{"HGMMA": 0, "HMMA": 2}]


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
    wn = em_ref.pack_table(W, plan.k_pad).wn[:, :10]
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


@pytest.mark.parametrize("k", [33, 63, 64, 65, 100, 513])
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


# --------------------------------------------------------------------------
# reg_step: the kernel's float64 solve, emulated in numpy


def _series(theta2):
    theta = math.sqrt(theta2 + 1e-32)
    if theta2 < 1e-8:
        return 1.0 - theta2 / 6.0, 0.5 - theta2 / 24.0, 1.0 / 6.0 - theta2 / 120.0
    return (math.sin(theta) / theta, (1.0 - math.cos(theta)) / theta2,
            (theta - math.sin(theta)) / (theta2 * theta + 1e-32))


def _hat(w):
    return np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])


def emulate_horn(h):
    """csrc/reg_step.cu:solve_horn: one-sided Jacobi on the columns of H
    (a pair is rotated while ga^2 > 1e-30 al be; t from one division, c =
    rsqrt(1 + t^2), here its correctly rounded value), columns by singular
    value, u3 = u1 x u2, R = V diag(1, 1, det V) U^T."""
    h = np.asarray(h, np.float64)
    Sw = max(h[3, 3], 1e-9)
    Sx, Snu = h[:3, 3], h[3, :3]
    W = h[:3, :3] - np.outer(Sx, Snu) / Sw
    V = np.eye(3)
    for _ in range(30):
        rotated = False
        for p, q in ((0, 1), (0, 2), (1, 2)):
            al, be, ga = W[:, p] @ W[:, p], W[:, q] @ W[:, q], W[:, p] @ W[:, q]
            if not ga * ga > 1e-30 * (al * be):
                continue
            rotated = True
            # sign(zeta) / (|zeta| + sqrt(1 + zeta^2)), zeta = (be - al) / (2 ga), times |2 ga| / |2 ga|
            d, g2 = be - al, 2.0 * ga
            sgn = 1.0 if d == 0.0 or (d > 0.0) == (ga > 0.0) else -1.0
            t = sgn * abs(g2) / (abs(d) + math.sqrt(d * d + g2 * g2))
            c = 1.0 / math.sqrt(1.0 + t * t)
            s = c * t
            W[:, [p, q]] = np.stack([c * W[:, p] - s * W[:, q], s * W[:, p] + c * W[:, q]], 1)
            V[:, [p, q]] = np.stack([c * V[:, p] - s * V[:, q], s * V[:, p] + c * V[:, q]], 1)
        if not rotated:
            break
    sig = np.linalg.norm(W, axis=0)
    order = sorted(range(3), key=lambda j: -sig[j])
    u, v = W[:, order].T.copy(), V[:, order].T.copy()
    if not sig[order[0]] > 0.0:  # H = 0: R = I
        return np.eye(3), Snu / Sw - Sx / Sw
    u[0] /= sig[order[0]]
    u[1] -= (u[0] @ u[1]) * u[0]
    if not np.linalg.norm(u[1]) > 1e-300:  # rank one: any unit vector orthogonal to u1
        ax = 0 if abs(u[0][0]) < 0.5 else (1 if abs(u[0][1]) < 0.5 else 2)
        u[1] = np.cross(u[0], np.eye(3)[ax])
    u[1] /= np.linalg.norm(u[1])
    u[2] = np.cross(u[0], u[1])
    d = -1.0 if np.cross(v[0], v[1]) @ v[2] < 0 else 1.0
    R = np.outer(v[0], u[0]) + np.outer(v[1], u[1]) + d * np.outer(v[2], u[2])
    return R, Snu / Sw - R @ (Sx / Sw)


def emulate_wls(A, b):
    """csrc/reg_step.cu:solve_wls: the damped system by LU with partial
    pivoting (the kernel eliminates the rows below the pivot in parallel
    lanes, each with this arithmetic), the rotation capped at 0.3."""
    A, b = np.asarray(A, np.float64), np.asarray(b, np.float64)
    d = np.diag(A)
    M = A + np.diag(1e-2 * np.maximum(d, 1e-12 * d.sum())) + 1e-6 * max(d.sum() / 6.0, 1.0) * np.eye(6)
    M = np.concatenate([M, b[:, None]], 1)
    for c in range(6):
        piv = c + int(np.argmax(np.abs(M[c:, c])))
        M[[c, piv]] = M[[piv, c]]
        for r in range(c + 1, 6):
            M[r, c:] -= M[r, c] / M[c, c] * M[c, c:]
    xi = np.zeros(6)
    for r in range(5, -1, -1):
        xi[r] = (M[r, 6] - M[r, r + 1:6] @ xi[r + 1:]) / M[r, r]
    return xi * min(0.3 / max(np.linalg.norm(xi[:3]), 1e-12), 1.0)


def emulate_se3_exp(xi):
    a, b, c = _series(xi[:3] @ xi[:3])
    K = _hat(xi[:3])
    return np.eye(3) + a * K + b * K @ K, (np.eye(3) + b * K + c * K @ K) @ xi[3:]


def emulate_se3_log(R, t):
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    w2 = w @ w
    cth = min(max((np.trace(R) - 1.0) * 0.5, -1.0), 1.0)
    small = w2 < 1e-12
    s = 0.5 * math.sqrt(1.0 if small else w2)
    om = (0.5 + w2 / 48.0 if small else math.atan2(s, cth) / (2.0 * s)) * w
    _, b, c = _series(om @ om)
    K = _hat(om)
    V = np.eye(3) + b * K + c * K @ K
    x12, x20, x01 = np.cross(V[:, 1], V[:, 2]), np.cross(V[:, 2], V[:, 0]), np.cross(V[:, 0], V[:, 1])
    return np.concatenate([om, np.array([t @ x12, t @ x20, t @ x01]) / (V[:, 0] @ x12)])


def _horn_moments(rng, n, planar=0.0, flip=False):
    """horn = P^T Q of n points x and their images under a random pose plus
    noise; planar squeezes x onto a plane (a near-degenerate H), flip mirrors
    the targets (det(V U^T) = -1 without the correction)."""
    from hgmm_torch.models.se3 import so3_exp

    x = rng.standard_normal((n, 3))
    x[:, 2] *= planar if planar else 1.0
    R = so3_exp(torch.from_numpy(rng.uniform(-1, 1, 3))).numpy()
    y = x @ R.T + rng.uniform(-0.5, 0.5, 3) + 0.01 * rng.standard_normal((n, 3))
    if flip:
        y[:, 2] *= -1.0
    w = rng.uniform(0.2, 1.0, n)
    P = np.concatenate([x, np.ones((n, 1))], 1)
    Q = np.concatenate([y * w[:, None], w[:, None]], 1)
    return P.T @ Q


@pytest.mark.parametrize("case", ["random", "planar", "line", "mirrored", "identity", "zero"])
def test_reg_step_horn_emulation_matches_solve_horn(case):
    from hgmm_torch.models.pose import solve_horn

    rng = np.random.default_rng(hash(case) % 1000)
    if case == "identity":
        x = rng.standard_normal((50, 3))
        P = np.concatenate([x, np.ones((50, 1))], 1)
        h = P.T @ P
    elif case == "zero":
        h = np.zeros((4, 4))
        h[3, 3] = 1.0
    else:
        h = _horn_moments(rng, 200, planar={"planar": 1e-4, "line": 0.0}.get(case, 0.0),
                          flip=case == "mirrored")
        if case == "line":
            h = _horn_moments(rng, 200)
            x = np.linspace(-1, 1, 200)[:, None] * np.array([[1.0, 2.0, -0.5]])
            P = np.concatenate([x, np.ones((200, 1))], 1)
            h = P.T @ np.concatenate([x @ np.diag([1.0, -1.0, -1.0]), np.ones((200, 1))], 1)
    R, t = emulate_horn(h)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-10)
    assert abs(np.linalg.det(R) - 1.0) < 1e-10
    ref = solve_horn(torch.from_numpy(h))
    if case == "line":  # rank one: the rotation about the line is free; both map the line alike
        x = np.array([1.0, 2.0, -0.5])
        np.testing.assert_allclose(R @ x + t, ref.R.numpy() @ x + ref.t.numpy(), atol=1e-8)
        return
    np.testing.assert_allclose(R, ref.R.numpy(), atol=1e-9)
    np.testing.assert_allclose(t, ref.t.numpy(), atol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_reg_step_wls_emulation_matches_the_twin(seed):
    """Damped Gauss-Newton on random, rank-deficient and ill-scaled A, with
    the cap on and off; exp and log against models/se3.py."""
    from hgmm_torch.models.pose import solve_wls_increment
    from hgmm_torch.models.se3 import Pose, se3_exp, se3_log

    rng = np.random.default_rng(seed)
    J = rng.standard_normal((40 if seed % 3 else 4, 6)) * rng.uniform(0.01, 100.0, 6)
    A = J.T @ J
    b = rng.standard_normal(6) * (1.0 if seed < 3 else 1e3)
    xi = emulate_wls(A, b)
    ref = solve_wls_increment(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(xi, ref, rtol=1e-7, atol=1e-10)
    for v in (xi, 1e-6 * xi, np.zeros(6), np.array([0.2, -0.1, 0.25, 1.0, 2.0, -1.0])):
        R, t = emulate_se3_exp(v)
        ref = se3_exp(torch.from_numpy(v))
        np.testing.assert_allclose(R, ref.R.numpy(), atol=1e-12)
        np.testing.assert_allclose(t, ref.t.numpy(), atol=1e-12)
        back = emulate_se3_log(R, t)
        np.testing.assert_allclose(back, se3_log(Pose(torch.from_numpy(R), torch.from_numpy(t))).numpy(),
                                   atol=1e-9)
        np.testing.assert_allclose(back, v, atol=1e-9)


# --------------------------------------------------------------------------
# reg_stats: the lanes plan and the online softmax of a point's lanes


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", [1, 8, 12, 64, 384, 512, 2048])
@pytest.mark.parametrize("top_k", [None, 1, 8, 32])
def test_plan_reg_stats_fills_the_card(n, k, top_k):
    plan = fused_em.plan_reg_stats(n, k, top_k, SMS)
    gated = top_k is not None and top_k < k
    assert plan.kmax == ((9 if top_k <= 8 else 33) if gated else 0)
    assert plan.kmax == 0 or plan.kmax > top_k  # the list holds every kept logit unless ties overflow it
    # The top_k body's chunk: the rule's (timed at K = 64 and 512 on the H100), 1 where nothing gates;
    # a chunk past 1 leaves at least as many chunks as the list holds.
    assert plan.chunk == (fused_em.plan_top_k_chunk(k, top_k) if gated else 1)
    assert plan.chunk in fused_em.RS_CHUNKS and (plan.chunk == 1 or -(-k // plan.chunk) >= plan.kmax)
    assert plan.chunk == {(64, 8): 2, (512, 8): 4, (512, 32): 4, (64, 32): 1, (8, 1): 1}.get((k, top_k), plan.chunk)
    assert plan.lanes in (1, 2, 4, 8, 16, 32) and (plan.lanes == 1 or not gated)
    assert plan.lanes <= max(1, k) and fused_em.RS_THREADS % plan.lanes == 0
    assert 1 <= plan.blocks <= fused_em.RS_BLOCKS_PER_SM * SMS
    assert plan.blocks <= max(1, -(-n // plan.points_per_block()))
    if plan.lanes > 1:  # more lanes only while the points alone leave the card short of warps
        assert n * plan.lanes // 2 < fused_em.RS_MIN_WARPS_PER_SM * SMS * 32
    if not gated and n == 16_384 and k >= 8:  # the odometry bucket: >= 8 warps an SM
        assert n * plan.lanes >= fused_em.RS_MIN_WARPS_PER_SM * SMS * 32 and plan.lanes == 4
    if n >= 437_645:  # the points alone fill the card
        assert plan.lanes == 1
    assert 96 * fused_em.MAX_K + 4 * 8 * 44 <= SMEM_LIMIT  # csrc/reg_stats.cu:reg_stats_smem_bytes


def test_plan_reg_stats_refuses_what_the_kernel_does_not_take():
    for top_k in (0, -3):  # top_k outside [1, K); every top_k in it has a body
        with pytest.raises(ValueError):
            fused_em.plan_reg_stats(100, 64, top_k, SMS)
    with pytest.raises(ValueError):
        fused_em.plan_reg_stats(100, 64, fused_em.MAX_TOP_K + 1, 0)
    with pytest.raises(ValueError):
        fused_em.plan_reg_stats(0, 64, None, SMS)
    with pytest.raises(ValueError):
        fused_em.plan_reg_stats(100, fused_em.MAX_K + 1, None, SMS)


@pytest.mark.parametrize("n", SIZES + (67_583, 67_584, 131_072))
@pytest.mark.parametrize("k", [1, 8, 12, 64, 384, 512, 2048])
@pytest.mark.parametrize("top_k", [None, 1, 8, 64])
def test_plan_reg_stats_tiles_where_the_points_fill_the_card(n, k, top_k):
    """Ungated, at one lane, where one wave of RS_TILE_BLOCKS_PER_SM blocks
    an SM gives each thread RS_TILE_MIN_POINTS points or more (67,584 on
    132 SMs), the plan tiles the lanes body: RS_TILE_POINTS (4) points
    a thread, that one wave of blocks, counted as reg_stats_tiled; so the
    dragon's 437,645 and the KITTI bucket's 131,072 take it at every K, the
    odometry bucket (16,384) keeps 4 lanes of one point, and a gated plan
    keeps one point a thread. Blocks stay within RS_BLOCKS_PER_SM an SM, and
    the tables padded to a multiple of 8 rows fit the card up to MAX_K."""
    plan = fused_em.plan_reg_stats(n, k, top_k, SMS)
    gate = fused_em._top_k(top_k, k)
    wave = fused_em.RS_TILE_BLOCKS_PER_SM * SMS
    tiled = not gate and n >= fused_em.RS_TILE_MIN_POINTS * fused_em.RS_THREADS * wave
    assert fused_em.RS_TILE_POINTS == 4  # the one tiled body the library builds (csrc/reg_stats.cu)
    if tiled:
        assert plan == fused_em.RegPlan(lanes=1, blocks=wave, kmax=0, chunk=1, points=fused_em.RS_TILE_POINTS)
    else:
        assert plan.points == 1
    assert fused_em.reg_stats_body(gate, plan) == ("reg_stats_tiled" if tiled else fused_em.reg_stats_body(
        gate, dataclasses.replace(plan, points=1)))
    if not gate and n in (131_072, 437_645):
        assert tiled
    if not gate and n == 16_384 and k >= 8:
        assert (plan.lanes, plan.points) == (4, 1)
    if n == 67_583:
        assert not tiled
    assert 1 <= plan.blocks <= fused_em.RS_BLOCKS_PER_SM * SMS
    assert 96 * -(-fused_em.MAX_K // 8) * 8 + 4 * 8 * 44 <= SMEM_LIMIT  # reg_stats_smem_bytes(tiled_rows(K))


def emulate_reg_lanes(x, W, mu, A6, b3, pose, weights, outlier, lanes):
    """csrc/reg_stats.cu:reg_stats_lanes_kernel's softmax in float32: lane l
    of a point walks components l, l + L, ... once, in chunks of 8 with a
    running max (its sum and red[12] rescaled once a chunk), the lanes merge by xor
    shuffles (offsets L/2 .. 1), then the outlier; the statistics from the
    merged (m, s, red) as em_ref.reg_moments gives them from gamma."""
    R, t = pose
    y = x @ R.T + t
    logits = em_ref._logits(y, W)  # [N, K], the kernel's logit() per pair
    aux = torch.cat([mu, A6, b3], 1)  # [K, 12]
    n, k = logits.shape
    m = torch.full((n, lanes), float("-inf"))
    s = torch.zeros(n, lanes)
    red = torch.zeros(n, lanes, 12)

    def rescale(a, mm):
        return torch.where(a == mm, torch.ones_like(a), torch.exp2((a - mm) * LOG2E))

    for li in range(lanes):  # a chunk of RS_CHUNK of the lane's components, one rescale a chunk
        mine = list(range(li, k, lanes))
        for c0 in range(0, len(mine), 8):
            js = mine[c0:c0 + 8]
            mm = torch.maximum(m[:, li], logits[:, js].amax(1))
            f = rescale(m[:, li], mm)
            s[:, li], red[:, li], m[:, li] = s[:, li] * f, red[:, li] * f[:, None], mm
            for j in js:
                e = torch.exp2((logits[:, j] - mm) * LOG2E)
                s[:, li] = s[:, li] + e
                red[:, li] = red[:, li] + e[:, None] * aux[j]
    off = lanes // 2
    while off:
        idx = torch.arange(lanes) ^ off
        mo, so, ro = m[:, idx], s[:, idx], red[:, idx]
        mm = torch.maximum(m, mo)
        fa, fb = rescale(m, mm), rescale(mo, mm)
        s, red, m = s * fa + so * fb, red * fa[..., None] + ro * fb[..., None], mm
        off //= 2
    m, s, red = m[:, 0], s[:, 0], red[:, 0]
    if outlier is not None:
        mo = torch.maximum(m, torch.tensor(float(outlier)))
        f = rescale(m, mo)
        s, red, m = s * f, red * f[:, None], mo
        s = s + torch.exp2(float(outlier) * LOG2E - torch.clamp(m, min=em_ref.NEG_INF) * LOG2E)
    w = torch.ones(n) if weights is None else weights
    live = m > em_ref.NEG_INF
    ss = torch.clamp(s, min=1e-38)
    scale = torch.where(live, w / ss, torch.zeros_like(ss))
    lse = torch.where(live, w * (torch.clamp(m, min=em_ref.NEG_INF) + torch.log(ss)), torch.zeros_like(ss))
    # gamma_ij = scale_i e_ij reproduces the merged contraction exactly:
    # rebuild it as one column a point of weight scale * (red, s).
    eff = torch.zeros(n, k)
    st = em_ref.reg_moments(x, y, eff, lse, mu, A6, b3)
    nu = red[:, :3] * scale[:, None]
    M = em_ref.sym_unpack(red[:, 3:9] * scale[:, None])
    u = red[:, 9:12] * scale[:, None]
    weff = s * scale
    if outlier is not None:  # the outlier's share is not Gaussian mass
        weff = (s - torch.exp2(float(outlier) * LOG2E - torch.clamp(m, min=em_ref.NEG_INF) * LOG2E)) * scale
    P = torch.cat([x, torch.ones_like(x[:, :1])], 1)
    horn = P.T @ torch.cat([nu, weff[:, None]], 1)
    r = torch.einsum("nij,nj->ni", M, y) - u
    z = torch.zeros_like(y[:, 0])
    J = torch.cat([torch.stack([torch.stack([z, y[:, 2], -y[:, 1]], -1), torch.stack([-y[:, 2], z, y[:, 0]], -1),
                                torch.stack([y[:, 1], -y[:, 0], z], -1)], -2),
                   torch.eye(3).expand(n, 3, 3)], -1)
    A = torch.einsum("nij,nik->jk", J, torch.einsum("nij,njk->nik", M, J))
    b = -torch.einsum("nij,ni->j", J, r)
    return em_ref.RegStats(horn=horn, A=A, b=b, loglik=st.loglik)


@pytest.mark.parametrize("k,lanes", [(8, 1), (8, 4), (12, 8), (64, 4), (100, 8), (384, 8), (64, 32)])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -2.0)])
def test_reg_lanes_emulation_matches_the_plain_version(k, lanes, weighted, outlier):
    from hgmm_torch.models.se3 import so3_exp
    from hgmm_torch.ops.gaussians import precision_terms, sym_pack

    rng = np.random.default_rng(k + lanes)
    n = 400
    pts = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    w = None
    if weighted:
        w = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
        w[::4] = 0.0
    params = _mixture(k, k, dead=(1,))
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3])), torch.tensor([0.05, 0.0, -0.1]))
    got = emulate_reg_lanes(pts, W, params.mu, sym_pack(A), b, pose, w, outlier, lanes)
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, None, outlier)
    s = n / 300
    torch.testing.assert_close(got.horn, ref.horn, rtol=2e-3, atol=2e-3 * s)
    torch.testing.assert_close(got.A, ref.A, rtol=2e-3, atol=2e-2 * s)
    torch.testing.assert_close(got.b, ref.b, rtol=2e-3, atol=2e-2 * s)
    torch.testing.assert_close(got.loglik, ref.loglik, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the masked em_stats by parent chunks


@pytest.mark.parametrize("counts", [[0], [1], [31, 0, 33], [5000, 1, 0, 64], [16_384 // 64] * 64,
                                    [437_645 // 8] * 8, [0] * 63 + [2]])
def test_plan_parent_chunks_covers_every_point_once(counts):
    size, chunks = fused_em.plan_parent_chunks(counts, SMS)
    assert size % 32 == 0 and 32 <= size <= 32 * fused_em.EG_MAX_PPT
    covered, first = [], 0
    for p, c in enumerate(counts):
        mine = [ch for ch in chunks if ch[0] == p]
        assert len(mine) == -(-c // size)
        assert all(0 < cnt <= size for _, _, cnt in mine)
        for _, f, cnt in mine:
            covered.extend(range(f, f + cnt))
        assert sorted(covered[-c:] if c else []) == list(range(first, first + c))
        first += c
    assert covered == list(range(sum(counts)))  # in parent order, each point once
    assert [ch[0] for ch in chunks] == sorted(ch[0] for ch in chunks)
    if sum(counts) >= 32 * SMS * fused_em.EG_TARGET_WARPS:  # large levels: chunks enough to fill the card
        assert len(chunks) >= SMS
    with pytest.raises(ValueError):
        fused_em.plan_parent_chunks(counts, 0)


def emulate_grouped(points, W, parent, branch, weights, sms=SMS):
    """csrc/em_stats.cu:em_stats_grouped_kernel's order in plain torch: the
    live points (a parent in range, weight != 0) sorted by parent (stable),
    chunks from plan_parent_chunks, a chunk's 32 lanes each over points lane,
    lane + 32, ..., float32 statistics of the parent's children, the lanes
    summed in lane order, the chunks of a parent in chunk order in float64."""
    n, k = points.shape[0], W.shape[1]
    n_par = -(-k // branch)
    w = torch.ones(n) if weights is None else weights.float()
    key = parent.long()
    key = torch.where((key >= 0) & (key < n_par) & (w != 0), key, torch.full_like(key, n_par))
    counts = torch.bincount(key, minlength=n_par + 1)[:n_par].tolist()
    order = torch.sort(key, stable=True).indices[: sum(counts)]
    pts, w = points[order], w[order]
    size, chunks = fused_em.plan_parent_chunks(counts, sms)
    wn = em_ref.pack_table(W).wn[:, :10]
    S = torch.zeros(k, 10, dtype=torch.float64)
    ll = torch.zeros((), dtype=torch.float64)
    for p, first, cnt in chunks:
        j0, nc = p * branch, min(branch, k - p * branch)
        psi = features(pts[first:first + cnt])
        logits = psi @ wn[j0:j0 + nc].T  # [cnt, nc]
        m = logits.amax(1)
        m2 = torch.clamp(m, min=em_ref.NEG_INF) * LOG2E
        e = torch.exp2(logits * LOG2E - m2[:, None])
        s = e.sum(1)
        live = m > em_ref.NEG_INF
        ss = torch.clamp(s, min=1e-38)
        scale = torch.where(live, w[first:first + cnt] / ss, torch.zeros_like(ss))
        lse = torch.where(live, w[first:first + cnt] * (torch.clamp(m, min=em_ref.NEG_INF) + torch.log(ss)),
                          torch.zeros_like(ss))
        lane_S = torch.zeros(32, nc, 10)
        lane_ll = torch.zeros(32)
        for i in range(cnt):
            lane_S[i % 32] += (e[i] * scale[i])[:, None] * psi[i][None, :]
            lane_ll[i % 32] += lse[i]
        S[j0:j0 + nc] += lane_S.sum(0).double()
        ll += lane_ll.sum().double()
    return em_ref.EmStats(S=S.float(), loglik=ll.float())


@pytest.mark.parametrize("k", [64, 68, 512])
@pytest.mark.parametrize("n,sms", [(1, 132), (300, 132), (3000, 1), (3000, 132)])
def test_grouped_emulation_matches_the_plain_version(k, n, sms):
    """Parents -1 and out of range, zero-weight rows and a dead child: each
    adds exactly what em_ref gives it."""
    rng = np.random.default_rng(k + n)
    pts = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    w[::7] = 0.0
    parent = torch.from_numpy(rng.integers(-1, -(-k // 8) + 2, n).astype(np.int32))
    W = pack_loglik_weights(_mixture(k, k, dead=(3,)))
    got = emulate_grouped(pts, W, parent, 8, w, sms)
    ref = em_ref.em_stats_masked(pts, W, parent, 8, w)
    _check_em(got, ref, n)
    assert float(got.S[3].abs().max()) == 0.0
    # the dropped rows: em_ref gives them exactly nothing
    drop = (parent < 0) | (parent >= -(-k // 8)) | (w == 0)
    if bool(drop.any()):
        alone = em_ref.em_stats_masked(pts[drop], W, parent[drop], 8, w[drop])
        assert float(alone.S.abs().max()) == 0.0 and float(alone.loglik) == 0.0


@pytest.mark.parametrize("branch", [9, 12, 16, 33, 45, 994, 995, fused_em.MAX_K])
def test_plan_grouped_wide_fits_the_shared_memory(branch):
    """The wide body: EG_WARPS warps a block while they fit, fewer past
    that, never more than the card's shared memory; branch <= 8 (the grouped
    body's) and past MAX_K are refused."""
    plan = fused_em.plan_grouped_wide(branch)
    per_warp = 48 * branch + 4 * fused_em.EGW_WARP_FLOATS
    assert plan.smem_bytes == plan.warps * per_warp <= SMEM_LIMIT
    assert plan.warps in (1, 2, 4) and (plan.warps == fused_em.EG_WARPS or 2 * plan.smem_bytes > SMEM_LIMIT)
    if branch <= 45:  # every tree level that fits MAX_K keeps four chunks a block
        assert plan.warps == fused_em.EG_WARPS
    for bad in (fused_em.EG_BMAX, 1, fused_em.MAX_K + 1):
        with pytest.raises(ValueError):
            fused_em.plan_grouped_wide(bad)


def emulate_grouped_wide(points, W, parent, branch, weights, sms=SMS):
    """csrc/em_stats.cu:em_stats_grouped_wide_kernel's order in plain torch:
    the chunks of emulate_grouped; pass 1 over all of a chunk's children
    gives each point m log2e and its scale (the max, then the sum of exp2 in
    child order); pass 2, a group of 8 children at a time, evaluates the
    group's logits again and sums gamma psi by lane, the lanes in lane
    order, into the group's columns."""
    n, k = points.shape[0], W.shape[1]
    n_par = -(-k // branch)
    w = torch.ones(n) if weights is None else weights.float()
    key = parent.long()
    key = torch.where((key >= 0) & (key < n_par) & (w != 0), key, torch.full_like(key, n_par))
    counts = torch.bincount(key, minlength=n_par + 1)[:n_par].tolist()
    order = torch.sort(key, stable=True).indices[: sum(counts)]
    pts, w = points[order], w[order]
    size, chunks = fused_em.plan_parent_chunks(counts, sms)
    assert size <= 32 * fused_em.EG_MAX_PPT  # a point slot each in shared memory
    wn = em_ref.pack_table(W).wn[:, :10]
    S = torch.zeros(k, 10, dtype=torch.float64)
    ll = torch.zeros((), dtype=torch.float64)
    for p, first, cnt in chunks:
        j0, nc = p * branch, min(branch, k - p * branch)
        psi = features(pts[first:first + cnt])
        m = torch.full((cnt,), -math.inf)
        for c in range(nc):  # pass 1: the max, then the sum, in child order
            m = torch.maximum(m, psi @ wn[j0 + c])
        m2 = torch.clamp(m, min=em_ref.NEG_INF) * LOG2E
        s = torch.zeros(cnt)
        for c in range(nc):
            s = s + torch.exp2((psi @ wn[j0 + c]) * LOG2E - m2)
        live = m > em_ref.NEG_INF
        ss = torch.clamp(s, min=1e-38)
        scale = torch.where(live, w[first:first + cnt] / ss, torch.zeros_like(ss))
        lse = torch.where(live, w[first:first + cnt] * (torch.clamp(m, min=em_ref.NEG_INF) + torch.log(ss)),
                          torch.zeros_like(ss))
        for g0 in range(0, nc, fused_em.EG_BMAX):  # pass 2, a group of 8 children
            rows = wn[j0 + g0:j0 + min(nc, g0 + fused_em.EG_BMAX)]
            g = torch.exp2((psi @ rows.T) * LOG2E - m2[:, None]) * scale[:, None]
            lane_S = torch.zeros(32, rows.shape[0], 10)
            for i in range(cnt):
                if scale[i] != 0:
                    lane_S[i % 32] += g[i][:, None] * psi[i][None, :]
            S[j0 + g0:j0 + g0 + rows.shape[0]] += lane_S.sum(0).double()
        lane_ll = torch.zeros(32)
        for i in range(cnt):
            lane_ll[i % 32] += lse[i]
        ll += lane_ll.sum().double()
    return em_ref.EmStats(S=S.float(), loglik=ll.float())


@pytest.mark.parametrize("branch,k", [(9, 81), (12, 144), (16, 256), (16, 250), (33, 99), (16, 10)])
@pytest.mark.parametrize("n,sms", [(1, 132), (300, 132), (3000, 1)])
def test_grouped_wide_emulation_matches_the_plain_version(branch, k, n, sms):
    """The wide body's order (groups of 8 children after an all-children
    normaliser) against em_ref at branch > 8: a partial last group (12, 33),
    a parent short of children (K = 250, 10), parents -1 and past K,
    zero-weight rows, a dead child."""
    rng = np.random.default_rng(k + n + branch)
    pts = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
    w[::7] = 0.0
    parent = torch.from_numpy(rng.integers(-1, -(-k // branch) + 2, n).astype(np.int32))
    W = pack_loglik_weights(_mixture(k, k, dead=(3,)))
    got = emulate_grouped_wide(pts, W, parent, branch, w, sms)
    _check_em(got, em_ref.em_stats_masked(pts, W, parent, branch, w), n)
    assert float(got.S[3].abs().max()) == 0.0


def order_keys(x: np.ndarray) -> np.ndarray:
    """csrc/reg_stats.cu:order_key: float32 -> uint32 in the floats' order,
    NaN -> 0 (below -inf)."""
    u = x.astype(np.float32).view(np.uint32)
    key = np.where(u & 0x80000000, ~u, u | np.uint32(0x80000000)).astype(np.uint32)
    return np.where(np.isnan(x), np.uint32(0), key)


def radix_select(logits: np.ndarray, top_k: int) -> float:
    """csrc/reg_stats.cu:reg_stats_select_kernel's threshold for one row: 4
    passes of 8 bits, most significant first; each a 256-bin histogram of
    the keys with the prefix found so far, the lanes' 8 bins each from the
    top, the lane whose running count reaches `want`, its bin."""
    keys = order_keys(logits)
    prefix, mask, want = 0, 0, top_k
    for shift in (24, 16, 8, 0):
        sel = keys[(keys & np.uint32(mask)) == prefix]
        hist = np.bincount((sel >> np.uint32(shift)) & np.uint32(0xFF), minlength=256)
        cnt = hist[::-1].reshape(32, 8)  # lane l: digits 255 - 8 l down to 248 - 8 l
        incl = np.cumsum(cnt.sum(1))
        excl = incl - cnt.sum(1)
        src = int(np.flatnonzero((excl < want) & (want <= incl))[0])
        above = int(excl[src])
        for q in range(8):
            if above + cnt[src, q] >= want:
                digit = 255 - 8 * src - q
                break
            above += int(cnt[src, q])
        want -= above
        prefix |= digit << shift
        mask |= 0xFF << shift
    key = np.uint32(prefix)
    u = key & np.uint32(0x7FFFFFFF) if key & np.uint32(0x80000000) else ~key
    return float(np.array([u], dtype=np.uint32).view(np.float32)[0])


@pytest.mark.parametrize("case", ["random", "tied", "neg_inf", "floor", "k2048", "wide_range"])
def test_radix_select_finds_the_top_k_th_logit(case):
    """The select body's threshold is torch.topk's top_k-th value, bit for
    bit, with multiplicity: random rows, rows of few distinct values, -inf
    and mask-floor logits (dead components), K = 2,048, values from 1e-30 to
    1e30 of both signs; the kept set (>= threshold) is em_ref's."""
    rng = np.random.default_rng(len(case))
    k = 2048 if case == "k2048" else 300
    x = rng.standard_normal((16, k)).astype(np.float32) * 50
    if case == "tied":
        x = rng.integers(-3, 4, (16, k)).astype(np.float32)
    elif case == "neg_inf":
        x[:, ::3] = -np.inf
        x[0] = -np.inf  # a row of nothing but -inf
    elif case == "floor":
        x[:, ::2] = em_ref.NEG_INF
    elif case == "wide_range":
        x = (rng.choice([-1, 1], (16, k)) * 10.0 ** rng.uniform(-30, 30, (16, k))).astype(np.float32)
        x[:, 5] = 0.0
        x[:, 6] = -0.0
    for top_k in (33, 64, 128, k // 2, k - 1):
        for row in x:
            th = radix_select(row, top_k)
            ref = float(torch.topk(torch.from_numpy(row), top_k).values[-1])
            assert th == ref or (th == 0.0 and ref == 0.0), (top_k, th, ref)
        t = torch.from_numpy(x)
        th = torch.tensor([radix_select(row, top_k) for row in x])[:, None]
        gated = torch.where(t >= th, t, torch.full_like(t, em_ref.NEG_INF))
        assert torch.equal(em_ref.top_k_mask_logits(t, top_k), gated)


def test_radix_select_puts_nan_below_every_logit():
    """A NaN logit sorts below -inf, as the register bodies never keep one;
    only a top_k that reaches into the NaNs gets a NaN threshold."""
    row = np.array([np.nan, 1.0, -np.inf, 3.0, np.nan, 2.0] + [-5.0] * 40, np.float32)
    assert radix_select(row, 3) == 1.0 and radix_select(row, 43) == -5.0
    assert radix_select(row, 44) == -np.inf and math.isnan(radix_select(row, 45))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k,top_k", [(64, 33), (512, 64), (512, 128), (512, 511), (2048, 2047)])
def test_plan_reg_stats_select_body(n, k, top_k):
    """32 < top_k < K: a warp a point (lanes 32, no register list), at most
    RS_BLOCKS_PER_SM blocks an SM, no more blocks than the warps need; the
    shared memory fits the card up to MAX_K; the SM count is required."""
    plan = fused_em.plan_reg_stats(n, k, top_k, SMS)
    assert plan.lanes == 32 and plan.kmax == 0 and plan.points_per_block() == fused_em.RS_THREADS // 32
    assert 1 <= plan.blocks <= min(fused_em.RS_BLOCKS_PER_SM * SMS, -(-n // plan.points_per_block()))
    assert fused_em.reg_select_smem_bytes(fused_em.MAX_K) <= SMEM_LIMIT
    with pytest.raises(ValueError):
        fused_em.plan_reg_stats(n, k, top_k, 0)


# --------------------------------------------------------------------------
# reg_stats' top_k body: the chunk rule and the selection by chunk maxima


def test_plan_top_k_chunk_is_a_function_of_k_and_top_k():
    """The chunk reads K and top_k alone: every N and SM count plans the
    rule's chunk, one of RS_CHUNKS."""
    for k in (9, 12, 33, 64, 72, 100, 192, 384, 512, 513, 1024, 2048):
        for top_k in (1, 2, 7, 8, 9, 16, 31, 32):
            if top_k >= k:
                continue
            want = fused_em.plan_top_k_chunk(k, top_k)
            assert want in fused_em.RS_CHUNKS
            got = {fused_em.plan_reg_stats(n, k, top_k, sms).chunk for n in SIZES for sms in (1, 66, 132, 264)}
            assert got == {want}


def test_top_k_shared_memory_fits_the_card():
    """The top_k body's chunked weight table (an odd number of float4 a
    chunk) beside the aux table fits up to MAX_K at every chunk size, and at
    chunk 1 it is the lanes body's 96 K + 1,408 bytes."""
    for chunk in fused_em.RS_CHUNKS:
        assert fused_em.reg_top_k_smem_bytes(fused_em.MAX_K, chunk) <= SMEM_LIMIT
        assert (3 * chunk + (chunk % 2 == 0)) % 2 == 1
    for k in (9, 64, 512, 2048):
        assert fused_em.reg_top_k_smem_bytes(k, 1) == 96 * k + 4 * 8 * 44


def emulate_top_k_chunks(logits, top_k, chunk):
    """csrc/reg_stats.cu:reg_stats_top_k_kernel's gate in float32, rows side
    by side: pass 1's keys (a chunk's max, a NaN logit dropped, -0 as +0, in
    order-preserving bits with the low ones replaced by the chunk's number),
    their list of the KMAX largest (the min/max insertion in chunk order), xb
    its top_k-th key cut to the high bits, the chunks stage 2 takes (the
    entries >= xb, or every chunk when the list's last entry reaches xb), th
    the top_k-th largest of their logits (NaN as -inf), and the kept
    components, those >= th in the taken chunks. Returns (kept [N, K] bool,
    taken [N] chunks, every [N] bool)."""
    n, k = logits.shape
    kmax = 9 if top_k <= 8 else 33
    nch = -(-k // chunk)
    low = np.uint32((2 << int(math.log2(max(nch - 1, 1)))) - 1)
    lg = np.full((n, nch * chunk), -np.inf, np.float32)
    lg[:, :k] = logits
    cm = np.where(np.isnan(lg), -np.inf, lg).reshape(n, nch, chunk).max(2) + np.float32(0.0)
    u = cm.view(np.uint32)
    keys = (np.where(u >> 31, ~u, u | np.uint32(0x80000000)) & ~low) | np.arange(nch, dtype=np.uint32)
    top = np.zeros((n, kmax), np.uint32)
    for c in range(nch):
        v = keys[:, c]
        ins = v > top[:, -1]
        for e in range(kmax):
            hi, v = np.maximum(v, top[:, e]), np.minimum(v, top[:, e])
            top[:, e] = np.where(ins, hi, top[:, e])
    xb = top[:, top_k - 1] & ~low
    every = top[:, -1] >= xb
    ge = (top[:, :-1] >= xb[:, None]) & ~every[:, None]
    taken = np.where(every, nch, ge.sum(1))
    mask = np.repeat(every[:, None], nch, 1)
    rows = np.arange(n)
    for e in range(kmax - 1):
        mask[rows, (top[:, e] & low).astype(np.int64)] |= ge[:, e]
    comp = np.repeat(mask, chunk, 1)[:, :k]
    cand = np.where(comp & ~np.isnan(logits), logits, -np.inf)
    th = -np.sort(-cand, 1)[:, top_k - 1]
    return comp & (logits >= th[:, None]), taken, every


def _gate_rows(kind, k, top_k, seed, n=48):
    """[n, K] float32 logits: "random"; "tree" (groups of 8 consecutive
    siblings around a parent's value, as a tree level's leaves); "one_chunk"
    (the top_k largest consecutive from a multiple of 16); "own_chunks" (the
    top_k largest spaced as far apart as K allows, up to 16: a chunk each at
    every chunk size up to that); "straddling_ties" (the top_k-th largest
    twice, at 16 m - 1 and 16 m, in two 16-blocks with nothing larger, the
    larger ones elsewhere); "many_ties" (values of 4 levels only: the list
    overflows); "close_maxima" (every logit within about 2^-20 of 1: the
    chunk maxima differ below the keys' cut bits, and the list reaches xb)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, k)).astype(np.float32)
    if kind == "tree":
        x = (np.repeat(3.0 * rng.standard_normal((n, -(-k // 8))), 8, 1)[:, :k] + 0.3 * x).astype(np.float32)
    elif kind == "many_ties":
        x = np.floor(x).clip(-2, 1).astype(np.float32)
    elif kind == "close_maxima":
        x = (1.0 + 2.0 ** -20 * x).astype(np.float32)
    elif kind in ("one_chunk", "own_chunks", "straddling_ties"):
        big = (10.0 + rng.permutation(top_k)).astype(np.float32)
        for r in range(n):
            if kind == "one_chunk":
                start = 16 * rng.integers(0, max(1, (k - top_k) // 16 + 1))
                x[r, start:start + top_k] = big
            elif kind == "own_chunks":
                gap = min(16, 1 << int(math.log2(k // top_k)))
                x[r, gap * rng.choice(k // gap, top_k, replace=False)] = big
            else:
                m = 16 * rng.integers(1, k // 16)
                free = np.setdiff1d(np.arange(k), np.arange(m - 16, m + 16))
                x[r, rng.choice(free, top_k - 1, replace=False)] = big[1:]
                x[r, [m - 1, m]] = 9.5
    return x


@pytest.mark.parametrize("chunk", fused_em.RS_CHUNKS)
@pytest.mark.parametrize("k", [64, 384, 512])
@pytest.mark.parametrize("top_k", [1, 8, 32])
@pytest.mark.parametrize("kind", ["random", "tree", "one_chunk", "own_chunks", "straddling_ties", "many_ties",
                                  "close_maxima"])
def test_top_k_by_chunk_maxima_keeps_what_the_plain_gate_keeps(chunk, k, top_k, kind):
    """The emulated selection keeps exactly em_ref.top_k_mask_logits' logits
    (the threshold with multiplicity, ties at it kept) at every chunk size;
    a point takes top_k to KMAX - 1 chunks, or, past the list, every chunk."""
    x = _gate_rows(kind, k, top_k, seed=k + 7 * top_k + chunk)
    kept, taken, every = emulate_top_k_chunks(x, top_k, chunk)
    t = torch.from_numpy(x)
    want = (em_ref.top_k_mask_logits(t, top_k) == t).numpy()
    assert (kept == want).all()
    kmax = 9 if top_k <= 8 else 33
    assert ((top_k <= taken) & (taken <= kmax - 1) | every).all()
    if -(-k // chunk) >= kmax and kind != "straddling_ties":  # the chunks fill the list
        assert every.any() if kind in ("many_ties", "close_maxima") else not every.any()  # the overflow path
    if kind == "straddling_ties":
        assert (want.sum(1) == top_k + 1).all()  # the tie at th: both copies kept


# --------------------------------------------------------------------------
# the first em_stats body (K <= 32): a point on L lanes, a persistent grid

SMALL_KS = (1, 3, 8, 9, 12, 16, 17, 24, 32)


def _lane_slots(n, plan, threads):
    """(block, warp, lane group, grid step) of every point, as the kernels'
    loops deal them: the warp's first point base = block * (T / L) + warp *
    (32 / L), lane group g takes base + g, then + blocks * (T / L) a step
    (assign holds AS_PT consecutive steps at once)."""
    per_block = threads // plan.lanes
    ppw = 32 // plan.lanes
    stride = plan.blocks * per_block
    i = torch.arange(n)
    step, slot = i // stride, i % stride
    return slot // per_block, (slot % per_block) // ppw, slot % ppw, step


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("k", SMALL_KS)
def test_plan_em_lanes_covers_every_point_and_component(n, k):
    plan = fused_em.plan_em_lanes(n, k, SMS)
    lanes, ct = plan.lanes, fused_em.ES_CT
    assert lanes in (1, 2, 4) and lanes * ct >= k
    assert lanes == 1 or (lanes // 2) * ct < k  # the fewest lanes that hold K, whatever N
    comps = [ct * s + c for s in range(lanes) for c in range(ct)]
    assert sorted(j for j in comps if j < k) == list(range(k))
    assert 1 <= plan.blocks <= fused_em.ES_BLOCKS_PER_SM * SMS  # so the partial rows
    per_block = fused_em.ES_THREADS // lanes
    assert plan.blocks <= max(1, -(-n // per_block))  # no block without a point
    b, w, g, step = _lane_slots(n, plan, fused_em.ES_THREADS)
    assert bool((b < plan.blocks).all()) and bool((w < fused_em.ES_THREADS // 32).all())
    key = ((step * plan.blocks + b) * (fused_em.ES_THREADS // 32) + w) * (32 // lanes) + g
    assert torch.equal(torch.sort(key).values, torch.arange(n))  # every point once
    assert fused_em.table_rows(k) == k


def test_plan_em_lanes_refuses_what_the_body_does_not_take():
    for k in (0, 33, 64, 512):
        with pytest.raises(ValueError):
            fused_em.plan_em_lanes(100, k, SMS)
    with pytest.raises(ValueError):
        fused_em.plan_em_lanes(100, 8, 0)


def emulate_em_lanes(points, W, weights, outlier, sms=3):
    """csrc/em_stats.cu:em_stats_kernel's order in plain torch: points dealt
    to (block, warp, lane group) by the plan, float32 statistics a lane (lane
    s of a point's L holds components 8 s .. 8 s + 7) in point order, the
    warp's lane groups summed in order, then its warps, then the blocks in
    float64; the loglik on lane s = 0."""
    n, k = points.shape[0], W.shape[1]
    plan = fused_em.plan_em_lanes(n, k, sms)
    warps, ppw, ct = fused_em.ES_THREADS // 32, 32 // plan.lanes, fused_em.ES_CT
    wn = em_ref.pack_table(W).wn[:, :10]
    psi = features(points)
    w = torch.ones(n) if weights is None else weights.float()
    logits = psi @ wn.T
    m = logits.amax(1)
    if outlier is not None:
        m = torch.maximum(m, torch.tensor(float(outlier)))
    m2 = torch.clamp(m, min=em_ref.NEG_INF) * LOG2E
    e = torch.exp2(logits * LOG2E - m2[:, None])
    s = e.sum(1)
    if outlier is not None:
        s = s + torch.exp2(float(outlier) * LOG2E - m2)
    live = m > em_ref.NEG_INF
    ss = torch.clamp(s, min=1e-38)
    scale = torch.where(live, w / ss, torch.zeros_like(ss))
    lse = torch.where(live, w * (torch.clamp(m, min=em_ref.NEG_INF) + torch.log(ss)), torch.zeros_like(ss))
    gamma = torch.zeros(n, plan.lanes * ct)
    gamma[:, :k] = e * scale[:, None]
    b, wi, g, step = _lane_slots(n, plan, fused_em.ES_THREADS)
    acc = torch.zeros(plan.blocks, warps, ppw, plan.lanes * ct, 10)
    ll = torch.zeros(plan.blocks, warps, ppw)
    for r in range(int(step.max()) + 1 if n else 0):  # a lane adds its points in step order
        at = step == r
        acc[b[at], wi[at], g[at]] += gamma[at][:, :, None] * psi[at][:, None, :]
        ll[b[at], wi[at], g[at]] += lse[at]
    by_warp = torch.zeros(plan.blocks, warps, plan.lanes * ct, 10)
    ll_warp = torch.zeros(plan.blocks, warps)
    for gg in range(ppw):  # lane order within the warp
        by_warp += acc[:, :, gg]
        ll_warp += ll[:, :, gg]
    by_block = torch.zeros(plan.blocks, plan.lanes * ct, 10)
    ll_block = torch.zeros(plan.blocks)
    for ww in range(warps):
        by_block += by_warp[:, ww]
        ll_block += ll_warp[:, ww]
    return em_ref.EmStats(S=by_block.double().sum(0)[:k].float(), loglik=ll_block.double().sum().float())


@pytest.mark.parametrize("k", [1, 3, 8, 12, 24, 32])
@pytest.mark.parametrize("n", [1, 31, 700])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -3.0)])
def test_em_lanes_emulation_matches_the_plain_version(k, n, weighted, outlier):
    rng = np.random.default_rng(k + 3 * n)
    pts = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    w = None
    if weighted:
        w = torch.from_numpy(rng.uniform(size=n).astype(np.float32))
        w[::3] = 0.0
    W = pack_loglik_weights(_mixture(k, k, dead=(0,) if k > 1 else ()))
    got = emulate_em_lanes(pts, W, w, outlier)
    _check_em(got, em_ref.em_stats(pts, W, w, outlier), n)
    if k > 1:
        assert float(got.S[0].abs().max()) == 0.0


# --------------------------------------------------------------------------
# assign: a lane a point unmasked, a lane a child masked, the lanes merged


def previous_assign(points, W, parent, branch):
    """The assign kernel before its redesign, transcribed: one thread a
    point scans the visible components in index order with a strict '>',
    then the masked-row fallback. Logits from the table (equal inputs give
    equal bits: the tests feed values whose every product and sum is exact)."""
    n, k = points.shape[0], W.shape[1]
    logits = (features(points) @ em_ref.pack_table(W).wn[:, :10].T).tolist()
    out = []
    for i in range(n):
        j0, j1 = 0, k
        if parent is not None:
            p = int(parent[i])
            j0, j1 = (0, 0) if p < 0 or p * branch >= k else (p * branch, min(p * branch + branch, k))
        best, idx = -math.inf, -1
        for j in range(j0, j1):
            if logits[i][j] > best:
                best, idx = logits[i][j], j
        masked_idx = 0 if j0 > 0 else (j1 if j1 < k else -1)
        if masked_idx >= 0 and not best > em_ref.NEG_INF:
            idx = min(idx, masked_idx) if (best == em_ref.NEG_INF and idx >= 0) else masked_idx
        out.append(max(idx, 0))
    return torch.tensor(out, dtype=torch.int32)


def emulate_assign(points, W, parent, branch, sms=SMS):
    """csrc/assign.cu's design: lane c of a point's L scans components j0 + c,
    j0 + c + L, ... with a strict '>', then the butterfly over the L lanes
    (offsets 1, 2, 4) keeps the larger logit and, on equal ones, the lower
    index; lane 0 applies the fallback."""
    n, k = points.shape[0], W.shape[1]
    lanes = fused_em.plan_assign(n, parent is not None, sms).lanes
    logits = (features(points) @ em_ref.pack_table(W).wn[:, :10].T).tolist()
    out = []
    for i in range(n):
        j0, j1 = 0, k
        if parent is not None:
            p = int(parent[i])
            j0, j1 = (0, 0) if p < 0 or p * branch >= k else (p * branch, min(p * branch + branch, k))
        lane = []
        for c in range(lanes):
            best, idx = -math.inf, -1
            for j in range(j0 + c, j1, lanes):
                if logits[i][j] > best:
                    best, idx = logits[i][j], j
            lane.append((best, idx))
        off = 1
        while off < lanes:
            merged = []
            for c in range(lanes):
                (b, x), (ob, oi) = lane[c], lane[c ^ off]
                merged.append((ob, oi) if ob > b or (ob == b and oi < x) else (b, x))
            lane, off = merged, 2 * off
        best, idx = lane[0]
        masked_idx = 0 if j0 > 0 else (j1 if j1 < k else -1)
        if masked_idx >= 0 and not best > em_ref.NEG_INF:
            idx = min(idx, masked_idx) if (best == em_ref.NEG_INF and idx >= 0) else masked_idx
        out.append(max(idx, 0))
    return torch.tensor(out, dtype=torch.int32)


def _exact_inputs(n, k, seed, ties=False, nan=False):
    """Quarter-integer points and 1/16-integer weights: every product and sum
    of a logit is exact in float32, so any order gives the same bits. ties:
    the second half of the components repeats the first; nan: a NaN weight
    makes component 1's logit NaN for every point."""
    rng = np.random.default_rng(seed)
    pts = torch.from_numpy((rng.integers(-8, 9, (n, 3)) / 4).astype(np.float32))
    W = torch.from_numpy((rng.integers(-8, 9, (10, k)) / 16).astype(np.float32))
    if ties:
        W[:, k // 2:] = W[:, : k - k // 2]
    if nan and k > 1:
        W[0, 1] = float("nan")
    return pts, W


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("masked", [False, True])
def test_plan_assign_covers_every_point(n, masked):
    plan = fused_em.plan_assign(n, masked, SMS)
    assert plan.lanes == (fused_em.AS_MASKED_LANES if masked else 1)
    assert 1 <= plan.blocks <= fused_em.AS_BLOCKS_PER_SM * SMS
    assert plan.blocks <= max(1, -(-n * plan.lanes // (fused_em.AS_THREADS * fused_em.AS_PT)))
    b, w, g, step = _lane_slots(n, plan, fused_em.AS_THREADS)
    key = ((step * plan.blocks + b) * (fused_em.AS_THREADS // 32) + w) * (32 // plan.lanes) + g
    assert torch.equal(torch.sort(key).values, torch.arange(n))
    with pytest.raises(ValueError):
        fused_em.plan_assign(n, masked, 0)


@pytest.mark.parametrize("k,branch", [(1, None), (5, None), (8, None), (64, 8), (64, 3), (100, 8), (512, 8)])
@pytest.mark.parametrize("ties,nan", [(False, False), (True, False), (True, True)])
def test_assign_design_is_bit_equal_to_the_previous_body(k, branch, ties, nan):
    """The lane merge gives the sequential scan's index on random, tied and
    NaN logits, with parents -1 and past K; without a NaN both equal the
    plain version (exact inputs: no near-tie to flip)."""
    n = 600
    pts, W = _exact_inputs(n, k, k + 7, ties, nan)
    parent = None
    if branch is not None:
        parent = torch.from_numpy(np.random.default_rng(k).integers(-1, -(-k // branch) + 2, n).astype(np.int32))
    got = emulate_assign(pts, W, parent, branch)
    assert torch.equal(got, previous_assign(pts, W, parent, branch))
    if not nan:
        assert torch.equal(got, em_ref.assign(pts, W, parent, branch))


# --------------------------------------------------------------------------
# The step kernels' reads: em_step's plan and sum over the partial rows of
# either layout, reg_step's coalesced sum of [nb, 59] rows


@pytest.mark.parametrize("k", [1, 8, 40, 64, 512, 2048])
@pytest.mark.parametrize("span", [0, 1, 24, 25, 128, 132, 528, 5000])
def test_plan_em_step_fits_the_rows_and_the_card(k, span):
    plan = fused_em.plan_em_step(k, span, SMS)
    assert plan.blocks == k + 1 and 1 <= plan.warps <= fused_em.EMS_MAX_WARPS
    lane_rows = -(-max(span, 1) // (3 * plan.warps))  # a warp sums three rows at once
    room = fused_em.EMS_WARPS_PER_SM * SMS // (k + 1)
    if plan.warps < min(fused_em.EMS_MAX_WARPS, room):  # fewer warps only when a lane has few rows
        assert lane_rows <= fused_em.EMS_ROWS_A_LANE
    assert plan.warps == 1 or plan.warps * (k + 1) <= fused_em.EMS_WARPS_PER_SM * SMS
    if plan.warps > 1:  # one warp fewer would leave a lane more rows than the plan allows
        assert -(-max(span, 1) // (3 * (plan.warps - 1))) > fused_em.EMS_ROWS_A_LANE


def test_plan_em_step_refuses_what_the_kernel_does_not_take():
    for args in ((0, 10, SMS), (fused_em.MAX_K + 1, 10, SMS), (8, -1, SMS), (8, 10, 0)):
        with pytest.raises(ValueError):
            fused_em.plan_em_step(*args)


def test_em_step_takes_only_partial_rows():
    """The kernel reads an em_stats body's rows (EmPartials): rows made
    outside a body are checked for it where they are made (em_rows); the
    summed statistics go to the twin alone."""
    k = 8
    p = MixtureParams(torch.full((k,), 1.0 / k), torch.zeros(k, 3), torch.eye(3).repeat(k, 1, 1))
    fit = em_ref.new_fit(p, 1, torch.tensor(10.0), torch.tensor(1e-4), fused_em.table_rows(k))
    with pytest.raises(TypeError):
        fused_em.em_rows(em_ref.EmStats(torch.zeros(k, 10), torch.tensor(0.0)), fit)


def emulate_em_step_sum(parts, warps):
    """csrc/em_step.cu's sum in float64: component j's slot g = 3 w + l / 10
    (lane l < 30 of warp w) adds feature l % 10 of rows r0 + g, r0 + g + 3W,
    ... on four accumulators (twelve rows a batch, row u of a batch on u mod
    4, rows past the end as zeros), added in pairs; slot position h = g mod 3
    over the warps in order, then (h0 + h1) + h2; S rounded to float32. The
    loglik: thread t of 32 W adds rows t, t + 32 W, ..., a warp's lanes by
    xor butterflies (lane 0's value), the warps in order."""
    p = parts.partial[: parts.n_rows].double().numpy()
    k, gs = parts.k, 3 * warps
    S = np.zeros((k, 10))
    for j in range(k):
        r0, r1, col = 0, parts.n_rows, 10 * j
        if parts.branch:
            par = j // parts.branch
            r0, r1 = int(parts.parent_off[par]), int(parts.parent_off[par + 1])
            col = (j - par * parts.branch) * 10
        for f in range(10):
            slot = []
            for g in range(gs):
                a = [0.0] * 4
                for r in range(r0 + g, r1, 12 * gs):
                    for u in range(12):
                        a[u & 3] += p[r + u * gs, col + f] if r + u * gs < r1 else 0.0
                slot.append((a[0] + a[1]) + (a[2] + a[3]))
            h = [sum(slot[3 * w + pos] for w in range(warps)) for pos in range(3)]
            S[j, f] = (h[0] + h[1]) + h[2]
    threads = 32 * warps
    lane_sums = np.array([sum(p[t::threads, -1]) if t < len(p) else 0.0 for t in range(threads)])
    ll = 0.0
    for w in range(warps):
        v = lane_sums[32 * w:32 * (w + 1)].copy()
        for off in (16, 8, 4, 2, 1):
            v = v + v[np.arange(32) ^ off]
        ll += v[0]
    return torch.from_numpy(S).float(), torch.tensor(ll).float()


def _int_partials(k, branch, n_rows, seed):
    """Partial rows of small integers (every float64 sum exact, whatever its
    order), plain or grouped by parent, with a few rows past n_rows."""
    rng = np.random.default_rng(seed)
    width = 10 * (branch or k) + 1
    partial = torch.from_numpy(rng.integers(-50, 51, (n_rows + 3, width)).astype(np.float32))
    if not branch:
        return em_ref.EmPartials(partial, k, n_rows, n_rows)
    n_par = -(-k // branch)
    cuts = np.sort(rng.integers(0, n_rows + 1, n_par - 1))
    off = torch.from_numpy(np.concatenate([[0], cuts, [n_rows]]).astype(np.int32))
    return em_ref.EmPartials(partial, k, n_rows, int((off[1:] - off[:-1]).max()), branch, off)


@pytest.mark.parametrize("k,branch", [(1, None), (8, None), (40, None), (64, 8), (100, 8), (40, 3)])
@pytest.mark.parametrize("n_rows", [0, 1, 23, 24, 25, 97, 528])
def test_em_step_sum_covers_every_row_once(k, branch, n_rows):
    """The kernel's order of the sum, with the plan's warps, against the
    twin's (em_ref.sum_partials) on exact rows: bit-equal."""
    parts = _int_partials(k, branch, n_rows, k + n_rows)
    S, ll = emulate_em_step_sum(parts, fused_em.plan_em_step(k, parts.span, SMS).warps)
    ref = em_ref.sum_partials(parts)
    assert torch.equal(S, ref.S) and torch.equal(ll, ref.loglik)


def emulate_reg_step_sum(partial, blocks):
    """csrc/reg_step.cu's coalesced sum of [nb, 59] rows in float64 on a
    cluster of B blocks: pass i (944 floats from 944 i, 16 rows) belongs to
    block i mod B; thread t reads the four floats from 4 t of a pass, so float
    q of thread t is always row 16 i + (4 t + q) / 59, column (4 t + q) mod
    59. A block takes its passes sixteen a batch, the u-th of a batch on
    accumulator u mod 4 (passes past the last full one as zeros), and the
    last, ragged pass (block full mod B's) on the first, last; the
    accumulators in pairs; a block's 16 rows of a pass in order; then the B
    blocks in rank order."""
    nb = partial.shape[0]
    flat = partial.double().reshape(-1).numpy()
    full = nb // 16
    part = np.zeros((blocks, 59))
    for b in range(blocks):
        window = np.zeros((16, 59))
        for t in range(236):
            for q in range(4):
                a = [0.0] * 4
                for i0 in range(b, full, 16 * blocks):
                    for u in range(16):
                        i = i0 + blocks * u
                        a[u & 3] += flat[944 * i + 4 * t + q] if i < full else 0.0
                if full % blocks == b and 944 * full + 4 * t + q < flat.size:
                    a[0] += flat[944 * full + 4 * t + q]
                slot = 4 * t + q
                window[slot // 59, slot % 59] = (a[0] + a[1]) + (a[2] + a[3])
        for o in range(59):
            part[b, o] = sum(window[:, o])
    return torch.tensor([sum(part[:, o]) for o in range(59)], dtype=torch.float64)


@pytest.mark.parametrize("nb", [1, 15, 16, 17, 33, 127, 128, 129, 256, 257, 528, 4100])
@pytest.mark.parametrize("blocks", [1, fused_em.STEP_CLUSTER])
def test_reg_step_sum_covers_every_row_once(nb, blocks):
    """On exact rows the kernel's order gives the plain float64 sum, on one
    block or a cluster."""
    partial = torch.from_numpy(np.random.default_rng(nb).integers(-50, 51, (nb, 59)).astype(np.float32))
    assert torch.equal(emulate_reg_step_sum(partial, blocks), partial.double().sum(0))


def test_plan_reg_step_takes_a_cluster_past_one_batch_of_loads():
    batch = fused_em.STEP_PASS_ROWS * fused_em.STEP_UNROLL  # 256 rows: the odometry bucket's scan
    assert [fused_em.plan_reg_step(nb) for nb in (1, 255, batch, batch + 1, 528)] == \
        [1, 1, 1, fused_em.STEP_CLUSTER, fused_em.STEP_CLUSTER]
    assert 944 == 4 * 4 * 59 == fused_em.STEP_PASS_ROWS * 59  # csrc/reg_step.cu: a float4 a thread, 236 threads
    with pytest.raises(ValueError):
        fused_em.plan_reg_step(0)


# --------------------------------------------------------------------------
# probe_vpu: the plan, and the SASS counts of a step


def _vpu_warp_rows(n, plan):
    """The kernel's mapping (csrc/probes.cu:probe_vpu_kernel): for each block
    and warp, its first element, its chains and the block's end."""
    b = np.arange(plan.blocks, dtype=np.int64)
    lo, hi = b * n // plan.blocks, (b + 1) * n // plan.blocks
    w = np.arange(plan.threads // 32, dtype=np.int64)
    run = lo[:, None] + w[None, :] * 32 * plan.chains
    rows = np.clip(-(-(hi[:, None] - run) // 32), 0, plan.chains)
    return run, rows, hi


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("n", [1, 5, 31, 33, 4 * 32 * 16 + 3, 262_143, 262_144, 262_147, 1_000_003])
def test_plan_vpu_covers_every_element_once(n, sms):
    from hgmm_torch.ops.probes import VPU_CHAINS, VPU_THREADS, plan_vpu

    plan = plan_vpu(n, sms)
    assert plan.chains in VPU_CHAINS and plan.threads % 32 == 0 and 32 <= plan.threads <= VPU_THREADS
    assert 1 <= plan.blocks <= -(-n // 32) and -(-n // plan.blocks) <= plan.threads * plan.chains
    run, rows, hi = _vpu_warp_rows(n, plan)
    seen = np.zeros(n, dtype=np.int64)
    lane = np.arange(32)
    for j in range(plan.chains):
        idx = run[..., None] + 32 * j + lane  # [blocks, warps, 32]
        live = (rows[..., None] > j) & (idx < hi[:, None, None])
        np.add.at(seen, idx[live], 1)
    assert (seen == 1).all()
    # The elements spread over the blocks within one; each block costs the
    # SFU one warp instruction a step for each 32 of its elements, rounded up
    # once (only the block's last warp runs fewer than `chains` chains).
    sizes = np.diff(np.arange(plan.blocks + 1, dtype=np.int64) * n // plan.blocks)
    assert sizes.max() - sizes.min() <= 1
    assert (rows.sum(axis=1) == -(-sizes // 32)).all()
    if n >= 32 * sms:
        assert plan.blocks % sms == 0


def test_plan_vpu_main_shape_and_refusals():
    """vpu_microbench's 512 x 512 on 132 SMs: one block an SM of 16 warps of
    four chains, 63 warp rows an SM at most against 62.06 on average; the
    launch before this plan (1,024 blocks of 256, one element a thread) put
    8 blocks of 8 warps on 100 SMs, 64 rows."""
    from hgmm_torch.ops.probes import VpuPlan, plan_vpu

    plan = plan_vpu(512 * 512, 132)
    assert plan == VpuPlan(chains=4, blocks=132, threads=512)
    _, rows, _ = _vpu_warp_rows(512 * 512, plan)
    assert rows.sum(axis=1).max() == 63 and 512 * 512 / 32 / 132 == pytest.approx(62.06, abs=0.01)
    assert -(-1024 // 132) * 256 // 32 == 64
    for n, sms in ((0, 132), (5, 0)):
        with pytest.raises(ValueError):
            plan_vpu(n, sms)


# Before this design (the parent's exp2 body, cuobjdump --dump-sass on the
# H100's build): a loop of four steps and the one-step remainder.
VPU_SASS = """\
\t\tFunction : _ZN4hgmm16probe_vpu_kernelILb1EEEvPKfiiPf
        /*0130*/              @!P1 BRA 0x350 ;
        /*0140*/                   IADD3 R4, -R2, R7, RZ ;
        /*0150*/                   IMAD.MOV.U32 R9, RZ, RZ, R5 ;
        /*0160*/                   VIADD R4, R4, 0xfffffffc ;
        /*0170*/                   FSETP.GEU.AND P1, PT, R9, -126, PT ;
        /*0180*/              @!P1 FMUL R9, R9, 0.5 ;
        /*0190*/                   MUFU.EX2 R5, R9 ;
        /*01a0*/              @!P1 FMUL R5, R5, R5 ;
        /*01b0*/                   F2F.BF16.F32 R5, R5 ;
        /*01c0*/                   IMAD.U32 R6, R5, 0x10000, RZ ;
        /*01d0*/                   FMUL R7, R6.reuse, -0.5 ;
        /*01e0*/                   FSETP.GEU.AND P1, PT, -R6, -126, PT ;
        /*01f0*/                   FSEL R7, R7, -R6, !P1 ;
        /*0200*/                   MUFU.EX2 R6, R7 ;
        /*0210*/              @!P1 FMUL R6, R6, R6 ;
        /*0220*/                   F2F.BF16.F32 R6, R6 ;
        /*0230*/                   SHF.L.U32 R8, R6, 0x10, RZ ;
        /*0240*/                   FSETP.GEU.AND P1, PT, -R8.reuse, -126, PT ;
        /*0250*/                   FMUL R9, R8, -0.5 ;
        /*0260*/                   FSEL R9, R9, -R8, !P1 ;
        /*0270*/                   MUFU.EX2 R5, R9 ;
        /*0280*/              @!P1 FMUL R5, R5, R5 ;
        /*0290*/                   F2F.BF16.F32 R5, R5 ;
        /*02a0*/                   IMAD.U32 R8, R5, 0x10000, RZ ;
        /*02b0*/                   FMUL R7, R8.reuse, -0.5 ;
        /*02c0*/                   FSETP.GEU.AND P1, PT, -R8, -126, PT ;
        /*02d0*/                   FSEL R7, R7, -R8, !P1 ;
        /*02e0*/                   MUFU.EX2 R6, R7 ;
        /*02f0*/              @!P1 FMUL R6, R6, R6 ;
        /*0300*/                   ISETP.NE.AND P1, PT, R4, RZ, PT ;
        /*0310*/                   F2F.BF16.F32 R6, R6 ;
        /*0320*/                   SHF.L.U32 R8, R6, 0x10, RZ ;
        /*0330*/                   FADD R5, -R8, -RZ ;
        /*0340*/               @P1 BRA 0x150 ;
        /*0350*/              @!P0 BRA 0x400 ;
        /*0360*/                   FSETP.GEU.AND P0, PT, R5, -126, PT ;
        /*0370*/                   VIADD R2, R2, 0xffffffff ;
        /*0380*/              @!P0 FMUL R5, R5, 0.5 ;
        /*0390*/                   MUFU.EX2 R4, R5 ;
        /*03a0*/              @!P0 FMUL R4, R4, R4 ;
        /*03b0*/                   ISETP.NE.AND P0, PT, R2, RZ, PT ;
        /*03c0*/                   F2F.BF16.F32 R4, R4 ;
        /*03d0*/                   SHF.L.U32 R6, R4, 0x10, RZ ;
        /*03e0*/                   FADD R5, -R6, -RZ ;
        /*03f0*/               @P0 BRA 0x360 ;
        /*0400*/                   ULDC.64 UR6, c[0x0][0x220] ;
\t\tFunction : _ZN4hgmm22probe_norm_bf16_kernelILi4EEEvPK13__nv_bfloat16S3_S3_iiiiPf
        /*0300*/                   HMMA.16816.F32.BF16 R24, R152, R4, R24 ;
        /*0310*/               @P0 BRA 0x300 ;
"""


def test_sass_loops_by_opcode():
    loops = _build.parse_sass_loops(VPU_SASS, "probe_vpu")
    (name, found), = loops.items()
    assert "probe_vpu" in name and len(found) == 2
    main, rest = found
    assert main["MUFU.EX2"] == 4 and main["F2F.BF16.F32"] == 4 and main["BRA"] == 1
    assert rest == {"FSETP.GEU.AND": 1, "VIADD": 1, "FMUL": 2, "MUFU.EX2": 1, "ISETP.NE.AND": 1,
                    "F2F.BF16.F32": 1, "SHF.L.U32": 1, "FADD": 1, "BRA": 1}
    # forward branches (0x130, 0x350) close no loop; the loop runs from the
    # branch's target to the branch
    assert _build.parse_sass_loops(VPU_SASS, "norm") == {
        "_ZN4hgmm22probe_norm_bf16_kernelILi4EEEvPK13__nv_bfloat16S3_S3_iiiiPf":
            [{"HMMA.16816.F32.BF16": 1, "BRA": 1}]}
    # the tensor-core counts read the same listing as before
    assert list(_build.parse_sass(VPU_SASS, "norm").values()) == [{"HGMMA": 0, "HMMA": 1}]


def test_vpu_sass_counts_a_step_of_the_busiest_loop():
    from hgmm_torch.ops.probes import vpu_sass_counts

    counts = vpu_sass_counts(_build.parse_sass_loops(VPU_SASS, "probe_vpu").popitem()[1])
    assert counts == {"steps_a_trip": 4, "exp2": 1.0, "convert_f2f": 1.0, "convert_f2fp": 0.0,
                      "upcast": 1.0, "exp2f_fixup": 3.75, "negate": 0.25, "loop": 1.0, "other": 0.0}
    # cast mode (no exp2): steps counted by the conversions
    cast = vpu_sass_counts([{"F2FP.BF16.F32.PACK_AB": 8, "VIADD": 1, "ISETP.NE.AND": 1, "BRA": 1}])
    assert cast["steps_a_trip"] == 8 and cast["convert_f2fp"] == 1.0 and cast["loop"] == 3 / 8
    assert vpu_sass_counts([{"IADD3": 1, "BRA": 1}]) == {"steps_a_trip": 0}


@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("n", [4, 1000, 64 * 256, 64 * 8192, 512 * 2048, 512 * 2048 + 4, 4 * 132 * 256 * 4])
def test_plan_addonly_covers_every_element_once(n, sms):
    """The addonly launch (csrc/probes.cu:probe_addonly_kernel): thread i of
    the grid takes the float4s i + j G, j < ADDONLY_VEC, G the grid's
    threads; every float4 is taken once, and the grid is the fewest whole
    blocks an SM that cover them."""
    from hgmm_torch.ops.probes import ADDONLY_THREADS, ADDONLY_VEC, plan_addonly

    plan = plan_addonly(n, sms)
    assert plan.blocks >= sms and plan.blocks % sms == 0
    n4, grid = n // 4, plan.blocks * ADDONLY_THREADS
    idx = np.arange(grid)[:, None] + grid * np.arange(ADDONLY_VEC)[None, :]
    seen = np.zeros(n4, dtype=np.int64)
    np.add.at(seen, idx[idx < n4], 1)
    assert (seen == 1).all()
    # the fewest whole waves that cover the float4s
    assert (plan.blocks - sms) * ADDONLY_THREADS * ADDONLY_VEC < n4 <= grid * ADDONLY_VEC


def test_plan_addonly_main_shapes_and_refusals():
    """mxu_microbench's [512, 2048] on 132 SMs: 4 float4 a thread, two blocks
    of 256 an SM (before this plan: 1,024 blocks of one float4 a thread,
    7.76 waves); [64, 8192]: one block an SM (on an H100 two float4 a thread
    and two blocks an SM read slower: PERF.md section 6)."""
    from hgmm_torch.ops.probes import AddonlyPlan, plan_addonly

    assert plan_addonly(512 * 2048, 132) == AddonlyPlan(blocks=264)
    assert plan_addonly(64 * 8192, 132) == AddonlyPlan(blocks=132)
    for n, sms in ((0, 132), (6, 132), (8, 0)):
        with pytest.raises(ValueError):
            plan_addonly(n, sms)


# The parent's addonly loop (one float4 a thread, the eps index wrapped each
# rep) and the shape of the redesign's: four reps a trip from one LDS.128.
ADDONLY_SASS = """\
\t\tFunction : _ZN4hgmm20probe_addonly_kernelEPK6float4PKfiiiPS0_
        /*0200*/                   LDS R9, [R3] ;
        /*0210*/                   VIADD R2, R2, 0x1 ;
        /*0220*/                   FADD R10, R4, R9 ;
        /*0230*/                   FADD R11, R5, R9 ;
        /*0240*/                   FADD R12, R6, R9 ;
        /*0250*/                   FADD R13, R7, R9 ;
        /*0260*/                   ISETP.NE.AND P0, PT, R2, R8, PT ;
        /*0270*/                   FADD R16, R16, R10 ;
        /*0280*/                   FADD R17, R17, R11 ;
        /*0290*/                   FADD R18, R18, R12 ;
        /*02a0*/                   FADD R19, R19, R13 ;
        /*02b0*/                   SEL R3, R3, RZ, P0 ;
        /*02c0*/               @P0 BRA 0x200 ;
"""


def test_addonly_sass_counts_the_busiest_loop():
    from hgmm_torch.ops.probes import ADDONLY_FADDS, addonly_sass_counts

    (name, loops), = _build.parse_sass_loops(ADDONLY_SASS, "probe_addonly").items()
    counts = addonly_sass_counts(loops, vec=1)
    assert counts == {"reps_a_trip": 1, "fadd_per_element_rep": 2.0, "other_per_rep": 5.0}
    # four float4 a thread, four reps a trip from one LDS.128, inside a steps loop that also
    # holds the last reps: the innermost adding loop is counted
    inner = {"LDS.128": 1, "FADD": 128, "VIADD": 1, "ISETP.GE.AND": 1, "BRA": 1}
    outer = {op: 2 * c for op, c in inner.items()}
    counts = addonly_sass_counts([outer, inner])
    assert counts["reps_a_trip"] == 4 and counts["fadd_per_element_rep"] == ADDONLY_FADDS
    assert counts["other_per_rep"] == 1.0
    # x + eps_r kept in registers across steps: one add an element and rep
    assert addonly_sass_counts([{"LDS.128": 1, "FADD": 64, "BRA": 1}])["fadd_per_element_rep"] == 1.0
    assert addonly_sass_counts([{"IADD3": 1, "BRA": 1}]) == {"reps_a_trip": 0}
