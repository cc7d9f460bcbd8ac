"""hgmm_torch.ops against hgmm.ops on the CPU.

The port's plain versions (hgmm_torch.ops.em_ref, the CPU path of every
CUDA kernel) are held against hgmm.ops.em_ref and against hgmm.ops.fused_em
run in interpret mode, as tests/test_fused_em.py runs it. Inputs are made
with numpy from a seed and handed to both packages.

Tolerances are those of tests/test_fused_em.py: the strict ones (:55-56,
:196-198) against em_ref and the strict Pallas path, the fast ones (:42-44,
:163-166) against the fast Pallas path, whose bf16 rounding of gamma is the
error they allow for. The gaussians functions are elementwise float32 in
both packages and differ only by the rounding of transcendental functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.ops import em_ref as jref
from hgmm.ops import fused_em as jfused
from hgmm.ops import gaussians as jg
from hgmm_torch import ops
from hgmm_torch.ops import em_ref as tref
from hgmm_torch.ops import gaussians as tg

torch.set_num_threads(2)

TILE = 256
STRICT = dict(rtol=2e-3, atol=2e-4, ll_rtol=1e-4)
FAST = dict(rtol=2e-2, atol=5e-3, ll_rtol=1e-3)
REG_STRICT = dict(horn=(2e-3, 2e-3), A=(2e-3, 2e-2), b=(2e-3, 2e-2), ll_rtol=1e-4)
REG_FAST = dict(horn=(1e-2, 1e-2), A=(1e-2, 2e-1), b=(1e-2, 2e-1), ll_rtol=1e-3)
# Elementwise float32 in both packages: a few ulp of transcendental rounding.
EW = dict(rtol=1e-5, atol=1e-6)


def _mixture(seed, k, dead=()):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal((k, 3)).astype(np.float32)
    a = (0.3 * rng.standard_normal((k, 3, 3))).astype(np.float32)
    sigma = (np.einsum("kij,klj->kil", a, a) + 0.05 * np.eye(3)).astype(np.float32)
    logits = rng.standard_normal(k)
    pi = np.exp(logits) / np.exp(logits).sum()
    pi[list(dead)] = 0.0
    pi = (pi / pi.sum()).astype(np.float32)
    return pi, mu, sigma


def _points(seed, n=300):
    return np.random.default_rng(seed).standard_normal((n, 3)).astype(np.float32)


def _pose(seed):
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    th = rng.uniform(-0.5, 0.5)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    return R.astype(np.float32), rng.uniform(-0.3, 0.3, 3).astype(np.float32)


def _tp(m):
    return tg.MixtureParams(*(torch.from_numpy(a) for a in m))


def _jp(m):
    return jg.MixtureParams(*(jnp.asarray(a) for a in m))


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, dtype=np.float64)


def _close(got, ref, rtol, atol):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=atol)


# ---------------------------------------------------------------- gaussians


def test_features_and_sym_packing():
    pts = _points(0, 50)
    _close(tg.features(torch.from_numpy(pts)), jg.features(jnp.asarray(pts)), **EW)
    m = np.random.default_rng(1).standard_normal((7, 3, 3)).astype(np.float32)
    m = m + m.transpose(0, 2, 1)
    p6 = tg.sym_pack(torch.from_numpy(m))
    _close(p6, jg.sym_pack(jnp.asarray(m)), 0, 0)
    _close(tg.sym_unpack(p6), jg.sym_unpack(jnp.asarray(_np(p6).astype(np.float32))), 0, 0)
    _close(tg.sym_unpack(p6), m, 0, 0)


@pytest.mark.parametrize("dead", [(), (2, 5)])
def test_precision_terms_and_packing(dead):
    m = _mixture(2, 12, dead)
    t, j = _tp(m), _jp(m)
    inv_t, ld_t = tg._inv_and_logdet_3x3(t.sigma)
    inv_j, ld_j = jg._inv_and_logdet_3x3(j.sigma)
    _close(inv_t, inv_j, 1e-5, 1e-5)
    _close(ld_t, ld_j, 1e-5, 1e-5)
    for a, b in zip(tg.precision_terms(t), jg.precision_terms(j)):
        _close(a, b, 1e-5, 1e-4)
    _close(tg.pack_loglik_weights(t), jg.pack_loglik_weights(j), 1e-5, 1e-4)
    _close(tg.max_logit_params(t), jg.max_logit_params(j), 1e-5, 1e-5)
    if dead:  # the -1e30 log-weight floor keeps pi = 0 components finite
        c = tg.precision_terms(t)[2]
        assert bool(torch.isfinite(c).all()) and float(c[2]) > 1e29


def test_unpack_eigvalsh_psd_floor():
    rng = np.random.default_rng(3)
    S = rng.standard_normal((9, 10)).astype(np.float32)
    for a, b in zip(tg.unpack_suffstats(torch.from_numpy(S)), jg.unpack_suffstats(jnp.asarray(S))):
        _close(a, b, 0, 0)
    a = rng.standard_normal((20, 3, 3)).astype(np.float32)
    m = np.einsum("kij,klj->kil", a, a).astype(np.float32)
    m[0] = np.diag([1e-6, 1.0, 1.0])  # clustered / near-degenerate cases
    m[1] = np.eye(3)
    # acos near clustered eigenvalues: ~1e-4 ||m|| in both (gaussians.py:271).
    _close(tg.sym3_eigvalsh(torch.from_numpy(m)), jg.sym3_eigvalsh(jnp.asarray(m)), 1e-4, 1e-5)
    _close(tg.psd_floor(torch.from_numpy(m), 0.5), jg.psd_floor(jnp.asarray(m), 0.5), 1e-5, 1e-5)


@pytest.mark.parametrize("cov_type", ["full", "diag", "iso"])
def test_mstep_update(cov_type):
    rng = np.random.default_rng(4)
    n, k = 400, 8
    pts = _points(5, n)
    gam = rng.dirichlet(np.ones(k), n).astype(np.float32)
    gam[:, 3] = 0.0  # an empty component: pi -> 0, mu -> 0, sigma -> I
    S = (gam.T @ np.asarray(jg.features(jnp.asarray(pts)))).astype(np.float32)
    args_t = tg.unpack_suffstats(torch.from_numpy(S))
    args_j = jg.unpack_suffstats(jnp.asarray(S))
    got = tg.mstep_update(*args_t, float(n), cov_reg=1e-6, cov_type=cov_type, cov_floor=1e-3)
    ref = jg.mstep_update(*args_j, float(n), cov_reg=1e-6, cov_type=cov_type, cov_floor=1e-3)
    for a, b in zip(got, ref):
        _close(a, b, 1e-5, 1e-6)
    assert float(got.pi[3]) == 0.0


# ------------------------------------------------------- E-step contractions


def _jax_em(fn, *args, **kw):
    """(em_ref, fused strict, fused fast) results of one JAX E-step."""
    return (
        getattr(jref, fn)(*args, **kw),
        getattr(jfused, fn)(*args, **kw, tile=TILE, precision="strict"),
        getattr(jfused, fn)(*args, **kw, tile=TILE),
    )


def _check_em(got, refs):
    for ref, tol in zip(refs, (STRICT, STRICT, FAST)):
        _close(got.S, ref.S, tol["rtol"], tol["atol"])
        _close(got.loglik, ref.loglik, tol["ll_rtol"], 0)


@pytest.mark.parametrize("k,weighted,outlier", [(12, False, None), (64, False, None), (16, True, -3.0)])
def test_em_stats(k, weighted, outlier):
    m = _mixture(10 + k, k, dead=(1,))
    pts = _points(11, 200 if weighted else 300)
    w = np.random.default_rng(12).uniform(size=pts.shape[0]).astype(np.float32) if weighted else None
    W = jg.pack_loglik_weights(_jp(m))
    refs = _jax_em("em_stats", jnp.asarray(pts), W, None if w is None else jnp.asarray(w),
                   outlier_logit=outlier)
    tw = None if w is None else torch.from_numpy(w)
    got = tref.em_stats(torch.from_numpy(pts), tg.pack_loglik_weights(_tp(m)), tw, outlier)
    _check_em(got, refs)
    # The dispatcher's CPU path over a Prepared buffer is the same function.
    via = ops.em_stats(ops.prepare(torch.from_numpy(pts), tw), tg.pack_loglik_weights(_tp(m)),
                     outlier_logit=outlier)
    _close(via.S, got.S, 0, 0)
    _close(via.loglik, got.loglik, 0, 0)


@pytest.mark.parametrize("k", [32, 64])
def test_em_stats_masked(k):
    m = _mixture(20 + k, k)
    pts = _points(21)
    parent = np.random.default_rng(22).integers(0, k // 8, 300).astype(np.int32)
    parent[:5] = -1  # padding rows: dead, no statistics, no loglik
    W = jg.pack_loglik_weights(_jp(m))
    refs = _jax_em("em_stats_masked", jnp.asarray(pts), W, jnp.asarray(parent), 8)
    got = tref.em_stats_masked(torch.from_numpy(pts), tg.pack_loglik_weights(_tp(m)),
                               torch.from_numpy(parent), 8)
    _check_em(got, refs)
    via = ops.em_stats_masked(ops.prepare(torch.from_numpy(pts)), tg.pack_loglik_weights(_tp(m)),
                              torch.from_numpy(parent), 8)
    _close(via.S, got.S, 0, 0)


def _check_assign(got, ref, pts, W, parent=None):
    """Equal, except where the top-two logits differ by less than 1e-4."""
    got, ref = np.asarray(got.numpy()), np.asarray(ref)
    bad = np.flatnonzero(got != ref)
    if bad.size:
        logits = np.asarray(jref._logits(jnp.asarray(pts[bad]), W))
        if parent is not None:
            logits = np.asarray(jref.child_mask_logits(jnp.asarray(logits), jnp.asarray(parent[bad]), 8))
        top2 = np.sort(logits, axis=1)[:, -2:]
        assert np.all(top2[:, 1] - top2[:, 0] < 1e-4), bad


@pytest.mark.parametrize("k", [24, 512])
def test_assign(k):
    m = _mixture(30 + k, k)
    pts = _points(31)
    parent = np.random.default_rng(32).integers(0, k // 8, 300).astype(np.int32)
    W = jg.pack_loglik_weights(_jp(m))
    Wt = tg.pack_loglik_weights(_tp(m))
    got = tref.assign(torch.from_numpy(pts), Wt)
    assert got.dtype == torch.int32 and got.shape == (300,)
    for ref in (jref.assign(jnp.asarray(pts), W), jfused.assign(jnp.asarray(pts), W, tile=TILE)):
        _check_assign(got, ref, pts, W)
    got_m = tref.assign(torch.from_numpy(pts), Wt, torch.from_numpy(parent), 8)
    assert bool(((got_m // 8) == torch.from_numpy(parent)).all())
    for ref in (jref.assign(jnp.asarray(pts), W, jnp.asarray(parent), 8),
                jfused.assign(jnp.asarray(pts), W, jnp.asarray(parent), 8, tile=TILE)):
        _check_assign(got_m, ref, pts, W, parent)


def _reg_inputs(seed, k, n=300):
    m = _mixture(seed, k)
    j = _jp(m)
    A, b, _ = jg.precision_terms(j)
    jargs = (jg.pack_loglik_weights(j), j.mu, jg.sym_pack(A), b)
    t = _tp(m)
    At, bt, _ = tg.precision_terms(t)
    targs = (tg.pack_loglik_weights(t), t.mu, tg.sym_pack(At), bt)
    return _points(seed + 1, n), _pose(seed + 2), jargs, targs


def _check_reg(got, ref, tol):
    for f in ("horn", "A", "b"):
        _close(getattr(got, f), getattr(ref, f), *tol[f])
    _close(got.loglik, ref.loglik, tol["ll_rtol"], 0)


@pytest.mark.parametrize(
    "k,top_k,outlier,weighted",
    [(16, None, None, False), (16, 4, None, False), (16, None, -2.0, False),
     (8, None, None, True), (512, None, -2.0, False)],
)
def test_reg_stats(k, top_k, outlier, weighted):
    pts, (R, t), jargs, targs = _reg_inputs(40 + k, k)
    w = (np.random.default_rng(43).uniform(size=300) > 0.3).astype(np.float32) if weighted else None
    jw = None if w is None else jnp.asarray(w)
    jpose = (jnp.asarray(R), jnp.asarray(t))
    refs = (
        (jref.reg_stats(jnp.asarray(pts), *jargs, jpose, jw, top_k=top_k, outlier_logit=outlier),
         REG_STRICT),
        (jfused.reg_stats(jnp.asarray(pts), *jargs, jpose, jw, top_k=top_k, outlier_logit=outlier,
                          tile=TILE, precision="strict"), REG_STRICT),
        (jfused.reg_stats(jnp.asarray(pts), *jargs, jpose, jw, top_k=top_k, outlier_logit=outlier,
                          tile=TILE), REG_FAST),
    )
    tw = None if w is None else torch.from_numpy(w)
    tpose = (torch.from_numpy(R), torch.from_numpy(t))
    got = tref.reg_stats(torch.from_numpy(pts), *targs, tpose, tw, top_k, outlier)
    for ref, tol in refs:
        _check_reg(got, ref, tol)
    via = ops.reg_stats(ops.prepare(torch.from_numpy(pts), tw), *targs, tpose, top_k=top_k,
                        outlier_logit=outlier)
    _close(via.A, got.A, 0, 0)
    _close(via.horn, got.horn, 0, 0)


def test_top_k_mask_keeps_ties():
    logits = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, -1.0, 0.0, 2.5]], np.float32)
    got = tref.top_k_mask_logits(torch.from_numpy(logits), 2)
    ref = jref.top_k_mask_logits(jnp.asarray(logits), 2)
    _close(got, ref, 0, 0)


# ------------------------------------------------------------- the M-step


def _sweep_stats(k, weighted, seed):
    """S [K, 10] and the loglik of one E-step (numpy, float32) of a mixture
    with components 0 and k - 1 empty (no point near them: pi = 0 after the
    step), on 400 points, weighted with zero-weight rows or not."""
    rng = np.random.default_rng(seed)
    n = 400
    pts = _points(seed + 1, n)
    w = rng.uniform(size=n).astype(np.float32) if weighted else np.ones(n, np.float32)
    if weighted:
        w[::4] = 0.0
    gam = rng.dirichlet(np.ones(k), n).astype(np.float32)
    gam[:, [0, k - 1]] = 0.0
    gam *= w[:, None]
    S = (gam.T @ np.asarray(jg.features(jnp.asarray(pts)))).astype(np.float32)
    return S, np.float32(-3.5 * n), float(w.sum())


@pytest.mark.parametrize("cov_type", ["full", "iso", "diag"])
@pytest.mark.parametrize("k,weighted", [(1, False), (8, True), (64, False), (512, True)])
def test_em_step_twin_is_hgmms_mstep_and_packing(k, weighted, cov_type):
    """em_ref.em_step (the plain twin of csrc/em_step.cu) against hgmm's
    mstep_update + pack_loglik_weights on the same numpy S: parameters and
    the packed table of the new parameters (floor rows past K), loglik[it]."""
    S, ll, total = _sweep_stats(k, weighted, 30 + k)
    init = _mixture(40 + k, k)
    rows = 2 * k if k >= 64 else k  # padded as the tiled body's table is
    fit = tref.new_fit(_tp(init), 3, total, 1e-3, rows)
    tref.em_step(tref.EmStats(torch.from_numpy(S), torch.tensor(ll)), fit, 1, cov_reg=1e-6,
                 cov_type=cov_type)
    T0, T1, T2 = jg.unpack_suffstats(jnp.asarray(S))
    ref = jg.mstep_update(T0, T1, T2, total, cov_reg=1e-6, cov_type=cov_type, cov_floor=1e-3)
    for a, b in zip(fit.params, ref):
        _close(a, b, 1e-5, 1e-6)
    if k > 1:
        assert float(fit.pi[0]) == 0.0 and float(fit.pi[k - 1]) == 0.0
        _close(fit.sigma[0], np.eye(3), 0, 0)
    W = np.asarray(jg.pack_loglik_weights(ref))
    live = np.asarray(ref.pi) > 0
    _close(fit.table.wn[:k, :10][live], -0.5 * W.T[live], 1e-5, 1e-4)
    # an empty component's bias carries the -1e30 log-weight floor
    assert bool((fit.table.wn[:k, 9][~live] < -1e29).all())
    assert bool((fit.table.wn[:, 10:] == 0).all())
    assert bool((fit.table.wn[k:, :9] == 0).all()) and bool((fit.table.wn[k:, 9] == tref.NEG_INF).all())
    assert fit.logliks.tolist() == [0.0, float(ll), 0.0]
    # The table reads back as W bit for bit.
    assert torch.equal(tref.weights(fit.table), tg.pack_loglik_weights(fit.params))


def _rows_of(S, ll, layout, k):
    """Partial rows whose float64 sum is exactly S and ll: shares 1/2, 1/4,
    1/8, 1/8 of every value (scaling by a power of two is exact), plain
    ([4, K*10 + 1], every row a share of all of S) or grouped by parent
    (branch 8: 1 to 4 rows a parent, each a share of its children's rows of S
    and of the loglik); two NaN rows past the last, which no sum may read."""
    full = np.concatenate([S.reshape(-1), [ll]]).astype(np.float32)
    shares = np.array([0.5, 0.25, 0.125, 0.125], np.float32)
    if layout == "plain":
        rows = shares[:, None] * full[None, :]
        off, span = None, 4
    else:
        branch, n_par = 8, -(-k // 8)
        Sp = np.zeros((n_par * branch, 10), np.float32)
        Sp[:k] = S
        counts = [1 + p % 4 for p in range(n_par)]
        ll_share = np.float32(ll) / np.float32(n_par)  # a power of two only at n_par = 1, 2, 4, 8
        rows, off = [], [0]
        for p, c in enumerate(counts):
            part = np.concatenate([Sp[p * branch:(p + 1) * branch].reshape(-1), [ll_share]])
            sh = [1.0] if c == 1 else ([0.5, 0.5] if c == 2 else ([0.5, 0.25, 0.25] if c == 3 else shares))
            rows += [np.float32(x) * part for x in sh]
            off.append(off[-1] + c)
        rows = np.stack(rows).astype(np.float32)
        off, span = torch.tensor(off, dtype=torch.int32), max(counts)
    rows = np.concatenate([rows, np.full((2, rows.shape[1]), np.nan, np.float32)])
    n_rows = rows.shape[0] - 2
    parts = tref.EmPartials(torch.from_numpy(rows), k, n_rows, span, 0 if layout == "plain" else 8, off)
    total_ll = np.float32(rows[:n_rows, -1].astype(np.float64).sum())
    return parts, total_ll


@pytest.mark.parametrize("layout", ["plain", "grouped"])
@pytest.mark.parametrize("cov_type", ["full", "iso", "diag"])
@pytest.mark.parametrize("k,weighted", [(8, True), (8, False), (40, True), (40, False), (64, True), (64, False)])
def test_em_step_on_partial_rows_is_hgmms_mstep_and_packing(layout, k, weighted, cov_type):
    """The twin of em_step's partial-rows entry (em_ref.sum_partials, then
    em_ref.em_step) on rows of either layout whose float64 sum is the S of an
    E-step: the parameters and the packed table against hgmm's mstep_update +
    pack_loglik_weights on that S within 1e-5 (float32 against float32 in
    another order of operations, the tolerance of the test above), and
    bit-equal to the twin on S itself; the NaN rows past the last are never
    read."""
    S, ll, total = _sweep_stats(k, weighted, 60 + k)
    parts, total_ll = _rows_of(S, ll, layout, k)
    summed = tref.sum_partials(parts)
    assert torch.equal(summed.S, torch.from_numpy(S)) and float(summed.loglik) == float(total_ll)
    init = _mixture(70 + k, k)
    rows = 64 if k == 40 else k
    fit, ref_fit = (tref.new_fit(_tp(init), 2, total, 1e-3, rows) for _ in range(2))
    tref.em_step(parts, fit, 1, cov_reg=1e-6, cov_type=cov_type)
    tref.em_step(tref.EmStats(torch.from_numpy(S), torch.tensor(total_ll)), ref_fit, 1, cov_reg=1e-6,
                 cov_type=cov_type)
    for a, b in zip((*fit.params, fit.table.wn, fit.logliks), (*ref_fit.params, ref_fit.table.wn, ref_fit.logliks)):
        assert torch.equal(a, b)
    T0, T1, T2 = jg.unpack_suffstats(jnp.asarray(S))
    ref = jg.mstep_update(T0, T1, T2, total, cov_reg=1e-6, cov_type=cov_type, cov_floor=1e-3)
    for a, b in zip(fit.params, ref):
        _close(a, b, 1e-5, 1e-6)
    W = np.asarray(jg.pack_loglik_weights(ref))
    live = np.asarray(ref.pi) > 0
    _close(fit.table.wn[:k, :10][live], -0.5 * W.T[live], 1e-5, 1e-4)
    assert bool((fit.table.wn[k:, 9] == tref.NEG_INF).all()) and fit.logliks.tolist() == [0.0, float(total_ll)]


def test_em_partials_on_the_cpu_are_the_plain_statistics_as_one_row():
    """ops.em_partials on the CPU: one plain row, S then the loglik, for a
    fit on a Prepared buffer and on grouped points; summed it is the
    statistics."""
    pts = torch.from_numpy(_points(5, 500))
    m = _mixture(6, 16)
    W = tg.pack_loglik_weights(_tp(m))
    prep = ops.prepare(pts)
    parts = ops.em_partials(ops.new_fit(prep, _tp(m), 1, 500.0, 1e-3))
    assert parts.partial.shape == (1, 16 * 10 + 1) and (parts.n_rows, parts.span, parts.branch) == (1, 1, 0)
    st = ops.em_stats(prep, W)
    assert torch.equal(tref.sum_partials(parts).S, st.S) and torch.equal(tref.sum_partials(parts).loglik, st.loglik)
    parent = torch.from_numpy(np.random.default_rng(3).integers(-1, 2, 500).astype(np.int32))
    grouped = ops.em_partials(ops.new_fit(ops.group_by_parent(prep, parent, 8, 16), _tp(m), 1, 500.0, 1e-3))
    ref = ops.em_stats_masked(prep, W, parent, 8)
    assert torch.equal(tref.sum_partials(grouped).S, ref.S)
