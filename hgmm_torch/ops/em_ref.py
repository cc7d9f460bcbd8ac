"""Plain PyTorch versions of the EM and registration contractions.

Counterpart of ``hgmm/ops/em_ref.py``. Every CUDA kernel in
``hgmm_torch/csrc`` has its plain twin here: the twin is the path for CPU
tensors and the oracle the kernels are checked against on the card. They
materialize the [N, K] logits, so they are meant for small N or checking.

Contracts (shared with the kernels in ``hgmm_torch.ops.fused_em``):

  em_stats(points, W, point_weights, outlier_logit) -> EmStats(S [K,10], loglik)
  em_stats_masked(points, W, parent, branch, ...)   -> same, logits masked to
                                                       the parent's child block
  assign(points, W, parent, branch)                 -> [N] int32 argmax
  reg_stats(x, W, mu, A6, b3, pose, ...)            -> RegStats(horn [4,4],
                                                       A [6,6], b [6], loglik)
  model_terms(params)                               -> (W, mu, A6, b3): the
                                                       terms reg_stats reads
                                                       (csrc/reg_tables.cu
                                                       writes pack_table(W)
                                                       and [mu | A6 | b3])
  reg_step(partial, scan, it, solver, first, last, tol)
                                                    -> one step of the
                                                       registration iterate on
                                                       the scan state (in place)
  em_step(stats, fit, it, cov_reg, cov_type)
                                                    -> the M-step of an EM
                                                       sweep on the fit state:
                                                       parameters, the next
                                                       packed table, loglik
                                                       (in place); stats may
                                                       be an E-step body's
                                                       unsummed partial rows
                                                       (EmPartials)

W is the [10, K] weight matrix of gaussians.pack_loglik_weights, or the
kernels' packed table of it (``Packed``, ``pack_table``), which the E-step
functions here read back exactly.

The matmuls here run in full float32: ``hgmm_torch`` turns TF32 off for
``torch.backends.cuda.matmul`` and ``torch.backends.cudnn`` when imported.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from hgmm_torch.ops.gaussians import (
    MixtureParams,
    features,
    mstep_update,
    pack_loglik_weights,
    precision_terms,
    sym_pack,
    sym_unpack,
    unpack_suffstats,
)

NEG_INF = -1e30
# The registration scan's state vector (csrc/hgmm_kernels.cuh:SCAN_*): the
# pose reg_stats reads (R row-major, t), the iteration's start pose, the loglik
# of the iteration's first statistics, the last live loglik and delta, done,
# and the steps run with done unset (the scan's live steps).
SCAN_POSE, SCAN_START, SCAN_LL, SCAN_LL_LAST, SCAN_D_LAST, SCAN_DONE = 0, 12, 24, 25, 26, 27
SCAN_LIVE = 28
SCAN_FLOATS = 32
REG_OUT = 59  # a reg_stats row: horn 16, A 36, b 6, loglik 1


class EmStats(NamedTuple):
    S: torch.Tensor  # [K, 10] Gamma^T Psi (T2 | T1 | T0 packed)
    loglik: torch.Tensor  # [] weighted data log-likelihood


class RegStats(NamedTuple):
    """Registration statistics: horn [4,4] = P^T Q with P = [x | 1] on the
    untransformed source and Q = [gamma mu | sum gamma]; A [6,6], b [6] the
    Mahalanobis Gauss-Newton normal equations on the se(3) twist; loglik."""

    horn: torch.Tensor
    A: torch.Tensor
    b: torch.Tensor
    loglik: torch.Tensor


class Packed(NamedTuple):
    """The kernels' weight table (csrc/hgmm_kernels.cuh, ``wn``): wn [rows, 12],
    row j < k = -1/2 W[:, j] and two zero columns, rows k.. floor rows (zero
    weights, the bias at NEG_INF, so their logit is the floor for every
    point); and k."""

    wn: torch.Tensor
    k: int


def pack_table(W: torch.Tensor, rows: int | None = None) -> Packed:
    """W [>=10, K] -> Packed with `rows` rows (K when None), in W's dtype."""
    k = W.shape[1]
    wn = torch.zeros((rows or k, 12), dtype=W.dtype, device=W.device)
    wn[:k, :10] = -0.5 * W[:10].T
    wn[k:, 9] = NEG_INF
    return Packed(wn, k)


def weights(W) -> torch.Tensor:
    """W [10, K] of W or of a Packed table: -2 wn[:k, :10]^T, the same bits
    (scaling by a power of two is exact)."""
    if isinstance(W, Packed):
        return -2.0 * W.wn[:W.k, :10].T
    return W


def _logits(points: torch.Tensor, W) -> torch.Tensor:
    """[N, K] log[pi_j N(y_i)] = -1/2 psi(y) @ W."""
    return -0.5 * (features(points) @ weights(W)[:10])


def _soft(logits: torch.Tensor, outlier_logit=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Row softmax + per-row logsumexp. With an outlier logit l0 the
    normalizer is exp(l0) + sum_j exp(l_ij), so responsibility rows sum to
    < 1. Rows whose every logit is at or below the mask floor (dead rows)
    get zero responsibilities and zero log-evidence."""
    m = torch.max(logits, dim=1, keepdim=True).values
    if outlier_logit is not None:
        m = torch.clamp(m, min=float(outlier_logit))
    m_safe = torch.clamp(m, min=NEG_INF)
    e = torch.exp(logits - m_safe)
    s = torch.sum(e, dim=1, keepdim=True)
    if outlier_logit is not None:
        s = s + torch.exp(float(outlier_logit) - m_safe)
    gamma = e / torch.clamp(s, min=1e-38)
    dead = m <= NEG_INF
    gamma = torch.where(dead, torch.zeros_like(gamma), gamma)
    lse = (m_safe + torch.log(torch.clamp(s, min=1e-38)))[:, 0]
    lse = torch.where(dead[:, 0], torch.zeros_like(lse), lse)
    return gamma, lse


def _weighted(gamma, lse, point_weights):
    if point_weights is None:
        return gamma, lse
    return gamma * point_weights[:, None], lse * point_weights


def em_stats(points, W, point_weights=None, outlier_logit=None) -> EmStats:
    """Dense E-step + sufficient statistics. points [N, 3], W [10, K]."""
    gamma, lse = _soft(_logits(points, W), outlier_logit)
    gamma, lse = _weighted(gamma, lse, point_weights)
    return EmStats(S=gamma.T @ features(points), loglik=torch.sum(lse))


def child_mask_logits(logits: torch.Tensor, parent: torch.Tensor, branch: int) -> torch.Tensor:
    """Mask [N, K] logits so point i sees only components
    [parent_i * branch, (parent_i + 1) * branch)."""
    comp = torch.arange(logits.shape[1], device=logits.device)[None, :]
    ok = torch.div(comp, branch, rounding_mode="floor") == parent.long()[:, None]
    return torch.where(ok, logits, torch.full_like(logits, NEG_INF))


def em_stats_masked(points, W, parent, branch, point_weights=None) -> EmStats:
    """em_stats with each point restricted to its parent's child block."""
    gamma, lse = _soft(child_mask_logits(_logits(points, W), parent, branch))
    gamma, lse = _weighted(gamma, lse, point_weights)
    return EmStats(S=gamma.T @ features(points), loglik=torch.sum(lse))


def assign(points, W, parent=None, branch=None) -> torch.Tensor:
    """Per-point argmax component, [N] int32, optionally restricted to the
    parent's child block. Ties go to the lowest index."""
    logits = _logits(points, W)
    if parent is not None:
        if branch is None:
            raise ValueError("assign: a parent mask needs its branch")
        logits = child_mask_logits(logits, parent, branch)
    return torch.argmax(logits, dim=1).to(torch.int32)


def top_k_mask_logits(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep each row's top-k logits (ties at the threshold kept)."""
    if k >= logits.shape[1]:
        return logits
    thresh = torch.topk(logits, k, dim=1).values[:, -1:]
    return torch.where(logits >= thresh, logits, torch.full_like(logits, NEG_INF))


def top_k_near_ties(x, W, pose, top_k: int, rel: float = 2e-6) -> torch.Tensor:
    """[N] bool: points whose top_k gate float32 rounding can decide.

    A logit that differs from the point's threshold (the top_k-th largest)
    by less than `rel` times the sum of the magnitudes of its terms,
    |psi(y)| . |W_j| / 2, can fall on either side of it in two float32
    evaluations that sum in different orders (the CUDA kernel and this
    module), and so change the point's statistics by a whole component.
    Exact ties are not near-ties: equal logits are kept on both sides, and
    top_k >= K gates nothing."""
    R, t = pose
    if top_k >= W.shape[1]:
        return torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    psi = features(x @ R.T + t)
    logits = -0.5 * (psi @ W[:10])
    thresh = torch.topk(logits, top_k, dim=1).values[:, -1:]
    scale = 0.5 * (psi.abs() @ W[:10].abs())
    gap = (logits - thresh).abs()
    return ((gap > 0) & (gap < rel * scale)).any(dim=1)


def model_terms(params: MixtureParams):
    """Per-component terms every registration iteration reuses: W [10,K],
    mu [K,3], A6 [K,6] packed precisions, b3 [K,3] = Sigma^-1 mu."""
    A, b, _ = precision_terms(params)
    return pack_loglik_weights(params), params.mu, sym_pack(A), b


def reg_stats(
    x, W, mu, A6, b3, pose, point_weights=None, top_k=None, outlier_logit=None,
) -> RegStats:
    """Registration E-step statistics. x [N, 3] source points; pose (R, t)
    applied as y = x R^T + t; mu [K,3], A6 [K,6] packed precisions,
    b3 [K,3] = Sigma^-1 mu."""
    R, t = pose
    y = x @ R.T + t
    logits = _logits(y, W)
    if top_k is not None:
        logits = top_k_mask_logits(logits, top_k)
    gamma, lse = _soft(logits, outlier_logit)
    gamma, lse = _weighted(gamma, lse, point_weights)
    return reg_moments(x, y, gamma, lse, mu, A6, b3)


def reg_moments(x, y, gamma, lse, mu, A6, b3) -> RegStats:
    """The registration statistics of weighted responsibilities gamma [N, K]
    and log-evidences lse [N] of the source x at its posed y = x R^T + t."""
    # Horn moments: P^T Q, P = [x | 1], Q = [gamma @ mu | gamma @ 1].
    w = torch.sum(gamma, dim=1)
    P = torch.cat([x, torch.ones_like(x[:, :1])], dim=1)
    Q = torch.cat([gamma @ mu, w[:, None]], dim=1)
    horn = P.T @ Q

    # Mahalanobis GN on the twist xi = [omega, v]: residual r_i = M_i y_i - u_i
    # with M_i = sum_j gamma_ij Sigma_j^-1, u_i = sum_j gamma_ij b_j and
    # J_i = [-[y_i]_x | I].
    M = sym_unpack(gamma @ A6)  # [N, 3, 3]
    u = gamma @ b3
    r = torch.einsum("nij,nj->ni", M, y) - u
    zeros = torch.zeros_like(y[:, 0])
    yx, yy, yz = y[:, 0], y[:, 1], y[:, 2]
    negyhat = torch.stack(
        [torch.stack([zeros, yz, -yy], -1), torch.stack([-yz, zeros, yx], -1),
         torch.stack([yy, -yx, zeros], -1)],
        dim=-2,
    )
    eye = torch.eye(3, dtype=y.dtype, device=y.device).expand_as(negyhat)
    J = torch.cat([negyhat, eye], dim=-1)  # [N, 3, 6]
    MJ = torch.einsum("nij,njk->nik", M, J)
    A = torch.einsum("nij,nik->jk", J, MJ)
    b = -torch.einsum("nij,ni->j", J, r)
    return RegStats(horn=horn, A=A, b=b, loglik=torch.sum(lse))


def direct_logits(points: torch.Tensor, params: MixtureParams) -> torch.Tensor:
    """[N, K] log[pi_j N(y_i; mu_j, Sigma_j)] from the direct quadratic form
    (y - mu)^T Sigma^-1 (y - mu), in float64: the oracle the expanded feature
    form (features @ W, which the kernels and the functions above evaluate in
    float32) is held against at metric scale, where its terms reach ~1e6."""
    y = points.double()
    pi, mu, sigma = (a.double().to(y.device) for a in params)
    d = y[:, None, :] - mu[None]
    maha = torch.einsum("nki,kij,nkj->nk", d, torch.linalg.inv(sigma), d)
    return torch.log(pi) - 0.5 * (maha + torch.logdet(sigma) + 3.0 * math.log(2.0 * math.pi))


def em_stats_direct(points, params, point_weights=None, outlier_logit=None, parent=None,
                    branch=None) -> EmStats:
    """em_stats (em_stats_masked with a parent) from direct_logits, float64."""
    logits = direct_logits(points, params)
    if parent is not None:
        logits = child_mask_logits(logits, parent, branch)
    gamma, lse = _soft(logits, outlier_logit)
    gamma, lse = _weighted(gamma, lse, None if point_weights is None else point_weights.double())
    return EmStats(S=gamma.T @ features(points.double()), loglik=torch.sum(lse))


def reg_stats_direct(x, params, pose, point_weights=None, outlier_logit=None) -> RegStats:
    """reg_stats (no top_k) from direct_logits, float64."""
    x = x.double()
    R, t = (v.double() for v in pose)
    y = x @ R.T + t
    gamma, lse = _soft(direct_logits(y, params), outlier_logit)
    gamma, lse = _weighted(gamma, lse, None if point_weights is None else point_weights.double())
    p64 = MixtureParams(*(a.double() for a in params))
    A, b, _ = precision_terms(p64)
    return reg_moments(x, y, gamma, lse, p64.mu, sym_pack(A), b)


class RegScan(NamedTuple):
    """A registration scan's state on one device: state [SCAN_FLOATS] and
    the outputs logliks, deltas [n_iters], all in the pose's dtype (float32
    on the card). The step kernel and its twin update them in place."""

    state: torch.Tensor
    logliks: torch.Tensor
    deltas: torch.Tensor

    @property
    def pose(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(R, t) as they stand (copies)."""
        return (self.state[SCAN_POSE:SCAN_POSE + 9].reshape(3, 3).clone(),
                self.state[SCAN_POSE + 9:SCAN_POSE + 12].clone())

    @property
    def done(self) -> torch.Tensor:
        return self.state[SCAN_DONE] != 0


def new_scan(R: torch.Tensor, t: torch.Tensor, n_iters: int, dtype=None) -> RegScan:
    """The state at the start of a scan: the pose (R, t), nothing done."""
    dtype = dtype or R.dtype
    state = torch.zeros(SCAN_FLOATS, dtype=dtype, device=R.device)
    state[SCAN_POSE:SCAN_POSE + 9] = R.reshape(9).to(dtype)
    state[SCAN_POSE + 9:SCAN_POSE + 12] = t.reshape(3).to(dtype)
    z = torch.zeros(n_iters, dtype=dtype, device=R.device)
    return RegScan(state, z, z.clone())


class RegPartials(NamedTuple):
    """reg_stats' partial rows [nb, REG_OUT], not yet summed: what a
    registration step reads. cluster: the card's step kernel's blocks
    (fused_em.plan_reg_step), planned with the rows' buffer; 0 on the CPU."""

    partial: torch.Tensor
    cluster: int = 0


def pack_reg(st: RegStats) -> torch.Tensor:
    """RegStats -> one [1, 59] partial row (horn, A, b, loglik)."""
    return torch.cat([st.horn.reshape(16), st.A.reshape(36), st.b.reshape(6),
                      st.loglik.reshape(1)])[None, :]


def reg_step(partial: torch.Tensor, scan: RegScan, it: int, solver: int, first: bool, last: bool,
             tol: float) -> None:
    """Plain twin of csrc/reg_step.cu: one step of the registration iterate
    on `scan`, in place, with the torch code of models/pose.py and
    models/se3.py in the state's dtype. partial [nb, 59]: the rows of
    reg_stats, summed here (in float64). solver 0: Horn; 1: one Gauss-Newton
    step. `first` records the iteration's start pose and loglik; `last`
    writes logliks[it], deltas[it] and sets done when delta < tol. A step
    run with done unset adds one to SCAN_LIVE. Once done, nothing changes and
    `last` re-emits the last live (loglik, delta). Reads the done flag on the
    host."""
    from hgmm_torch.models.pose import apply_wls_increment, solve_horn, solve_wls_increment
    from hgmm_torch.models.se3 import Pose, se3_log

    st, lls, ds = scan
    if bool(st[SCAN_DONE] != 0):
        if last:
            lls[it] = st[SCAN_LL_LAST]
            ds[it] = st[SCAN_D_LAST]
        return
    sums = partial.double().sum(0).to(st.dtype)
    if first:
        st[SCAN_START:SCAN_START + 12] = st[SCAN_POSE:SCAN_POSE + 12].clone()
        st[SCAN_LL] = sums[58]
    R, t = scan.pose
    if solver == 0:
        new = solve_horn(sums[:16].reshape(4, 4))
    else:
        new = apply_wls_increment(Pose(R, t), solve_wls_increment(sums[16:52].reshape(6, 6), sums[52:58]))
    st[SCAN_POSE:SCAN_POSE + 9] = new.R.reshape(9)
    st[SCAN_POSE + 9:SCAN_POSE + 12] = new.t
    st[SCAN_LIVE] += 1
    if not last:
        return
    start = Pose(st[SCAN_START:SCAN_START + 9].reshape(3, 3).clone(),
                 st[SCAN_START + 9:SCAN_START + 12].clone())
    delta = torch.linalg.norm(se3_log(Pose(*scan.pose).compose(start.inverse())))
    lls[it] = st[SCAN_LL]
    ds[it] = delta
    st[SCAN_LL_LAST] = st[SCAN_LL]
    st[SCAN_D_LAST] = delta
    if bool(delta < tol):
        st[SCAN_DONE] = 1.0


# --------------------------------------------------------------------------
# the M-step of an EM sweep (csrc/em_step.cu)

COV_TYPES = ("full", "iso", "diag")  # csrc/em_step.cu's cov_type 0, 1, 2


class EmFit(NamedTuple):
    """A fit's state on one device, which em_step updates in place: the
    parameters (pi [K], mu [K, 3], sigma [K, 3, 3]), the packed table of
    them that the next sweep's E-step reads, every sweep's loglik [n_iters],
    and the data's total weight and covariance floor, 0-d tensors on the
    device (never read on the host); and the data its sweeps' E-step reads
    (hgmm_torch.ops.new_fit: on the card the body it launches)."""

    pi: torch.Tensor
    mu: torch.Tensor
    sigma: torch.Tensor
    table: Packed
    logliks: torch.Tensor
    total: torch.Tensor
    cov_floor: torch.Tensor
    data: object = None

    @property
    def params(self) -> MixtureParams:
        return MixtureParams(self.pi, self.mu, self.sigma)


def new_fit(init: MixtureParams, n_iters: int, total, cov_floor, rows: int | None = None) -> EmFit:
    """The state before the first sweep from `init` (copied), in init's dtype
    and on its device; the table has `rows` rows (K when None)."""
    pi, mu, sigma = (a.clone().contiguous() for a in init)
    like = dict(dtype=mu.dtype, device=mu.device)
    return EmFit(pi, mu, sigma, pack_table(pack_loglik_weights(init).to(**like), rows),
                 torch.zeros(n_iters, **like), torch.as_tensor(total, **like).reshape(()).clone(),
                 torch.as_tensor(cov_floor, **like).reshape(()).clone())


class EmPartials(NamedTuple):
    """An E-step body's partial rows, not yet summed: what a fit's sweep
    hands em_step (csrc/em_step.cu sums them, sum_partials here).
    branch 0, the plain rows: partial [>= n_rows, K*10 + 1], every row adds
    S row-major and the loglik (em_stats_kernel, em_stats_tiled_kernel; on
    the CPU one row, the sums: partials_of). branch > 0, the grouped rows:
    partial [>= n_rows, branch*10 + 1], rows parent_off[p] .. parent_off[p +
    1] - 1 ([ceil(K / branch) + 1] int32) add to the children p branch ..
    p branch + branch - 1 of parent p, and every row to the loglik in its
    last column (em_stats_grouped_kernel). span: the most rows one component
    sums (em_step's launch plan); warps: the card's em_step's warps a
    component (fused_em.plan_em_step of span), planned with the rows' buffer;
    0 on the CPU."""

    partial: torch.Tensor
    k: int
    n_rows: int
    span: int
    branch: int = 0
    parent_off: torch.Tensor | None = None
    warps: int = 0


def partials_of(stats: EmStats) -> EmPartials:
    """EmStats as one plain partial row: S row-major, then the loglik."""
    k = stats.S.shape[0]
    row = torch.cat([stats.S.reshape(-1), stats.loglik.reshape(1).to(stats.S.dtype)])
    return EmPartials(row[None, :], k, 1, 1)


def sum_partials(parts: EmPartials) -> EmStats:
    """The float64 sum of the partial rows, in the partials' dtype: S [K, 10]
    and the loglik (the plain twin of csrc/em_step.cu's sum, and of the
    reduce kernels of csrc/em_stats.cu)."""
    p = parts.partial[: parts.n_rows].double()
    k = parts.k
    if parts.branch == 0:
        S = p[:, : 10 * k].sum(0).reshape(k, 10)
    else:
        off = parts.parent_off.long()
        n_par = off.shape[0] - 1
        par = torch.searchsorted(off, torch.arange(parts.n_rows, device=p.device), right=True) - 1
        S = torch.zeros((n_par, parts.branch * 10), dtype=p.dtype, device=p.device)
        S = S.index_add_(0, par, p[:, : parts.branch * 10]).reshape(n_par * parts.branch, 10)[:k]
    dtype = parts.partial.dtype
    return EmStats(S.to(dtype), p[:, -1].sum().to(dtype))


def em_step(stats, fit: EmFit, it: int, cov_reg: float = 1e-6, cov_type: str = "full") -> None:
    """Plain twin of csrc/em_step.cu: the M-step from the sweep's statistics
    (gaussians.mstep_update), the next sweep's packed table of the new
    parameters (pack_loglik_weights, pack_table) and logliks[it] =
    stats.loglik, all in place on `fit`, in the fit's dtype. stats: EmStats,
    or the body's EmPartials, summed first (sum_partials)."""
    if cov_type not in COV_TYPES:
        raise ValueError(f"em_step: cov_type {cov_type!r} not in {COV_TYPES}")
    if isinstance(stats, EmPartials):
        stats = sum_partials(stats)
    T0, T1, T2 = unpack_suffstats(stats.S.to(fit.mu.dtype))
    new = mstep_update(T0, T1, T2, fit.total, cov_reg=cov_reg, cov_type=cov_type, cov_floor=fit.cov_floor)
    for buf, val in zip(fit.params, new):
        buf.copy_(val)
    fit.table.wn.copy_(pack_table(pack_loglik_weights(new), fit.table.wn.shape[0]).wn)
    fit.logliks[it] = stats.loglik
