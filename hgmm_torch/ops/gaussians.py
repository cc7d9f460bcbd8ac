"""Gaussian-mixture parameter packing: the quadratic-feature formulation.

PyTorch counterpart of ``hgmm/ops/gaussians.py``. The per-point /
per-component log-density

    log [pi_j N(y; mu_j, Sigma_j)] = -1/2 [ y^T A_j y - 2 b_j . y + c_j ]

with A_j = Sigma_j^-1, b_j = A_j mu_j and
c_j = mu_j^T b_j + logdet Sigma_j + 3 log 2pi - 2 log pi_j is linear in the
degree-<=2 monomial features psi(y) = [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1],
so the logits are -1/2 psi(y) . W[:, j] for W [10, K] packed from the
parameters, and the M-step sufficient statistics are S = Gamma^T Psi [K, 10]
(T2 in columns 0:6, T1 in 6:9, T0 in 9).

Everything is float32 and follows the device of its inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

PHI_DIM = 10  # [x^2, y^2, z^2, xy, xz, yz, x, y, z, 1]
LOG_2PI = 1.8378770664093453

# Index maps between the 6 packed symmetric entries and [3, 3] matrices.
_SYM_I = (0, 1, 2, 0, 0, 1)
_SYM_J = (0, 1, 2, 1, 2, 2)


class MixtureParams(NamedTuple):
    """Plain GMM parameters: K components in R^3."""

    pi: torch.Tensor  # [K] mixture weights
    mu: torch.Tensor  # [K, 3] means
    sigma: torch.Tensor  # [K, 3, 3] covariances (SPD)

    @property
    def k(self) -> int:
        return self.pi.shape[0]


def features(points: torch.Tensor) -> torch.Tensor:
    """psi(y): points [N, 3] -> [N, 10]."""
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    return torch.stack(
        [x * x, y * y, z * z, x * y, x * z, y * z, x, y, z, torch.ones_like(x)],
        dim=-1,
    )


def sym_pack(m: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] symmetric -> [..., 6] packed [m00, m11, m22, m01, m02, m12].
    Basic indexing only: an index tensor from the host would be copied to the
    card, a host sync on every call."""
    return torch.stack([m[..., i, j] for i, j in zip(_SYM_I, _SYM_J)], dim=-1)


def sym_unpack(p: torch.Tensor) -> torch.Tensor:
    """[..., 6] packed -> [..., 3, 3] symmetric."""
    a, d, f, b, c, e = p.unbind(-1)
    return torch.stack(
        [torch.stack([a, b, c], -1), torch.stack([b, d, e], -1),
         torch.stack([c, e, f], -1)],
        dim=-2,
    )


def _inv_and_logdet_3x3(sigma: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cholesky-based inverse and logdet of batched SPD [K, 3, 3].

    The explicit 3x3 recurrence (no LAPACK): cofactor expansion cancels
    catastrophically in float32 for covariances at the regularization floor,
    so Sigma = L L^T is factored, L inverted, and Sigma^-1 = L^-T L^-1.
    """
    tiny = 1e-30
    a, b, c = sigma[..., 0, 0], sigma[..., 1, 0], sigma[..., 2, 0]
    d, e = sigma[..., 1, 1], sigma[..., 2, 1]
    f = sigma[..., 2, 2]
    l11 = torch.sqrt(torch.clamp(a, min=tiny))
    l21 = b / l11
    l31 = c / l11
    l22 = torch.sqrt(torch.clamp(d - l21 * l21, min=tiny))
    l32 = (e - l21 * l31) / l22
    l33 = torch.sqrt(torch.clamp(f - l31 * l31 - l32 * l32, min=tiny))
    m11 = 1.0 / l11
    m22 = 1.0 / l22
    m33 = 1.0 / l33
    m21 = -l21 * m11 * m22
    m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33
    m32 = -l32 * m22 * m33
    i00 = m11 * m11 + m21 * m21 + m31 * m31
    i01 = m21 * m22 + m31 * m32
    i02 = m31 * m33
    i11 = m22 * m22 + m32 * m32
    i12 = m32 * m33
    i22 = m33 * m33
    inv = torch.stack(
        [torch.stack([i00, i01, i02], -1), torch.stack([i01, i11, i12], -1),
         torch.stack([i02, i12, i22], -1)],
        dim=-2,
    )
    logdet = 2.0 * (torch.log(l11) + torch.log(l22) + torch.log(l33))
    return inv, logdet


def _log_pi(pi: torch.Tensor) -> torch.Tensor:
    # Finite floor (not -inf) for pi == 0: keeps 0 * inf NaNs out of the
    # feature contraction while pushing dead components below the mask floor.
    return torch.where(
        pi > 0, torch.log(torch.clamp(pi, min=1e-38)), torch.full_like(pi, -1e30)
    )


def precision_terms(
    params: MixtureParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-component (A [K,3,3], b = A mu [K,3], c [K]) of the quadratic form.

    Elementwise contractions, as in the JAX package, so no matmul precision
    setting can touch them.
    """
    A, logdet = _inv_and_logdet_3x3(params.sigma)
    b = torch.sum(A * params.mu[:, None, :], dim=-1)
    c = torch.sum(params.mu * b, dim=-1) + logdet + 3.0 * LOG_2PI - 2.0 * _log_pi(params.pi)
    return A, b, c


def pack_loglik_weights(params: MixtureParams) -> torch.Tensor:
    """W [10, K] with log[pi_j N(y; mu_j, Sigma_j)] = -1/2 psi(y) . W[:, j].

    Cross-term rows carry the factor 2 (features are pure monomials)."""
    A, b, c = precision_terms(params)
    a6 = sym_pack(A)
    return torch.stack(
        [a6[:, 0], a6[:, 1], a6[:, 2], 2.0 * a6[:, 3], 2.0 * a6[:, 4],
         2.0 * a6[:, 5], -2.0 * b[:, 0], -2.0 * b[:, 1], -2.0 * b[:, 2], c],
        dim=0,
    )


def max_logit_params(params: MixtureParams) -> torch.Tensor:
    """Global upper bound of log[pi_j N(y)] over y and j:
    max_j log pi_j - 1/2 logdet Sigma_j - 3/2 log 2pi (floored at -1e8).

    The port's kernels take an exact per-point max and need no such shift;
    this is kept for parity with the JAX package's API."""
    _, logdet = _inv_and_logdet_3x3(params.sigma)
    g = _log_pi(params.pi) - 0.5 * logdet - 1.5 * LOG_2PI
    return torch.clamp(torch.max(g) + 1e-3, min=-1e8)


def unpack_suffstats(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """S [K, 10] -> (T0 [K], T1 [K, 3], T2 [K, 3, 3])."""
    return S[:, 9], S[:, 6:9], sym_unpack(S[:, 0:6])


def sym3_eigvalsh(m: torch.Tensor) -> torch.Tensor:
    """Analytic ascending eigenvalues of symmetric [..., 3, 3] matrices
    (Smith's trigonometric method): elementwise and NaN-free for finite input.
    """
    q = (m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]) / 3.0
    a, d, f = m[..., 0, 0] - q, m[..., 1, 1] - q, m[..., 2, 2] - q
    b, c, e = m[..., 0, 1], m[..., 0, 2], m[..., 1, 2]
    p2 = a * a + d * d + f * f + 2.0 * (b * b + c * c + e * e)
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    # Normalize before the determinant: p**3 underflows for near-isotropic m.
    safe_p = torch.clamp(p, min=1e-30)
    an, dn, fn = a / safe_p, d / safe_p, f / safe_p
    bn, cn, en = b / safe_p, c / safe_p, e / safe_p
    det = an * (dn * fn - en * en) - bn * (bn * fn - en * cn) + cn * (bn * en - dn * cn)
    r = torch.clamp(0.5 * det, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0943951023931953)  # + 2 pi / 3
    lmid = 3.0 * q - lmax - lmin
    return torch.stack([lmin, lmid, lmax], dim=-1)


def psd_floor(sigma: torch.Tensor, floor) -> torch.Tensor:
    """Floor the eigenvalues of symmetric [K, 3, 3] matrices at >= floor by
    adding the eigenvalue deficit times I (eigenvectors preserved)."""
    sym = 0.5 * (sigma + sigma.transpose(-1, -2))
    lmin = sym3_eigvalsh(sym)[..., 0]
    # sym3_eigvalsh may overestimate lmin by ~1e-4 ||m||; subtract that
    # allowance so the floor is a guarantee.
    norm_bound = torch.abs(sym[..., 0, 0] + sym[..., 1, 1] + sym[..., 2, 2]) + torch.sqrt(
        torch.clamp(torch.sum(sym * sym, dim=(-2, -1)), min=0.0)
    )
    lmin = lmin - 2e-4 * norm_bound
    bump = torch.clamp(floor - lmin, min=0.0)
    return sym + bump[..., None, None] * torch.eye(3, dtype=sym.dtype, device=sym.device)


def mstep_update(
    T0: torch.Tensor,
    T1: torch.Tensor,
    T2: torch.Tensor,
    total_weight,
    cov_reg: float = 1e-6,
    cov_type: str = "full",
    min_weight: float = 1e-6,
    cov_floor=0.0,
) -> MixtureParams:
    """Closed-form M-step: pi = T0 / total, mu = T1 / T0,
    Sigma = T2 / T0 - mu mu^T + cov_reg I, eigenvalues floored at
    max(cov_floor, cov_reg). Components holding less than max(min_weight,
    1e-6 * total) get pi = 0, mu = 0 and Sigma = I (inert everywhere)."""
    eye = torch.eye(3, dtype=T1.dtype, device=T1.device)
    total_weight = torch.as_tensor(total_weight, dtype=T1.dtype, device=T1.device)
    floor = torch.clamp(1e-6 * total_weight, min=min_weight)
    empty = T0 <= floor
    safe_T0 = torch.maximum(T0, floor)
    pi = T0 / total_weight
    mu = torch.where(empty[:, None], torch.zeros_like(T1), T1 / safe_T0[:, None])
    sigma = T2 / safe_T0[:, None, None] - mu[:, :, None] * mu[:, None, :]
    if cov_type == "iso":
        var = torch.diagonal(sigma, dim1=-2, dim2=-1).sum(-1) / 3.0
        sigma = var[:, None, None] * eye
    elif cov_type == "diag":
        sigma = torch.diagonal(sigma, dim1=-2, dim2=-1)[..., None] * eye
    sigma = sigma + cov_reg * eye
    sigma = torch.where(empty[:, None, None], eye, sigma)
    floor_eig = torch.clamp(
        torch.as_tensor(cov_floor, dtype=T1.dtype, device=T1.device),
        min=max(cov_reg, 1e-9),
    )
    sigma = psd_floor(sigma, floor_eig)
    pi = torch.where(empty, torch.zeros_like(pi), pi)
    return MixtureParams(pi=pi, mu=mu, sigma=sigma)
