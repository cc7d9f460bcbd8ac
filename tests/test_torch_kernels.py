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


@pytest.mark.parametrize("k", [8, 64, 384])
@pytest.mark.parametrize("weighted,outlier", [(False, None), (True, -2.0)])
def test_reg_stats(cuda, k, weighted, outlier):
    n = 20_000
    pts, w = _inputs(n, k + 6, cuda)
    w = w if weighted else None
    params = _mixture(k, k + 7, cuda, dead=(2,))
    W = pack_loglik_weights(params)
    A, b, _ = precision_terms(params)
    pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=cuda)),
            torch.tensor([0.05, 0.0, -0.1], device=cuda))
    got = fused_em.reg_stats(prepare(pts, w).pts4, W, params.mu, sym_pack(A), b, pose, None, outlier)
    ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, w, None, outlier)
    s = n / 300
    _close(got.horn, ref.horn, 2e-3, 2e-3 * s)
    _close(got.A, ref.A, 2e-3, 2e-2 * s)
    _close(got.b, ref.b, 2e-3, 2e-2 * s)
    _close(got.loglik, ref.loglik, 1e-4, 0.0)


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
    with pytest.raises(NotImplementedError):
        fused_em.reg_stats(p, W, params.mu, sym_pack(A), b, pose, top_k=4)
    with pytest.raises(ValueError):
        fused_em.em_stats(p.double(), W)
    with pytest.raises(ValueError):
        fused_em.em_stats(p[:, ::2], W)  # not contiguous
    with pytest.raises(ValueError):
        fused_em.em_stats(p, torch.zeros(10, fused_em.MAX_K + 1, device=cuda))


def test_dispatch_sends_cuda_tensors_to_the_kernels(cuda):
    from hgmm_torch import ops

    pts, _ = _inputs(1000, 13, cuda)
    W = pack_loglik_weights(_mixture(8, 14, cuda))
    fused_em.reset_launches()
    ops.em_stats(pts, W)
    ops.assign(pts, W)
    assert fused_em.LAUNCHES["em_stats"] == 1 and fused_em.LAUNCHES["assign"] == 1
