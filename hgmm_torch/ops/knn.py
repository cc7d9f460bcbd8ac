"""Nearest-neighbour search, dispatched by device.

Counterpart of ``hgmm/ops/knn.py``. ``nearest_neighbor`` sends CPU tensors
to the plain version ``nearest_neighbor_ref`` and CUDA tensors to the
hand-written kernel ``csrc/knn.cu`` (``nearest_neighbor_cuda``), which
launches or raises; there is no other switch.

The plain version keeps the JAX twin's factored form
d2 = |q|^2 - 2 q.t + |t|^2 in query chunks, so the [Nq, Nt] distance matrix
exists one chunk at a time. The kernel computes (q - t)^2 directly, which
does not cancel for close points far from the origin; the two agree on the
chosen neighbour's distance, and on the index except at near-ties.
"""

from __future__ import annotations

import torch

from hgmm_torch.ops import _build, fused_em


def nearest_neighbor_ref(query: torch.Tensor, target: torch.Tensor, chunk: int = 2048):
    """For each query point the index and squared distance of its nearest
    target point: (idx [Nq] int32, d2 [Nq]). Ties go to the lowest index."""
    t2 = torch.sum(target * target, dim=1)
    idx, d2 = [], []
    for q in torch.split(query, chunk):
        d = torch.sum(q * q, dim=1)[:, None] - 2.0 * (q @ target.T) + t2[None, :]
        idx.append(torch.argmin(d, dim=1).to(torch.int32))
        # The factored form goes epsilon-negative for exact matches.
        d2.append(torch.clamp(torch.amin(d, dim=1), min=0.0))
    if not idx:
        return (torch.zeros(0, dtype=torch.int32, device=query.device),
                torch.zeros(0, dtype=query.dtype, device=query.device))
    return torch.cat(idx), torch.cat(d2)


def nearest_neighbor_cuda(query: torch.Tensor, target: torch.Tensor):
    """Kernel twin of nearest_neighbor_ref on CUDA tensors: query [Nq, 3],
    target [Nt, 3], both float32 and contiguous, Nt >= 1."""
    for name, t in (("query", query), ("target", target)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: expected [N, 3], got {tuple(t.shape)}")
        fused_em._check(name, t, torch.float32, tuple(t.shape))
    if query.device != target.device:
        raise ValueError(f"query on {query.device}, target on {target.device}")
    nq, nt = query.shape[0], target.shape[0]
    if nt < 1:
        raise ValueError("nearest_neighbor: empty target")
    idx = torch.empty((nq,), dtype=torch.int32, device=query.device)
    d2 = torch.empty((nq,), dtype=torch.float32, device=query.device)
    if nq == 0:
        return idx, d2
    with torch.cuda.device(query.device):
        err = _build.load().hgmm_knn(query.data_ptr(), nq, target.data_ptr(), nt,
                                     idx.data_ptr(), d2.data_ptr(), fused_em._stream(query))
    fused_em._raise_on(err, "knn")
    fused_em.LAUNCHES["knn"] += 1
    return idx, d2


def nearest_neighbor(query: torch.Tensor, target: torch.Tensor):
    """Nearest target point per query: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (idx [Nq] int32, d2 [Nq])."""
    if query.is_cuda:
        return nearest_neighbor_cuda(query, target)
    return nearest_neighbor_ref(query, target)
