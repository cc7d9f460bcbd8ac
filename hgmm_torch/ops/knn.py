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

import dataclasses

import torch

from hgmm_torch.ops import _build

KNN_QPB = 1024  # queries a block: 128 threads x 8 queries (csrc/knn.cu:KNN_QPB)
KNN_TILE = 512  # targets a shared-memory tile (csrc/knn.cu:KNN_TILE)
KNN_RESIDENT = 4  # blocks an SM holds (csrc/knn.cu: __launch_bounds__(128, 4))
MAX_SPLITS = 32  # cap of the target splits (and of the partial rows a query merges)


@dataclasses.dataclass(frozen=True)
class KnnPlan:
    query_blocks: int  # grid.x: blocks of KNN_QPB queries
    splits: int  # grid.y: runs of `span` targets; > 1 needs the merge kernel
    span: int  # targets a split, a multiple of KNN_TILE

    @property
    def blocks(self) -> int:
        return self.query_blocks * self.splits


def _balance(blocks: int, sms: int) -> float:
    """Share of the SMs' time that does work when `blocks` equal blocks are
    dealt to `sms` SMs: the blocks resident on an SM share its lanes, so the
    SMs that get one block more set the time (on an H100 with 132 SMs 428
    blocks, 3.24 an SM, take 24 % longer than 1,712, 12.97 an SM, for the
    same search)."""
    return blocks / (sms * -(-blocks // sms))


def plan_knn(nq: int, nt: int, sms: int) -> KnnPlan:
    """The grid of one search: the fewest target splits that give every SM its
    KNN_RESIDENT blocks and load the SMs evenly (balance >= 0.98), else the
    best balance; a search too small for that takes the most even load and
    then the most blocks (up to MAX_SPLITS a query block) instead of a handful
    of busy SMs. Every split but the last holds `span` targets, and no split
    is empty."""
    if nq < 1 or nt < 1:
        raise ValueError(f"plan_knn: nq={nq}, nt={nt} must be >= 1")
    qb = -(-nq // KNN_QPB)
    tiles = -(-nt // KNN_TILE)
    # Split counts that leave no split empty, each with its tiles a split.
    spans = {}
    for s in range(1, min(MAX_SPLITS, tiles) + 1):
        span_tiles = -(-tiles // s)
        if -(-tiles // span_tiles) == s:
            spans[s] = span_tiles
    full = [s for s in spans if qb * s >= sms * KNN_RESIDENT]
    if not full:  # a small search: the most even load, then the most blocks
        s = max(spans, key=lambda c: (_balance(qb * c, sms), c))
    else:
        s = next((c for c in full if _balance(qb * c, sms) >= 0.98),
                 max(full, key=lambda c: (_balance(qb * c, sms), -c)))
    return KnnPlan(qb, s, spans[s] * KNN_TILE)


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
        _build.check_tensor(name, t, torch.float32)
    if query.device != target.device:
        raise ValueError(f"query on {query.device}, target on {target.device}")
    nq, nt = query.shape[0], target.shape[0]
    if nt < 1:
        raise ValueError("nearest_neighbor: empty target")
    idx = torch.empty((nq,), dtype=torch.int32, device=query.device)
    d2 = torch.empty((nq,), dtype=torch.float32, device=query.device)
    if nq == 0:
        return idx, d2
    plan = plan_knn(nq, nt, _build.sms(query.device))
    part_idx = part_d2 = None
    if plan.splits > 1:
        part_idx = torch.empty((plan.splits, nq), dtype=torch.int32, device=query.device)
        part_d2 = torch.empty((plan.splits, nq), dtype=torch.float32, device=query.device)
    _build.launch("knn", "hgmm_knn", query.device, query.data_ptr(), nq, target.data_ptr(), nt, plan.splits,
                  plan.span, None if part_idx is None else part_idx.data_ptr(),
                  None if part_d2 is None else part_d2.data_ptr(), idx.data_ptr(), d2.data_ptr())
    return idx, d2


def nearest_neighbor(query: torch.Tensor, target: torch.Tensor):
    """Nearest target point per query: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors. Returns (idx [Nq] int32, d2 [Nq])."""
    if query.is_cuda:
        return nearest_neighbor_cuda(query, target)
    return nearest_neighbor_ref(query, target)
