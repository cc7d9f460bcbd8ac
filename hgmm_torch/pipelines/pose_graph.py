"""Pose-graph optimization: Gauss-Newton on SE(3) with exact autodiff
Jacobians, dense on one device or by a segment-wise Schur complement over a
mesh for odometry chains (``refine_chain_sharded``).

Counterpart of ``hgmm/pipelines/pose_graph.py``. Parametrization: right-perturbation T_i <- T_i * Exp(xi_i). Edge
residual r_e = Log(Z_e^-1 * T_i^-1 * T_j) in R^6; the per-edge 6x6 Jacobians
come from ``torch.func.jacfwd`` of the residual at xi = 0, batched over edges
with ``torch.func.vmap`` — exact, with no hand-derived adjoints.
"""

from __future__ import annotations

import threading
import warnings
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from hgmm_torch.models.se3 import Pose, se3_exp, se3_log
from hgmm_torch.parallel.mesh import per_rank
from hgmm_torch.utils.profiling import count, span


class EdgeList(NamedTuple):
    """Batch of relative-pose constraints i -> j."""

    i: torch.Tensor  # [E] int64 source node
    j: torch.Tensor  # [E] int64 target node
    R: torch.Tensor  # [E, 3, 3] measured relative rotation (frame i -> j)
    t: torch.Tensor  # [E, 3] measured relative translation
    weight: torch.Tensor  # [E] scalar information weight


def odometry_chain_edges(rel_poses) -> EdgeList:
    """Edges (k, k+1) from a list of frame-to-frame relative poses
    (Z_k = pose of frame k+1 expressed in frame k)."""
    e = len(rel_poses)
    R = torch.stack([p.R for p in rel_poses])
    return EdgeList(
        i=torch.arange(e, device=R.device),
        j=torch.arange(1, e + 1, device=R.device),
        R=R,
        t=torch.stack([p.t for p in rel_poses]),
        weight=torch.ones(e, dtype=R.dtype, device=R.device),
    )


def concat_edge_lists(a: EdgeList, b: EdgeList) -> EdgeList:
    return EdgeList(*(torch.cat([x, y.to(x.device)]) for x, y in zip(a, b)))


def _edge_residual(xi_i, xi_j, Ti_R, Ti_t, Tj_R, Tj_t, Z_R, Z_t):
    Ti = Pose(Ti_R, Ti_t).compose(se3_exp(xi_i))
    Tj = Pose(Tj_R, Tj_t).compose(se3_exp(xi_j))
    return se3_log(Pose(Z_R, Z_t).inverse().compose(Ti.inverse().compose(Tj)))


def _res_and_jac(TiR, Tit, TjR, Tjt, ZR, Zt):
    zero = torch.zeros(6, dtype=TiR.dtype, device=TiR.device)
    args = (zero, zero, TiR, Tit, TjR, Tjt, ZR, Zt)
    return (_edge_residual(*args), jacfwd(_edge_residual, argnums=0)(*args),
            jacfwd(_edge_residual, argnums=1)(*args))


_batched = vmap(_res_and_jac)
# torch.func's forward-mode levels are process-wide: the ranks of an
# EmulatedMesh (threads) take their Jacobians one at a time.
_FUNC_LOCK = threading.Lock()


def _res_and_jacs(*edges):
    """[E] poses and measurements -> residuals [E, 6], Jacobians [E, 6, 6] (x2)."""
    with _FUNC_LOCK:
        return _batched(*edges)


class PoseGraphResult(NamedTuple):
    R: torch.Tensor  # [M, 3, 3]
    t: torch.Tensor  # [M, 3]
    residual_history: torch.Tensor  # [n_iters] sum of squared residuals

    def poses(self) -> list[Pose]:
        return [Pose(self.R[m], self.t[m]) for m in range(self.R.shape[0])]


def _robust_weight(weight, res, robust_delta):
    """IRLS Geman-McClure reweighting: the edge weight is scaled by
    (delta^2 / (delta^2 + ||r||^2))^2 — ~1 for residuals below delta,
    ~(delta/||r||)^4 above it. The kernel is redescending: a false loop
    closure is switched off rather than merely bounded. None = pure GN."""
    if robust_delta is None:
        return weight
    r2 = torch.sum(res * res, dim=1)
    d2 = robust_delta * robust_delta
    return weight * (d2 / (d2 + r2)) ** 2


def refine_pose_graph(
    R: torch.Tensor,  # [M, 3, 3] initial absolute poses
    t: torch.Tensor,  # [M, 3]
    edges: EdgeList,
    n_iters: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e8,
    robust_delta: float | None = None,
) -> PoseGraphResult:
    """Dense Gauss-Newton (one device; M up to a few hundred). Node 0 is
    gauge-fixed by a strong prior. robust_delta: see _robust_weight.

    Edge endpoints are validated first: an out-of-range index raises
    ValueError (the JAX package's eager check; a gather on the card would
    fault instead). Traced as ``hgmm_torch.pg.refine``, with the counters
    ``pg.iters`` and ``pg.edges``."""
    with span("hgmm_torch.pg.refine"):
        count("pg.iters", n_iters)
        count("pg.edges", int(edges.i.numel()))
        return _refine_dense(R, t, edges, n_iters, damping, gauge_weight, robust_delta)


def _refine_dense(R, t, edges: EdgeList, n_iters: int, damping: float, gauge_weight: float,
                  robust_delta: float | None) -> PoseGraphResult:
    m = int(R.shape[0])
    idx = torch.cat([edges.i, edges.j]).cpu()
    bad = idx[(idx < 0) | (idx >= m)]
    if bad.numel():
        raise ValueError(f"edge endpoints {sorted(set(bad.tolist()))} out of range for {m} nodes")
    dev, dtype = R.device, R.dtype
    ei, ej = edges.i.to(dev).long(), edges.j.to(dev).long()
    eR, et, ew = (x.to(device=dev, dtype=dtype) for x in (edges.R, edges.t, edges.weight))
    # Flat [M*M] block index of each edge's four Hessian blocks.
    blocks = torch.cat([ei * m + ei, ej * m + ej, ei * m + ej, ej * m + ei])
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    costs = []
    for _ in range(n_iters):
        res, Ji, Jj = _res_and_jacs(R[ei], t[ei], R[ej], t[ej], eR, et)
        w_r = _robust_weight(ew, res, robust_delta)
        w = w_r[:, None, None]
        H = torch.zeros((m * m, 6, 6), dtype=dtype, device=dev)
        H.index_add_(0, blocks, torch.cat([
            w * torch.einsum("eai,eaj->eij", Ji, Ji), w * torch.einsum("eai,eaj->eij", Jj, Jj),
            w * torch.einsum("eai,eaj->eij", Ji, Jj), w * torch.einsum("eai,eaj->eij", Jj, Ji),
        ]))
        g = torch.zeros((m, 6), dtype=dtype, device=dev)
        g.index_add_(0, torch.cat([ei, ej]), torch.cat([
            w_r[:, None] * torch.einsum("eai,ea->ei", Ji, res),
            w_r[:, None] * torch.einsum("eai,ea->ei", Jj, res),
        ]))
        # Gauge prior on node 0 + Levenberg damping.
        H[0] += gauge_weight * eye6
        Hd = H.view(m, m, 6, 6).transpose(1, 2).reshape(6 * m, 6 * m)
        Hd = Hd + damping * torch.eye(6 * m, dtype=dtype, device=dev)
        delta = -torch.linalg.solve(Hd, g.reshape(6 * m)).reshape(m, 6)
        upd = vmap(se3_exp)(delta)
        t = t + torch.einsum("mij,mj->mi", R, upd.t)
        R = torch.einsum("mij,mjk->mik", R, upd.R)
        costs.append(torch.sum(w_r * torch.sum(res * res, dim=1)))
    return PoseGraphResult(R, t, torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev))


# ---------------------------------------------------------------------------
# The distributed Schur complement for odometry chains


def _can_shard_chain(m: int, s: int) -> bool:
    """Whether an m-node chain shards over s ranks: shared by
    refine_chain_sharded's fallback and _chain_segmentation's None return."""
    return m - 1 >= s


def _chain_segmentation(m: int, s: int, closure_nodes):
    """Host-side static segmentation of an M-node chain over S ranks, with a
    retained-node set: the segment boundaries and every closure endpoint. A
    closure endpoint interior to a segment stays there and is left out of
    that segment's Schur elimination; it joins the global reduced system
    beside the boundaries.

    Returns None only when the chain is too short to shard (m-1 < s), else
    a dict of numpy index arrays:
      bounds [S+1]      global node ids of the segment boundaries (an even
                        split of the chain, not driven by the closures)
      node_idx [S, L+1] slot -> global node id per segment (unused slots
                        alias the left boundary, so pose gathers stay valid)
      pi, pj [S, L]     local slot endpoints of each edge slot
      eidx [S, L]       global chain-edge id of each edge slot (0 for pads)
      emask [S, L]      True where the edge slot carries a real chain edge
      perm [S, L+1]     slot permutation: the P retained slots first
                        (boundaries + closure endpoints + inert pad-slot
                        dummies), then the L+1-P interior slots to eliminate
      ret_gidx [S, P]   global reduced-system index of each retained slot
      gnode [G]         global node id per reduced index (M = dump row for
                        dummy pad slots, whose rows are damping-only)
      int_scatter [S, L+1-P] global node id of each eliminated interior
                        slot, or M (dump) for unused alias slots
      gid_of            dict node id -> reduced index (for closure edges)
      l_seg, p_ret, n_int, g_tot
    """
    if not _can_shard_chain(m, s):
        return None
    # Integer even split: consecutive bounds differ by >= 1 when m-1 >= s.
    bounds = np.array([(d * (m - 1)) // s for d in range(s + 1)], np.int64)
    closure_set = sorted({int(x) for x in closure_nodes} - set(bounds.tolist()))
    interior_by_seg: list[list[int]] = [[] for _ in range(s)]
    for x in closure_set:
        d = int(np.searchsorted(bounds, x, side="right") - 1)
        interior_by_seg[d].append(x)
    rmax = max((len(v) for v in interior_by_seg), default=0)
    seg_len = bounds[1:] - bounds[:-1]  # [S] real edges per segment
    # Slot count: the longest segment plus rmax inert alias slots, so that
    # (a) every segment, full-length ones included, can pad its retained set
    # to the common width P with edge-free dummy slots (damping-only rows,
    # decoupled, all sharing one dump index in the reduced system: g_tot
    # stays |boundaries ∪ closures| + 1 however the closures cluster), and
    # (b) at least one interior slot remains to eliminate (n_int >= 1).
    l_seg = max(2, int(seg_len.max()) + rmax, rmax + 2)
    p_ret = 2 + rmax
    n_int = l_seg + 1 - p_ret  # >= 1 by construction
    node_idx = np.zeros((s, l_seg + 1), np.int32)
    pi = np.zeros((s, l_seg), np.int32)
    pj = np.zeros((s, l_seg), np.int32)
    eidx = np.zeros((s, l_seg), np.int32)
    emask = np.zeros((s, l_seg), bool)
    perm = np.zeros((s, l_seg + 1), np.int32)
    ret_gidx = np.zeros((s, p_ret), np.int32)
    int_scatter = np.full((s, n_int), m, np.int32)
    # Reduced-system indexing: boundaries and closure endpoints first (the
    # closure blocks' vocabulary), then one dump index shared by every inert
    # pad dummy (their rows are damping-only and decoupled, so summing them
    # on one row is exact).
    gnode = sorted(set(bounds.tolist()) | set(closure_set))
    gid_of = {n: g for g, n in enumerate(gnode)}
    dump_gid = len(gnode)
    gnode = gnode + [m]
    for d in range(s):
        b0, b1 = int(bounds[d]), int(bounds[d + 1])
        ld = b1 - b0
        # Slots 0..ld-1 walk the path from the left boundary; slot l_seg is
        # the right boundary; slots ld..l_seg-1 are unused (they alias b0, so
        # residuals stay finite; their edges have weight 0 and touch no slot,
        # so their rows are damping-only and the reduction is exact).
        node_idx[d, :ld] = b0 + np.arange(ld)
        node_idx[d, ld:l_seg] = b0
        node_idx[d, l_seg] = b1
        pi[d, :ld] = np.arange(ld)
        pj[d, : ld - 1] = np.arange(1, ld)
        pj[d, ld - 1] = l_seg  # the last real edge couples into the right boundary
        eidx[d, :ld] = b0 + np.arange(ld)
        emask[d, :ld] = True
        # Retained slots: both boundaries, this segment's closure endpoints,
        # then edge-free alias dummies sharing the dump index.
        r_slots = [x - b0 for x in interior_by_seg[d]]
        ret = [0, l_seg] + r_slots
        gq = [gid_of[b0], gid_of[b1]] + [gid_of[x] for x in interior_by_seg[d]]
        used = set(ret)
        for cand in range(ld, l_seg):
            if len(ret) == p_ret:
                break
            ret.append(cand)
            used.add(cand)
            gq.append(dump_gid)
        if len(ret) != p_ret:
            raise AssertionError((d, ld, l_seg, p_ret))
        nonret = [x for x in range(l_seg + 1) if x not in used]
        perm[d] = ret + nonret
        ret_gidx[d] = gq
        int_scatter[d] = [(b0 + x if 0 < x < ld else m) for x in nonret]
    return dict(
        bounds=bounds.astype(np.int32), node_idx=node_idx, pi=pi, pj=pj, eidx=eidx, emask=emask,
        perm=perm, ret_gidx=ret_gidx, gnode=np.asarray(gnode, np.int32), int_scatter=int_scatter,
        gid_of=gid_of, l_seg=l_seg, p_ret=p_ret, n_int=n_int, g_tot=len(gnode),
    )


def _blocks(Ji, Jj, w):
    """An edge batch's four Hessian blocks (ii, jj, ij, ji), weighted."""
    w = w[:, None, None]
    return torch.cat([w * torch.einsum("eai,eaj->eij", Ji, Ji), w * torch.einsum("eai,eaj->eij", Jj, Jj),
                      w * torch.einsum("eai,eaj->eij", Ji, Jj), w * torch.einsum("eai,eaj->eij", Jj, Ji)])


def _grads(Ji, Jj, res, w):
    """An edge batch's gradient rows at i, then at j."""
    return torch.cat([w[:, None] * torch.einsum("eai,ea->ei", Ji, res),
                      w[:, None] * torch.einsum("eai,ea->ei", Jj, res)])


@per_rank
def refine_chain_sharded(
    R: torch.Tensor,
    t: torch.Tensor,
    edge_R: torch.Tensor,  # [M-1, 3, 3] measured relative rotations k -> k+1
    edge_t: torch.Tensor,  # [M-1, 3]
    mesh,
    n_iters: int = 10,
    damping: float = 1e-6,
    gauge_weight: float = 1e8,
    edge_weight: torch.Tensor | None = None,  # [M-1] chain-edge weights
    closures: EdgeList | None = None,  # loop closures
    robust_delta: float | None = None,  # IRLS robust gate (see _robust_weight)
) -> PoseGraphResult:
    """Distributed Gauss-Newton for an odometry chain by segment-wise Schur
    complement over a mesh (BASELINE.json:5), one rank's program.

    The chain of M nodes splits evenly into S = mesh.size segments; the
    retained set of the reduction is the S + 1 segment boundaries plus every
    closure endpoint (_chain_segmentation). Rank d owns segment d. Each
    Gauss-Newton step it
      1. builds its segment's normal equations over L + 1 slots,
      2. Schur-eliminates its interior (non-retained) slots,
      3. adds its reduced blocks HK [G, G, 6, 6], gK [G, 6] and its cost over
         the mesh, one all-reduce: the only traffic,
      4. adds the closure blocks once (replicated: closures join retained
         nodes only), solves the reduced system and back-substitutes its
         interior.
    A rank keeps the retained nodes' poses and its own interior's; one sum
    over the mesh after the last step gathers every pose. On one rank the
    whole chain is one segment. Matches refine_pose_graph up to the damping's
    placement and float rounding.

    Falls back to the dense solver when the chain is too short to shard
    (M - 1 < S). Closure endpoints out of range raise ValueError. Traced as
    refine_pose_graph is: ``hgmm_torch.pg.refine``, ``pg.iters``, ``pg.edges``.
    """
    with span("hgmm_torch.pg.refine"):
        count("pg.iters", n_iters)
        count("pg.edges", int(R.shape[0]) - 1 + (0 if closures is None else int(closures.i.numel())))
        return _refine_chain(R, t, edge_R, edge_t, mesh, n_iters, damping, gauge_weight, edge_weight,
                             closures, robust_delta)


def _refine_chain(R, t, edge_R, edge_t, mesh, n_iters, damping, gauge_weight, edge_weight, closures,
                  robust_delta) -> PoseGraphResult:
    s, rank = mesh.size, mesh.rank
    m = int(R.shape[0])
    dev, dtype = R.device, R.dtype
    edge_R, edge_t = edge_R.to(device=dev, dtype=dtype), edge_t.to(device=dev, dtype=dtype)
    edge_weight = (torch.ones(m - 1, dtype=dtype, device=dev) if edge_weight is None
                   else edge_weight.to(device=dev, dtype=dtype))
    ci = cj = []
    if closures is not None and closures.i.numel() > 0:
        ci, cj = closures.i.cpu().tolist(), closures.j.cpu().tolist()
        bad = [x for x in ci + cj if x < 0 or x >= m]
        if bad:
            raise ValueError(f"closure endpoints {bad} out of range for {m} nodes")
    else:
        closures = None

    if not _can_shard_chain(m, s):
        if m > 512:
            warnings.warn(
                f"refine_chain_sharded: cannot shard a {m}-node chain over {s} ranks (m - 1 < "
                f"ranks); falling back to the dense O(M^3) solver", stacklevel=3)
        edges = EdgeList(torch.arange(m - 1, device=dev), torch.arange(1, m, device=dev), edge_R,
                         edge_t, edge_weight)
        if closures is not None:
            edges = concat_edge_lists(edges, closures)
        return _refine_dense(R, t, edges, n_iters, damping, gauge_weight, robust_delta)

    seg = _chain_segmentation(m, s, ci + cj)
    l1, p_ret, n_int, g = seg["l_seg"] + 1, seg["p_ret"], seg["n_int"], seg["g_tot"]

    def idx(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    node_idx, pi, pj = idx(seg["node_idx"][rank]), idx(seg["pi"][rank]), idx(seg["pj"][rank])
    perm, retg, gnode = idx(seg["perm"][rank]), idx(seg["ret_gidx"][rank]), idx(seg["gnode"])
    own = idx(seg["int_scatter"][rank])
    emask = torch.as_tensor(seg["emask"][rank], device=dev)
    eidx = idx(seg["eidx"][rank])
    # Each slot's measurement and weight; pad slots carry the identity and 0.
    zR = torch.where(emask[:, None, None], edge_R[eidx], torch.eye(3, dtype=dtype, device=dev))
    zt = torch.where(emask[:, None], edge_t[eidx], torch.zeros((), dtype=dtype, device=dev))
    zw = torch.where(emask, edge_weight[eidx], torch.zeros((), dtype=dtype, device=dev))
    a_blocks = torch.cat([pi * l1 + pi, pj * l1 + pj, pi * l1 + pj, pj * l1 + pi])
    k_blocks = (retg[:, None] * g + retg[None, :]).reshape(-1)
    if closures is not None:
        cl_i, cl_j = idx(ci), idx(cj)
        ki, kj = idx([seg["gid_of"][x] for x in ci]), idx([seg["gid_of"][x] for x in cj])
        cl_blocks = torch.cat([ki * g + ki, kj * g + kj, ki * g + kj, kj * g + ki])
        cR, ct, cw = (x.to(device=dev, dtype=dtype) for x in (closures.R, closures.t, closures.weight))
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag = torch.arange(l1, device=dev) * (l1 + 1)
    costs = []
    for _ in range(n_iters):
        # 1. The segment's normal equations over its L + 1 slots.
        Rs, ts = R[node_idx], t[node_idx]
        res, Ji, Jj = _res_and_jacs(Rs[pi], ts[pi], Rs[pj], ts[pj], zR, zt)
        w = _robust_weight(zw, res, robust_delta)
        A = torch.zeros((l1 * l1, 6, 6), dtype=dtype, device=dev).index_add_(0, a_blocks, _blocks(Ji, Jj, w))
        gl = torch.zeros((l1, 6), dtype=dtype, device=dev).index_add_(0, torch.cat([pi, pj]),
                                                                       _grads(Ji, Jj, res, w))
        if rank == 0:  # the gauge prior on node 0, rank 0's slot 0
            A[0] += gauge_weight * eye6
        A[diag] += damping * eye6
        # 2. Retained slots first; eliminate the n_int interior ones.
        Ap = A.view(l1, l1, 6, 6)[perm][:, perm]
        gp = gl[perm]
        A_KK = Ap[:p_ret, :p_ret].transpose(1, 2).reshape(6 * p_ret, 6 * p_ret)
        A_II = Ap[p_ret:, p_ret:].transpose(1, 2).reshape(6 * n_int, 6 * n_int)
        A_IK = Ap[p_ret:, :p_ret].transpose(1, 2).reshape(6 * n_int, 6 * p_ret)
        sol = torch.linalg.solve(A_II, torch.cat([A_IK, gp[p_ret:].reshape(-1, 1)], dim=1))
        X, y = sol[:, :-1], sol[:, -1]  # A_II^-1 A_IK, A_II^-1 g_I
        S_red = A_KK - A_IK.T @ X
        g_red = gp[:p_ret].reshape(-1) - A_IK.T @ y
        # 3. HK, gK and the cost in one buffer, summed over the mesh.
        buf = torch.zeros(g * g * 36 + g * 6 + 1, dtype=dtype, device=dev)
        HK = buf[: g * g * 36].view(g * g, 6, 6)
        gK = buf[g * g * 36: -1].view(g, 6)
        HK.index_add_(0, k_blocks, S_red.view(p_ret, 6, p_ret, 6).transpose(1, 2).reshape(-1, 6, 6))
        gK.index_add_(0, retg, g_red.view(p_ret, 6))
        buf[-1] = torch.sum(w * torch.sum(res * res, dim=1))
        mesh.all_reduce_(buf)
        cost = buf[-1].clone()
        # 4. The closure blocks once, the reduced solve, the back-substitution.
        if closures is not None:
            res_c, Jci, Jcj = _res_and_jacs(R[cl_i], t[cl_i], R[cl_j], t[cl_j], cR, ct)
            wc = _robust_weight(cw, res_c, robust_delta)
            HK.index_add_(0, cl_blocks, _blocks(Jci, Jcj, wc))
            gK.index_add_(0, torch.cat([ki, kj]), _grads(Jci, Jcj, res_c, wc))
            cost = cost + torch.sum(wc * torch.sum(res_c * res_c, dim=1))
        HKd = HK.view(g, g, 6, 6).transpose(1, 2).reshape(6 * g, 6 * g)
        HKd = HKd + damping * torch.eye(6 * g, dtype=dtype, device=dev)
        delta_G = -torch.linalg.solve(HKd, gK.reshape(-1)).reshape(g, 6)
        delta_I = -(y + X @ delta_G[retg].reshape(-1)).reshape(n_int, 6)
        # Retained deltas land at their nodes (pad dummies on the dump row m),
        # this rank's interior deltas at theirs.
        delta = torch.zeros((m + 1, 6), dtype=dtype, device=dev)
        delta[gnode] = delta_G
        delta[own] = delta_I
        upd = vmap(se3_exp)(delta[:m])
        t = t + torch.einsum("mij,mj->mi", R, upd.t)
        R = torch.einsum("mij,mjk->mik", R, upd.R)
        costs.append(cost)
    # Gather the poses: each interior node from its rank, the retained ones
    # from rank 0, added over the mesh (every other row adds zeros).
    rows = own[own < m]
    if rank == 0:
        rows = torch.cat([rows, gnode[gnode < m]])
    out = torch.zeros((m, 12), dtype=dtype, device=dev)
    out[rows] = torch.cat([R[rows].reshape(-1, 9), t[rows]], dim=1)
    mesh.all_reduce_(out)
    return PoseGraphResult(out[:, :9].reshape(m, 3, 3), out[:, 9:],
                           torch.stack(costs) if costs else torch.zeros(0, dtype=dtype, device=dev))
