"""ctypes wrappers of the CUDA kernels in ``hgmm_torch/csrc``.

Counterpart of ``hgmm/ops/fused_em.py``. Each wrapper takes the prepared
point buffer ``pts4`` [4, N] f32 (rows x, y, z, w; see ``hgmm_torch.ops.prepare``),
checks device, dtype, shape and contiguity, launches on the current CUDA
stream, raises on a nonzero CUDA error code and adds one to its entry of
``LAUNCHES``. They accept CUDA tensors only: the dispatch in
``hgmm_torch.ops`` sends CPU tensors to the plain versions in ``em_ref``.

The kernels compute what the TPU kernels compute with float32 FMAs and an
exact per-point max in the softmax, so they take no softmax shift; their
sums are reduced in a fixed order and are reproducible run to run.

``em_stats`` has three kernel bodies (``csrc/em_stats.cu``): unmasked calls with
K >= 33 run the register-tiled one on a persistent grid, with the launch
geometry of ``plan_em_tiles``; unmasked calls with K <= 32 the first one, a
point on 1 to 4 lanes (``plan_em_lanes``); masked calls run by parent chunks
over the points sorted by parent (``group_by_parent``, ``plan_parent_chunks``).
K and the mask alone decide. Each takes W [10, K] or the packed table
(``em_ref.Packed``) that ``em_step`` (``csrc/em_step.cu``) writes. A fit's
sweep launches the body alone (``em_partials``, ``em_partials_grouped``: the
partial rows, not summed) and then ``em_step``, which sums the rows and runs
the M-step (launch geometry from ``plan_em_step``): two launches and no host
read (``new_fit`` holds the state on the card). ``em_stats`` and
``em_stats_grouped`` add the reduce kernel for their other callers.

A registration scan builds its tables once (``reg_tables``), and its state
lives on the card (``new_scan``): ``reg_partials`` (``csrc/reg_stats.cu``,
launch geometry from ``plan_reg_stats``) and ``reg_step``
(``csrc/reg_step.cu``) read and write it without a host sync.
"""

from __future__ import annotations

import dataclasses
import threading

import torch

from hgmm_torch.ops import _build
from hgmm_torch.ops.em_ref import (
    COV_TYPES,
    REG_OUT,
    SCAN_FLOATS,
    EmFit,
    EmPartials,
    EmStats,
    Packed,
    RegScan,
    RegStats,
    pack_table,
)
from hgmm_torch.ops.em_ref import new_scan as em_ref_new_scan

MAX_K = 2048  # largest K whose tables fit in shared memory
MAX_TOP_K = 32  # largest top_k < K that reg_stats gates (csrc/reg_stats.cu)
# The masked em_stats by parent chunks (csrc/em_stats.cu:em_stats_grouped_kernel).
EG_BMAX = 8  # largest branch on the card
EG_MAX_PPT = 16  # points a lane in a chunk, at most
EG_TARGET_WARPS = 4  # chunks (warps) an SM the plan aims for
# The register-tiled em_stats kernel (csrc/em_stats.cu:em_stats_tiled_kernel).
EMT_THREADS = 256
EMT_PT = 8  # points a thread
EMT_CT = 8  # components a thread
# The first em_stats body, K <= ES_MAX_K (csrc/em_stats.cu:em_stats_kernel).
ES_THREADS = 128
ES_MAX_K = 32  # above it the tiled body on 64 padded rows was faster (PERF.md)
ES_CT = 8  # components a lane
ES_BLOCKS_PER_SM = 4  # cap of the grid, so of the partial rows
EMT_MIN_K = ES_MAX_K + 1  # the register-tiled body from here on
# assign (csrc/assign.cu).
AS_THREADS = 256
AS_BLOCKS_PER_SM = 4
AS_MASKED_LANES = 8  # lanes a point under a parent mask, one a child
AS_PT = 2  # points a lane holds at once
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100 (227 KB)
# reg_stats (csrc/reg_stats.cu) and its plan.
RS_THREADS = 256
RS_MIN_WARPS_PER_SM = 8  # below it the plan gives a point more lanes
RS_BLOCKS_PER_SM = 4  # cap of the grid, so of the partial rows
# reg_step (csrc/reg_step.cu) and its plan.
STEP_PASS_ROWS = 16  # partial rows a pass of the block reads (944 floats)
STEP_UNROLL = 16  # passes a block has in flight at once
STEP_CLUSTER = 8  # blocks of one thread block cluster past one batch of passes
# em_step (csrc/em_step.cu) and its plan.
EMS_MAX_WARPS = 16  # a component's warps, at most
EMS_ROWS_A_LANE = 12  # partial rows a lane sums (its loads in flight at once) before the plan adds a warp
EMS_WARPS_PER_SM = 64  # resident warps an SM on the H100

# Kernel launches by wrapper, for showing that a run went through the kernels
# (ops/knn.py and ops/probes.py count their kernels here too).
LAUNCHES = {"em_stats": 0, "em_stats_masked": 0, "em_step": 0, "assign": 0, "reg_stats": 0,
            "reg_step": 0, "knn": 0, "probe_logits": 0, "probe_addonly": 0, "probe_stats": 0,
            "probe_norm": 0, "probe_vpu": 0}


_LAUNCHES_LOCK = threading.Lock()  # the ranks of an EmulatedMesh launch from threads


def reset_launches() -> None:
    with _LAUNCHES_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Add one to a kernel's count (each wrapper, where it launches)."""
    with _LAUNCHES_LOCK:
        LAUNCHES[name] += 1


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got one on {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_points(pts4: torch.Tensor) -> int:
    if pts4.dim() != 2 or pts4.shape[0] != 4:
        raise ValueError(f"pts4: expected [4, N], got {tuple(pts4.shape)}")
    _check("pts4", pts4, torch.float32, tuple(pts4.shape))
    return pts4.shape[1]


def _table(W, device, rows: int | None = None) -> Packed:
    """The packed table of a call: a Packed as given (float32 on the card,
    `rows` rows when given, at least K), or W [>=10, K] packed with `rows`
    rows (K when None)."""
    if isinstance(W, Packed):
        k, wn = W.k, W.wn
        if not 1 <= k <= MAX_K or wn.dim() != 2 or not (rows or k) <= wn.shape[0] or (rows and wn.shape[0] != rows):
            raise ValueError(f"table of shape {tuple(wn.shape)} for K={k}, {rows or k} rows")
        _check("table", wn, torch.float32, (wn.shape[0], 12))
        if wn.device != torch.device(device):
            raise ValueError(f"table: on {wn.device}, the points on {device}")
        return W
    k = W.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    return pack_table(W[:10].to(device=device, dtype=torch.float32), rows)


def table_rows(k: int, masked: bool = False) -> int:
    """Rows of the packed table an em_stats call reads: the tiled body's
    k_pad (padded with floor rows), else K."""
    plan = plan_em_tiles(k, masked)
    return k if plan is None else plan.k_pad


@dataclasses.dataclass(frozen=True)
class LanePlan:
    """Launch geometry of a kernel that gives a point `lanes` lanes of a warp
    on a persistent grid of `blocks` blocks (the first em_stats body:
    csrc/em_stats.cu:em_stats_kernel, one partial row a block; assign)."""

    lanes: int
    blocks: int


def plan_em_lanes(n: int, k: int, sms: int) -> LanePlan:
    """The first em_stats body (K <= ES_MAX_K): lanes = K / ES_CT rounded up
    to a power of two (1 at K <= 8), so a lane holds at most ES_CT
    components, whatever N (more lanes of fewer components at K = 8 lost at
    every N measured: PERF.md); blocks of ES_THREADS threads, one a
    ES_THREADS / lanes points, at most ES_BLOCKS_PER_SM an SM."""
    if sms < 1 or not 1 <= k <= ES_MAX_K:
        raise ValueError(f"plan_em_lanes: K={k}, {sms} SMs")
    lanes = 1 << (-(-k // ES_CT) - 1).bit_length()
    per_block = ES_THREADS // lanes
    return LanePlan(lanes, max(1, min(ES_BLOCKS_PER_SM * sms, -(-n // per_block))))


def plan_assign(n: int, masked: bool, sms: int) -> LanePlan:
    """assign: one lane a point unmasked (every lane reads the same rows),
    AS_MASKED_LANES under a parent mask (a lane a child of the parent's
    block); a lane holds AS_PT points at once; blocks of AS_THREADS threads,
    at most AS_BLOCKS_PER_SM an SM."""
    if sms < 1:
        raise ValueError(f"plan_assign: {sms} SMs")
    lanes = AS_MASKED_LANES if masked else 1
    return LanePlan(lanes, max(1, min(AS_BLOCKS_PER_SM * sms, -(-n * lanes // (AS_THREADS * AS_PT)))))


@dataclasses.dataclass(frozen=True)
class EmTilePlan:
    """Launch geometry of the register-tiled em_stats kernel: 256 threads as
    `point_groups` x `comp_groups`, each thread EMT_PT points x EMT_CT
    components of a tile of `points` points and all `k_pad` components."""

    k: int
    k_pad: int  # K rounded up to the tiling; rows k.. are floor rows
    comp_groups: int  # the kernel's template argument NCG
    point_groups: int
    points: int  # P, points a tile

    def components(self, cg: int) -> list[int]:
        """The k_pad-row indices of component group cg: two runs of four, so
        that neighbouring lanes read neighbouring 16-byte words."""
        return [(c // 4) * (self.k_pad // 2) + 4 * cg + c % 4 for c in range(EMT_CT)]

    def tile_points(self, pg: int) -> list[int]:
        """The tile rows of point group pg."""
        return list(range(pg * EMT_PT, (pg + 1) * EMT_PT))

    @property
    def smem_bytes(self) -> int:
        """csrc/em_stats.cu:emt_smem_floats: the weight table, two psi tiles,
        two raw tiles, the cross-warp max and sum, the end-of-block staging of
        every thread's statistics, the loglik tree."""
        p, warps = self.points, max(self.comp_groups // 32, 1)
        floats = (10 * self.k_pad + 20 * p + 8 * p + 2 * p * warps
                  + self.point_groups * self.k_pad * 10 + EMT_THREADS)
        return 4 * floats

    @property
    def state_registers(self) -> int:
        """Registers a thread holds across a tile: its logits, its statistics,
        the per-point max and sum, one feature's psi and weight operands."""
        return EMT_PT * EMT_CT + EMT_CT * 10 + 2 * EMT_PT + EMT_PT + EMT_CT

    def blocks(self, n: int, sms: int) -> int:
        """Persistent grid: one block an SM at most, never more than tiles."""
        return max(1, min(sms, -(-n // self.points)))


def plan_em_tiles(k: int, masked: bool = False) -> EmTilePlan | None:
    """The tile plan of an em_stats call, or None where another body runs:
    K < EMT_MIN_K (the first body, a point on 1 to 4 lanes: plan_em_lanes)
    and every masked call (em_stats_grouped). The choice depends
    on K and the mask alone."""
    if masked or k < EMT_MIN_K:
        return None
    if k > MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    k_pad = 1 << (k - 1).bit_length()
    ncg = k_pad // EMT_CT
    npg = EMT_THREADS // ncg
    return EmTilePlan(k=k, k_pad=k_pad, comp_groups=ncg, point_groups=npg, points=npg * EMT_PT)


def _parent(parent: torch.Tensor, n: int, branch: int) -> torch.Tensor:
    if branch is None or branch < 1:
        raise ValueError(f"a parent mask needs a branch >= 1, got {branch}")
    parent = parent.to(torch.int32).contiguous()
    _check("parent", parent, torch.int32, (n,))
    return parent


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        msg = _build.load().hgmm_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _outlier(outlier_logit) -> tuple[int, float]:
    return (0, 0.0) if outlier_logit is None else (1, float(outlier_logit))


def em_partials(pts4: torch.Tensor, W, outlier_logit=None, out: torch.Tensor | None = None) -> EmPartials:
    """The unmasked em_stats body on a prepared [4, N] buffer, one launch:
    its partial rows [nb, K*10 + 1], which em_step sums (a fit's sweep); with
    `out` [K*10 + 1] the reduce kernel also writes their sum there. W is
    [10, K] or a Packed table (table_rows(K) rows)."""
    n = _check_points(pts4)
    k = W.k if isinstance(W, Packed) else W.shape[1]
    plan = plan_em_tiles(k)
    wn = _table(W, pts4.device, table_rows(k)).wn
    sms = _sms(pts4.device)
    lane_plan = plan_em_lanes(n, k, sms) if plan is None else None
    nb = lane_plan.blocks if plan is None else plan.blocks(n, sms)
    partial = torch.empty((nb, k * 10 + 1), dtype=torch.float32, device=pts4.device)
    out_p = None if out is None else out.data_ptr()
    has_out, out_l = _outlier(outlier_logit)
    with torch.cuda.device(pts4.device):
        if plan is None:
            err = _build.load().hgmm_em_stats(
                pts4.data_ptr(), n, wn.data_ptr(), k, lane_plan.lanes, has_out, out_l, partial.data_ptr(), nb,
                out_p, _stream(pts4),
            )
        else:
            err = _build.load().hgmm_em_stats_tiled(
                pts4.data_ptr(), n, wn.data_ptr(), k, plan.k_pad, has_out, out_l,
                partial.data_ptr(), nb, out_p, _stream(pts4),
            )
    _raise_on(err, "em_stats")
    count_launch("em_stats")
    return EmPartials(partial, k, nb, nb)


def em_stats(pts4: torch.Tensor, W, outlier_logit=None) -> EmStats:
    """Kernel twin of em_ref.em_stats on a prepared [4, N] buffer: the body
    and the reduce; W is [10, K] or a Packed table (table_rows(K) rows)."""
    k = W.k if isinstance(W, Packed) else W.shape[1]
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=pts4.device)
    em_partials(pts4, W, outlier_logit, out)
    return EmStats(S=out[: k * 10].view(k, 10), loglik=out[k * 10])


@dataclasses.dataclass(frozen=True)
class StepPlan:
    """Launch geometry of em_step (csrc/em_step.cu): a block of `warps` warps
    a component, then one for the loglik and the floor rows (`blocks` = K +
    1)."""

    warps: int
    blocks: int


def plan_em_step(k: int, span: int, sms: int) -> StepPlan:
    """A component's warps: enough that a lane sums at most EMS_ROWS_A_LANE
    of the `span` partial rows it reads (a warp reads three rows at once), at
    most EMS_MAX_WARPS, and no more than the card holds resident for K + 1
    blocks at once (EMS_WARPS_PER_SM an SM); at least one."""
    if sms < 1 or not 1 <= k <= MAX_K or span < 0:
        raise ValueError(f"plan_em_step: K={k}, {span} rows, {sms} SMs")
    want = -(-max(span, 1) // (3 * EMS_ROWS_A_LANE))
    room = EMS_WARPS_PER_SM * sms // (k + 1)
    return StepPlan(max(1, min(EMS_MAX_WARPS, want, room)), k + 1)


def em_step(parts, fit: EmFit, it: int, cov_reg: float = 1e-6, cov_type: str = "full") -> None:
    """Kernel twin of em_ref.em_step (csrc/em_step.cu): one launch after an
    em_stats body that sums its partial rows (EmPartials, either layout) and
    writes the fit's parameters, table and logliks[it] on the card from them
    and the total and cov_floor there, nothing read back."""
    if not isinstance(parts, EmPartials):
        raise TypeError(f"em_step: expected an em_stats body's EmPartials, got {type(parts).__name__}")
    k, wn = fit.table.k, fit.table.wn
    rows = wn.shape[0]
    dev = wn.device
    width = (parts.branch or k) * 10 + 1
    n_par = -(-k // parts.branch) if parts.branch else 0
    checks = [("partial", parts.partial, torch.float32, (parts.partial.shape[0], width)),
              ("pi", fit.pi, torch.float32, (k,)), ("mu", fit.mu, torch.float32, (k, 3)),
              ("sigma", fit.sigma, torch.float32, (k, 3, 3)), ("table", wn, torch.float32, (rows, 12)),
              ("logliks", fit.logliks, torch.float32, tuple(fit.logliks.shape)),
              ("total", fit.total, torch.float32, ()), ("cov_floor", fit.cov_floor, torch.float32, ())]
    if parts.branch:
        checks.append(("parent_off", parts.parent_off, torch.int32, (n_par + 1,)))
    for name, t, dtype, shape in checks:
        _check(name, t, dtype, shape)
        if t.device != dev:
            raise ValueError(f"em_step: {name} on {t.device}, the table on {dev}")
    if (not 0 <= it < fit.logliks.shape[0] or cov_type not in COV_TYPES or rows < k or parts.k != k
            or not 0 <= parts.n_rows <= parts.partial.shape[0] or parts.branch > EG_BMAX):
        raise ValueError(f"em_step: sweep {it} of {fit.logliks.shape[0]}, cov_type {cov_type!r}, "
                         f"{rows} rows for K={k}, partials of K={parts.k} with {parts.n_rows} rows "
                         f"of {tuple(parts.partial.shape)}, branch {parts.branch}")
    plan = plan_em_step(k, parts.span, _sms(dev))
    with torch.cuda.device(dev):
        err = _build.load().hgmm_em_step(
            parts.partial.data_ptr(), parts.n_rows,
            parts.parent_off.data_ptr() if parts.branch else None, parts.branch,
            fit.total.data_ptr(), fit.cov_floor.data_ptr(), k, rows, float(cov_reg),
            COV_TYPES.index(cov_type), fit.pi.data_ptr(), fit.mu.data_ptr(), fit.sigma.data_ptr(),
            wn.data_ptr(), fit.logliks.data_ptr(), it, plan.warps, _stream(wn),
        )
    _raise_on(err, "em_step")
    count_launch("em_step")


def plan_parent_chunks(counts: list[int], sms: int) -> tuple[int, list[tuple[int, int, int]]]:
    """Chunks of the masked E-step (csrc/em_stats.cu:em_stats_grouped_kernel)
    over points sorted by parent, counts[p] of parent p: (P, [(parent, first
    point, count)]), every chunk at most P points of one parent, in parent
    order. P = 32 ppt, ppt points a lane: the live points over EG_TARGET_WARPS
    warps an SM, between 1 and EG_MAX_PPT."""
    if sms < 1:
        raise ValueError(f"plan_parent_chunks: {sms} SMs")
    n_live = sum(counts)
    ppt = max(1, min(EG_MAX_PPT, n_live // (32 * EG_TARGET_WARPS * sms)))
    size = 32 * ppt
    chunks, first = [], 0
    for p, c in enumerate(counts):
        chunks.extend((p, first + s, min(size, c - s)) for s in range(0, c, size))
        first += c
    return size, chunks


@dataclasses.dataclass
class ParentGroups:
    """A tree level's points grouped by parent for the masked E-step, built
    once a level (group_by_parent) and reused by every sweep: the live points
    (a parent in range, a nonzero weight) sorted by parent, the chunk table
    and each parent's first chunk on the card, the partial buffer."""

    pts4: torch.Tensor  # [4, n_live]
    branch: int
    k: int
    chunk_points: int
    parent_rows: int  # the most chunks of one parent
    chunks: torch.Tensor  # [n_chunks, 3] int32: parent, first point, count
    parent_off: torch.Tensor  # [n_parents + 1] int32
    partial: torch.Tensor  # [max(n_chunks, 1), branch*10 + 1]

    @property
    def n_chunks(self) -> int:
        return self.chunks.shape[0]


def group_by_parent(pts4: torch.Tensor, parent: torch.Tensor, branch: int, k: int) -> ParentGroups:
    """Sort a level's points by parent (stable) and plan the chunks: one
    device-to-host copy of the per-parent counts. Points whose parent has no
    child below K (-1 among them) and zero-weight rows are left out: the
    masked E-step gives them exactly nothing (dead, or weight 0)."""
    n = _check_points(pts4)
    parent = _parent(parent, n, branch)
    if branch > EG_BMAX:
        raise ValueError(f"em_stats_masked: branch {branch} > {EG_BMAX} on the card")
    n_par = -(-k // branch)
    key = parent.long()
    key = torch.where((key >= 0) & (key < n_par) & (pts4[3] != 0), key, torch.full_like(key, n_par))
    # index_add_, not bincount: bincount on the card reads its maximum back.
    counts = torch.zeros(n_par + 1, dtype=torch.int64, device=key.device).index_add_(
        0, key, torch.ones_like(key))[:n_par].tolist()  # the level's one host read
    order = torch.sort(key, stable=True).indices[: sum(counts)]
    size, chunks = plan_parent_chunks(counts, _sms(pts4.device))
    off, first = [], 0
    for c in counts:
        off.append(first)
        first += -(-c // size)
    off.append(first)
    # The chunk table and the offsets in one copy from pinned memory, which
    # does not make the host wait.
    host = torch.tensor([v for ch in chunks for v in ch] + off, dtype=torch.int32).pin_memory()
    dev_tab = host.to(pts4.device, non_blocking=True)
    return ParentGroups(
        pts4=pts4[:, order].contiguous(), branch=branch, k=k, chunk_points=size,
        parent_rows=max((b - a for a, b in zip(off, off[1:])), default=0),
        chunks=dev_tab[: 3 * len(chunks)].view(-1, 3), parent_off=dev_tab[3 * len(chunks):],
        partial=torch.empty((max(len(chunks), 1), branch * 10 + 1), dtype=torch.float32,
                            device=pts4.device),
    )


def em_partials_grouped(groups: ParentGroups, W, out: torch.Tensor | None = None) -> EmPartials:
    """The masked em_stats body on a level's grouped points, one launch: its
    partial rows [n_chunks, branch*10 + 1] (a chunk's), which em_step sums
    by parent (a fit's sweep); with `out` [K*10 + 1] the reduce kernel also
    writes their sum there. W is [10, K] or a Packed table."""
    k = W.k if isinstance(W, Packed) else W.shape[1]
    if k != groups.k:
        raise ValueError(f"em_stats_masked: W has K={k}, the groups were made for K={groups.k}")
    wn = _table(W, groups.pts4.device).wn
    with torch.cuda.device(groups.pts4.device):
        err = _build.load().hgmm_em_stats_grouped(
            groups.pts4.data_ptr(), groups.pts4.shape[1], wn.data_ptr(), k, groups.branch,
            groups.chunks.data_ptr(), groups.n_chunks, groups.parent_off.data_ptr(),
            groups.partial.data_ptr(), None if out is None else out.data_ptr(), _stream(groups.pts4),
        )
    _raise_on(err, "em_stats_masked")
    count_launch("em_stats_masked")
    return EmPartials(groups.partial, k, groups.n_chunks, groups.parent_rows, groups.branch,
                      groups.parent_off)


def em_stats_grouped(groups: ParentGroups, W) -> EmStats:
    """Kernel twin of em_ref.em_stats_masked on a level's grouped points: the
    body and the reduce; W is [10, K] or a Packed table."""
    k = W.k if isinstance(W, Packed) else W.shape[1]
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=groups.pts4.device)
    em_partials_grouped(groups, W, out)
    return EmStats(S=out[: k * 10].view(k, 10), loglik=out[k * 10])


def em_stats_masked(pts4: torch.Tensor, W: torch.Tensor, parent: torch.Tensor, branch: int) -> EmStats:
    """Kernel twin of em_ref.em_stats_masked; parent [N] (int), -1 = none.
    Groups the points first (one device-to-host copy); a loop of sweeps on
    one assignment groups once (group_by_parent) and calls em_stats_grouped."""
    return em_stats_grouped(group_by_parent(pts4, parent, branch, W.shape[1]), W)


def assign(pts4: torch.Tensor, W, parent=None, branch=None) -> torch.Tensor:
    """Kernel twin of em_ref.assign: [N] int32 argmax component; W is
    [10, K] or a Packed table."""
    n = _check_points(pts4)
    table = _table(W, pts4.device)
    if parent is not None:
        parent = _parent(parent, n, branch)
    plan = plan_assign(n, parent is not None, _sms(pts4.device))
    out = torch.empty((n,), dtype=torch.int32, device=pts4.device)
    with torch.cuda.device(pts4.device):
        err = _build.load().hgmm_assign(
            pts4.data_ptr(), n, table.wn.data_ptr(), table.k,
            None if parent is None else parent.data_ptr(), branch or 1, plan.blocks,
            out.data_ptr(), _stream(pts4),
        )
    _raise_on(err, "assign")
    count_launch("assign")
    return out


def _top_k(top_k, k: int) -> int:
    """The kernel's top_k argument: 0 (no gating) for None or top_k >= K."""
    if top_k is None or top_k >= k:
        return 0
    if not 1 <= top_k <= MAX_TOP_K:
        raise ValueError(f"reg_stats: top_k={top_k} < K={k} outside [1, {MAX_TOP_K}]")
    return int(top_k)


@dataclasses.dataclass(frozen=True)
class RegPlan:
    """Launch geometry of reg_stats (csrc/reg_stats.cu): `lanes` lanes of a
    warp share a point and split its K components (the lanes body; 1 with
    top_k gating, the one-thread-a-point top_k body, whose list holds `kmax`
    logits), `blocks` blocks of RS_THREADS threads, grid-stride; one partial
    row a block."""

    lanes: int
    blocks: int
    kmax: int  # 0: no gating

    def points_per_block(self) -> int:
        return RS_THREADS // self.lanes


def plan_reg_stats(n: int, k: int, top_k, sms: int) -> RegPlan:
    """Lanes a point: 1, doubled up to min(32, K) while the points fill fewer
    than RS_MIN_WARPS_PER_SM warps an SM (the odometry bucket, N = 16,384,
    gets 4); 1 with top_k gating. Blocks: one a RS_THREADS / lanes points, at
    most RS_BLOCKS_PER_SM an SM. Shared memory: the two [K, 12] tables and the
    warps' sums, 96 K + 1,408 bytes (csrc/reg_stats.cu:reg_stats_smem_bytes),
    inside the card's limit up to MAX_K."""
    if n < 1 or not 1 <= k <= MAX_K:
        raise ValueError(f"reg_stats: N={n}, K={k}")
    gate = _top_k(top_k, k)
    lanes, kmax = 1, (0 if not gate else (9 if gate <= 8 else 33))
    while not gate and 2 * lanes <= min(32, k) and n * lanes < RS_MIN_WARPS_PER_SM * sms * 32:
        lanes *= 2
    blocks = max(1, min(-(-n * lanes // RS_THREADS), RS_BLOCKS_PER_SM * sms))
    return RegPlan(lanes=lanes, blocks=blocks, kmax=kmax)


@dataclasses.dataclass
class RegTables:
    """What a registration scan reuses on every iteration, built once: the
    source buffer, the packed weights wn and aux = [mu | A6 | b3] ([K, 12]
    each), the gate, the outlier, the launch plan and the partial buffer."""

    pts4: torch.Tensor
    wn: torch.Tensor
    aux: torch.Tensor
    gate: int
    outlier: tuple[int, float]
    plan: RegPlan
    partial: torch.Tensor

    @property
    def k(self) -> int:
        return self.wn.shape[0]


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def reg_tables(pts4, W, mu, A6, b3, top_k=None, outlier_logit=None) -> RegTables:
    n = _check_points(pts4)
    dev = pts4.device
    wn = _table(W, dev).wn
    k = wn.shape[0]
    f32 = dict(dtype=torch.float32, device=dev)
    aux = torch.cat([mu.to(**f32), A6.to(**f32), b3.to(**f32)], dim=1).contiguous()
    _check("aux", aux, torch.float32, (k, 12))
    plan = plan_reg_stats(n, k, top_k, _sms(dev))
    return RegTables(pts4, wn, aux, _top_k(top_k, k), _outlier(outlier_logit), plan,
                     torch.empty((plan.blocks, REG_OUT), **f32))


def reg_partials(tab: RegTables, pose12: torch.Tensor, done: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch reg_stats at the pose pose12 [12] (R row-major, t; float32 on
    the card): the [blocks, 59] partials in tab.partial (and their sum in
    `out` [59] when given). With `done` (a float32 flag on the card) the
    kernel returns at once when it is set."""
    n = tab.pts4.shape[1]
    for name, t in (("pose12", pose12), ("done", done), ("out", out)):
        if t is not None:
            _check(name, t, torch.float32, tuple(t.shape))
            if t.device != tab.pts4.device:
                raise ValueError(f"{name}: on {t.device}, the points on {tab.pts4.device}")
    if pose12.numel() < 12:
        raise ValueError("pose12: expected [R (9), t (3)]")
    with torch.cuda.device(tab.pts4.device):
        err = _build.load().hgmm_reg_stats(
            tab.pts4.data_ptr(), n, pose12.data_ptr(), None if done is None else done.data_ptr(),
            tab.wn.data_ptr(), tab.aux.data_ptr(), tab.k, tab.gate, tab.plan.lanes, *tab.outlier,
            tab.partial.data_ptr(), tab.plan.blocks, None if out is None else out.data_ptr(),
            _stream(tab.pts4),
        )
    _raise_on(err, "reg_stats")
    count_launch("reg_stats")
    return tab.partial


def reg_stats(pts4, W, mu, A6, b3, pose, top_k=None, outlier_logit=None) -> RegStats:
    """Kernel twin of em_ref.reg_stats: the pose (R, t) is applied in the
    kernel, so the source buffer is read as it is on every iteration."""
    tab = reg_tables(pts4, W, mu, A6, b3, top_k, outlier_logit)
    R, t = pose
    f32 = dict(dtype=torch.float32, device=pts4.device)
    pose12 = torch.cat([R.reshape(9).to(**f32), t.reshape(3).to(**f32)]).contiguous()
    out = torch.empty((REG_OUT,), **f32)
    reg_partials(tab, pose12, out=out)
    return RegStats(
        horn=out[:16].view(4, 4), A=out[16:52].view(6, 6), b=out[52:58], loglik=out[58]
    )


def new_scan(R: torch.Tensor, t: torch.Tensor, n_iters: int) -> RegScan:
    """em_ref.new_scan in float32 on the pose's card."""
    if not R.is_cuda:
        raise ValueError(f"new_scan: expected a pose on the card, got one on {R.device}")
    return em_ref_new_scan(R, t, n_iters, dtype=torch.float32)


def plan_reg_step(nb: int) -> int:
    """reg_step's blocks, one thread block cluster: one block while the nb
    partial rows are one batch of its loads (STEP_PASS_ROWS x STEP_UNROLL
    rows), STEP_CLUSTER past it, which read the rows side by side and add
    their sums through distributed shared memory. On an H100 a block takes
    ~0.8 us a batch of 256 rows, and the cluster's barriers ~1 us; at 528
    rows the cluster takes ~1.25 us less than one block (PERF.md)."""
    if nb < 1:
        raise ValueError(f"plan_reg_step: {nb} partial rows")
    return 1 if nb <= STEP_PASS_ROWS * STEP_UNROLL else STEP_CLUSTER


def reg_step(partial: torch.Tensor, scan: RegScan, it: int, solver: int, first: bool, last: bool,
             tol: float) -> None:
    """Kernel twin of em_ref.reg_step (csrc/reg_step.cu): one launch, the
    scan state updated in place on the card, nothing read back."""
    if partial.dim() != 2 or partial.shape[1] != REG_OUT:
        raise ValueError(f"reg_step: partial of shape {tuple(partial.shape)}, expected [nb, {REG_OUT}]")
    _check("partial", partial, torch.float32, tuple(partial.shape))
    _check("state", scan.state, torch.float32, (SCAN_FLOATS,))
    for name, t in (("logliks", scan.logliks), ("deltas", scan.deltas)):
        _check(name, t, torch.float32, tuple(t.shape))
    if not 0 <= it < scan.logliks.shape[0] or solver not in (0, 1):
        raise ValueError(f"reg_step: iteration {it} of {scan.logliks.shape[0]}, solver {solver}")
    if partial.data_ptr() % 16:
        raise ValueError("reg_step: the partial rows must start on a 16-byte boundary (the kernel reads float4)")
    with torch.cuda.device(partial.device):
        err = _build.load().hgmm_reg_step(
            partial.data_ptr(), partial.shape[0], scan.state.data_ptr(), scan.logliks.data_ptr(),
            scan.deltas.data_ptr(), it, solver, int(first), int(last), float(tol),
            plan_reg_step(partial.shape[0]), _stream(partial),
        )
    _raise_on(err, "reg_step")
    count_launch("reg_step")
