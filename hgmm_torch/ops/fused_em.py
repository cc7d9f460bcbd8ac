"""ctypes wrappers of the CUDA kernels in ``hgmm_torch/csrc``.

Counterpart of ``hgmm/ops/fused_em.py``. Each wrapper takes the prepared
point buffer ``pts4`` [4, N] f32 (rows x, y, z, w; see ``hgmm_torch.ops.prepare``)
and launches through ``_build.launch`` (the current CUDA stream, a raise on a
nonzero CUDA error code, one more in ``LAUNCHES``). They accept CUDA tensors
only: the dispatch in ``hgmm_torch.ops`` sends CPU tensors to the plain
versions in ``em_ref``.

The kernels compute what the TPU kernels compute with float32 FMAs and an
exact per-point max in the softmax, so they take no softmax shift; their
sums are reduced in a fixed order and are reproducible run to run.

``em_stats`` has four kernel bodies (``csrc/em_stats.cu``): unmasked calls with
K >= 33 run the register-tiled one on a persistent grid, with the launch
geometry of ``plan_em_tiles``; unmasked calls with K <= 32 the first one, a
point on 1 to 4 lanes (``plan_em_lanes``); masked calls run by parent chunks
over the points sorted by parent (``group_by_parent``, ``plan_parent_chunks``):
the grouped body up to EG_BMAX children a parent, the wide one past it
(``plan_grouped_wide``). K, the mask and the branch alone decide, and each
body counts its launches under its own name (``em_stats``, ``em_stats_tiled``,
``em_stats_masked``, ``em_stats_masked_wide``). Each takes
W [10, K] or the packed table (``em_ref.Packed``) that ``em_step``
(``csrc/em_step.cu``) writes. A fit's
sweep launches the body alone (``em_partials``, ``em_partials_grouped``: the
partial rows, not summed) and then ``em_step``, which sums the rows and runs
the M-step (launch geometry from ``plan_em_step``): two launches and no host
read. ``em_stats`` and ``em_stats_grouped`` add the reduce kernel for their
other callers.

A registration scan builds its tables once, from the level's mixture in one
launch (``reg_tables_of``: ``csrc/reg_tables.cu``) or from W, mu, A6, b3
(``reg_tables``), and its state lives on the card (``new_scan``):
``reg_partials`` (``csrc/reg_stats.cu``,
launch geometry from ``plan_reg_stats``: the lanes body without gating,
tiled with several points a thread where the points fill the card, the
top_k body with a register list up to MAX_TOP_K, the select body past it)
and ``reg_step`` (``csrc/reg_step.cu``) read and write it without a host
sync. ``reg_scan`` launches a whole scan's steps, those two kernels a step,
from one host call (``hgmm_reg_scan``).

The step path (``em_partials``, ``em_partials_grouped``, ``em_step``,
``reg_partials``, ``reg_step``, ``reg_scan``) checks, plans and allocates nothing: the
objects it launches from were checked, planned and given their buffers where
they were made, once a level (``flat_body``, ``group_by_parent``,
``bind_fit``; ``reg_tables_of``, ``new_scan``), or once for rows made
elsewhere (``em_rows``, ``reg_rows``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import itertools

import torch

from hgmm_torch.ops import _build
from hgmm_torch.ops._build import LAUNCHES, check_tensor, count_launch, launch, reset_launches  # noqa: F401
from hgmm_torch.ops.em_ref import (
    COV_TYPES,
    REG_OUT,
    SCAN_DONE,
    SCAN_FLOATS,
    EmFit,
    EmPartials,
    EmStats,
    Packed,
    RegPartials,
    RegScan,
    RegStats,
    pack_table,
)
from hgmm_torch.ops.em_ref import new_scan as em_ref_new_scan
from hgmm_torch.ops.gaussians import MixtureParams
from hgmm_torch.utils import profiling

MAX_K = 2048  # largest K whose tables fit in shared memory
MAX_TOP_K = 32  # largest top_k < K of reg_stats' register bodies (above it the warp select body)
# The masked em_stats by parent chunks (csrc/em_stats.cu:em_stats_grouped_kernel,
# and em_stats_grouped_wide_kernel past EG_BMAX).
EG_BMAX = 8  # largest branch of the grouped body, which holds the children in registers
EG_MAX_PPT = 16  # points a lane in a chunk, at most
EG_TARGET_WARPS = 4  # chunks (warps) an SM the plan aims for
EG_WARPS = 4  # chunks a block, one a warp
# The wide body's shared memory a warp past the parent's rows: the lanes'
# transpose (32 rows of EG_BMAX * 10 + 1) and two floats a point slot.
EGW_WARP_FLOATS = 32 * (EG_BMAX * 10 + 1) + 2 * 32 * EG_MAX_PPT
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
# The tiled lanes body (one lane, RS_TILE_POINTS points a thread): one wave of
# RS_TILE_BLOCKS_PER_SM blocks an SM, as many as its registers let reside
# (the kernel's __launch_bounds__), where that wave's threads get at least
# RS_TILE_MIN_POINTS points each.
RS_TILE_POINTS = 4
RS_TILE_BLOCKS_PER_SM = 1
RS_TILE_MIN_POINTS = 2
RS_CHUNKS = (1, 2, 4, 8, 16)  # chunk sizes of the top_k body (csrc/reg_stats.cu:launch_top_k)
TK_LOGIT = 10  # instructions a logit (9 FMA and an add), in plan_top_k_chunk's cost
TK_STAGE = 5  # instructions an entry of a list insertion, in plan_top_k_chunk's cost
TK_RANDOM = 60  # a stage-2 logit from a row of the point's own (bank conflicts), in the same units
# The top_k body's device counters (int64, the kernel's `counters`): read
# under profiling.tracing() as these counters.
TOPK_COUNTERS = ("reg.topk_points", "reg.topk_rechunks", "reg.topk_fallback_points")
# reg_step (csrc/reg_step.cu) and its plan.
STEP_PASS_ROWS = 16  # partial rows a pass of the block reads (944 floats)
STEP_UNROLL = 16  # passes a block has in flight at once
STEP_CLUSTER = 8  # blocks of one thread block cluster past one batch of passes
# em_step (csrc/em_step.cu) and its plan.
EMS_MAX_WARPS = 16  # a component's warps, at most
EMS_ROWS_A_LANE = 12  # partial rows a lane sums (its loads in flight at once) before the plan adds a warp
EMS_WARPS_PER_SM = 64  # resident warps an SM on the H100

def _check_points(pts4: torch.Tensor) -> int:
    if pts4.dim() != 2 or pts4.shape[0] != 4:
        raise ValueError(f"pts4: expected [4, N], got {tuple(pts4.shape)}")
    check_tensor("pts4", pts4, torch.float32)
    return pts4.shape[1]


def _table(W, device, rows: int | None = None) -> Packed:
    """The packed table of a call: a Packed as given (float32 on the card,
    `rows` rows when given, at least K), or W [>=10, K] packed with `rows`
    rows (K when None)."""
    if isinstance(W, Packed):
        k, wn = W.k, W.wn
        if not 1 <= k <= MAX_K or wn.dim() != 2 or not (rows or k) <= wn.shape[0] or (rows and wn.shape[0] != rows):
            raise ValueError(f"table of shape {tuple(wn.shape)} for K={k}, {rows or k} rows")
        check_tensor("table", wn, torch.float32, (wn.shape[0], 12))
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
    check_tensor("parent", parent, torch.int32, (n,))
    return parent


def _outlier(outlier_logit) -> tuple[int, float]:
    return (0, 0.0) if outlier_logit is None else (1, float(outlier_logit))


@dataclasses.dataclass
class FlatBody:
    """The unmasked em_stats body on a prepared [4, N] buffer, checked and
    planned once (flat_body) and launched by every sweep on it (em_partials):
    the C entry (the register-tiled body from EMT_MIN_K, else the first one)
    and its geometry argument (k_pad, or the first body's lanes), the
    outlier, and the rows em_step reads: `parts` (the body's, one a block)
    and `row` (their sum: a sharded sweep)."""

    pts4: torch.Tensor
    k: int
    entry: str
    geometry: int
    outlier: tuple[int, float]
    parts: EmPartials
    row: EmPartials

    @property
    def name(self) -> str:
        """The launch counter: the C entry without the library's prefix
        (em_stats_tiled, or em_stats for the first body)."""
        return self.entry.removeprefix("hgmm_")


def _rows(partial: torch.Tensor, k: int, n_rows: int, span: int, sms: int, branch: int = 0,
          parent_off: torch.Tensor | None = None) -> EmPartials:
    """Partial rows as em_step reads them: its warps planned with them."""
    return EmPartials(partial, k, n_rows, span, branch, parent_off, plan_em_step(k, span, sms).warps)


def _one_row(k: int, sms: int, device) -> EmPartials:
    """The buffer of a body's rows summed to one [1, K*10 + 1] (em_row)."""
    return _rows(torch.empty((1, k * 10 + 1), dtype=torch.float32, device=device), k, 1, 1, sms)


def flat_body(pts4: torch.Tensor, k: int, outlier_logit=None) -> FlatBody:
    """The unmasked body of K components on pts4: its plan, its blocks (one
    partial row each) and its buffers."""
    n = _check_points(pts4)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    tiles, sms = plan_em_tiles(k), _build.sms(pts4.device)
    if tiles is None:
        lanes = plan_em_lanes(n, k, sms)
        entry, geometry, nb = "hgmm_em_stats", lanes.lanes, lanes.blocks
    else:
        entry, geometry, nb = "hgmm_em_stats_tiled", tiles.k_pad, tiles.blocks(n, sms)
    partial = torch.empty((nb, k * 10 + 1), dtype=torch.float32, device=pts4.device)
    return FlatBody(pts4, k, entry, geometry, _outlier(outlier_logit), _rows(partial, k, nb, nb, sms),
                    _one_row(k, sms, pts4.device))


def em_partials(body: FlatBody, wn: torch.Tensor, out: torch.Tensor | None = None) -> EmPartials:
    """Launch the unmasked body with the table wn [table_rows(K), 12]: its
    partial rows in body.parts, which em_step sums (a fit's sweep), and with
    `out` [K*10 + 1] their sum there by the reduce kernel. Counted as the
    body's name."""
    launch(body.name, body.entry, body.pts4.device, body.pts4.data_ptr(), body.pts4.shape[1], wn.data_ptr(),
           body.k, body.geometry, *body.outlier, body.parts.partial.data_ptr(), body.parts.n_rows,
           None if out is None else out.data_ptr())
    return body.parts


def em_stats(pts4: torch.Tensor, W, outlier_logit=None) -> EmStats:
    """Kernel twin of em_ref.em_stats on a prepared [4, N] buffer: the body
    and the reduce; W is [10, K] or a Packed table (table_rows(K) rows)."""
    k = W.k if isinstance(W, Packed) else W.shape[1]
    body = flat_body(pts4, k, outlier_logit)
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=pts4.device)
    em_partials(body, _table(W, pts4.device, table_rows(k)).wn, out)
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


def _check_on(what: str, dev, named) -> None:
    """check_tensor on each (name, tensor, dtype, shape), each on `dev`."""
    for name, t, dtype, shape in named:
        check_tensor(name, t, dtype, shape)
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, expected on {dev}")


def bind_fit(body, fit: EmFit) -> EmFit:
    """The fit state whose sweeps launch on `body` (a FlatBody or
    ParentGroups) from what this checks once: the parameters, the table,
    logliks, total and cov_floor float32 on the body's card, of its K, and
    the table of the rows the body reads (table_rows(K) for the unmasked
    body, at least K for the grouped one). Returns fit with data = body."""
    k, wn = fit.table.k, fit.table.wn
    rows = wn.shape[0]
    if body.k != k or rows < k or (isinstance(body, FlatBody) and rows != table_rows(k)):
        raise ValueError(f"fit: a table of {rows} rows for K={k}, sweeps of K={body.k}")
    _check_on("fit", body.pts4.device, [
        ("pi", fit.pi, torch.float32, (k,)), ("mu", fit.mu, torch.float32, (k, 3)),
        ("sigma", fit.sigma, torch.float32, (k, 3, 3)), ("table", wn, torch.float32, (rows, 12)),
        ("logliks", fit.logliks, torch.float32, None), ("total", fit.total, torch.float32, ()),
        ("cov_floor", fit.cov_floor, torch.float32, ())])
    return fit._replace(data=body)


def em_rows(parts, fit: EmFit) -> EmPartials:
    """Partial rows made outside a body (EmPartials of either layout, such as
    em_ref.partials_of's one row) as em_step reads them for `fit`: checked
    against it, their warps planned."""
    if not isinstance(parts, EmPartials):
        raise TypeError(f"em_step: expected an em_stats body's EmPartials, got {type(parts).__name__}")
    k = fit.table.k
    dev = fit.table.wn.device
    named = [("partial", parts.partial, torch.float32, (parts.partial.shape[0], (parts.branch or k) * 10 + 1))]
    if parts.branch:
        named.append(("parent_off", parts.parent_off, torch.int32, (-(-k // parts.branch) + 1,)))
    _check_on("em_step", dev, named)
    if parts.k != k or not 0 <= parts.n_rows <= parts.partial.shape[0]:
        raise ValueError(f"em_step: partials of K={parts.k} with {parts.n_rows} rows of "
                         f"{tuple(parts.partial.shape)}, a fit of K={k}")
    return _rows(parts.partial, k, parts.n_rows, parts.span, _build.sms(dev), parts.branch, parts.parent_off)


def em_step(parts: EmPartials, fit: EmFit, it: int, cov_reg: float = 1e-6, cov_type: str = "full") -> None:
    """Kernel twin of em_ref.em_step (csrc/em_step.cu): one launch after an
    em_stats body that sums its partial rows (a body's parts or row, or
    em_rows') and writes the fit's parameters, table and logliks[it] on the
    card from them and the total and cov_floor there, nothing read back.
    `it` indexes the write to logliks, so it is held to the fit's sweeps."""
    wn = fit.table.wn
    if not 0 <= it < fit.logliks.shape[0] or cov_type not in COV_TYPES:
        raise ValueError(f"em_step: sweep {it} of {fit.logliks.shape[0]}, cov_type {cov_type!r}")
    launch("em_step", "hgmm_em_step", wn.device, parts.partial.data_ptr(), parts.n_rows,
           parts.parent_off.data_ptr() if parts.branch else None, parts.branch, fit.total.data_ptr(),
           fit.cov_floor.data_ptr(), fit.table.k, wn.shape[0], float(cov_reg), COV_TYPES.index(cov_type),
           fit.pi.data_ptr(), fit.mu.data_ptr(), fit.sigma.data_ptr(), wn.data_ptr(), fit.logliks.data_ptr(), it,
           parts.warps)


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


@dataclasses.dataclass(frozen=True)
class WidePlan:
    """Launch geometry of the masked E-step past EG_BMAX children
    (csrc/em_stats.cu:em_stats_grouped_wide_kernel): `warps` chunks a block
    and its dynamic shared memory."""

    warps: int
    smem_bytes: int


def plan_grouped_wide(branch: int) -> WidePlan:
    """EG_WARPS warps a block, halved while their shared memory (the
    parent's 3 branch float4 rows and EGW_WARP_FLOATS a warp) passes the
    card's limit; branch > EG_BMAX, at most MAX_K."""
    if not EG_BMAX < branch <= MAX_K:
        raise ValueError(f"plan_grouped_wide: branch {branch} outside ({EG_BMAX}, {MAX_K}]")
    per_warp = 16 * 3 * branch + 4 * EGW_WARP_FLOATS
    warps = EG_WARPS
    while warps > 1 and warps * per_warp > SMEM_LIMIT:
        warps //= 2
    return WidePlan(warps, warps * per_warp)


@dataclasses.dataclass
class ParentGroups:
    """A tree level's points grouped by parent for the masked E-step, built
    once a level (group_by_parent) and reused by every sweep: the live points
    (a parent in range, a nonzero weight) sorted by parent, the chunk table
    and each parent's first chunk on the card, the body's warps a block and
    launch counter, and the rows em_step reads: `parts` (a chunk's each) and
    `row` (their sum: a sharded sweep)."""

    pts4: torch.Tensor  # [4, n_live]
    branch: int
    k: int
    chunk_points: int
    parent_rows: int  # the most chunks of one parent
    chunks: torch.Tensor  # [n_chunks, 3] int32: parent, first point, count
    parent_off: torch.Tensor  # [n_parents + 1] int32
    warps: int  # EG_WARPS, or plan_grouped_wide's past EG_BMAX children
    name: str  # em_stats_masked, or em_stats_masked_wide past EG_BMAX children
    parts: EmPartials  # partial [max(n_chunks, 1), branch*10 + 1]
    row: EmPartials

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
    if not 1 <= k <= MAX_K:
        raise ValueError(f"em_stats_masked: K={k} outside [1, {MAX_K}]")
    n_par = -(-k // branch)
    key = parent.long()
    key = torch.where((key >= 0) & (key < n_par) & (pts4[3] != 0), key, torch.full_like(key, n_par))
    # index_add_, not bincount: bincount on the card reads its maximum back.
    counts = torch.zeros(n_par + 1, dtype=torch.int64, device=key.device).index_add_(
        0, key, torch.ones_like(key))[:n_par].tolist()  # the level's one host read
    order = torch.sort(key, stable=True).indices[: sum(counts)]
    sms = _build.sms(pts4.device)
    size, chunks = plan_parent_chunks(counts, sms)
    wide = branch > EG_BMAX
    off, first = [], 0
    for c in counts:
        off.append(first)
        first += -(-c // size)
    off.append(first)
    # The chunk table and the offsets in one copy from pinned memory, which
    # does not make the host wait.
    host = torch.tensor([v for ch in chunks for v in ch] + off, dtype=torch.int32).pin_memory()
    dev_tab = host.to(pts4.device, non_blocking=True)
    parent_rows = max((b - a for a, b in zip(off, off[1:])), default=0)
    parent_off = dev_tab[3 * len(chunks):]
    partial = torch.empty((max(len(chunks), 1), branch * 10 + 1), dtype=torch.float32, device=pts4.device)
    return ParentGroups(
        pts4=pts4[:, order].contiguous(), branch=branch, k=k, chunk_points=size, parent_rows=parent_rows,
        chunks=dev_tab[: 3 * len(chunks)].view(-1, 3), parent_off=parent_off,
        warps=plan_grouped_wide(branch).warps if wide else EG_WARPS,
        name="em_stats_masked_wide" if wide else "em_stats_masked",
        parts=_rows(partial, k, len(chunks), parent_rows, sms, branch, parent_off),
        row=_one_row(k, sms, pts4.device),
    )


def em_partials_grouped(groups: ParentGroups, wn: torch.Tensor, out: torch.Tensor | None = None) -> EmPartials:
    """Launch the masked body on a level's grouped points with the table wn
    [>= K, 12]: its partial rows in groups.parts (a chunk's each), which
    em_step sums by parent (a fit's sweep), and with `out` [K*10 + 1] their
    sum there by the reduce kernel."""
    launch(groups.name, "hgmm_em_stats_grouped", groups.pts4.device, groups.pts4.data_ptr(),
           groups.pts4.shape[1], wn.data_ptr(), groups.k, groups.branch, groups.chunks.data_ptr(), groups.n_chunks,
           groups.parent_off.data_ptr(), groups.warps, groups.parts.partial.data_ptr(),
           None if out is None else out.data_ptr())
    return groups.parts


def em_stats_grouped(groups: ParentGroups, W) -> EmStats:
    """Kernel twin of em_ref.em_stats_masked on a level's grouped points: the
    body and the reduce; W is [10, K] or a Packed table."""
    k = W.k if isinstance(W, Packed) else W.shape[1]
    if k != groups.k:
        raise ValueError(f"em_stats_masked: W has K={k}, the groups were made for K={groups.k}")
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=groups.pts4.device)
    em_partials_grouped(groups, _table(W, groups.pts4.device).wn, out)
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
    plan = plan_assign(n, parent is not None, _build.sms(pts4.device))
    out = torch.empty((n,), dtype=torch.int32, device=pts4.device)
    launch("assign", "hgmm_assign", pts4.device, pts4.data_ptr(), n, table.wn.data_ptr(), table.k,
           None if parent is None else parent.data_ptr(), branch or 1, plan.blocks, out.data_ptr())
    return out


def reg_stats_body(gate: int, plan: RegPlan) -> str:
    """The launch counter of the reg_stats body a table's gate (_top_k) and
    plan select: "reg_stats" (the lanes body, no gating, a point a thread),
    "reg_stats_tiled" (the same with plan.points > 1 points a thread),
    "reg_stats_top_k" (the register-list body, 1 <= gate <= MAX_TOP_K),
    "reg_stats_select" past it."""
    if not gate:
        return "reg_stats_tiled" if plan.points > 1 else "reg_stats"
    return "reg_stats_top_k" if gate <= MAX_TOP_K else "reg_stats_select"


def _top_k(top_k, k: int) -> int:
    """The kernel's top_k argument: 0 (no gating) for None or top_k >= K,
    else top_k, at least 1."""
    if top_k is None or top_k >= k:
        return 0
    if top_k < 1:
        raise ValueError(f"reg_stats: top_k={top_k} < 1")
    return int(top_k)


@dataclasses.dataclass(frozen=True)
class RegPlan:
    """Launch geometry of reg_stats (csrc/reg_stats.cu): `lanes` lanes of a
    warp share a point and split its K components (the lanes body, at one
    lane with `points` points a thread; 1 with top_k <= MAX_TOP_K, the
    one-thread-a-point top_k body, whose list holds `kmax` chunk maxima of
    `chunk` components each; 32 past it, the select body, a warp a point),
    `blocks` blocks of RS_THREADS threads, grid-stride; one partial row a
    block."""

    lanes: int
    blocks: int
    kmax: int  # 0: no register list (no gating, or the select body)
    chunk: int = 1  # components a list entry stands for (the top_k body; 1 elsewhere)
    points: int = 1  # points a thread takes through its component loop at once (the lanes body at one lane)

    def points_per_block(self) -> int:
        return RS_THREADS // self.lanes


def warp_insertions(chunks: int, kmax: int) -> float:
    """Expected insertions a warp makes into its points' lists of kmax over
    `chunks` chunk maxima in random order: a point inserts its i-th with
    probability min(1, kmax / i), and the warp runs the insertion when any of
    its 32 points does."""
    return sum(1.0 - (1.0 - min(1.0, kmax / i)) ** 32 for i in range(1, chunks + 1))


@functools.lru_cache(maxsize=None)
def plan_top_k_chunk(k: int, top_k: int) -> int:
    """Components a chunk of the top_k body (csrc/reg_stats.cu:
    reg_stats_top_k_kernel), from K and top_k alone: the C of RS_CHUNKS
    whose cost a point, in instructions, is least:

        K (TK_LOGIT + 1) + warp_insertions(K / C, kmax) (TK_STAGE kmax + 1)
        + top_k C (TK_RANDOM + TK_STAGE (kmax - 1)),

    the logits and their chunk maxima, pass 1's insertions into the list of
    kmax (9 for top_k <= 8, else 33), and stage 2's top_k chunks of C logits
    read from rows of the point's own (bank conflicts) with an insertion
    into the list of kmax - 1 each. A C > 1 whose K / C chunks do not fill
    the list is not a candidate; of equal costs the smaller C. The constants
    fit the H100 timings of every C at K = 64 and 512 (PERF.md, the chunk sweeps):
    K = 512 gives 4 at top_k 8 and 32; K = 64 gives 2 at top_k 8, 1 at 32."""
    kmax = 9 if top_k <= 8 else 33

    def cost(c: int) -> float:
        pass1 = k * (TK_LOGIT + 1) + warp_insertions(-(-k // c), kmax) * (TK_STAGE * kmax + 1)
        return pass1 + top_k * c * (TK_RANDOM + TK_STAGE * (kmax - 1))

    return min((c for c in RS_CHUNKS if c == 1 or -(-k // c) >= kmax), key=cost)


def plan_reg_stats(n: int, k: int, top_k, sms: int) -> RegPlan:
    """Lanes a point: 1, doubled up to min(32, K) while the points fill fewer
    than RS_MIN_WARPS_PER_SM warps an SM (the odometry bucket, N = 16,384,
    gets 4); 1 with top_k <= MAX_TOP_K, 32 with a larger top_k < K. The top_k
    body's chunk: plan_top_k_chunk (1 for every other body). Blocks: one a
    RS_THREADS / lanes points, at most RS_BLOCKS_PER_SM an SM. Without a
    gate, at one lane, where one wave of RS_TILE_BLOCKS_PER_SM blocks an SM
    gives each thread RS_TILE_MIN_POINTS points or more (N >= 67,584 on 132
    SMs: the dragon's 437,645 and the KITTI bucket's 131,072), the tiled body:
    RS_TILE_POINTS points a thread, that one wave. Shared memory: the two [K,
    12] tables and the warps' sums, 96 K + 1,408 bytes
    (csrc/reg_stats.cu:reg_stats_smem_bytes; the tiled body's K rounded up
    to 8); the top_k body's reg_top_k_smem_bytes, the select body's
    reg_select_smem_bytes. All inside the card's limit up to MAX_K."""
    if n < 1 or not 1 <= k <= MAX_K or sms < 1:
        raise ValueError(f"reg_stats: N={n}, K={k}, {sms} SMs")
    gate = _top_k(top_k, k)
    if gate > MAX_TOP_K:
        return RegPlan(lanes=32, blocks=max(1, min(-(-n * 32 // RS_THREADS), RS_BLOCKS_PER_SM * sms)), kmax=0)
    lanes, kmax = 1, (0 if not gate else (9 if gate <= 8 else 33))
    while not gate and 2 * lanes <= min(32, k) and n * lanes < RS_MIN_WARPS_PER_SM * sms * 32:
        lanes *= 2
    wave = RS_TILE_BLOCKS_PER_SM * sms
    if not gate and lanes == 1 and n >= RS_TILE_MIN_POINTS * RS_THREADS * wave:
        return RegPlan(lanes=1, blocks=wave, kmax=0, points=RS_TILE_POINTS)
    blocks = max(1, min(-(-n * lanes // RS_THREADS), RS_BLOCKS_PER_SM * sms))
    return RegPlan(lanes=lanes, blocks=blocks, kmax=kmax, chunk=plan_top_k_chunk(k, gate) if gate else 1)


def reg_top_k_smem_bytes(k: int, chunk: int) -> int:
    """Shared memory of reg_stats' top_k body (csrc/reg_stats.cu:
    reg_top_k_smem_bytes): the weight table by chunks of `chunk` rows, each
    padded to an odd number of float4 (3 chunk, plus one when even), the
    [K, 12] aux table and the warps' 44 sums."""
    stride = 3 * chunk + (chunk % 2 == 0)
    return 16 * (-(-k // chunk) * stride + 3 * k) + 4 * (RS_THREADS // 32) * 44


def reg_select_smem_bytes(k: int) -> int:
    """Shared memory of reg_stats' select body (csrc/reg_stats.cu:
    reg_select_smem_bytes): the [K, 12] weight table, each warp's K logits
    and 256-bin histogram, and the warps' 44 sums."""
    warps = RS_THREADS // 32
    return 48 * k + 4 * warps * k + 4 * warps * 256 + 4 * warps * 44


@dataclasses.dataclass
class RegTables:
    """What a registration scan reuses on every iteration, built once: the
    source buffer, the packed weights wn and aux = [mu | A6 | b3] ([K, 12]
    each), the gate, the outlier, the launch plan, the launch counter of the
    body the gate selects, the rows reg_step reads (`rows`, a block's each;
    `row`, their sum: a sharded scan step) and, for the top_k body inside
    profiling.tracing(), its counters."""

    pts4: torch.Tensor
    wn: torch.Tensor
    aux: torch.Tensor
    gate: int
    outlier: tuple[int, float]
    plan: RegPlan
    body: str
    rows: RegPartials
    row: RegPartials
    counters: torch.Tensor | None = None  # the top_k body's TOPK_COUNTERS, under profiling.tracing()

    @property
    def k(self) -> int:
        return self.wn.shape[0]


def _reg_tables(pts4, n: int, wn, aux, top_k, outlier_logit) -> RegTables:
    k = wn.shape[0]
    plan = plan_reg_stats(n, k, top_k, _build.sms(pts4.device))
    counters = None
    if plan.kmax and profiling.tracer is not None:
        # Summed on the card over every launch with these tables, read once
        # by the tracer's summary().
        counters = torch.zeros(len(TOPK_COUNTERS), dtype=torch.int64, device=pts4.device)
        for i, name in enumerate(TOPK_COUNTERS):
            profiling.count_later(name, counters, i)
    gate = _top_k(top_k, k)
    f32 = dict(dtype=torch.float32, device=pts4.device)
    return RegTables(pts4, wn, aux, gate, _outlier(outlier_logit), plan, reg_stats_body(gate, plan),
                     reg_rows(torch.empty((plan.blocks, REG_OUT), **f32)),
                     reg_rows(torch.empty((1, REG_OUT), **f32)), counters)


def reg_tables(pts4, W, mu, A6, b3, top_k=None, outlier_logit=None) -> RegTables:
    """A scan's RegTables from W [10, K] (or a Packed table) and model_terms'
    mu, A6 and b3: wn packed and aux = [mu | A6 | b3] by torch ops."""
    n = _check_points(pts4)
    dev = pts4.device
    wn = _table(W, dev).wn
    f32 = dict(dtype=torch.float32, device=dev)
    aux = torch.cat([mu.to(**f32), A6.to(**f32), b3.to(**f32)], dim=1).contiguous()
    check_tensor("aux", aux, torch.float32, (wn.shape[0], 12))
    return _reg_tables(pts4, n, wn, aux, top_k, outlier_logit)


def reg_tables_of(pts4, params: MixtureParams, top_k=None, outlier_logit=None) -> RegTables:
    """A scan's RegTables from the mixture itself (pi [K], mu [K, 3], sigma
    [K, 3, 3], float32 and contiguous on the points' card): wn and aux written
    by one launch of csrc/reg_tables.cu, the float64 twin of em_ref.model_terms,
    then pack_table of W and the cat of [mu | A6 | b3]; nothing read back."""
    k = params.k
    if not 1 <= k <= MAX_K:
        raise ValueError(f"reg_tables: K={k} outside [1, {MAX_K}]")
    shapes = {"pi": (k,), "mu": (k, 3), "sigma": (k, 3, 3)}
    for (name, shape), t in zip(shapes.items(), params):
        if tuple(t.shape) != shape:
            raise ValueError(f"reg_tables: {name} of shape {tuple(t.shape)}, expected {shape}")
    n = _check_points(pts4)
    dev = pts4.device
    _check_on("reg_tables", dev, [(name, t, torch.float32, shape) for (name, shape), t in zip(shapes.items(), params)])
    wn = torch.empty((k, 12), dtype=torch.float32, device=dev)
    aux = torch.empty((k, 12), dtype=torch.float32, device=dev)
    launch("reg_tables", "hgmm_reg_tables", dev, params.pi.data_ptr(), params.mu.data_ptr(), params.sigma.data_ptr(),
           k, wn.data_ptr(), aux.data_ptr())
    return _reg_tables(pts4, n, wn, aux, top_k, outlier_logit)


def reg_partials(tab: RegTables, pose12: torch.Tensor, done: torch.Tensor | None = None,
                 out: torch.Tensor | None = None) -> RegPartials:
    """Launch reg_stats at the pose pose12 [12] (R row-major, t; float32 on
    the tables' card): the partials in tab.rows (and their sum in `out` [59]
    when given). With `done` (a float32 flag on the card) the kernel returns
    at once when it is set."""
    launch(tab.body, "hgmm_reg_stats", tab.pts4.device, tab.pts4.data_ptr(), tab.pts4.shape[1], pose12.data_ptr(),
           None if done is None else done.data_ptr(), tab.wn.data_ptr(), tab.aux.data_ptr(), tab.k, tab.gate,
           tab.plan.lanes, tab.plan.points, tab.plan.chunk, *tab.outlier, tab.rows.partial.data_ptr(), tab.plan.blocks,
           None if tab.counters is None else tab.counters.data_ptr(), None if out is None else out.data_ptr())
    return tab.rows


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


class CardScan(RegScan):
    """A RegScan checked once for the tables it steps on (scan_of), and
    `flag`, the one-float view of its done flag that reg_stats reads."""

    flag: torch.Tensor


def scan_of(tab: RegTables, state: torch.Tensor, logliks: torch.Tensor, deltas: torch.Tensor) -> CardScan:
    """A scan's state (state [SCAN_FLOATS], logliks and deltas [n_iters])
    for the tables `tab`: float32 and contiguous on the tables' card."""
    _check_on("scan", tab.pts4.device, [("state", state, torch.float32, (SCAN_FLOATS,)),
                                        ("logliks", logliks, torch.float32, None),
                                        ("deltas", deltas, torch.float32, tuple(logliks.shape))])
    scan = CardScan(state, logliks, deltas)
    scan.flag = state[SCAN_DONE:SCAN_DONE + 1]
    return scan


def new_scan(tab: RegTables, R: torch.Tensor, t: torch.Tensor, n_iters: int) -> CardScan:
    """em_ref.new_scan in float32 for the tables `tab` (scan_of: the pose on
    their card)."""
    return scan_of(tab, *em_ref_new_scan(R, t, n_iters, dtype=torch.float32))


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


def reg_rows(partial: torch.Tensor) -> RegPartials:
    """reg_stats rows [nb, 59] (float32 on the card, 16-byte aligned: the
    kernel reads float4) as reg_step reads them, the step's cluster planned:
    a table's buffers, or rows made elsewhere."""
    if partial.dim() != 2 or partial.shape[1] != REG_OUT:
        raise ValueError(f"reg_step: partial of shape {tuple(partial.shape)}, expected [nb, {REG_OUT}]")
    check_tensor("partial", partial, torch.float32)
    if partial.data_ptr() % 16:
        raise ValueError("reg_step: the partial rows must start on a 16-byte boundary (the kernel reads float4)")
    return RegPartials(partial, plan_reg_step(partial.shape[0]))


def reg_step(rows: RegPartials, scan: RegScan, it: int, solver: int, first: bool, last: bool,
             tol: float) -> None:
    """Kernel twin of em_ref.reg_step (csrc/reg_step.cu) on a table's rows or
    reg_rows': one launch, the scan state updated in place on the card,
    nothing read back. `it` indexes the writes to logliks and deltas, so it
    is held to the scan's iterations."""
    if not 0 <= it < scan.logliks.shape[0] or solver not in (0, 1):
        raise ValueError(f"reg_step: iteration {it} of {scan.logliks.shape[0]}, solver {solver}")
    launch("reg_step", "hgmm_reg_step", rows.partial.device, rows.partial.data_ptr(), rows.partial.shape[0],
           scan.state.data_ptr(), scan.logliks.data_ptr(), scan.deltas.data_ptr(), it, solver, int(first), int(last),
           float(tol), rows.cluster)


@functools.lru_cache(maxsize=64)
def _schedule_rows(steps: tuple) -> ctypes.Array:
    """A scan's steps (pipelines/register.py:scan_schedule) as hgmm_reg_scan
    reads them: [steps, 4] ints on the host, a step's (it, solver, first,
    last)."""
    return (ctypes.c_int * (4 * len(steps)))(*map(int, itertools.chain.from_iterable(steps)))


def reg_scan(tab: RegTables, scan: RegScan, steps: tuple, tol: float) -> None:
    """A scan's steps on its state, in place, from one host call
    (csrc/reg_stats.cu:hgmm_reg_scan): for each (it, solver, first, last) of
    `steps` the reg_partials launch and then the reg_step launch on the
    table's rows that the two wrappers would make, in the same order, on the
    current stream, nothing read back. After the call the launches count as
    the wrappers count theirs (tab.body and reg_step, a step each), and the
    steps as reg.native_steps; a nonzero code raises with its step's index
    and counts nothing."""
    if not steps:
        return
    if steps[0][0] < 0 or steps[-1][0] >= scan.logliks.shape[0]:
        raise ValueError(f"reg_scan: iterations {steps[0][0]}..{steps[-1][0]} of {scan.logliks.shape[0]}")
    failed = ctypes.c_int(-1)
    _build.call("reg_scan", "hgmm_reg_scan", tab.pts4.device, tab.pts4.data_ptr(), tab.pts4.shape[1],
                scan.state.data_ptr(), tab.wn.data_ptr(), tab.aux.data_ptr(), tab.k, tab.gate, tab.plan.lanes,
                tab.plan.points, tab.plan.chunk, *tab.outlier, tab.rows.partial.data_ptr(), tab.plan.blocks,
                None if tab.counters is None else tab.counters.data_ptr(), scan.logliks.data_ptr(),
                scan.deltas.data_ptr(), float(tol), tab.rows.cluster, _schedule_rows(steps), len(steps),
                ctypes.byref(failed), failed_step=failed)
    count_launch(tab.body, len(steps))
    count_launch("reg_step", len(steps))
    profiling.count("reg.native_steps", len(steps))
