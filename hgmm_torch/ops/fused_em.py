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
K >= 64 run the register-tiled one on a persistent grid, with the launch
geometry of ``plan_em_tiles``; unmasked calls with K < 64 the first one;
masked calls run by parent chunks over the points sorted by parent
(``group_by_parent``, ``plan_parent_chunks``). K and the mask alone decide.

A registration scan builds its tables once (``reg_tables``), and its state
lives on the card (``new_scan``): ``reg_partials`` (``csrc/reg_stats.cu``,
launch geometry from ``plan_reg_stats``) and ``reg_step``
(``csrc/reg_step.cu``) read and write it without a host sync.
"""

from __future__ import annotations

import dataclasses

import torch

from hgmm_torch.ops import _build
from hgmm_torch.ops.em_ref import NEG_INF, REG_OUT, SCAN_FLOATS, EmStats, RegScan, RegStats
from hgmm_torch.ops.em_ref import new_scan as em_ref_new_scan

TILE = 256  # points per block tile; csrc/hgmm_kernels.cuh:TILE
MAX_BLOCKS = 1024  # cap of the grid (and of the partial-sum rows)
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
EMT_MIN_K = 64  # below it the call is bound by bytes and the launch: the first kernel body
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100 (227 KB)
# reg_stats (csrc/reg_stats.cu) and its plan.
RS_THREADS = 256
RS_MIN_WARPS_PER_SM = 8  # below it the plan gives a point more lanes
RS_BLOCKS_PER_SM = 4  # cap of the grid, so of the partial rows

# Kernel launches by wrapper, for showing that a run went through the kernels
# (ops/knn.py and ops/probes.py count their kernels here too).
LAUNCHES = {"em_stats": 0, "em_stats_masked": 0, "assign": 0, "reg_stats": 0, "reg_step": 0, "knn": 0,
            "probe_logits": 0, "probe_addonly": 0, "probe_stats": 0, "probe_norm": 0,
            "probe_vpu": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def _pack_w(W: torch.Tensor, device, rows: int | None = None) -> torch.Tensor:
    """W [>=10, K] -> [rows, 12] f32 (rows = K unless given): row j < K is
    -1/2 W[:, j] with two zero columns; a row past K has zero weights and its
    bias at the mask floor, so its logit is the floor for every point."""
    k = W.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K={k} outside [1, {MAX_K}]")
    wn = torch.zeros((rows or k, 12), dtype=torch.float32, device=device)
    wn[:k, :10] = -0.5 * W[:10].T.to(device=device, dtype=torch.float32)
    wn[k:, 9] = NEG_INF
    return wn


def _n_blocks(n: int) -> int:
    return max(1, min(MAX_BLOCKS, -(-n // TILE)))


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
    K < EMT_MIN_K (the first body, one thread a point, then threads per
    component) and every masked call (em_stats_grouped). The choice depends
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


def em_stats(pts4: torch.Tensor, W: torch.Tensor, outlier_logit=None) -> EmStats:
    """Kernel twin of em_ref.em_stats on a prepared [4, N] buffer."""
    n = _check_points(pts4)
    k = W.shape[1]
    plan = plan_em_tiles(k)
    wn = _pack_w(W, pts4.device, None if plan is None else plan.k_pad)
    nb = _n_blocks(n) if plan is None else plan.blocks(n, _sms(pts4.device))
    partial = torch.empty((nb, k * 10 + 1), dtype=torch.float32, device=pts4.device)
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=pts4.device)
    has_out, out_l = _outlier(outlier_logit)
    with torch.cuda.device(pts4.device):
        if plan is None:
            err = _build.load().hgmm_em_stats(
                pts4.data_ptr(), n, wn.data_ptr(), k, has_out, out_l, partial.data_ptr(), nb,
                out.data_ptr(), _stream(pts4),
            )
        else:
            err = _build.load().hgmm_em_stats_tiled(
                pts4.data_ptr(), n, wn.data_ptr(), k, plan.k_pad, has_out, out_l,
                partial.data_ptr(), nb, out.data_ptr(), _stream(pts4),
            )
    _raise_on(err, "em_stats")
    LAUNCHES["em_stats"] += 1
    return EmStats(S=out[: k * 10].view(k, 10), loglik=out[k * 10])


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
        chunks=dev_tab[: 3 * len(chunks)].view(-1, 3), parent_off=dev_tab[3 * len(chunks):],
        partial=torch.empty((max(len(chunks), 1), branch * 10 + 1), dtype=torch.float32,
                            device=pts4.device),
    )


def em_stats_grouped(groups: ParentGroups, W: torch.Tensor) -> EmStats:
    """Kernel twin of em_ref.em_stats_masked on a level's grouped points."""
    k = W.shape[1]
    if k != groups.k:
        raise ValueError(f"em_stats_masked: W has K={k}, the groups were made for K={groups.k}")
    wn = _pack_w(W, groups.pts4.device)
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=groups.pts4.device)
    with torch.cuda.device(groups.pts4.device):
        err = _build.load().hgmm_em_stats_grouped(
            groups.pts4.data_ptr(), groups.pts4.shape[1], wn.data_ptr(), k, groups.branch,
            groups.chunks.data_ptr(), groups.n_chunks, groups.parent_off.data_ptr(),
            groups.partial.data_ptr(), out.data_ptr(), _stream(groups.pts4),
        )
    _raise_on(err, "em_stats_masked")
    LAUNCHES["em_stats_masked"] += 1
    return EmStats(S=out[: k * 10].view(k, 10), loglik=out[k * 10])


def em_stats_masked(pts4: torch.Tensor, W: torch.Tensor, parent: torch.Tensor, branch: int) -> EmStats:
    """Kernel twin of em_ref.em_stats_masked; parent [N] (int), -1 = none.
    Groups the points first (one device-to-host copy); a loop of sweeps on
    one assignment groups once (group_by_parent) and calls em_stats_grouped."""
    return em_stats_grouped(group_by_parent(pts4, parent, branch, W.shape[1]), W)


def assign(pts4: torch.Tensor, W: torch.Tensor, parent=None, branch=None) -> torch.Tensor:
    """Kernel twin of em_ref.assign: [N] int32 argmax component."""
    n = _check_points(pts4)
    wn = _pack_w(W, pts4.device)
    if parent is not None:
        parent = _parent(parent, n, branch)
    out = torch.empty((n,), dtype=torch.int32, device=pts4.device)
    with torch.cuda.device(pts4.device):
        err = _build.load().hgmm_assign(
            pts4.data_ptr(), n, wn.data_ptr(), wn.shape[0],
            None if parent is None else parent.data_ptr(), branch or 1, _n_blocks(n),
            out.data_ptr(), _stream(pts4),
        )
    _raise_on(err, "assign")
    LAUNCHES["assign"] += 1
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
    wn = _pack_w(W, dev)
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
    LAUNCHES["reg_stats"] += 1
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
    with torch.cuda.device(partial.device):
        err = _build.load().hgmm_reg_step(
            partial.data_ptr(), partial.shape[0], scan.state.data_ptr(), scan.logliks.data_ptr(),
            scan.deltas.data_ptr(), it, solver, int(first), int(last), float(tol), _stream(partial),
        )
    _raise_on(err, "reg_step")
    LAUNCHES["reg_step"] += 1
