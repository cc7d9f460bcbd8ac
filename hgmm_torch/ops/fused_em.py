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

``em_stats`` has two kernel bodies (``csrc/em_stats.cu``): unmasked calls with
K >= 64 run the register-tiled one on a persistent grid, with the launch
geometry of ``plan_em_tiles``; every masked call and K < 64 run the first
one. K and the mask alone decide, here.
"""

from __future__ import annotations

import dataclasses

import torch

from hgmm_torch.ops import _build
from hgmm_torch.ops.em_ref import NEG_INF, EmStats, RegStats

TILE = 256  # points per block tile; csrc/hgmm_kernels.cuh:TILE
MAX_BLOCKS = 1024  # cap of the grid (and of the partial-sum rows)
MAX_K = 2048  # largest K whose tables fit in shared memory
MAX_TOP_K = 32  # largest top_k < K that reg_stats gates (csrc/reg_stats.cu)
# The register-tiled em_stats kernel (csrc/em_stats.cu:em_stats_tiled_kernel).
EMT_THREADS = 256
EMT_PT = 8  # points a thread
EMT_CT = 8  # components a thread
EMT_MIN_K = 64  # below it the call is bound by bytes and the launch: the first kernel body
SMEM_LIMIT = 232_448  # bytes of shared memory a block can use on the H100 (227 KB)

# Kernel launches by wrapper, for showing that a run went through the kernels
# (ops/knn.py and ops/probes.py count their kernels here too).
LAUNCHES = {"em_stats": 0, "em_stats_masked": 0, "assign": 0, "reg_stats": 0, "knn": 0,
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
    """The tile plan of an em_stats call, or None where the first kernel body
    (one thread a point, then threads per component) runs: every masked call
    and K < EMT_MIN_K. The choice depends on K and the mask alone."""
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


def _em_stats(pts4, W, parent, branch, outlier_logit, counter) -> EmStats:
    n = _check_points(pts4)
    k = W.shape[1]
    plan = plan_em_tiles(k, masked=parent is not None)
    wn = _pack_w(W, pts4.device, None if plan is None else plan.k_pad)
    if plan is None:
        nb = _n_blocks(n)
    else:
        nb = plan.blocks(n, torch.cuda.get_device_properties(pts4.device).multi_processor_count)
    partial = torch.empty((nb, k * 10 + 1), dtype=torch.float32, device=pts4.device)
    out = torch.empty((k * 10 + 1,), dtype=torch.float32, device=pts4.device)
    has_out, out_l = _outlier(outlier_logit)
    with torch.cuda.device(pts4.device):
        if plan is None:
            err = _build.load().hgmm_em_stats(
                pts4.data_ptr(), n, wn.data_ptr(), k, None if parent is None else parent.data_ptr(),
                branch or 1, has_out, out_l, partial.data_ptr(), nb, out.data_ptr(), _stream(pts4),
            )
        else:
            err = _build.load().hgmm_em_stats_tiled(
                pts4.data_ptr(), n, wn.data_ptr(), k, plan.k_pad, has_out, out_l,
                partial.data_ptr(), nb, out.data_ptr(), _stream(pts4),
            )
    _raise_on(err, counter)
    LAUNCHES[counter] += 1
    return EmStats(S=out[: k * 10].view(k, 10), loglik=out[k * 10])


def em_stats(pts4: torch.Tensor, W: torch.Tensor, outlier_logit=None) -> EmStats:
    """Kernel twin of em_ref.em_stats on a prepared [4, N] buffer."""
    return _em_stats(pts4, W, None, None, outlier_logit, "em_stats")


def em_stats_masked(pts4: torch.Tensor, W: torch.Tensor, parent: torch.Tensor, branch: int) -> EmStats:
    """Kernel twin of em_ref.em_stats_masked; parent [N] (int), -1 = none."""
    parent = _parent(parent, pts4.shape[1], branch)
    return _em_stats(pts4, W, parent, branch, None, "em_stats_masked")


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


def reg_stats(pts4, W, mu, A6, b3, pose, top_k=None, outlier_logit=None) -> RegStats:
    """Kernel twin of em_ref.reg_stats: the pose (R, t) is applied in the
    kernel, so the source buffer is read as it is on every iteration."""
    n = _check_points(pts4)
    dev = pts4.device
    wn = _pack_w(W, dev)
    k = wn.shape[0]
    gate = _top_k(top_k, k)
    f32 = dict(dtype=torch.float32, device=dev)
    aux = torch.cat([mu.to(**f32), A6.to(**f32), b3.to(**f32)], dim=1).contiguous()
    _check("aux", aux, torch.float32, (k, 12))
    R, t = pose
    pose12 = torch.cat([R.reshape(9).to(**f32), t.reshape(3).to(**f32)]).contiguous()
    nb = _n_blocks(n)
    partial = torch.empty((nb, 59), **f32)
    out = torch.empty((59,), **f32)
    has_out, out_l = _outlier(outlier_logit)
    with torch.cuda.device(dev):
        err = _build.load().hgmm_reg_stats(
            pts4.data_ptr(), n, pose12.data_ptr(), wn.data_ptr(), aux.data_ptr(), k, gate,
            has_out, out_l, partial.data_ptr(), nb, out.data_ptr(), _stream(pts4),
        )
    _raise_on(err, "reg_stats")
    LAUNCHES["reg_stats"] += 1
    return RegStats(
        horn=out[:16].view(4, 4), A=out[16:52].view(6, 6), b=out[52:58], loglik=out[58]
    )
