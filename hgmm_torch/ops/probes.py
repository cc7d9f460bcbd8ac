"""Unit-rate probes: the E-step's matrix shapes and its exp2 chain, each alone.

Counterpart of the Pallas bodies of ``benchmarks/mxu_microbench.py``
(``_logits_kernel``, ``_addonly_kernel``, ``_stats_kernel``, ``_norm_kernel``)
and ``benchmarks/vpu_microbench.py`` (``_kernel``). Every probe repeats one
body ``steps * reps`` times and returns its accumulator:

    logits   out[K,T] += (wt[K,80] + eps_r) @ phi[80,T]
    stats    out[32,K] += (phi32[32,T] + eps_r) @ e[K,T]^T
    norm     out[8,T]  += (ones[8,K] + eps_r) @ e[K,T]
    addonly  acc = x; acc += x + eps_r                  (float32)
    vpu      x <- -f32(bf16(exp2(x)))  or  x <- -f32(bf16(x))

with r the iteration modulo ``reps`` and eps_r = 1e-6 (r + 1) rounded to the
operand's type. ``logits`` and ``stats`` take bfloat16 operands (the TPU
bodies' arithmetic: tensor cores, float32 accumulate) or float32 operands
(float32 FMAs, what the port's E-step kernels execute); ``norm`` is bfloat16.

Dispatch is by device, as in ``hgmm_torch.ops``: CPU tensors run the plain
versions (``*_ref``), CUDA tensors launch the hand-written kernels of
``csrc/probes.cu`` (``*_cuda``) or raise. The launch geometry is chosen here
(``plan_*``, from the card's SM count ``sms``), so that the grid fills the
card where the shape allows it, and passed to the kernels. The bf16 logits,
stats and norm kernels run on the warpgroup tensor cores (``wgmma``); their
plans pick the tile by shape (``_pick_tile``, ``plan_norm``). The vpu kernel
runs up to four
independent chains a thread and spreads the elements over the SMs
(``plan_vpu``); ``vpu_sass_counts`` reads what a step of its chain issues.
The addonly kernel takes four float4 a thread over a grid of whole waves
(``plan_addonly``); ``addonly_sass_counts`` reads the adds a rep issues.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from hgmm_torch.ops import _build
from hgmm_torch.ops.fused_em import LAUNCHES, _check, _raise_on, _stream, count_launch  # noqa: F401

DEPTH = 80  # contraction depth of the logits product (csrc/probes.cu:DEPTH)
MAX_REPS = 64  # csrc/probes.cu:MAX_REPS

PROBES = ("probe_logits", "probe_addonly", "probe_stats", "probe_norm", "probe_vpu")


def eps_table(reps: int, dtype: torch.dtype, device=None) -> torch.Tensor:
    """eps_r = 1e-6 (r + 1) for r < reps, rounded to `dtype` (to nearest
    even, as ``jnp.bfloat16(1e-6 * (r + 1))`` rounds)."""
    eps = torch.tensor([1e-6 * (r + 1) for r in range(reps)], dtype=torch.float64)
    return eps.to(torch.float32).to(dtype).to(device)


@functools.lru_cache(maxsize=None)
def _eps_on_card(reps: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """eps_table on the card, made once: the copy from a host tensor waits for
    the stream (made on every call it would hold each launch back until the
    previous kernel ends) and cannot be captured in a CUDA graph (the
    microbenchmarks time the probes' calls from one)."""
    return eps_table(reps, dtype, device)


# --------------------------------------------------------------------------
# plain versions


def _accumulate(acc: torch.Tensor, terms, steps: int) -> torch.Tensor:
    """acc + the terms, one after the other, `steps` times over (float32,
    in the kernels' order)."""
    for _ in range(steps):
        for d in terms:
            acc = acc + d
    return acc


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation; bfloat16 products are exact in float32."""
    return a.to(torch.float32) @ b.to(torch.float32)


def _products(a, b, reps, transpose_b=False):
    eps = eps_table(reps, a.dtype, a.device)
    bb = b.T if transpose_b else b
    return [_matmul_f32(a + eps[r], bb) for r in range(reps)]


def logits_ref(wt: torch.Tensor, phi: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """[K, T] f32: steps times the reps products (wt + eps_r) @ phi, the add
    in wt's type, summed in float32."""
    out = torch.zeros((wt.shape[0], phi.shape[1]), dtype=torch.float32, device=wt.device)
    return _accumulate(out, _products(wt, phi, reps), steps)


def stats_ref(phi32: torch.Tensor, e: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """[32, K] f32: the products (phi32 + eps_r) @ e^T."""
    out = torch.zeros((phi32.shape[0], e.shape[0]), dtype=torch.float32, device=e.device)
    return _accumulate(out, _products(phi32, e, reps, transpose_b=True), steps)


def norm_ref(ones: torch.Tensor, e: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """[8, T] f32: the products (ones + eps_r) @ e."""
    out = torch.zeros((ones.shape[0], e.shape[1]), dtype=torch.float32, device=e.device)
    return _accumulate(out, _products(ones, e, reps), steps)


def addonly_ref(x: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """x + the steps * reps terms (x + eps_r), float32."""
    eps = eps_table(reps, torch.float32, x.device)
    return _accumulate(x.clone(), [x + eps[r] for r in range(reps)], steps)


def vpu_ref(x: torch.Tensor, steps: int, reps: int, mode: str = "exp2") -> torch.Tensor:
    """The chain of steps * reps iterations x <- -f32(bf16(exp2(x))) (mode
    "exp2") or x <- -f32(bf16(x)) (mode "cast")."""
    _check_mode(mode)
    for _ in range(steps * reps):
        y = torch.exp2(x) if mode == "exp2" else x
        x = -(y.to(torch.bfloat16).to(torch.float32))
    return x


def _check_mode(mode: str) -> None:
    if mode not in ("exp2", "cast"):
        raise ValueError(f"vpu: mode {mode!r} is neither 'exp2' nor 'cast'")


# --------------------------------------------------------------------------
# launch geometry


@dataclasses.dataclass(frozen=True)
class Plan:
    grid: tuple[int, int]  # blocks along the sliced axes
    threads: int  # threads a block
    tile: int  # the kernel's slice argument (columns of T a block; nk for norm)
    partials: int  # rows of the partial-sum scratch (0: the kernel writes `out`)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


# The bf16 bodies' tiles (csrc/probes.cu). logits: N, the columns of T a
# block of one warpgroup (probe_logits_bf16_kernel<N>: its accumulator, two
# products in flight, wt and two A sets are 1.5 N + 60 registers a thread, so
# N = 128 would pass 255 with the addresses). stats: (D, G), the T slice of a
# block and its warpgroups, one 64-row slice of K each, which share the
# block's B tiles (probe_stats_bf16_kernel<D, G>; G = 2 needs D = 64 for a
# whole 16-byte chunk a thread). norm: (D, G), the K slice of a block and its
# warpgroups, one 64-row tile of T each, which share the block's B tiles
# (probe_norm_bf16_kernel<D, G>: D divides 128 G).
LOGITS_N = (64, 32)
STATS_TILES = ((64, 1), (32, 1), (64, 2))
NORM_TILES = ((64, 2), (32, 2))
# A grid fills the card when its blocks leave at most this share of the SMs
# idle: one block a warpgroup more or less changes little, a wider tile a lot
# (on an H100, 128 blocks of 64 x 64 beat 256 of 64 x 32 for stats, and 128
# norm blocks of (64, 2) beat 256 of (64, 1) or (32, 2): PERF.md section 6).
FILL = 7 / 8


def _pick_tile(cands, t: int, k: int, sms: int, weight=lambda g: 1.0) -> tuple[int, int]:
    """The tile (w, g) of a grid of (t / w) x (k / 64 g) blocks, each g
    warpgroups over w columns of T: a block's tensor work is proportional to
    w g, so the busiest SM takes ceil(blocks / sms) w g, times weight(g) for
    what else its warpgroups wait on; the least of that among the tiles whose
    grid fills the card (all tiles where none does), ties to the larger tile
    (fewer fixed costs a rep)."""
    fits = [(w, g) for w, g in cands if t % w == 0 and k % (64 * g) == 0]
    blocks = {c: (t // c[0]) * (k // (64 * c[1])) for c in fits}
    full = [c for c in fits if blocks[c] >= FILL * sms] or fits
    return min(full, key=lambda c: (-(-blocks[c] // sms) * c[0] * c[1] * weight(c[1]),
                                    -c[0] * c[1], -c[0]))


def stats_weight(g: int) -> float:
    """What a stats or norm warpgroup's tensor work waits on besides itself,
    in its B reads: the block's fenced stores of each B tile, which its g
    warpgroups share (both bodies store 128 rows of B a step)."""
    return 1.0 + 1.0 / g


def plan_logits(k: int, t: int, f32: bool, sms: int) -> Plan:
    if f32:
        _need(k % 16 == 0 and t % 128 == 0, f"logits f32: K={k} % 16 and T={t} % 128 must be 0")
        return Plan((t // 128, k // 16), 128, 128, 0)
    _need(k % 64 == 0 and t % 32 == 0, f"logits bf16: K={k} % 64 and T={t} % 32 must be 0")
    n, _ = _pick_tile([(n, 1) for n in LOGITS_N], t, k, sms)
    return Plan((t // n, k // 64), 128, n, 0)


def plan_stats(k: int, t: int, f32: bool, sms: int) -> Plan:
    if f32:
        _need(k % 32 == 0 and t % 32 == 0, f"stats f32: K={k} % 32 and T={t} % 32 must be 0")
        threads = next(c for c in (128, 96, 64, 32) if k % c == 0)
        return Plan((t // 32, k // threads), threads, 32, t // 32)
    _need(k % 64 == 0 and t % 32 == 0, f"stats bf16: K={k} % 64 and T={t} % 32 must be 0")
    d, g = _pick_tile(STATS_TILES, t, k, sms, stats_weight)
    return Plan((t // d, k // (64 * g)), 128 * g, d, t // d)


def plan_norm(k: int, t: int, sms: int) -> Plan:
    """The norm tile (D, G) of a grid of ceil(T / 64 G) x (K / D) blocks,
    weighed as _pick_tile weighs stats' (a block's tensor work is D G, its B
    stores stats_weight(G)), T's last 64-row tile possibly partial; the
    plan's tile is D."""
    _need(k % 64 == 0 and t % 16 == 0, f"norm: K={k} % 64 and T={t} % 16 must be 0")
    blocks = {(d, g): -(-t // (64 * g)) * (k // d) for d, g in NORM_TILES}
    full = [c for c in NORM_TILES if blocks[c] >= FILL * sms] or list(NORM_TILES)
    d, g = min(full, key=lambda c: (-(-blocks[c] // sms) * c[0] * c[1] * stats_weight(c[1]),
                                    -c[0] * c[1], -c[0]))
    return Plan((-(-t // (64 * g)), k // d), 128 * g, d, k // d)


@dataclasses.dataclass(frozen=True)
class VpuPlan:
    chains: int  # independent chains a thread (probe_vpu_kernel<E, K>: K)
    blocks: int  # block b takes the elements [b n / blocks, (b + 1) n / blocks)
    threads: int  # threads a block, 32 * chains elements a warp


VPU_CHAINS = (4, 2, 1)  # the K the kernel is built for (csrc/probes.cu:hgmm_probe_vpu)
VPU_THREADS = 1024  # the most threads a block


def plan_vpu(n: int, sms: int) -> VpuPlan:
    """The vpu launch for n elements on `sms` SMs: blocks a whole multiple
    of the SMs (one block an SM where 1,024 threads hold its share), the
    elements spread over them within one, each block's warps on runs of 32 K
    consecutive elements. K is the most chains a thread that still leaves
    each of an SM's four warp schedulers a warp; fewer blocks where n is
    small (at least 32 elements a block)."""
    _need(n >= 1 and sms >= 1, f"vpu: n={n} and sms={sms} must be >= 1")
    per_sm = -(-n // sms)
    chains = next((k for k in VPU_CHAINS if -(-per_sm // (32 * k)) >= 4), VPU_CHAINS[-1])
    blocks = min(sms * -(-per_sm // (VPU_THREADS * chains)), -(-n // 32))
    size = -(-n // blocks)  # the largest block's elements
    threads = 32 * -(-size // (32 * chains))
    return VpuPlan(chains, blocks, threads)


# What a step of the vpu chain issues (csrc/probes.cu:vpu_step), by the SASS
# opcode's prefix; the rest counts as "other".
VPU_SASS_KINDS = {
    "exp2": ("MUFU.EX2",),
    "convert_f2f": ("F2F.",),  # the single convert: the quarter-rate path
    "convert_f2fp": ("F2FP.",),  # the packed convert
    "upcast": ("PRMT", "SHF", "IMAD.U32", "IMAD.SHL", "LOP3"),
    "exp2f_fixup": ("FSETP", "FMUL", "FSEL"),
    "negate": ("FADD",),
    "loop": ("VIADD", "IADD3", "ISETP", "BRA", "IMAD.MOV", "MOV", "PLOP3"),
}
VPU_CONVERTS = 1  # conversions an element and step the design issues: one F2FP, no F2F


def vpu_sass_counts(loops: list[dict[str, int]]) -> dict[str, float]:
    """Instructions an element and step by kind (VPU_SASS_KINDS) in the
    busiest loop of a probe_vpu kernel (``_build.sass_loops``): the loop with
    the most steps a trip, counted by its exp2s or, with none in the kernel
    (cast mode), by its conversions. {"steps_a_trip": 0} for a kernel
    without a loop that converts."""

    def kind(op: str) -> str:
        return next((k for k, pre in VPU_SASS_KINDS.items() if op.startswith(pre)), "other")

    def by_kind(loop):
        out = dict.fromkeys([*VPU_SASS_KINDS, "other"], 0)
        for op, c in loop.items():
            out[kind(op)] += c
        return out

    kinds = [by_kind(loop) for loop in loops]
    key = "exp2" if any(k["exp2"] for k in kinds) else None
    steps = [k["exp2"] if key else k["convert_f2f"] + k["convert_f2fp"] for k in kinds]
    if not steps or max(steps) == 0:
        return {"steps_a_trip": 0}
    i = max(range(len(steps)), key=steps.__getitem__)
    return {"steps_a_trip": steps[i], **{k: v / steps[i] for k, v in kinds[i].items()}}


@dataclasses.dataclass(frozen=True)
class AddonlyPlan:
    blocks: int  # blocks of ADDONLY_THREADS; thread i of the grid takes float4s i + j blocks threads


ADDONLY_VEC = 4  # float4 a thread (csrc/probes.cu:ADD_VEC)
ADDONLY_THREADS = 256  # csrc/probes.cu:ADD_THREADS


def plan_addonly(n: int, sms: int) -> AddonlyPlan:
    """The addonly launch for n float32 elements (n / 4 float4) on `sms`
    SMs, ADDONLY_VEC float4 a thread: the fewest blocks that cover the
    float4s in a whole number of blocks an SM."""
    _need(n >= 4 and n % 4 == 0 and sms >= 1, f"addonly: n={n} (a multiple of 4) and sms={sms} must be >= 1")
    per_sm = -(-(n // 4) // sms)
    return AddonlyPlan(sms * -(-per_sm // (ADDONLY_THREADS * ADDONLY_VEC)))


ADDONLY_FADDS = 2  # float32 adds an element and rep: x + eps_r, then acc + that


def addonly_sass_counts(loops: list[dict[str, int]], vec: int = ADDONLY_VEC) -> dict[str, float]:
    """Adds an element and rep in the busiest loop of a probe_addonly kernel
    of `vec` float4 a thread (``_build.sass_loops``): the innermost loop that
    adds (the fewest instructions), its reps counted by the eps it loads from
    shared memory (LDS.128: four, LDS.64: two, LDS: one).
    {"reps_a_trip": 0} for a kernel without such a loop."""
    adding = [loop for loop in loops if loop.get("FADD", 0)]
    if not adding:
        return {"reps_a_trip": 0}
    loop = min(adding, key=lambda c: sum(c.values()))
    reps = sum(c * (int(op.rsplit(".", 1)[1]) // 32 if op[-3:] in (".64", "128") else 1)
               for op, c in loop.items() if op.split(".")[0] == "LDS")
    if reps == 0:
        return {"reps_a_trip": 0}
    other = sum(loop.values()) - loop["FADD"]
    return {"reps_a_trip": reps, "fadd_per_element_rep": loop["FADD"] / (4 * vec * reps),
            "other_per_rep": other / reps}


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# --------------------------------------------------------------------------
# kernel wrappers (CUDA tensors only)


def _loop(steps: int, reps: int) -> None:
    _need(steps >= 0 and 1 <= reps <= MAX_REPS and steps * reps < 2 ** 31,
          f"steps={steps}, reps={reps}: need steps >= 0 and 1 <= reps <= {MAX_REPS}")


def _operand(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    _check(name, x, dtype, shape)
    if x.data_ptr() % 32:
        raise ValueError(f"{name}: expected a 32-byte aligned tensor")


def _mode_dtype(name: str, a: torch.Tensor) -> bool:
    """True for the float32 arithmetic, False for bfloat16."""
    if a.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: expected bfloat16 or float32 operands, got {a.dtype}")
    return a.dtype == torch.float32


def logits_cuda(wt: torch.Tensor, phi: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """Kernel twin of logits_ref: wt [K, 80], phi [80, T], both bfloat16 (tensor
    cores) or both float32 (FMA)."""
    _loop(steps, reps)
    f32 = _mode_dtype("logits", wt)
    k, t = wt.shape[0], phi.shape[-1]
    _operand("wt", wt, wt.dtype, (k, DEPTH))
    _operand("phi", phi, wt.dtype, (DEPTH, t))
    plan = plan_logits(k, t, f32, _sms(wt.device))
    eps = _eps_on_card(reps, wt.dtype, wt.device)
    out = torch.empty((k, t), dtype=torch.float32, device=wt.device)
    with torch.cuda.device(wt.device):
        err = _build.load().hgmm_probe_logits(
            wt.data_ptr(), phi.data_ptr(), eps.data_ptr(), k, t, steps, reps, int(f32), plan.tile,
            out.data_ptr(), _stream(wt))
    _raise_on(err, "probe_logits")
    count_launch("probe_logits")
    return out


def stats_cuda(phi32: torch.Tensor, e: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """Kernel twin of stats_ref: phi32 [32, T], e [K, T], both bfloat16 or
    both float32."""
    _loop(steps, reps)
    f32 = _mode_dtype("stats", e)
    k, t = e.shape
    _operand("phi32", phi32, e.dtype, (32, t))
    _operand("e", e, e.dtype, (k, t))
    plan = plan_stats(k, t, f32, _sms(e.device))
    eps = _eps_on_card(reps, e.dtype, e.device)
    partial = torch.empty((plan.partials, 32 * k), dtype=torch.float32, device=e.device)
    out = torch.empty((32, k), dtype=torch.float32, device=e.device)
    with torch.cuda.device(e.device):
        err = _build.load().hgmm_probe_stats(
            phi32.data_ptr(), e.data_ptr(), eps.data_ptr(), k, t, steps, reps, int(f32), plan.tile,
            plan.threads, partial.data_ptr(), out.data_ptr(), _stream(e))
    _raise_on(err, "probe_stats")
    count_launch("probe_stats")
    return out


def norm_cuda(ones: torch.Tensor, e: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """Kernel twin of norm_ref: ones [8, K], e [K, T], bfloat16, K % 64 and
    T % 16 zero. The kernel computes the transpose: T on the tensor cores'
    64-row side, 16 reps of the 8 rows along N."""
    _loop(steps, reps)
    k, t = e.shape
    _operand("ones", ones, torch.bfloat16, (8, k))
    _operand("e", e, torch.bfloat16, (k, t))
    plan = plan_norm(k, t, _sms(e.device))
    eps = _eps_on_card(reps, torch.bfloat16, e.device)
    partial = torch.empty((plan.partials, 8 * t), dtype=torch.float32, device=e.device)
    out = torch.empty((8, t), dtype=torch.float32, device=e.device)
    with torch.cuda.device(e.device):
        err = _build.load().hgmm_probe_norm(
            ones.data_ptr(), e.data_ptr(), eps.data_ptr(), k, t, steps, reps, plan.tile,
            plan.threads, partial.data_ptr(), out.data_ptr(), _stream(e))
    _raise_on(err, "probe_norm")
    count_launch("probe_norm")
    return out


def addonly_cuda(x: torch.Tensor, steps: int, reps: int) -> torch.Tensor:
    """Kernel twin of addonly_ref: x float32, its element count a multiple of 4."""
    _loop(steps, reps)
    _operand("x", x, torch.float32, tuple(x.shape))
    _need(x.numel() >= 4 and x.numel() % 4 == 0, f"addonly: {x.numel()} elements, need a multiple of 4")
    plan = plan_addonly(x.numel(), _sms(x.device))
    eps = _eps_on_card(reps, torch.float32, x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.load().hgmm_probe_addonly(x.data_ptr(), eps.data_ptr(), x.numel(), steps, reps,
                                               plan.blocks, out.data_ptr(), _stream(x))
    _raise_on(err, "probe_addonly")
    count_launch("probe_addonly")
    return out


def vpu_cuda(x: torch.Tensor, steps: int, reps: int, mode: str = "exp2") -> torch.Tensor:
    """Kernel twin of vpu_ref: x float32, any shape."""
    _loop(steps, reps)
    _check_mode(mode)
    _check("x", x, torch.float32, tuple(x.shape))
    _need(x.numel() >= 1, "vpu: empty input")
    plan = plan_vpu(x.numel(), _sms(x.device))
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _build.load().hgmm_probe_vpu(x.data_ptr(), x.numel(), steps, reps, int(mode == "exp2"),
                                           plan.chains, plan.blocks, plan.threads, out.data_ptr(),
                                           _stream(x))
    _raise_on(err, "probe_vpu")
    count_launch("probe_vpu")
    return out


# --------------------------------------------------------------------------
# dispatch by device


def logits(wt, phi, steps, reps):
    return logits_cuda(wt, phi, steps, reps) if wt.is_cuda else logits_ref(wt, phi, steps, reps)


def stats(phi32, e, steps, reps):
    return stats_cuda(phi32, e, steps, reps) if e.is_cuda else stats_ref(phi32, e, steps, reps)


def norm(ones, e, steps, reps):
    return norm_cuda(ones, e, steps, reps) if e.is_cuda else norm_ref(ones, e, steps, reps)


def addonly(x, steps, reps):
    return addonly_cuda(x, steps, reps) if x.is_cuda else addonly_ref(x, steps, reps)


def vpu(x, steps, reps, mode="exp2"):
    return vpu_cuda(x, steps, reps, mode) if x.is_cuda else vpu_ref(x, steps, reps, mode)
