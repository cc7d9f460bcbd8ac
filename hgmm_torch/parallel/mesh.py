"""The communication seam of the sharded programs, and how a run joins a
process group.

Counterpart of ``hgmm/parallel/mesh.py``. Clouds are sharded along their
point axis ("points"); mixture parameters and poses are replicated. Every
sharded program is written per rank, against a mesh: an object with
``rank``, ``size``, ``device`` and ``all_reduce_(tensor)``, which sums the
tensor over the ranks in place, in a fixed order, and returns it. Its only
traffic is that sum, of the O(K) sufficient statistics of a sweep, the 59
pose statistics of a registration step or the reduced pose-graph system.

Two meshes:
- ``ProcessMesh`` (``make_mesh``): the ranks of a ``torch.distributed``
  process group, one process each, over NCCL on the card and gloo on the CPU.
  A mesh on the card is NCCL or it raises.
- ``EmulatedMesh``: R ranks in one process, a thread each, every rank running
  the same program on its shard. Its ``all_reduce_`` is a barrier, the sum of
  the R tensors in rank order, and a barrier. On the card every rank enqueues
  on the same stream, so the sum follows each shard's kernels with no host
  sync. It holds multi-rank behaviour on one process and one card (NCCL
  refuses two ranks on one device); it is used only where a caller builds it.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import os
import threading
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from hgmm_torch.utils.device import resolve_device

POINTS_AXIS = "points"


def _device(device) -> torch.device:
    """resolve_device, with a card's index made explicit (the current one)."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _backend(device: torch.device) -> str:
    if device.type != "cuda":
        return "gloo"
    if not dist.is_nccl_available():
        raise RuntimeError("a mesh on the card runs over NCCL, and this torch build has no NCCL")
    return "nccl"


def _check_on(mesh, t: torch.Tensor) -> None:
    if t.device != mesh.device:
        raise ValueError(f"all_reduce_: a tensor on {t.device}, the mesh on {mesh.device}")


class ProcessMesh:
    """The ranks of a torch.distributed process group on `device`: this
    process is rank `rank` of `size`."""

    def __init__(self, group, device: torch.device):
        self.group = group
        self.device = device
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place (NCCL's or gloo's fixed order for
        a given world)."""
        _check_on(self, t)
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t


def make_mesh(device=None) -> ProcessMesh:
    """The mesh of the default process group on `device` (the card when
    None, and an error without one). Without a default group it joins the
    group of a torchrun launch (RANK and WORLD_SIZE in the environment:
    initialize_multihost), else starts a world of size 1 on an in-process
    store (no network, no port): NCCL on the card, gloo on the CPU. A group
    whose backend cannot reach `device` raises (a card run never falls back
    to gloo)."""
    device = resolve_device(device)
    backend = _backend(device)
    if not dist.is_initialized() and "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        initialize_multihost(device=device)
    elif not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    elif backend not in str(dist.get_backend()):
        raise RuntimeError(f"make_mesh: the default process group runs {dist.get_backend()}, "
                           f"and a mesh on {device} needs {backend}")
    return ProcessMesh(dist.group.WORLD, _device(device))


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device=None,
) -> None:
    """Join the process group of a multi-process run: with no arguments from
    torchrun's environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE),
    else at tcp://coordinator_address as rank process_id of num_processes.
    On the card (the default) each process takes the card of its LOCAL_RANK
    (else process_id) and the group runs NCCL; device="cpu" runs gloo. A
    lost process fails the run: recovery is a restart from a checkpoint."""
    device = resolve_device(device)
    backend = _backend(device)
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % torch.cuda.device_count())
    if coordinator_address is None:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)


def replicated(mesh) -> torch.device:
    """Where replicated state (parameters, poses) lives: the mesh's device."""
    return mesh.device


def points_sharding(mesh, n: int) -> slice:
    """This rank's rows of an n-point axis: an even split in rank order
    (equal shares when n divides by the mesh size, as pad_points_for_mesh
    makes it)."""
    return slice(n * mesh.rank // mesh.size, n * (mesh.rank + 1) // mesh.size)


class ShardedPoints(NamedTuple):
    """This rank's rows of a cloud that no rank holds whole."""

    local: torch.Tensor  # [n_local, 3] on the mesh's device
    n: int  # rows over every rank


def shard_points_from_host(points, mesh) -> ShardedPoints:
    """Wrap this process's own rows (each host reads only its slice of a
    10M+-point cloud) with the global count, one sum over the mesh; the rows
    are not gathered. The sharded entry points take this or the whole cloud."""
    if not isinstance(points, torch.Tensor):
        points = torch.from_numpy(np.asarray(points, np.float32))
    local = points.to(device=mesh.device, dtype=torch.float32)
    count = torch.tensor([local.shape[0]], dtype=torch.int64, device=mesh.device)
    return ShardedPoints(local, int(mesh.all_reduce_(count).item()))


class _Hub:
    """What the threads of one EmulatedMesh.run share."""

    def __init__(self, size: int):
        self.slots: list[torch.Tensor | None] = [None] * size
        self.barrier = threading.Barrier(size)


class _EmulatedRank:
    """Rank `rank` of an EmulatedMesh, as its thread's program sees it."""

    def __init__(self, hub: _Hub, rank: int, size: int, device: torch.device):
        self._hub = hub
        self.rank = rank
        self.size = size
        self.device = device

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's tensor summed in rank order (each rank computes the
        same sum, so the ranks hold equal bits), written into `t`."""
        _check_on(self, t)
        hub = self._hub
        hub.slots[self.rank] = t
        hub.barrier.wait()
        first = hub.slots[0]
        if any(s.shape != first.shape or s.dtype != first.dtype for s in hub.slots):
            raise ValueError(f"all_reduce_: ranks hold {[tuple(s.shape) for s in hub.slots]}")
        total = first.clone()
        for s in hub.slots[1:]:
            total += s
        hub.barrier.wait()  # every rank has read every slot
        return t.copy_(total)


class EmulatedMesh:
    """`size` ranks of one process on `device` (the card when None): run(fn)
    calls fn(rank_mesh) on a thread a rank and returns the results in rank
    order. The sharded entry points take it as their mesh and return rank
    0's result."""

    def __init__(self, size: int, device=None):
        if size < 1:
            raise ValueError(f"EmulatedMesh: {size} ranks")
        self.size = size
        self.device = _device(device)

    def run(self, fn) -> list:
        hub = _Hub(self.size)
        results: list = [None] * self.size
        errors: list = [None] * self.size
        on_card = self.device.type == "cuda"
        if on_card:
            from hgmm_torch.ops import _build

            _build.load()  # built once, before the threads
            stream = torch.cuda.current_stream(self.device)

        def body(rank: int) -> None:
            ctx = (torch.cuda.stream(stream) if on_card else contextlib.nullcontext())
            try:
                with ctx:
                    results[rank] = fn(_EmulatedRank(hub, rank, self.size, self.device))
            except BaseException as e:  # handed to the caller below
                errors[rank] = e
                hub.barrier.abort()  # the other ranks leave their barrier

        threads = [threading.Thread(target=body, args=(r,), name=f"hgmm-rank-{r}")
                   for r in range(self.size)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        raised = [e for e in errors if e is not None]
        if raised:
            raise next((e for e in raised if not isinstance(e, threading.BrokenBarrierError)), raised[0])
        return results


def _own_generator(g: torch.Generator) -> torch.Generator:
    return torch.Generator(device=g.device).set_state(g.get_state())


def per_rank(fn):
    """Decorate a per-rank program that takes a `mesh` argument: given an
    EmulatedMesh, fn runs on each of its ranks and the call returns rank 0's
    result. Each rank but 0 draws from its own copy of a torch.Generator
    argument, as each process of a real world holds its own."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        mesh = bound.arguments.get("mesh")
        if not isinstance(mesh, EmulatedMesh):
            return fn(*args, **kwargs)
        gens = {k for k, v in bound.arguments.items() if isinstance(v, torch.Generator)}
        per = [dict(bound.arguments, **{k: _own_generator(bound.arguments[k]) for k in gens})
               for _ in range(mesh.size - 1)]

        def rank_fn(rank_mesh):
            arguments = bound.arguments if rank_mesh.rank == 0 else per[rank_mesh.rank - 1]
            b = inspect.BoundArguments(sig, dict(arguments, mesh=rank_mesh))
            return fn(*b.args, **b.kwargs)

        return mesh.run(rank_fn)[0]

    return wrapper
