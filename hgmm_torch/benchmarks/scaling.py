"""Weak scaling of the sharded EM fit: a fixed number of points a rank.

    python -m hgmm_torch.benchmarks.scaling [--points-per-device 262144] [--k 64]
        [--iters 20] [--device cuda|cpu]
    torchrun --nproc-per-node 4 -m hgmm_torch.benchmarks.scaling   # four cards

Counterpart of ``benchmarks/scaling.py`` (BASELINE.md row 2: >= 80 % weak-
scaling efficiency). For each mesh size s in (1, 2, 4, 8) it fits s x
--points-per-device points of the trefoil with ``parallel.sharded_em_fit``
(K = --k, --iters sweeps, from one seeded init) and reports points a second
and the efficiency against s = 1; at s = 1 also the unsharded ``em_fit`` on
the same points and the sharded program's overhead over it.

- On the card the meshes are the ranks of the process group
  (``parallel.make_mesh``: a world of one process unless torchrun started
  more), s up to its size, each ``ProcessMesh(dist.new_group(range(s)))``
  over NCCL; the ranks outside a mesh wait at a barrier, and rank 0 prints.
- On the CPU (--device cpu) the meshes are ``EmulatedMesh(s)``, s ranks as
  threads of one process: a check of the sharded program, not of its speed
  (the records say so in ``note``).

Times are the host clock around a fit that ends in ``utils.timing.sync``,
the median of 3 after a warm fit. One JSON line a mesh size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from hgmm_torch.utils.device import resolve_device

SIZES = (1, 2, 4, 8)
EMULATED_NOTE = "emulated ranks in one process; functional validation only"


def _timed_fit(fit, device, iters: int, repeats: int):
    """(params, seconds a sweep): the median of `repeats` fits after a warm one."""
    from hgmm_torch.utils.timing import sync

    params, _ = fit()
    sync(device)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        params, _ = fit()
        sync(device)
        times.append(time.perf_counter() - t0)
    return params, float(np.median(times)) / iters


def _problem(n: int, k: int, device):
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.gmm import init_params

    pts = make_cloud(n, "trefoil", seed=0, device=device)
    return pts, init_params(pts, k, torch.Generator().manual_seed(1))


def _meshes(device, sizes):
    """(s, mesh or None) for each s: None where this rank is outside the mesh."""
    if device.type != "cuda":
        from hgmm_torch.parallel import EmulatedMesh

        return [(s, EmulatedMesh(s, device)) for s in sizes]
    import torch.distributed as dist

    from hgmm_torch.parallel import make_mesh
    from hgmm_torch.parallel.mesh import ProcessMesh

    world = make_mesh(device)
    out = []
    for s in (s for s in sizes if s <= world.size):
        group = dist.new_group(list(range(s)))  # every rank takes part in making it
        out.append((s, ProcessMesh(group, world.device) if world.rank < s else None))
    return out


def run(points_per_device: int = 1 << 18, k: int = 64, iters: int = 20, device=None,
        sizes=SIZES, repeats: int = 3, emit=None):
    """Returns (records, params): a record a mesh size this rank belongs to,
    and the fitted parameters by mesh size and "unsharded" (the s = 1
    problem). emit(record) is called on rank 0 as each is made."""
    import torch.distributed as dist

    from hgmm_torch.models.gmm import em_fit
    from hgmm_torch.parallel import sharded_em_fit

    device = resolve_device(device)
    meshes = _meshes(device, sizes)
    rank = dist.get_rank() if device.type == "cuda" else 0
    print(f"# device={device} mesh sizes={[s for s, _ in meshes]}", file=sys.stderr)

    pts1, init1 = _problem(points_per_device, k, device)
    p0, unsharded_sweep = _timed_fit(lambda: em_fit(pts1, init1, n_iters=iters), device, iters, repeats)
    unsharded_pps = points_per_device / unsharded_sweep
    records, params = [], {"unsharded": p0}
    base_pps = None
    for s, mesh in meshes:
        if mesh is None:
            dist.barrier()
            continue
        n = points_per_device * s
        pts, init = (pts1, init1) if s == 1 else _problem(n, k, device)
        params[s], sweep = _timed_fit(lambda: sharded_em_fit(pts, init, mesh, n_iters=iters), device,
                                      iters, repeats)
        pps = n / sweep
        if base_pps is None:
            base_pps = pps / s
        rec = {"devices": s, "points": n, "points_per_sec": pps,
               "weak_scaling_efficiency": pps / (base_pps * s)}
        if s == 1:
            rec["unsharded_points_per_sec"] = unsharded_pps
            rec["sharding_overhead"] = 1.0 - pps / unsharded_pps
        if device.type != "cuda":
            rec["note"] = EMULATED_NOTE
        records.append(rec)
        if emit is not None and rank == 0:
            emit(rec)
        if device.type == "cuda":
            dist.barrier()
    return records, params


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--points-per-device", type=int, default=1 << 18)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    import torch.distributed as dist

    ours = not dist.is_initialized()  # make_mesh may start a world of one process
    try:
        records, _ = run(args.points_per_device, args.k, args.iters, args.device,
                         emit=lambda rec: print(json.dumps(rec), flush=True))
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()
    return records


if __name__ == "__main__":
    main()
