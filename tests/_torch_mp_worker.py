"""One rank of the port's multi-process run (tests/test_torch_parallel.py
::test_two_process_gloo_run), the twin of tests/_mp_worker.py.

Each process holds only its share of the cloud (shard_points_from_host),
joins the process group through initialize_multihost, and runs the sharded
EM, registration and Schur pose-graph refinement. Rank 0 also runs them
unsharded on its device (em_fit, register_points, the dense solver), writes
both to OUT and prints the largest gaps as one JSON line.

    python tests/_torch_mp_worker.py HOST:PORT NPROC RANK OUT.npz [cpu|cuda]
    torchrun --nproc-per-node 4 tests/_torch_mp_worker.py env 4 0 OUT.npz cuda

With `env` the group comes from torchrun's environment (its RANK replaces
the RANK argument); on cuda each process takes the card of its LOCAL_RANK
and the group runs NCCL.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


def main() -> None:
    coord, nproc, out = sys.argv[1], int(sys.argv[2]), sys.argv[4]
    device = sys.argv[5] if len(sys.argv) > 5 else "cpu"
    import torch.distributed as dist

    from _torch_mp_case import chain_case, cloud_case, gt_pose
    from hgmm_torch import convert
    from hgmm_torch.models.gmm import em_fit
    from hgmm_torch.parallel import (initialize_multihost, make_mesh, shard_points_from_host,
                                     sharded_em_fit, sharded_register_points)
    from hgmm_torch.pipelines.pose_graph import (concat_edge_lists, refine_chain_sharded,
                                                 refine_pose_graph)
    from hgmm_torch.pipelines.register import register_points

    torch.set_num_threads(1)
    if coord == "env":
        initialize_multihost(device=device)
    else:
        initialize_multihost(coord, nproc, int(sys.argv[3]), device=device)
    mesh = make_mesh(device)
    pid = mesh.rank
    assert mesh.size == nproc, (mesh.size, nproc)
    dev = mesh.device
    pts, init = cloud_case()
    per = pts.shape[0] // nproc
    local = shard_points_from_host(pts[pid * per:(pid + 1) * per], mesh)
    assert local.n == pts.shape[0]
    init_t = convert.mixture_from_numpy(*init, device=dev)
    params, lls = sharded_em_fit(local, init_t, mesh, n_iters=5)
    gt = gt_pose()
    src = gt.inverse().apply(torch.from_numpy(pts)).numpy()
    reg = sharded_register_points(shard_points_from_host(src[pid * per:(pid + 1) * per], mesh), params,
                                  mesh, n_iters=20, method="horn")
    R0, t0, chain, closures = chain_case(2 * nproc + 3, dev)
    pg = refine_chain_sharded(R0, t0, chain.R, chain.t, mesh, n_iters=6, damping=1e-8,
                              closures=closures, robust_delta=5.0)
    if pid == 0:
        one, lls1 = em_fit(torch.from_numpy(pts).to(dev), init_t, n_iters=5)
        reg1 = register_points(torch.from_numpy(src).to(dev), params, n_iters=20, method="horn")
        dense = refine_pose_graph(R0, t0, concat_edge_lists(chain, closures), n_iters=6, damping=1e-8,
                                  robust_delta=5.0)
        got = dict(pi=params.pi, mu=params.mu, sigma=params.sigma, lls=lls, R=reg.pose.R,
                   t=reg.pose.t, pg_R=pg.R, pg_t=pg.t)
        ref = dict(pi=one.pi, mu=one.mu, sigma=one.sigma, lls=lls1, R=reg1.pose.R, t=reg1.pose.t,
                   pg_R=dense.R, pg_t=dense.t)
        np.savez(out, **{k: v.cpu().numpy() for k, v in got.items()},
                 **{f"one_{k}": v.cpu().numpy() for k, v in ref.items()})
        print(json.dumps({"ranks": nproc, "device": str(dev), "backend": str(dist.get_backend()),
                          "max_abs_gap_to_one_process": {k: float((got[k] - ref[k]).abs().max())
                                                         for k in got}}), flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
