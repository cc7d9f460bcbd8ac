"""Registration quality and speed: ICP against the flat GMM and the GMM tree.

    python -m hgmm_torch.benchmarks.registration_suite [--n 100000] [--device cuda|cpu]

Counterpart of ``benchmarks/registration_suite.py`` (the reference README's
CPU-ICP vs GPU-ICP vs GMM vs HGMM comparison). A trefoil of --n points, a
random pose (rotation <= 0.2 rad, translation <= 0.06) and a source moved by
its inverse plus 0.002 of noise, all drawn from seeds; then four algorithms,
each fit and registration timed by ``utils.timing.time_fn`` (warmup 1,
median of 3: CUDA events on the card, the host clock on the CPU):

- ``icp``: point-to-point ICP, 30 iterations (the knn kernel);
- ``gmm_flat64``: a flat K = 64 fit, 20 sweeps, then 40 registration
  iterations (the unmasked em_stats body at K = 64);
- ``hgmm_tree_8x3``: the tree (branch 8, 3 levels, 10 sweeps a level), its
  leaves (cut 0.0) registered with outlier 0.0;
- ``hgmm_adaptive_cut``: the same tree cut at the median node complexity of
  its level 1 (fewer components).

Prints one JSON line per algorithm with the reference's keys (``algorithm``,
``n_points``, ``fit_s``, ``register_s``, ``rmse``, ``rot_err_deg``, and ``k``
for the tree's cuts), unrounded. The draws are numpy's and torch's, so they
differ from the reference's jax.random draws for the same seeds.
"""

from __future__ import annotations

import argparse
import json

import torch

from hgmm_torch.utils.device import resolve_device

ICP_ITERS = 30
FLAT_K, FLAT_SWEEPS = 64, 20
TREE = dict(branch=8, levels=3, em_iters=10)
REG_ITERS = 40


def make_problem(n: int, device=None):
    """(source, cloud, gt) on `device`: the trefoil (seed 0), the pose
    (generator seed 1) and the perturbed source (seed 2)."""
    from hgmm_torch.data.synthetic import make_cloud, perturb
    from hgmm_torch.models.se3 import random_pose

    device = resolve_device(device)
    cloud = make_cloud(n, "trefoil", seed=0, device=device)
    gt = random_pose(torch.Generator().manual_seed(1), max_angle=0.2, max_trans=0.06, device=device)
    return perturb(cloud, gt.inverse(), noise=0.002, seed=2), cloud, gt


def run(source: torch.Tensor, cloud: torch.Tensor, gt, warmup: int = 1, iters: int = 3, emit=None):
    """The four algorithms on (source, cloud), both on one device, against
    the true pose gt. Returns (records, poses): one record a line, with the
    reference's keys, and each algorithm's final pose. emit(record) is called
    as each record is made."""
    from hgmm_torch.baselines.icp import icp
    from hgmm_torch.eval.metrics import registration_rmse, rotation_error_deg
    from hgmm_torch.models.gmm import Gmm
    from hgmm_torch.models.gmm_tree import GmmTree, node_complexity
    from hgmm_torch.pipelines.register import register_points
    from hgmm_torch.utils.timing import time_fn

    device = cloud.device
    n = int(cloud.shape[0])
    records, poses = [], {}

    def timed(fn):
        out, median_s, _ = time_fn(fn, device=device, warmup=warmup, iters=iters)
        return out, median_s

    def report(name, pose, fit_s, reg_s, **extra):
        rec = {"algorithm": name, "n_points": n, "fit_s": fit_s, "register_s": reg_s,
               "rmse": float(registration_rmse(pose, source, gt)),
               "rot_err_deg": float(rotation_error_deg(pose, gt)), **extra}
        records.append(rec)
        poses[name] = pose
        if emit is not None:
            emit(rec)

    res, dt = timed(lambda: icp(source, cloud, n_iters=ICP_ITERS))
    report("icp", res.pose, 0.0, dt)

    (gmm, _), fit_dt = timed(lambda: Gmm.fit(cloud, k=FLAT_K, n_iters=FLAT_SWEEPS,
                                             generator=torch.Generator().manual_seed(3)))
    res, dt = timed(lambda: register_points(source, gmm.params, n_iters=REG_ITERS))
    report("gmm_flat64", res.pose, fit_dt, dt)

    (tree, _), fit_dt = timed(lambda: GmmTree.fit(cloud, **TREE,
                                                  generator=torch.Generator().manual_seed(4)))
    cut = tree.cut_mixture(0.0)
    res, dt = timed(lambda: register_points(source, cut, n_iters=REG_ITERS, outlier_logit=0.0))
    report("hgmm_tree_8x3", res.pose, fit_dt, dt, k=int(cut.pi.shape[0]))

    # The adaptive mixed-resolution cut (arXiv 1807.02587): the simplest half
    # of the parents replaces its children.
    thr = float(torch.quantile(node_complexity(tree.levels[-2]), 0.5))
    acut = tree.cut_mixture(thr)
    res, dt = timed(lambda: register_points(source, acut, n_iters=REG_ITERS, outlier_logit=0.0))
    report("hgmm_adaptive_cut", res.pose, fit_dt, dt, k=int(acut.pi.shape[0]))
    return records, poses


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    source, cloud, gt = make_problem(args.n, args.device)
    records, _ = run(source, cloud, gt, emit=lambda rec: print(json.dumps(rec), flush=True))
    return records


if __name__ == "__main__":
    main()
