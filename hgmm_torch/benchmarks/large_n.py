"""Config 5 at scale: 10M+ points through the sharded EM program.

    python -m hgmm_torch.benchmarks.large_n [--n 10485760] [--k 512] [--iters 20] [--device cuda|cpu]

Counterpart of ``benchmarks/large_n.py``: ``hgmm_torch.parallel.sharded_em_fit``
over ``make_mesh()`` (a world of one process, or the process group of a
torchrun launch, each process then one rank) at N = 10,485,760 points of a
seeded scene round 256 centres, K = 512; prints one JSON line with the
reference's keys. The E-step never holds the [N, K] responsibilities, so N
points cost the [N, 3] cloud and the [4, N] prepared buffer (~28 bytes a
point), and the sum over the mesh is K * 10 + 1 floats a sweep whatever N.
On the CPU (--device cpu, small --n) it rehearses the control flow with the
plain versions; the times are then the host's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from hgmm_torch.utils.device import resolve_device


def scene(n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] float32: points round 256 normal centres (scale 4), spread 0.3,
    drawn with numpy from `seed` (the reference's scene)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(256, 3)).astype(np.float32) * 4.0
    idx = rng.integers(0, 256, size=n)
    return centers[idx] + rng.normal(size=(n, 3)).astype(np.float32) * 0.3


def run(n: int, k: int, iters: int, device=None, repeats: int = 3) -> dict:
    from hgmm_torch.models.gmm import init_params
    from hgmm_torch.parallel import make_mesh, sharded_em_fit
    from hgmm_torch.utils.timing import sync

    device = resolve_device(device)
    mesh = make_mesh(device)
    pts = torch.from_numpy(scene(n)).to(device)
    init = init_params(pts, k, torch.Generator().manual_seed(1))
    print(f"# device={device} ranks={mesh.size}", file=sys.stderr)

    def fit():
        out = sharded_em_fit(pts, init, mesh, n_iters=iters)
        sync(device)
        return out

    t0 = time.perf_counter()
    fit()  # builds the kernels on first use
    first_s = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _, lls = fit()
        times.append(time.perf_counter() - t0)
    per_sweep = float(np.median(times)) / iters
    out = {"benchmark": "large_n_sharded_em", "n_points": n, "k": k, "devices": mesh.size,
           "ms_per_sweep": per_sweep * 1e3, "points_per_sec": n / per_sweep,
           "compile_plus_first_run_s": first_s, "final_loglik_per_point": float(lls[-1]) / n,
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    if device.type == "cuda":
        out["hbm_in_use_gb"] = torch.cuda.memory_allocated(device) / 2**30
        out["hbm_peak_gb"] = torch.cuda.max_memory_allocated(device) / 2**30
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=10 * (1 << 20))
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.n, args.k, args.iters, args.device)))


if __name__ == "__main__":
    main()
