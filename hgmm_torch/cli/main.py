"""hgmm-torch command-line interface: the single-pair commands of the JAX
package's CLI (fit-gmm, register, icp), with the same arguments and printed
lines, run by hgmm_torch on the device that --device names.

    python -m hgmm_torch.cli.main fit-gmm CLOUD [--tree] [--out NPZ] [--device cuda|cpu]
    python -m hgmm_torch.cli.main register SOURCE TARGET [--preset NAME] [--out NPY]
    python -m hgmm_torch.cli.main icp SOURCE TARGET [--iters N]

Clouds are .ply, KITTI .bin or .npy files. --device defaults to cuda and
the command fails when CUDA is not available; --device cpu runs the plain
PyTorch path.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from hgmm_torch.configs.presets import PRESETS

SEED = 0  # of the torch.Generator that draws a fit's initial means


def _load_cloud(path: str, device: torch.device) -> torch.Tensor:
    p = Path(path)
    if p.suffix == ".ply":
        from hgmm_torch.data.ply import load_ply

        pts = load_ply(p)
    elif p.suffix == ".bin":
        from hgmm_torch.data.kitti import load_velodyne_bin

        pts = load_velodyne_bin(p)
    elif p.suffix == ".npy":
        pts = np.load(p)
    else:
        raise SystemExit(f"unsupported cloud format: {p.suffix}")
    return torch.from_numpy(np.ascontiguousarray(pts, dtype=np.float32)).to(device)


def _elapsed(t0: float, device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def _generator() -> torch.Generator:
    return torch.Generator().manual_seed(SEED)


def cmd_fit_gmm(args) -> None:
    from hgmm_torch.models.gmm import Gmm
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.utils import checkpoint as ckpt

    pts = _load_cloud(args.cloud, args.device)
    t0 = time.perf_counter()
    if args.tree:
        tree, lls = GmmTree.fit(pts, branch=args.branch, levels=args.levels, em_iters=args.iters,
                                generator=_generator())
        ckpt.save_tree(args.out, tree)
        print(f"tree fit: {tree.n_leaves} leaves, loglik/level={lls.cpu().numpy()}")
    else:
        gmm, lls = Gmm.fit(pts, k=args.k, n_iters=args.iters, generator=_generator())
        ckpt.save_mixture(args.out, gmm.params)
        print(f"gmm fit: K={args.k}, final loglik={float(lls[-1]):.2f}")
    print(f"({_elapsed(t0, args.device):.2f}s) saved -> {args.out}")


def cmd_register(args) -> None:
    from hgmm_torch.pipelines.register import register_pair

    preset = PRESETS[args.preset]
    source = _load_cloud(args.source, args.device)
    target = _load_cloud(args.target, args.device)
    t0 = time.perf_counter()
    res = register_pair(
        source,
        target=target,
        model_kind=preset.model_kind,
        k=preset.k,
        branch=preset.branch,
        levels=preset.levels,
        fit_iters=preset.fit_iters,
        complexity_threshold=(
            preset.complexity_threshold
            if args.complexity_threshold is None
            else args.complexity_threshold
        ),
        generator=_generator(),
        n_iters=preset.reg_iters,
        method=preset.method,
        top_k=preset.top_k,
        outlier_logit=preset.outlier_logit,
    )
    dt = _elapsed(t0, args.device)
    T = res.pose.matrix().cpu().numpy()
    print(f"converged={bool(res.converged)} in {dt:.2f}s; transform:")
    print(T)
    if args.out:
        np.save(args.out, T)
        print(f"saved -> {args.out}")
    if args.export_aligned:
        from hgmm_torch.viz.export import export_alignment

        export_alignment(args.export_aligned, source, target, res.pose)
        print(f"aligned clouds -> {args.export_aligned}")


def cmd_icp(args) -> None:
    from hgmm_torch.baselines.icp import icp

    source = _load_cloud(args.source, args.device)
    target = _load_cloud(args.target, args.device)
    res = icp(source, target, n_iters=args.iters)
    print(res.pose.matrix().cpu().numpy())
    print(f"final match rmse: {float(res.rmse_history[-1]):.6f}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="hgmm-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda: the CUDA kernels (fails without a card); cpu: the plain PyTorch path",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fit-gmm", parents=[common], help="fit a flat GMM or GMM-tree to a cloud")
    f.add_argument("cloud")
    f.add_argument("--out", default="mixture.npz")
    f.add_argument("--tree", action="store_true")
    f.add_argument("--k", type=int, default=64)
    f.add_argument("--branch", type=int, default=8)
    f.add_argument("--levels", type=int, default=3)
    f.add_argument("--iters", type=int, default=20)
    f.set_defaults(fn=cmd_fit_gmm)

    r = sub.add_parser("register", parents=[common], help="register source cloud onto target")
    r.add_argument("source")
    r.add_argument("target")
    r.add_argument("--preset", default="config2_tree_8x3", choices=sorted(PRESETS))
    r.add_argument(
        "--complexity-threshold", type=float, default=None,
        help="adaptive-cut threshold override (0 = pure leaves)",
    )
    r.add_argument("--out", default=None)
    r.add_argument("--export-aligned", default=None)
    r.set_defaults(fn=cmd_register)

    i = sub.add_parser("icp", parents=[common], help="ICP baseline registration")
    i.add_argument("source")
    i.add_argument("target")
    i.add_argument("--iters", type=int, default=30)
    i.set_defaults(fn=cmd_icp)

    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.error("--device cuda: CUDA is not available (--device cpu runs the plain PyTorch path)")
    args.device = torch.device(args.device)
    args.fn(args)


if __name__ == "__main__":
    main()
