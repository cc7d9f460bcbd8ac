#!/usr/bin/env python3
"""Smoke run of hgmm_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. It
1. prints the card's name and power limit (nvidia-smi) and fails without CUDA;
2. builds the CUDA kernels of hgmm_torch/csrc with nvcc (timed);
3. checks each kernel against its plain PyTorch version on the card at small
   shapes (weights, outlier, dead components, parent -1);
4. drives the main path once: hgmm_torch.register_pair with the
   config2_tree_8x3 preset on a 437,645-point pair (the vertex count of the
   Stanford dragon; synthetic trefoil stand-in, ground truth z-rotation
   0.25 rad, t = (0.05, -0.04, 0.06)), with every kernel launch counter set
   to 0 just before and read just after; it fails unless the pose errors are
   within the bounds of tests/test_register.py, every output is finite and
   every kernel of the path was launched;
5. times the tree fit and the registration, and checks and times each kernel
   against its plain version at the shapes the slice gives it;
6. checks that register_pair on the card agrees with the plain CPU path on a
   4,000-point pair.
Each phase prints one JSON line; the line before the last is the kernel
table, the last line {"ok": true, "device": ...}. Any failure exits non-zero.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

N_POINTS = 437_645
GT_OMEGA = (0.0, 0.0, 0.25)
GT_T = (0.05, -0.04, 0.06)
# tests/test_register.py:45-50
BOUNDS = {"rmse": 0.03, "rot_deg": 3.0, "trans": 0.02, "pose_delta": 0.06}
# Strict tolerances of tests/test_fused_em.py:55-56 (em_stats) and :196-198
# (reg_stats), stated there for N=300 points. S, horn, A and b are sums over
# the N points, so their atol is scaled by N / 300; rtol is kept.
TOL_EM = dict(rtol=2e-3, atol=2e-4, ll_rtol=1e-4)
TOL_REG = dict(horn=(2e-3, 2e-3), A=(2e-3, 2e-2), b=(2e-3, 2e-2), ll_rtol=1e-4)
TIE_GAP = 1e-4  # an assign mismatch is allowed where the top-two logit gap is below this


def log(obj) -> None:
    print(json.dumps(obj), flush=True)


class CheckFailed(AssertionError):
    pass


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = Path(__file__).resolve().parent
    if not (repo / "hgmm_torch" / "__init__.py").is_file():
        print(f"chip_smoke: no hgmm_torch package beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    import hgmm_torch
    from hgmm_torch.ops import _build, fused_em

    if Path(hgmm_torch.__file__).resolve().parent != repo / "hgmm_torch":
        raise CheckFailed(f"imported hgmm_torch from {hgmm_torch.__file__}, not from {repo}")
    dev = torch.device("cuda")

    prebuilt = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.load()
    log({"phase": "build", "seconds": time.perf_counter() - t0, "library": _build.library_path().name,
         "compiled_here": not prebuilt})

    errs = {name: 0.0 for name in fused_em.LAUNCHES}
    small_checks(torch, dev, errs)
    log({"phase": "kernel_checks_small", "ok": True})

    counts, main_res = main_path(torch, dev)
    log({"phase": "main_path", **main_res, "launches": counts})

    timings = slice_checks(torch, dev, errs)
    agreement = cpu_agreement(torch, dev)
    log({"phase": "cpu_agreement", **agreement})

    sources = {"em_stats": "em_stats.cu", "em_stats_masked": "em_stats.cu",
               "assign": "assign.cu", "reg_stats": "reg_stats.cu"}
    replaces = {"em_stats": "hgmm/ops/fused_em.py:559", "em_stats_masked": "hgmm/ops/fused_em.py:559",
                "assign": "hgmm/ops/fused_em.py:859", "reg_stats": "hgmm/ops/fused_em.py:920"}
    kernels = []
    for name in fused_em.LAUNCHES:
        main_shape = timings[name][-1]
        kernels.append({
            "name": name, "route": "cuda", "source": f"hgmm_torch/csrc/{sources[name]}",
            "replaces": replaces[name], "launches": counts[name], "max_abs_err": errs[name],
            "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"], "k": main_shape["k"],
            "shapes": timings[name],
        })
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


# --------------------------------------------------------------------------
# helpers


def cuda_ms(torch, fn, reps: int = 20) -> float:
    """Mean device time of fn() over `reps` launches, by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def close(torch, name: str, got, ref, rtol: float, atol: float) -> float:
    """Raise unless |got - ref| <= atol + rtol |ref| everywhere; return max |got - ref|."""
    got = got.double().cpu()
    ref = ref.double().cpu()
    if not bool(torch.isfinite(got).all()):
        raise CheckFailed(f"{name}: non-finite kernel output")
    err = (got - ref).abs()
    bad = err > atol + rtol * ref.abs()
    if bool(bad.any()):
        i = int(torch.argmax((err - atol - rtol * ref.abs()).flatten()))
        raise CheckFailed(
            f"{name}: {int(bad.sum())} entries out of tolerance (rtol {rtol}, atol {atol}); "
            f"worst got {got.flatten()[i].item()} ref {ref.flatten()[i].item()}"
        )
    return float(err.max()) if err.numel() else 0.0


def check_em(torch, name, got, ref, n, errs):
    scale = n / 300.0
    e1 = close(torch, f"{name}.S", got.S, ref.S, TOL_EM["rtol"], TOL_EM["atol"] * scale)
    e2 = close(torch, f"{name}.loglik", got.loglik, ref.loglik, TOL_EM["ll_rtol"], 0.0)
    errs[name] = max(errs[name], e1, e2)


def check_reg(torch, got, ref, n, errs):
    scale = n / 300.0
    e = [close(torch, f"reg_stats.{f}", getattr(got, f), getattr(ref, f), r, a * scale)
         for f, (r, a) in ((f, TOL_REG[f]) for f in ("horn", "A", "b"))]
    e.append(close(torch, "reg_stats.loglik", got.loglik, ref.loglik, TOL_REG["ll_rtol"], 0.0))
    errs["reg_stats"] = max(errs["reg_stats"], *e)


def check_assign(torch, got, ref, points, W, parent, branch, errs):
    """Equal, except where the kernel's choice is within TIE_GAP of the plain
    version's best logit (a near-tie that float32 summation order can flip).
    Records the largest such logit gap as the kernel's error."""
    from hgmm_torch.ops import em_ref

    mism = (got != ref).nonzero().flatten()
    gap = 0.0
    if mism.numel():
        logits = em_ref._logits(points[mism], W)
        if parent is not None:
            logits = em_ref.child_mask_logits(logits, parent[mism], branch)
        rows = torch.arange(mism.numel(), device=logits.device)
        gaps = logits[rows, ref[mism].long()] - logits[rows, got[mism].long()]
        gap = float(gaps.max())
        if not gap < TIE_GAP:
            raise CheckFailed(f"assign: {int((gaps >= TIE_GAP).sum())} of {mism.numel()} "
                              f"mismatches are not near-ties (largest gap {gap})")
    errs["assign"] = max(errs["assign"], gap)


def random_mixture(torch, k, gen, dev, dead=()):
    from hgmm_torch.ops.gaussians import MixtureParams

    mu = torch.randn(k, 3, generator=gen)
    a = 0.3 * torch.randn(k, 3, 3, generator=gen)
    sigma = a @ a.transpose(1, 2) + 0.05 * torch.eye(3)
    pi = torch.softmax(torch.randn(k, generator=gen), 0)
    for j in dead:
        pi[j] = 0.0
    pi = pi / pi.sum()
    return MixtureParams(pi.to(dev), mu.to(dev), sigma.to(dev))


# --------------------------------------------------------------------------
# phases


def small_checks(torch, dev, errs) -> None:
    """Each kernel against its plain version on small random inputs."""
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights, precision_terms, sym_pack
    from hgmm_torch.models.se3 import so3_exp

    gen = torch.Generator().manual_seed(0)
    n = 3000
    pts = torch.randn(n, 3, generator=gen).to(dev)
    w = torch.rand(n, generator=gen).to(dev)
    for k in (8, 64, 512):
        params = random_mixture(torch, k, gen, dev, dead=(3,))
        W = pack_loglik_weights(params)
        for weights, outlier in ((None, None), (w, -3.0)):
            prep = prepare(pts, weights)
            got = fused_em.em_stats(prep.pts4, W, outlier)
            ref = em_ref.em_stats(pts, W, weights, outlier)
            check_em(torch, "em_stats", got, ref, n, errs)
        parent = torch.randint(-1, k // 8, (n,), generator=gen).to(dev)
        prep = prepare(pts, w)
        check_em(torch, "em_stats_masked", fused_em.em_stats_masked(prep.pts4, W, parent, 8),
                 em_ref.em_stats_masked(pts, W, parent, 8, w), n, errs)
        check_assign(torch, fused_em.assign(prep.pts4, W), em_ref.assign(pts, W), pts, W,
                     None, None, errs)
        check_assign(torch, fused_em.assign(prep.pts4, W, parent, 8),
                     em_ref.assign(pts, W, parent, 8), pts, W, parent, 8, errs)
        A, b, _ = precision_terms(params)
        pose = (so3_exp(torch.tensor([0.1, -0.2, 0.3], device=dev)),
                torch.tensor([0.05, 0.0, -0.1], device=dev))
        for weights, outlier in ((None, None), (w, -2.0)):
            prep = prepare(pts, weights)
            got = fused_em.reg_stats(prep.pts4, W, params.mu, sym_pack(A), b, pose, None, outlier)
            ref = em_ref.reg_stats(pts, W, params.mu, sym_pack(A), b, pose, weights, None, outlier)
            check_reg(torch, got, ref, n, errs)
    torch.cuda.synchronize()


def make_pair(torch, n, dev):
    from hgmm_torch.data.synthetic import make_cloud
    from hgmm_torch.models.se3 import Pose, so3_exp

    cloud = make_cloud(n, "trefoil", seed=4, device=dev)
    gt = Pose(so3_exp(torch.tensor(GT_OMEGA, device=dev)), torch.tensor(GT_T, device=dev))
    return gt.inverse().apply(cloud), cloud, gt


def preset_kwargs():
    from hgmm_torch.configs.presets import PRESETS

    p = PRESETS["config2_tree_8x3"]
    return dict(model_kind=p.model_kind, branch=p.branch, levels=p.levels, fit_iters=p.fit_iters,
                complexity_threshold=p.complexity_threshold, n_iters=p.reg_iters, method=p.method,
                top_k=p.top_k, outlier_logit=p.outlier_logit)


def pose_errors(source, res, gt):
    from hgmm_torch.eval.metrics import (pose_delta_norm, registration_rmse, rotation_error_deg,
                                         translation_error)

    return {"rmse": float(registration_rmse(res.pose, source, gt)),
            "rot_deg": float(rotation_error_deg(res.pose, gt)),
            "trans": float(translation_error(res.pose, gt)),
            "pose_delta": float(pose_delta_norm(res.pose, gt))}


def main_path(torch, dev):
    """register_pair with config2_tree_8x3 on the 437,645-point pair."""
    import hgmm_torch
    from hgmm_torch.ops import fused_em

    source, target, gt = make_pair(torch, N_POINTS, dev)
    torch.cuda.synchronize()
    fused_em.reset_launches()
    t0 = time.perf_counter()
    res = hgmm_torch.register_pair(source, target=target, generator=torch.Generator().manual_seed(0),
                                   **preset_kwargs())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(fused_em.LAUNCHES)
    errors = pose_errors(source, res, gt)
    finite = all(bool(torch.isfinite(x).all()) for x in (res.pose.R, res.pose.t, res.logliks, res.deltas))
    if not finite:
        raise CheckFailed("main path: non-finite output")
    if res.logliks.shape != (3 * 50,) or res.deltas.shape != (3 * 50,):
        raise CheckFailed(f"main path: logliks/deltas of shape {tuple(res.logliks.shape)}")
    for key, bound in BOUNDS.items():
        if not errors[key] < bound:
            raise CheckFailed(f"main path: {key} = {errors[key]} not below {bound}")
    missing = [name for name, c in counts.items() if c == 0]
    if missing:
        raise CheckFailed(f"main path: kernels never launched: {missing}")
    return counts, {"n_source": N_POINTS, "n_target": N_POINTS, "wall_s": wall, "errors": errors,
                    "bounds": BOUNDS, "converged": bool(res.converged),
                    "final_loglik": float(res.logliks[-1])}


def slice_checks(torch, dev, errs):
    """Time the fit and the registration apart, then check and time every
    kernel against its plain version at the slice's shapes."""
    from hgmm_torch.models.gmm_tree import GmmTree
    from hgmm_torch.ops import em_ref, fused_em, prepare
    from hgmm_torch.ops.gaussians import pack_loglik_weights
    from hgmm_torch.pipelines.register import model_terms, register_tree

    kw = preset_kwargs()
    source, target, gt = make_pair(torch, N_POINTS, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tree, _ = GmmTree.fit(target, branch=kw["branch"], levels=kw["levels"], em_iters=kw["fit_iters"],
                          generator=torch.Generator().manual_seed(0))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = register_tree(source, tree, n_iters=kw["n_iters"], method=kw["method"],
                        complexity_threshold=kw["complexity_threshold"])
    torch.cuda.synchronize()
    reg_s = time.perf_counter() - t0
    n_live = int((res.deltas >= 1e-7).sum())
    log({"phase": "timed_run", "fit_s": fit_s, "register_s": reg_s,
         "live_iterations": n_live, "register_ms_per_live_iteration": 1e3 * reg_s / max(n_live, 1),
         "errors": pose_errors(source, res, gt)})

    timings = {name: [] for name in fused_em.LAUNCHES}
    tgt = prepare(target)
    src = prepare(source)
    Ws = [pack_loglik_weights(p) for p in tree.levels]
    parents = [None, fused_em.assign(tgt.pts4, Ws[0])]
    parents.append(fused_em.assign(tgt.pts4, Ws[1], parents[1], 8))
    n = N_POINTS

    def record(name, k, kern, plain):
        timings[name].append({"k": k, "n": n, "ms": cuda_ms(torch, kern),
                              "plain_ms": cuda_ms(torch, plain, reps=5)})

    # Tree fit: level 0 unmasked at K=8, levels 1-2 masked at K=64 and 512.
    W0 = Ws[0]
    check_em(torch, "em_stats", fused_em.em_stats(tgt.pts4, W0), em_ref.em_stats(target, W0), n, errs)
    record("em_stats", 8, lambda: fused_em.em_stats(tgt.pts4, W0), lambda: em_ref.em_stats(target, W0))
    check_assign(torch, fused_em.assign(tgt.pts4, W0), em_ref.assign(target, W0), target, W0,
                 None, None, errs)
    record("assign", 8, lambda: fused_em.assign(tgt.pts4, W0), lambda: em_ref.assign(target, W0))
    for lvl in (1, 2):
        W, par = Ws[lvl], parents[lvl]
        k = W.shape[1]
        check_em(torch, "em_stats_masked", fused_em.em_stats_masked(tgt.pts4, W, par, 8),
                 em_ref.em_stats_masked(target, W, par, 8), n, errs)
        record("em_stats_masked", k, lambda: fused_em.em_stats_masked(tgt.pts4, W, par, 8),
               lambda: em_ref.em_stats_masked(target, W, par, 8))
        check_assign(torch, fused_em.assign(tgt.pts4, W, par, 8), em_ref.assign(target, W, par, 8),
                     target, W, par, 8, errs)
        record("assign", k, lambda: fused_em.assign(tgt.pts4, W, par, 8),
               lambda: em_ref.assign(target, W, par, 8))
    # Registration: levels 0 and 1, then the adaptive cut, at the final pose.
    pose = (res.pose.R, res.pose.t)
    for params in (tree.levels[0], tree.levels[1], tree.cut_mixture(kw["complexity_threshold"])):
        W, mu, A6, b3 = model_terms(params)
        k = W.shape[1]
        check_reg(torch, fused_em.reg_stats(src.pts4, W, mu, A6, b3, pose),
                  em_ref.reg_stats(source, W, mu, A6, b3, pose), n, errs)
        record("reg_stats", k, lambda: fused_em.reg_stats(src.pts4, W, mu, A6, b3, pose),
               lambda: em_ref.reg_stats(source, W, mu, A6, b3, pose))
    log({"phase": "slice_kernels", "timings": timings, "max_abs_err": errs})
    return timings


def cpu_agreement(torch, dev):
    """register_pair on the card (kernels) and on the CPU (plain versions),
    same 4,000-point pair and seed: both meet the bounds and agree."""
    import hgmm_torch
    from hgmm_torch.eval.metrics import pose_delta_norm
    from hgmm_torch.models.se3 import Pose

    out = {}
    poses = {}
    for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
        source, target, gt = make_pair(torch, 4000, d)
        res = hgmm_torch.register_pair(source, target=target,
                                       generator=torch.Generator().manual_seed(0), **preset_kwargs())
        out[name] = pose_errors(source, res, gt)
        for key, bound in BOUNDS.items():
            if not out[name][key] < bound:
                raise CheckFailed(f"{name} 4k pair: {key} = {out[name][key]} not below {bound}")
        poses[name] = Pose(res.pose.R.cpu(), res.pose.t.cpu())
    gap = float(pose_delta_norm(poses["cuda"], poses["cpu"]))
    # Both runs meet the bounds; their poses may differ by float32 summation
    # order and argmax near-ties in the tree build, well inside the bounds.
    if not gap < 0.01:
        raise CheckFailed(f"cuda and cpu poses differ by {gap}")
    out["pose_delta_cuda_vs_cpu"] = gap
    return out


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as exc:  # any failed phase: report it and exit non-zero
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
