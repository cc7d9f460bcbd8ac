"""BASELINE config 1 through the port's normal path: a flat K-component fit
(``Gmm.fit``) and Horn registration onto it (``register_pair(model_kind=
"flat", method="horn")``), against the benchmark's plain float64 reference
of the flat cells (``regbench/reference/flat.py``) on seeded clouds; the
launch plans at the bunny's 35,947 points; and the ``bunny_flat64`` cell run
whole on the CPU at a small size, correct unbroken and not correct with each
fault the cell can have.

Tolerances: at 3,000 points the CPU port (float32) lay within 5e-5 of the
float64 fit by ``common.mixture_gap`` and within 5e-7 rad and 3e-7 of its
pose, at K = 16 and 64 over three seeds; the bounds below leave twenty times that.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hgmm_torch.configs.presets import CONFIG1_FLAT64
from hgmm_torch.ops import fused_em
from regbench.harness import cell, common, data, layout
from regbench.reference import flat
from regbench.tests.small import copy_layout, edit

REPO = Path(__file__).resolve().parents[1]
N_SMALL = 3000
FIT_GAP = 1e-3
ROT_GAP = 1e-5  # rad
TRANS_GAP = 1e-5  # cloud units
BUNNY = 35_947
SMS = 132  # the H100's


def _pair(seed: int, n: int = N_SMALL) -> data.Pair:
    return data.pair_pool(seed, n, 1, 0.2, 0.06, 0.002)[0]


def _gen(pair: data.Pair) -> torch.Generator:
    return torch.Generator().manual_seed(pair.fit_seed)


@pytest.mark.parametrize("seed", [3, 2147483811])
@pytest.mark.parametrize("k", [16, 64])
def test_flat_fit_matches_the_reference(k, seed):
    from hgmm_torch import Gmm

    pair = _pair(seed)
    gmm, logliks = Gmm.fit(torch.from_numpy(pair.target), k=k, n_iters=20, generator=_gen(pair))
    ref = flat.fit_flat(torch.from_numpy(pair.target), k, 20, _gen(pair))
    assert logliks.shape == (20,) and bool(torch.isfinite(logliks).all())
    assert int((ref.pi > 0).sum()) == k  # no component died: every one is compared
    got = tuple(a.numpy() for a in gmm.params)
    assert common.mixture_gap(got, tuple(a.numpy() for a in ref)) < FIT_GAP


@pytest.mark.parametrize("seed", [3, 2147483811])
@pytest.mark.parametrize("k", [16, 64])
def test_flat_register_pair_matches_the_reference(k, seed):
    """register_pair(model_kind="flat") fits inside with the generator it is
    given, so its pose is the reference's from the same start draw."""
    from hgmm_torch import register_pair

    pair = _pair(seed)
    res = register_pair(torch.from_numpy(pair.source), torch.from_numpy(pair.target), model_kind="flat",
                        k=k, fit_iters=20, generator=_gen(pair), n_iters=50, method="horn", tol=1e-7)
    m = flat.fit_flat(torch.from_numpy(pair.target), k, 20, _gen(pair))
    R, t = flat.register(torch.from_numpy(pair.source), m, 50, "horn", 1e-7)
    assert common.rotation_gap(res.pose.R.numpy(), R) < ROT_GAP
    assert common.translation_gap(res.pose.t.numpy(), t) < TRANS_GAP
    # and both near the truth the pair was made from
    assert common.rotation_gap(R, pair.R) < 0.02 and common.translation_gap(t, pair.t) < 0.02


def test_the_preset_is_the_configuration():
    cfg = json.loads((REPO / "regbench" / "configs" / "bunny_flat_k64.json").read_text())
    p = CONFIG1_FLAT64
    assert (p.model_kind, p.k, p.fit_iters, p.reg_iters, p.method, p.cov_type) == (
        "flat", cfg["k"], cfg["fit_iters"], cfg["reg_iters"], cfg["method"], cfg["cov_type"])
    assert (p.top_k, p.outlier_logit) == (cfg["top_k"], cfg["outlier_logit"])
    assert cfg["points"] == cfg["published_points"] == BUNNY and cfg["reduced"] == []
    entry = next(c for c in layout.Layout().bench["configs"] if c["name"] == "bunny_flat_k64")
    assert entry["file"] == "regbench/configs/bunny_flat_k64.json" and entry["reduced"] == []


def test_the_limits_lie_between_their_readings():
    limits = json.loads((REPO / "regbench" / "limits" / "bunny_flat64.json").read_text())
    assert set(limits) == {"fit_gap", "pose_rot_gap", "pose_trans_gap"}
    for v in limits.values():
        assert v["lower"] < v["limit"] < v["upper"]


def test_the_plans_at_the_bunny_size():
    """At 35,947 points and K = 64: the fit's E-step on the register-tiled
    body (64 rows, 256-point tiles, one block an SM over 141 tiles), counted
    as em_stats_tiled; the registration on the one-lane, one-point lanes
    body over 141 blocks, counted as reg_stats: the points fill 8 warps an
    SM (33,792) but not the tiled body's two points a thread (67,584)."""
    tiles = fused_em.plan_em_tiles(64)
    assert (tiles.k_pad, tiles.points, -(-BUNNY // tiles.points), tiles.blocks(BUNNY, SMS)) == (
        64, 256, 141, 132)
    plan = fused_em.plan_reg_stats(BUNNY, 64, None, SMS)
    assert plan == fused_em.RegPlan(lanes=1, blocks=141, kmax=0, chunk=1, points=1)
    assert fused_em.reg_stats_body(0, plan) == "reg_stats"
    low = fused_em.RS_MIN_WARPS_PER_SM * SMS * 32
    high = fused_em.RS_TILE_MIN_POINTS * fused_em.RS_THREADS * fused_em.RS_TILE_BLOCKS_PER_SM * SMS
    assert (low, high) == (33_792, 67_584) and low <= BUNNY < high
    assert fused_em.plan_reg_stats(low - 1, 64, None, SMS).lanes == 2
    assert fused_em.plan_reg_stats(high, 64, None, SMS).points == fused_em.RS_TILE_POINTS


# --------------------------------------------------------------------------
# the cell on the CPU


@pytest.fixture(autouse=True)
def jax_allowed(request, monkeypatch):
    """The suite's conftest imports jax for the parity tests, so a cell run
    here skips the benchmark's import guard (which exits a benchmark process
    that holds jax)."""
    if "small" in request.fixturenames:
        monkeypatch.setattr(cell, "guard", lambda when: None)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    root = copy_layout(tmp_path_factory.mktemp("flat"))
    edit(root / "regbench" / "configs" / "bunny_flat_k64.json", points=N_SMALL)
    edit(root / "regbench" / "traffic" / "flat_pair_pool8.json", pool=1, check_pairs=1, warm_requests=1)
    return layout.Layout(root)


def _mstep_unchanged(mp):
    import hgmm_torch.ops as ops

    mp.setattr(ops, "em_step", lambda *a, **k: None)


def _pose_step_unchanged(mp):
    import hgmm_torch.ops as ops

    mp.setattr(ops, "reg_step", lambda *a, **k: None)


def _half_the_points(mp):
    import hgmm_torch.ops as ops

    whole = ops.prepare

    def half(points, point_weights=None):
        w = torch.ones_like(points[:, 0]) if point_weights is None else point_weights
        return whole(points[::2], 2.0 * w[::2])

    mp.setattr(ops, "prepare", half)


def _pose_altered(mp):
    import hgmm_torch.pipelines.register as reg
    from hgmm_torch.models.se3 import Pose

    honest = reg.register_points

    def altered(*a, **k):
        res = honest(*a, **k)
        return res._replace(pose=Pose(res.pose.R, res.pose.t + 0.01))

    mp.setattr(reg, "register_points", altered)


FAULTS = {"mstep_unchanged": _mstep_unchanged, "pose_step_unchanged": _pose_step_unchanged,
          "half_the_points": _half_the_points, "pose_altered": _pose_altered}


def _run(lay, seed=2147483811):
    return cell.run(lay, "bunny_flat64", seed, 1.0, False, "cpu", 0.0)["result"]


def test_a_sound_bunny_run_is_correct(small):
    out = _run(small)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"pairs_per_s", "pair_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_reads_incorrect(small, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(small)
    assert out["correct"] is False, out["checks"]
    assert any(not c["value"] <= c["limit"] for c in out["checks"].values())


def test_the_traced_run_and_the_program_spans_read_the_flat_path(small, monkeypatch):
    """The traced run on the CPU reports every per-layer metric with something
    to read there (the device's are not: no card), and
    regbench/tools/program_spans.py, its stretches cut short, finds each of
    the fit's and the registration's spans once a request, and the scan's
    steps."""
    import importlib.util
    import sys

    from regbench.harness import requests

    for name in ("PROFILE_PAIRS", "SYNC_PAIRS", "SPAN_PAIRS", "STEADY_PAIRS"):
        monkeypatch.setattr(requests, name, 1)
    out = cell.run(small, "bunny_flat64", 5, 0.5, True, "cpu", 0.0)
    assert out["result"]["correct"] is True, out["result"]["checks"]
    metrics = out["result"]["metrics"]
    assert {"fit_ms", "reg_ms", "pair_mfu", "host_syncs_per_pair"} <= set(metrics)
    assert all(np.isfinite(m["value"]) and m["value"] >= 0 for m in metrics.values())

    spec = importlib.util.spec_from_file_location("regbench_program_spans",
                                                  REPO / "regbench" / "tools" / "program_spans.py")
    tool = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name, n in (("PROFILE_PAIRS", 1), ("SYNC_PAIRS", 1), ("TRACER_PAIRS", 2), ("LEAD_PAIRS", 1)):
        monkeypatch.setattr(tool, name, n)
    monkeypatch.setattr(tool, "costs", lambda: {})
    prog = tool.run(small.root, "bunny_flat64", 5, 0, "cpu")
    assert prog["requests"] == 2
    spans = ("hgmm_torch.fit", "hgmm_torch.fit.init", "hgmm_torch.fit.sweeps", "hgmm_torch.reg",
             "hgmm_torch.reg.prep", "hgmm_torch.reg.scan")
    assert all(prog["by_span"][s]["spans"] == 1 for s in spans), prog["by_span"]
    assert "hgmm_torch.reg.cut" not in prog["by_span"]
    assert prog["counters"]["reg.steps"] == 50 and 1 <= prog["counters"]["reg.live_steps"] <= 50
