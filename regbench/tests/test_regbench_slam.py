"""The SLAM cell (kitti_slam: whole sequences of chain, loop closures,
pose-graph refinement and the global map) on the CPU at small sizes, in this
test's own copy of the layout: a sound run reads correct = true, and correct
= false under each fault of the back end: the closures dropped, the
reciprocal test skipped, the refinement a no-op, the map fitted from the
unrefined poses. The cell's new per-layer readers return None on a record
without their fields.

On the card (marker gpu), the control (the reference in float32 with TF32
matrix products in the program's place) fails the cell's limits."""

from __future__ import annotations

import pytest
import torch

from regbench.harness import cell, control, layout
from regbench.tests.small import copy_layout, edit

CELL = "kitti_slam"
CONFIG = ("configs", "kitti_hdl64_slam.json")
TRAFFIC = ("traffic", "slam_two_laps.json")
READERS = ("closure_ms", "refine_ms", "map_ms", "closure_fits_per_seq", "kern_map_roofline")


def _layout(root):
    """Two laps of 16 frames of 12,000-point scans, trees 8 x 2, buckets of
    16,384: at 8 frames a lap, or at fewer points, the chain's pairs land in
    other basins in float32 and float64 alike and the chain's worst gap
    swings past limits set at full size."""
    copy_layout(root)
    cfg = root.joinpath("regbench", *CONFIG)
    edit(cfg, frames=32, scan_points=12000, world_points=40000, levels=2,
         map=dict(layout.Layout(root).config("kitti_hdl64_slam")["map"], levels=2, bucket=16384))
    edit(root.joinpath("regbench", *TRAFFIC), bucket=16384, trace_sequences=1)
    return layout.Layout(root)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _layout(tmp_path_factory.mktemp("slam_small"))


def _closures_dropped(mp):
    import hgmm_torch.pipelines.loop_closure as lc

    mp.setattr(lc, "detect_loop_closures", lambda *a, **k: None)


def _reciprocal_skipped(mp):
    import hgmm_torch.pipelines.loop_closure as lc

    mp.setattr(lc, "reciprocal_check", lambda fwd, rev, tol: (True, fwd, 0.0))


def _refine_no_op(mp):
    import hgmm_torch.pipelines.odometry as odo
    from hgmm_torch.pipelines.pose_graph import PoseGraphResult

    mp.setattr(odo, "refine_pose_graph",
               lambda R, t, edges, **k: PoseGraphResult(R, t, torch.zeros(0, dtype=R.dtype)))


def _map_from_unrefined(mp):
    import hgmm_torch
    from hgmm_torch.pipelines.pose_graph import PoseGraphResult

    honest = hgmm_torch.refine_odometry

    def refine(res, *a, **k):
        class Unrefined(PoseGraphResult):
            def poses(self):
                return res.abs_poses

        return Unrefined(*honest(res, *a, **k))

    mp.setattr(hgmm_torch, "refine_odometry", refine)


FAULTS = {"closures_dropped": _closures_dropped, "reciprocal_skipped": _reciprocal_skipped,
          "refine_no_op": _refine_no_op, "map_from_unrefined": _map_from_unrefined}


def _run(lay, seed=2147483811):
    return cell.run(lay, CELL, seed, 1.0, False, "cpu", 0.0)["result"]


def test_a_sound_run_is_correct(small):
    out = _run(small)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 31 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_each_fault_reads_incorrect(small, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(small)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.parametrize("record", [{}, {"profile": {"pairs": 79, "busy_s": 1.0, "wall_s": 2.0}},
                                    {"backend": {}}, {"backend": {"closure_ms": []}}])
def test_the_new_readers_read_nothing_without_their_fields(record):
    lay = layout.Layout()
    for name in READERS:
        assert lay.reader(name)(record) is None, name


def test_the_new_readers_read_their_fields():
    lay = layout.Layout()
    record = {"backend": {"closure_ms": [3.0, 1.0, 2.0], "refine_ms": [5.0], "map_ms": [7.0, 9.0],
                          "closure_fits": [12, 12, 10]},
              "profile": {"map_bound_s": 0.01, "map_fit_busy_s": 0.5}}
    got = {name: lay.reader(name)(record) for name in READERS}
    assert got == {"closure_ms": 2.0, "refine_ms": 5.0, "map_ms": 8.0, "closure_fits_per_seq": 12,
                   "kern_map_roofline": pytest.approx(2.0)}


@pytest.mark.gpu
def test_the_control_fails_on_the_card(small):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    limits = small.limits(CELL)
    got = control.readings(small, CELL, 2147483821, "cuda")
    assert any(not got[k] <= v["limit"] for k, v in limits.items()), got
