"""The correctness check can fail. On the CPU, a whole run of a cell (all but
the look for a card) at small sizes with the program broken underneath reads
correct = false, once for each fault the cell can have: a step that returns
its state unchanged (the pose step, the M-step), half of the points left out
with the mean taken over the rest, and a pose altered where it is produced.
The cells run on one chip, so no exchange between chips can be left out.
The same run unbroken reads correct = true.

On the card (marker gpu), the control: the reference in float32 with TF32
matrix products in the program's place fails the cells' limits, at the small
sizes here; PERF.md gives its readings at the cells' own sizes
(``python3 -m regbench.harness.control``)."""

from __future__ import annotations

import pytest
import torch

from regbench.harness import cell, control, layout
from regbench.tests.small import copy_layout, edit

CELLS = ("dragon_pair", "dragon_to_map", "kitti_dense")


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return layout.Layout(copy_layout(tmp_path_factory.mktemp("layout")))


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """The small layout with 20,000-point object scans: at 6,000 a source's
    pose onto another sample's tree is too loosely held for float32 to land
    within the cells' limits, which were set at 437,645 points."""
    root = copy_layout(tmp_path_factory.mktemp("sound"))
    edit(root / "regbench" / "configs" / "dragon_tree_8x3.json", points=20000)
    return layout.Layout(root)


def _pose_step_unchanged(mp):
    import hgmm_torch.ops as ops

    mp.setattr(ops, "reg_step", lambda *a, **k: None)


def _mstep_unchanged(mp):
    import hgmm_torch.ops as ops

    mp.setattr(ops, "em_step", lambda *a, **k: None)


def _half_the_points(mp):
    import hgmm_torch.ops as ops

    whole = ops.prepare

    def half(points, point_weights=None):
        w = torch.ones_like(points[:, 0]) if point_weights is None else point_weights
        return whole(points[::2], 2.0 * w[::2])

    mp.setattr(ops, "prepare", half)


def _pose_altered(mp):
    import hgmm_torch.pipelines.odometry as odo
    import hgmm_torch.pipelines.register as reg
    from hgmm_torch.models.se3 import Pose

    honest = reg.register_tree

    def altered(*a, **k):
        res = honest(*a, **k)
        return res._replace(pose=Pose(res.pose.R, res.pose.t + 0.01))

    mp.setattr(reg, "register_tree", altered)
    mp.setattr(odo, "register_tree", altered)


FAULTS = {"pose_step_unchanged": _pose_step_unchanged, "mstep_unchanged": _mstep_unchanged,
          "half_the_points": _half_the_points, "pose_altered": _pose_altered}


def _run(lay, workload, seed=2147483811):
    return cell.run(lay, workload, seed, 1.0, False, "cpu", 0.0)["result"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(sound, workload):
    out = _run(sound, workload)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_each_fault_reads_incorrect(small, workload, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(small, workload)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_on_the_card(small, workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    limits = small.limits(workload)
    got = control.readings(small, workload, 2147483821, "cuda")
    assert any(not got[k] <= v["limit"] for k, v in limits.items()), got
