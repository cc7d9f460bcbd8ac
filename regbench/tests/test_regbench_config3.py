"""The config-3 cell (dragon_config3_topk: partial, cluttered views onto a
model built once, each point gated to its top_k components, a uniform outlier
logit) on the CPU at small sizes, in this test's own copy of the layout: a
sound run reads correct = true, and correct = false under each fault the other
cells' check catches (regbench/tests/test_regbench_control.py) and under the
two this configuration adds: the gate dropped (the program ignores top_k) and
the outlier term dropped.

On the card (marker gpu), the control (the reference in float32 with TF32
matrix products in the program's place) fails the cell's limits."""

from __future__ import annotations

import pytest
import torch

from regbench.harness import cell, control, layout
from regbench.tests.small import copy_layout, edit
from regbench.tests.test_regbench_control import FAULTS

CELL = "dragon_config3_topk"
CONFIG = ("configs", "dragon_mahal_topk8.json")
TRAFFIC = ("traffic", "partial_map_pool8.json")


def _layout(root, points):
    copy_layout(root)
    edit(root.joinpath("regbench", *CONFIG), points=points)
    edit(root.joinpath("regbench", *TRAFFIC), pool=1, check_pairs=1, warm_requests=1)
    return layout.Layout(root)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _layout(tmp_path_factory.mktemp("config3_small"), 6000)


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """20,000-point views: at 6,000 a view's pose is held too loosely for
    float32 to land within limits set at 437,645 points (as the other cells'
    sound runs)."""
    return _layout(tmp_path_factory.mktemp("config3_sound"), 20000)


def _gate_dropped(mp):
    import hgmm_torch.ops as ops

    whole = ops.reg_problem_of
    mp.setattr(ops, "reg_problem_of",
               lambda points, params, top_k=None, outlier_logit=None: whole(points, params, None, outlier_logit))


def _outlier_dropped(mp):
    import hgmm_torch.ops as ops

    whole = ops.reg_problem_of
    mp.setattr(ops, "reg_problem_of",
               lambda points, params, top_k=None, outlier_logit=None: whole(points, params, top_k, None))


ALL_FAULTS = {**FAULTS, "gate_dropped": _gate_dropped, "outlier_dropped": _outlier_dropped}


def _run(lay, seed=2147483811):
    return cell.run(lay, CELL, seed, 1.0, False, "cpu", 0.0)["result"]


def test_a_sound_run_is_correct(sound):
    out = _run(sound)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("fault", sorted(ALL_FAULTS))
def test_each_fault_reads_incorrect(small, fault, monkeypatch):
    ALL_FAULTS[fault](monkeypatch)
    out = _run(small)
    assert out["correct"] is False, out["checks"]
    assert any(c["value"] > c["limit"] for c in out["checks"].values())


@pytest.mark.gpu
def test_the_control_fails_on_the_card(small):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    limits = small.limits(CELL)
    got = control.readings(small, CELL, 2147483821, "cuda")
    assert any(not got[k] <= v["limit"] for k, v in limits.items()), got
