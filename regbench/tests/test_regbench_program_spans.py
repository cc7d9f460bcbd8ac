"""regbench/tools/program_spans.py on the CPU at the small layout, its
stretches cut short: the program's spans reach the profiled stretch's
annotations and the tracer's requests, and the five readings are numbers
where the cell has what they read."""

from __future__ import annotations

import functools
import importlib.util
import sys

import pytest

from regbench.tests.small import REPO, copy_layout, edit


def _tool(monkeypatch):
    path = REPO / "regbench" / "tools" / "program_spans.py"
    spec = importlib.util.spec_from_file_location("regbench_program_spans", path)
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name, n in (("PROFILE_PAIRS", 2), ("SYNC_PAIRS", 1), ("TRACER_PAIRS", 2), ("LEAD_PAIRS", 1)):
        monkeypatch.setattr(mod, name, n)
    monkeypatch.setattr(mod, "costs", functools.partial(mod.costs, 200, 1))
    return mod


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = copy_layout(tmp_path_factory.mktemp("layout"))
    edit(root / "regbench" / "configs" / "dragon_tree_8x3.json", points=2000, reg_iters=10)
    edit(root / "regbench" / "configs" / "kitti_hdl64_8x3.json", frames=6, scan_points=3000,
         world_points=20000, reg_iters=5)
    edit(root / "regbench" / "traffic" / "chain_dense.json", bucket=2048)
    return root


def test_idle_by_span_puts_a_gap_to_the_innermost_span(monkeypatch):
    tool = _tool(monkeypatch)
    ann = lambda name, ts, dur: {"cat": "user_annotation", "name": name, "ts": ts, "dur": dur}  # noqa: E731
    kern = lambda ts, dur: {"cat": "kernel", "name": "k", "ts": ts, "dur": dur}  # noqa: E731
    events = [ann("hgmm_torch.reg", 0, 100), ann("hgmm_torch.reg.scan", 10, 40),
              {"cat": "cpu_op", "name": "aten::mul", "ts": 12, "dur": 10},
              kern(0, 5), kern(15, 5), kern(45, 10), kern(70, 10), kern(130, 5)]
    # gaps (middle, length): (10, 10) and (32.5, 25) in the scan, (62.5, 15) in reg, (105, 50) in none
    got = tool.idle_by_span(events)
    assert [k for k, _ in got] == ["none", "hgmm_torch.reg.scan", "hgmm_torch.reg"]
    assert [v for _, v in got] == pytest.approx([5e-5, 3.5e-5, 1.5e-5])


@pytest.mark.parametrize("workload", ["dragon_pair", "dragon_to_map", "kitti_dense"])
def test_program_spans_reads_the_programs_spans(layout, workload, monkeypatch):
    tool = _tool(monkeypatch)
    out = tool.run(layout, workload, 2147483901, 1, "cpu")
    prof = out["profile"]
    assert prof["reg_scan_spans"] == 3 * tool.PROFILE_PAIRS
    assert 0.0 < prof["reg_scan_idle_s"] <= prof["wall_s"]  # no device events: the spans are idle
    assert prof["idle_by_span"] == []  # nor gaps between them
    assert out["requests"] == (tool.TRACER_PAIRS if workload != "kitti_dense" else 5)
    spans = out["by_span"]
    assert spans["hgmm_torch.reg.scan"]["spans"] == 3 and spans["hgmm_torch.reg.prep"]["spans"] == 3
    assert ("hgmm_torch.fit.init" in spans) == (workload != "dragon_to_map")
    read = out["readings"]
    assert (read["fit_init_ms"] is not None) == (workload != "dragon_to_map")
    for name in ("reg_prep_ms", "reg_scan_ms", "reg_scan_idle_ms", "reg_live_step_pct"):
        assert isinstance(read[name], float), name
    assert 0.0 < read["reg_live_step_pct"] <= 100.0
    assert len(out["rates"]["off"]) == len(out["rates"]["on"]) == 1
    assert all(out[k] > 0 for k in ("span_off_ns", "record_function_ns", "count_launch_ns",
                                    "count_launch_before_ns", "span_on_ns", "count_launch_on_ns"))
