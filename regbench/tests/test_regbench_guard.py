"""The import guard and the refusal to measure off the card: no process of
the benchmark may hold jax or the JAX package (top-level names compared
whole, so hgmm_torch passes and hgmm does not), and without a CUDA device the
run exits with no result."""

from __future__ import annotations

import subprocess
import sys
import types

import pytest

from regbench.harness import cell, common, layout, requests
from regbench.tests.small import REPO, copy_layout


@pytest.mark.parametrize("modules, found", [
    (["hgmm_torch", "hgmm_torch.ops.fused_em", "numpy", "regbench.harness"], []),
    (["hgmm", "hgmm_torch"], ["hgmm"]),
    (["hgmm.ops.fused_em"], ["hgmm"]),
    (["jax._src.core", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["hgmmx", "jaxtyping", "flaxen"], []),
])
def test_forbidden_names_are_whole_top_level_names(modules, found):
    assert common.forbidden_modules(modules) == found


def test_the_guard_stops_a_run(monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "hgmm", sys.modules["regbench"])
    with pytest.raises(SystemExit) as e:
        cell.guard("after the check")
    assert e.value.code == 3
    assert "hgmm" in capsys.readouterr().err


def test_a_module_the_check_loads_stops_the_run(tmp_path, monkeypatch, capsys):
    """The guard runs after the check, the last work before the result."""
    lay = layout.Layout(copy_layout(tmp_path))
    honest = requests.PoolEntry.check

    def planting(self, dtype=None):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return honest(self, dtype)

    monkeypatch.setattr(requests.PoolEntry, "check", planting)
    with pytest.raises(SystemExit) as e:
        cell.run(lay, "dragon_pair", 2147483829, 0.2, False, "cpu", 0.0)
    assert e.value.code == 3
    assert "after the check" in capsys.readouterr().err


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "from regbench.harness import cell, common, control, data, layout, requests, roofline, trace;"
            "from regbench.reference import mixture, odometry, register;"
            "lay = layout.Layout('.');"
            "[lay.entry(e) for e in ('register_pair', 'register_to_model', 'run_odometry')];"
            "[lay.reader(m['name']) for m in lay.bench['per_layer']];"
            "import hgmm_torch, hgmm_torch.pipelines.odometry, hgmm_torch.data.native;"
            "print(common.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "regbench/run.py", "--workload", "dragon_pair", "--seed",
                          "1", "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    if "CUDA is not available" not in out.stderr:
        pytest.skip("a CUDA device is present")
    assert out.returncode == 2
    assert out.stdout == ""
