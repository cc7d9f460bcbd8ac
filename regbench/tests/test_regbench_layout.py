"""The harness is driven by data: a new configuration, traffic mix, metric
reader and cell are new files and new entries in BENCHMARK.json, found by
name, with no edit to a file that is already there."""

from __future__ import annotations

import hashlib
import json

import pytest

from regbench.harness import cell, layout, requests
from regbench.tests.small import copy_layout


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_every_name_in_the_benchmark_has_its_files():
    lay = layout.Layout()
    for c in lay.bench["configs"]:
        assert lay.config(c["name"])["name"] == c["name"]
        assert lay.config(c["name"])["reduced"] == c["reduced"]
    for w in lay.bench["workloads"]:
        traffic = lay.traffic(w["traffic"])
        assert hasattr(lay.entry(traffic["entry"]), "Entry")
        assert lay.limits(w["name"])
        assert {m["name"] for m in lay.end_to_end(w["name"])} == {"pairs_per_s", "pair_p95_ms", "setup_s"}
        assert lay.per_layer(w["name"])
    for m in lay.bench["per_layer"]:
        assert lay.reader(m["name"])({}) is None  # nothing to read: nothing reported


def test_a_new_config_traffic_metric_and_cell_need_no_edit(tmp_path, monkeypatch):
    root = copy_layout(tmp_path)
    before = _digests(root)
    pkg = root / "regbench"
    cfg = json.loads((pkg / "configs" / "dragon_tree_8x3.json").read_text())
    cfg.update(name="bunny_tree_8x2", levels=2, points=3000)
    (pkg / "configs" / "bunny_tree_8x2.json").write_text(json.dumps(cfg))
    traffic = json.loads((pkg / "traffic" / "pair_pool8.json").read_text())
    traffic.update(pool=1, check_pairs=1)
    (pkg / "traffic" / "pair_pool1.json").write_text(json.dumps(traffic))
    (pkg / "metrics" / "requests_traced.py").write_text(
        "def read(record):\n    return float(record['attempted'])\n")
    (pkg / "limits" / "bunny_pair.json").write_text((pkg / "limits" / "dragon_pair.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bunny_tree_8x2", "source": "http://graphics.stanford.edu/data/3Dscanrep/",
                             "file": "regbench/configs/bunny_tree_8x2.json", "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "bunny_pair", "config": "bunny_tree_8x2", "traffic": "pair_pool1",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "requests_traced", "unit": "requests", "better": "higher",
                               "source": "host_clock", "layer": "entry", "moves": "pairs_per_s",
                               "workloads": ["bunny_pair"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items() if p.name != "BENCHMARK.json")

    lay = layout.Layout(root)
    assert lay.config("bunny_tree_8x2")["levels"] == 2
    assert lay.traffic("pair_pool1")["pool"] == 1
    assert [m["name"] for m in lay.per_layer("bunny_pair")] == [
        "device_idle_pct", "launch_calls_per_pair", "host_syncs_per_pair", "pair_mfu", "requests_traced"]
    assert "requests_traced" not in [m["name"] for m in lay.per_layer("dragon_pair")]
    for name, value in (("PROFILE_PAIRS", 1), ("SYNC_PAIRS", 1), ("SPAN_PAIRS", 1)):
        monkeypatch.setattr(requests, name, value)
    out = cell.run(lay, "bunny_pair", 5, 0.5, True, "cpu", 0.0)["result"]
    assert out["metrics"]["requests_traced"] == {"value": float(out["attempted"]), "unit": "requests"}
    assert out["correct"] is True, out["checks"]
    out = cell.run(lay, "bunny_pair", 5, 0.5, False, "cpu", 0.0)["result"]
    assert set(out["metrics"]) == {"pairs_per_s", "pair_p95_ms", "setup_s"}


def test_an_unknown_name_is_refused(tmp_path):
    lay = layout.Layout(copy_layout(tmp_path))
    for get in (lay.cell, lay.config, lay.entry, lay.reader):
        with pytest.raises((KeyError, FileNotFoundError)):
            get("no_such_name")
