"""hgmm_torch.utils.profiling: the torch.profiler trace, the device-busy
reading of its Chrome trace, and the JSONL metrics sink."""

import json

import numpy as np
import torch

from hgmm_torch.utils.profiling import MetricsLog, device_busy, trace


def _event(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_device_busy_counts_overlaps_once(tmp_path):
    """Kernels on two streams overlap; host ops and runtime calls are not
    device time."""
    events = [
        _event("cpu_op", "aten::mul", 0.0, 50.0),
        _event("cuda_runtime", "cudaLaunchKernel", 1.0, 3.0),
        _event("kernel", "k_a", 10.0, 5.0),
        _event("kernel", "k_b", 12.0, 5.0),  # overlaps k_a: busy 10-17
        _event("gpu_memcpy", "Memcpy HtoD", 20.0, 2.0),
        _event("kernel", "k_a", 30.0, 4.0),
        _event("kernel", "k_c", 31.0, 1.0),  # inside the second k_a
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 40.0},  # no duration
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    busy, by_name = device_busy(path)
    assert busy == 7.0 + 2.0 + 4.0
    assert by_name == {"k_a": 9.0, "k_b": 5.0, "k_c": 1.0}


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.randn(64, 64)
    with trace(tmp_path / "t"):
        (x @ x).sum()
    path = tmp_path / "t" / "trace.json"
    assert any(e.get("cat") == "cpu_op" for e in json.loads(path.read_text())["traceEvents"])
    busy, by_name = device_busy(path)  # a CPU-only trace: no device time
    assert busy == 0.0 and by_name == {}


def test_metrics_log_serializes_tensors(tmp_path):
    log = MetricsLog(tmp_path / "sub" / "m.jsonl")
    log.log({"event": "a", "x": torch.tensor(1.5), "v": torch.arange(3),
             "n": np.float32(2.0), "nested": [{"t": torch.ones(2, dtype=torch.float64)}]})
    log.log({"event": "b"})
    lines = [json.loads(s) for s in (tmp_path / "sub" / "m.jsonl").read_text().splitlines()]
    assert [r["event"] for r in lines] == ["a", "b"]
    assert lines[0]["x"] == 1.5 and lines[0]["v"] == [0, 1, 2] and lines[0]["n"] == 2.0
    assert lines[0]["nested"] == [{"t": [1.0, 1.0]}]
    assert all(isinstance(r["time"], float) for r in lines)
