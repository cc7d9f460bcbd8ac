"""The port's bench path on the CPU: hgmm_torch.bench, the CLI's `bench`, the
benchmarks of hgmm_torch/benchmarks at tiny sizes, the timing helpers and the
roofline.

The sweep of the bench is held to hgmm.ops.em_ref.em_stats on the same numpy
mixture and points (rtol 2e-3, atol 2e-4, loglik rtol 1e-4: the strict
tolerances of tests/test_fused_em.py:55-56). hgmm/eval/roofline.py has no
numeric counterpart in the port: its constants are a TPU's measured rates, and
the port's roofline is built from the H100's published peaks, so the bounds
are held against hand arithmetic here, not against the JAX module. Only the
dataclass fields and the tie-break rule are shared.
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hgmm.eval import roofline as jroof
from hgmm.ops import em_ref as jref
from hgmm.ops import gaussians as jg
from hgmm_torch import bench, convert
from hgmm_torch.benchmarks import (kernel_compare, kernel_shapes, mxu_microbench, trace_accounting,
                                   vpu_microbench)
from hgmm_torch.cli.main import main as cli_main
from hgmm_torch.eval import roofline
from hgmm_torch.ops import fused_em
from hgmm_torch.ops.gaussians import pack_loglik_weights
from hgmm_torch.utils import timing

torch.set_num_threads(2)

KEYS = {"metric", "value", "unit", "vs_baseline"}
SMALL = dict(n=4096, k=64, sweeps=2)


def _one_json_line(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.strip()]
    assert len(lines) == 1, out
    return json.loads(lines[0])


def test_run_bench_prints_the_reference_keys(capsys):
    fused_em.reset_launches()
    res = bench.run_bench(device="cpu", **SMALL)
    cap = capsys.readouterr()
    rec = _one_json_line(cap.out)
    assert set(rec) == KEYS and rec["metric"] == "estep_points_per_sec_chip"
    assert rec["unit"] == "points/s" and rec["value"] > 0 and math.isfinite(rec["vs_baseline"])
    target = 0.70 * roofline.estep_attainable(SMALL["k"]).points_per_sec
    assert rec["vs_baseline"] == pytest.approx(rec["value"] / target, abs=1e-4)
    assert "ms/sweep" in cap.err and "device=cpu" in cap.err
    assert res["value"] == rec["value"] and res["device"] == "cpu"
    assert all(c == 0 for c in fused_em.LAUNCHES.values())


def test_bench_sweep_matches_jax_em_ref(capsys):
    mix, pts = bench.bench_problem(SMALL["n"], SMALL["k"])
    res = bench.run_bench(device="cpu", **SMALL)
    capsys.readouterr()
    W = jg.pack_loglik_weights(jg.MixtureParams(*map(jnp.asarray, mix)))
    ref = jref.em_stats(jnp.asarray(pts), W)
    np.testing.assert_allclose(res["stats"].S.numpy(), np.asarray(ref.S), rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(float(res["stats"].loglik), float(ref.loglik), rtol=1e-4)


def test_bench_problem_is_seeded_and_well_formed():
    (pi, mu, sigma), pts = bench.bench_problem(1000, 16)
    (pi2, _, _), pts2 = bench.bench_problem(1000, 16)
    np.testing.assert_array_equal(pts, pts2)
    np.testing.assert_array_equal(pi, pi2)
    assert pts.shape == (1000, 3) and pts.dtype == np.float32
    assert mu.shape == (16, 3) and sigma.shape == (16, 3, 3)
    assert pi.sum() == pytest.approx(1.0, abs=1e-6) and (pi > 0).all()
    assert (np.linalg.eigvalsh(sigma.astype(np.float64)) >= 0.05 - 1e-6).all()
    assert not np.array_equal(bench.bench_problem(1000, 16, seed=1)[1], pts)
    assert (bench.N, bench.K, bench.SWEEPS) == (1 << 21, 512, 150)  # the root bench.py's


def test_loglik_weights_carry_across():
    mix, _ = bench.bench_problem(8, 16)
    jW = np.asarray(jg.pack_loglik_weights(jg.MixtureParams(*map(jnp.asarray, mix))))
    tW = pack_loglik_weights(convert.mixture_from_numpy(*mix, device="cpu"))
    assert tW.dtype == torch.float32 and jW.dtype == np.float32 and tW.shape[1] == jW.shape[1]
    np.testing.assert_allclose(jW[:10], tW.numpy()[:10], rtol=1e-4, atol=1e-4)


def test_cli_bench_cpu_and_trace(capsys, tmp_path):
    cli_main(["bench", "--device", "cpu", "--n", "2048", "--k", "16", "--sweeps", "2",
              "--trace", str(tmp_path / "tr")])
    rec = _one_json_line(capsys.readouterr().out)
    assert set(rec) == KEYS and rec["value"] > 0
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
    # A CPU trace holds no device event: the accounting says so.
    with pytest.raises(SystemExit, match="em_stats_kernel"):
        trace_accounting.main([str(tmp_path / "tr")])


def test_module_bench_main_cpu(capsys):
    bench.main(["--device", "cpu", "--n", "1024", "--k", "8", "--sweeps", "1"])
    assert set(_one_json_line(capsys.readouterr().out)) == KEYS


@pytest.mark.parametrize("entry", ["cli", "module"])
def test_bench_on_cuda_without_a_card_exits_2(monkeypatch, capsys, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        (cli_main if entry == "cli" else bench.main)((["bench"] if entry == "cli" else []) + ["--device", "cuda"])
    assert exc.value.code == 2
    assert capsys.readouterr().out == ""


def test_kernel_shapes_cpu(capsys):
    rows = kernel_shapes.main(["--device", "cpu", "--n", "1024", "--sweeps", "1"])
    out = capsys.readouterr().out
    assert [(r["k"], r["masked"]) for r in rows] == list(kernel_shapes.SHAPES)
    assert {(8, False), (64, True), (512, True)} <= set(kernel_shapes.SHAPES)
    for r in rows:
        assert r["ms"] > 0 and r["gpts"] > 0 and r["bound_ms"] > 0
        assert r["bound_by"] in ("bytes", "operations") and r["device"] == "cpu"
    assert json.loads(out.splitlines()[-1])["kernel_shapes"][0]["k"] == 8
    assert kernel_shapes.sweeps_for(512) == 20 and kernel_shapes.sweeps_for(8) == 1280


# the fields of a probe report that a run measures (the rest are its constants)
MEASURED = ("add_", "us_per_tile", "tflops_", "share_of_peak", "ps_per_point", "torch_matmul_us",
            "serial_")


def test_mxu_microbench_cpu(capsys):
    rep = mxu_microbench.main(["--device", "cpu", "--k", "64", "--t", "256", "--steps", "2",
                               "--r1", "1", "--r2", "2"])
    out = capsys.readouterr().out
    assert set(rep["cases"]) == {"logits_bf16", "stats_bf16", "norm_bf16", "logits_f32", "stats_f32"}
    for c in rep["cases"].values():
        assert math.isfinite(c["us_per_tile_raw"]) and c["torch_matmul_us"] > 0
        assert c["peak_tflops"] in (989.0, 67.0)  # the H100's peaks, never a TPU's
        assert len(c["grid"]) == 2
    # No line quotes the TPU's 197 TFLOP/s in any spelling. A measured time may
    # hold the digits ("197.57 ps/elem"), so the search is of the same report
    # printed with every measured field at 0: the text and the constants stay.
    assert out.split("{")[0].count("TFLOP/s peak") == len(rep["cases"])
    blank = {k: 0.0 if k.startswith(MEASURED) else v for k, v in rep.items()}
    blank["cases"] = {n: {k: 0.0 if k.startswith(MEASURED) else v for k, v in c.items()}
                      for n, c in rep["cases"].items()}
    mxu_microbench.print_report(blank)
    constants = capsys.readouterr().out
    assert "TFLOP/s peak" in constants and "197" not in constants
    assert json.loads(out.splitlines()[-1])["k"] == 64


def test_vpu_microbench_cpu(capsys):
    rep = vpu_microbench.main(["--device", "cpu", "--k", "16", "--t", "32", "--steps", "2",
                               "--r1", "1", "--r2", "2"])
    capsys.readouterr()
    tau = {m: rep["modes"][m]["tau_iter_ps"] for m in ("exp2", "cast")}
    # the reference's pair cost: tau(exp2) - (2/3) tau(cast)
    assert rep["tau_pair_ps"] == pytest.approx(tau["exp2"] - (2.0 / 3.0) * tau["cast"], rel=1e-9)
    assert rep["sfu_peak_per_s"] == roofline.H100_SFU_OPS


@pytest.mark.parametrize("module", [mxu_microbench, vpu_microbench, kernel_shapes])
def test_benchmarks_default_to_the_card(monkeypatch, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.run()


def test_trace_accounting_on_a_synthetic_trace(tmp_path, capsys):
    ev = []
    ts = 100.0
    for _ in range(4):  # four sweeps: torch op 2, kernel 50, reduction 5, gap 3
        ev.append({"cat": "kernel", "name": "void at::native::vectorized_elementwise", "ts": ts, "dur": 2.0})
        ev.append({"cat": "kernel", "name": "void hgmm::em_stats_kernel<false>(...)", "ts": ts + 2, "dur": 50.0})
        ev.append({"cat": "kernel", "name": "hgmm::reduce_partials_kernel(...)", "ts": ts + 52, "dur": 5.0})
        ev.append({"cat": "cpu_op", "name": "aten::empty", "ts": ts, "dur": 60.0})
        ts += 60.0
    (tmp_path / "trace.json").write_text(json.dumps({"traceEvents": ev}))
    acc = trace_accounting.main([str(tmp_path), "--k", "512", "--n", str(1 << 21)])
    capsys.readouterr()
    assert acc["sweeps"] == 4
    per = acc["per_sweep_ms"]
    assert per["kernel"] == pytest.approx(0.050) and per["reduction"] == pytest.approx(0.005)
    # the window opens at the first E+M kernel: three of the four torch ops lie inside
    assert per["torch"] == pytest.approx(3 * 0.002 / 4) and per["gap"] == pytest.approx(3 * 0.003 / 4)
    assert acc["model_ms"]["fp32"] == pytest.approx((1 << 21) * 512 * 40 / 67e12 * 1e3)
    assert acc["model_ms"]["hbm"] == pytest.approx((1 << 21) * 16 / 3.35e12 * 1e3)
    assert acc["bound"] == "fp32"


def test_kernel_compare_cpu(tmp_path, capsys):
    """Two runs of one tree give equal bits; a changed output shows its gap."""
    a, b = tmp_path / "a.pt", tmp_path / "b.pt"
    for f in (a, b):
        times = kernel_compare.main(["--save", str(f), "--device", "cpu", "--n", "600",
                                     "--bench-n", "512", "--bench-k", "64"])
        assert times["em_stats_ms"] > 0 and times["knn_ms"] > 0 and times["card"] is None
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 2 and lines[0]["em_stats_shape"] == [512, 64]
    rep = kernel_compare.main(["--diff", str(a), str(b)])
    assert set(rep.values()) == {"bit-equal"}
    assert {"knn", "em_stats_K8", "em_stats_K512_weighted_outlier", "em_stats_masked_K512", "assign_K512",
            "reg_stats_K384", "reg_stats_K64_top8", "reg_stats_K512_top8"} <= set(rep)
    assert times["reg_stats_K512_top8_n16384_ms"] > 0 and times["em_stats_masked_K64_n16384_ms"] > 0
    out = torch.load(a)
    S, ll = out["em_stats_K8"]
    out["em_stats_K8"] = (S + 0.5, ll)
    torch.save(out, b)
    rep = kernel_compare.main(["--diff", str(a), str(b)])
    assert rep["em_stats_K8"]["max_abs_gap"] == 0.5 and rep["knn"] == "bit-equal"
    with pytest.raises(SystemExit):
        kernel_compare.main([])


class _FakeCuda:
    """What kernel_compare.graph_us asks of torch.cuda, on the host: a call
    made while a graph captures records its kernel in the graph and runs
    nothing; a replay runs what the graph recorded. `ran` counts the
    kernels that ran, as the card would."""

    def __init__(self):
        self.ran, self.capturing, self.graphs = 0, None, []
        fake = self

        class Graph:
            def __init__(self):
                self.kernels = 0

            def replay(self):
                fake.ran += self.kernels

        class Event:
            def __init__(self, enable_timing=False):
                pass

            def record(self):
                pass

            def elapsed_time(self, end):
                return 1.0

        self.CUDAGraph, self.Event = Graph, Event

    def launch(self):
        if self.capturing is not None:
            self.capturing.kernels += 1
        else:
            self.ran += 1

    def graph(self, g):
        fake = self

        class Capture:
            def __enter__(self):
                fake.capturing = g

            def __exit__(self, *exc):
                fake.capturing = None

        return Capture()

    def Stream(self):  # noqa: N802
        return self

    def current_stream(self):
        return self

    def wait_stream(self, other):
        pass

    def stream(self, s):
        return self.graph(None)

    def synchronize(self):
        pass


@pytest.mark.parametrize("calls,replays", [(1, 1), (2, 3), (50, 2)])
def test_graph_us_counts_every_launch(calls, replays):
    """A probe timed from a CUDA graph (mxu_microbench.seconds_a_call): its
    wrapper adds to LAUNCHES only when it is called (the warm-up call and
    the capture), but every replay launches the captured kernels again.
    graph_us adds those, so the count is what ran on the card."""
    fake = _FakeCuda()
    counts = {"probe_norm": 0, "em_step": 5}

    def wrapper():  # a port wrapper: launch, then count
        fake.launch()
        counts["probe_norm"] += 1

    us = kernel_compare.graph_us(type("T", (), {"cuda": fake}), wrapper, calls=calls, replays=replays,
                                 launches=counts)
    assert us == pytest.approx(1e3 / (replays * calls))
    assert fake.ran == 1 + calls * (1 + replays)
    assert counts == {"probe_norm": fake.ran, "em_step": 5}
    kernel_compare.graph_us(type("T", (), {"cuda": fake}), wrapper, calls=calls, replays=replays)
    assert counts["probe_norm"] == fake.ran - calls * replays  # without `launches`: the wrappers' count


def test_time_fn_and_sync_on_the_cpu():
    calls = []
    out, med, times = timing.time_fn(lambda a, b=1: calls.append(a) or a + b, 2, b=3, warmup=1, iters=4,
                                     device="cpu")
    assert out == 5 and len(times) == 4 and len(calls) == 5
    assert med == float(np.median(times)) and med >= 0
    assert math.isnan(timing.time_fn(lambda: None, warmup=1, iters=0, device="cpu")[1])
    timing.sync("cpu")
    # the device is required: a forgotten one must not time launches on the host clock
    with pytest.raises(TypeError):
        timing.time_fn(lambda: None)
    with pytest.raises(TypeError):
        timing.sync()
    assert not hasattr(timing, "measure_rtt")  # the tunnel correction is not ported


N, K = 437_645, 512
HAND = {
    # the work these inputs need over the peaks, by hand (seconds)
    "em_stats": (dict(n=N, k=K), N * K * 40 / 67e12, "operations", "fp32"),
    "em_stats_masked": (dict(n=N, k=K, branch=8), (N * 20 + (20 * K + 1) * 4) / 3.35e12, "bytes", "hbm"),
    "assign_masked": (dict(n=N, k=K, branch=8), (N * 24 + 10 * K * 4) / 3.35e12, "bytes", "hbm"),
    "assign": (dict(n=N, k=K), N * K * 20 / 67e12, "operations", "fp32"),
    "reg_stats": (dict(n=N, k=K), N * (K * 45 + 200) / 67e12, "operations", "fp32"),
    "reg_stats_top_k": (dict(n=N, k=K, top_k=8), N * (K * 20 + 8 * 25 + 200) / 67e12, "operations", "fp32"),
    "knn": (dict(nq=N, nt=N), N * N * 8 / 67e12, "operations", "fp32"),
    "probe_logits": (dict(k=512, t=2048, steps=1024, reps=6, dtype="bf16"),
                     1024 * 6 * 2 * 512 * 80 * 2048 / 989e12, "operations", "bf16"),
    "probe_logits_f32": (dict(k=512, t=2048, steps=1024, reps=6, dtype="f32"),
                         1024 * 6 * 2 * 512 * 80 * 2048 / 67e12, "operations", "fp32"),
    "probe_stats": (dict(k=64, t=8192, steps=10, reps=2, dtype="bf16"),
                    20 * 2 * 32 * 64 * 8192 / 989e12, "operations", "bf16"),
    "probe_norm": (dict(k=512, t=2048, steps=1024, reps=6), 6144 * 2 * 8 * 512 * 2048 / 989e12,
                   "operations", "bf16"),
    "probe_addonly": (dict(k=512, t=2048, steps=1024, reps=6), 6144 * 2 * 512 * 2048 / 33.5e12,
                      "operations", "fp32"),
    "probe_vpu": (dict(k=512, t=512, steps=10, reps=2, mode="exp2"),
                  20 * 512 * 512 / (132 * 16 * 67e12 / (132 * 256)), "operations", "sfu"),
    "probe_vpu_cast": (dict(k=512, t=512, steps=2048, reps=8, mode="cast"),
                       2048 * 8 * 2 * 512 * 512 / 33.5e12, "operations", "fp32"),
    "probe_logits_one_product": (dict(k=64, t=256, steps=0, reps=1, dtype="bf16"),
                                 ((64 * 80 + 80 * 256) * 2 + 64 * 256 * 4) / 3.35e12, "bytes", "hbm"),
    # S [K, 10], loglik, total, cov_floor in; pi, mu, sigma (13 a component),
    # the [rows, 12] table and one loglik out
    "em_step": (dict(k=512, rows=512), ((10 * 512 + 3) + 13 * 512 + 12 * 512 + 1) * 4 / 3.35e12,
                "bytes", "hbm"),
    # pi, mu, sigma (13 a component) in; wn and aux (24 a component) out
    "reg_tables": (dict(k=512), 148 * 512 / 3.35e12, "bytes", "hbm"),
}


@pytest.mark.parametrize("case", list(HAND))
def test_kernel_bound_against_hand_arithmetic(case):
    shape, seconds, by, unit = HAND[case]
    kernel = case
    for suffix in ("_masked", "_top_k", "_f32", "_cast", "_one_product"):
        if kernel.endswith(suffix) and kernel != "em_stats_masked":
            kernel = kernel[: -len(suffix)]
    b = roofline.kernel_bound(kernel, **shape)
    assert b.seconds == pytest.approx(seconds, rel=1e-9)
    assert (b.by, b.unit) == (by, unit)
    assert b.seconds == max(b.bytes / roofline.H100_HBM_BYTES, b.seconds if by == "operations" else 0)


def test_kernel_bound_estimates_of_the_table():
    """The bounds the kernel table quotes at 437,645 points (microseconds)."""
    us = lambda name, **s: roofline.kernel_bound(name, **s).seconds * 1e6  # noqa: E731
    assert us("em_stats", n=N, k=512) == pytest.approx(133.8, abs=0.1)
    assert us("em_stats_masked", n=N, k=512, branch=8) == pytest.approx(2.63, abs=0.01)
    assert us("em_stats_masked", n=N, k=64, branch=8) == pytest.approx(2.61, abs=0.01)
    assert us("assign", n=N, k=512, branch=8) == pytest.approx(3.14, abs=0.01)
    assert us("knn", nq=N, nt=N) == pytest.approx(22_870, rel=1e-3)
    assert roofline.kernel_bound("reg_stats", n=N, k=512, top_k=512).seconds == \
        roofline.kernel_bound("reg_stats", n=N, k=512).seconds  # top_k >= K gates nothing
    with pytest.raises(ValueError, match="unknown kernel"):
        roofline.kernel_bound("em_sweep", n=1, k=1)


def test_kernel_bound_of_the_wide_masked_body_and_the_select_body():
    """em_stats_masked_wide computes em_stats_masked's function (its bound
    follows the branch: at 16 children the 40 flop a pair pass the 20 bytes a
    point); reg_stats_select is reg_stats with top_k plus SELECT_PASSES passes
    of OPS_SELECT_KEY operations over the K keys a point, the bytes the same."""
    wide = roofline.kernel_bound("em_stats_masked_wide", n=N, k=256, branch=16)
    assert wide == roofline.kernel_bound("em_stats_masked", n=N, k=256, branch=16)
    assert wide.by == "operations" and wide.flops == N * 16 * 40
    assert roofline.kernel_bound("em_stats_masked", n=N, k=64, branch=8).by == "bytes"
    sel = roofline.kernel_bound("reg_stats_select", n=N, k=512, top_k=64)
    gated = roofline.kernel_bound("reg_stats", n=N, k=512, top_k=64)
    assert sel.flops == gated.flops + N * roofline.SELECT_PASSES * roofline.OPS_SELECT_KEY * 512
    assert sel.bytes == gated.bytes and sel.by == "operations" and sel.seconds > gated.seconds


@pytest.mark.parametrize("nb,branch", [(528, None), (132, None), (900, 8)])
def test_em_step_bound_counts_the_partial_rows(nb, branch):
    """em_step reads the body's partial rows, nb x (10 K + 1) floats (10
    branch + 1 for the grouped body's), not S, and adds each once in float64;
    nb = 1 is the S-and-loglik row."""
    k = 8 if branch is None else 64
    width = 10 * (branch or k) + 1
    b = roofline.kernel_bound("em_step", k=k, rows=k, nb=nb, branch=branch)
    assert b.bytes == (nb * width + 2 + 13 * k + 12 * k + 1) * 4
    assert b.flops == nb * width + k * roofline.FLOP_EM_STEP
    assert b.seconds == pytest.approx(max(b.bytes / 3.35e12, b.flops / roofline.H100_FP64_FLOPS), rel=1e-12)
    one = roofline.kernel_bound("em_step", k=k, rows=k, nb=1, branch=None)
    assert one.bytes == roofline.kernel_bound("em_step", k=k, rows=k).bytes == ((10 * k + 3) + 25 * k + 1) * 4


def test_estep_attainable_hand_arithmetic_and_fields():
    att = roofline.estep_attainable(512)
    t_fma, t_sfu, t_hbm = 512 * 40 / 67e12, 512 / roofline.H100_SFU_OPS, 16 / 3.35e12
    assert att.points_per_sec == pytest.approx(1 / t_fma) and att.bound == "fp32"
    assert att.serial_points_per_sec == pytest.approx(1 / (t_fma + t_sfu))
    assert att.flops_per_point == 512 * 40
    assert (1 << 21) / att.points_per_sec == pytest.approx(0.641e-3, rel=2e-3)  # 0.64 ms a sweep
    m = roofline.estep_attainable(512, masked=True, branch=8)
    assert m.bound == "hbm" and m.points_per_sec == pytest.approx(3.35e12 / 20)
    assert m.flops_per_point == 8 * 40 and t_hbm < 1 / m.points_per_sec
    # the reference's dataclass fields, and none of its constants
    assert [f.name for f in dataclasses.fields(roofline.EstepRoofline)] == \
        [f.name for f in dataclasses.fields(jroof.EstepRoofline)]
    assert roofline.H100_SFU_OPS == pytest.approx(4.1875e12)
    assert not any(hasattr(roofline, name) for name in ("V5E_BF16_FLOPS", "MXU_LOGITS_RATE"))


def test_estep_attainable_tie_break_order():
    """hbm > fp32 > sfu on exact ties, as hgmm/eval/roofline.py:145-153 orders
    hbm > mxu > vpu."""
    tie = dict(fp32_flops=40.0, hbm_bytes=16.0, sfu_ops=1.0)  # k=1: every unit takes 1 s a point
    assert roofline.estep_attainable(1, **tie).bound == "hbm"
    assert roofline.estep_attainable(1, **dict(tie, hbm_bytes=32.0)).bound == "fp32"
    assert roofline.estep_attainable(1, **dict(tie, hbm_bytes=32.0, fp32_flops=80.0)).bound == "sfu"
    assert roofline.estep_attainable(1, **tie).serial_points_per_sec == pytest.approx(0.5)
    # K=8 unmasked at the published peaks is itself an exact tie of stream and FMA
    assert roofline.estep_attainable(8).bound == "hbm"
