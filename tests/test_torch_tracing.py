"""hgmm_torch.utils.profiling's spans and counters: off, a span is one shared
object that does nothing; under torch.profiler it is a record_function;
inside tracing() the tracer keeps the spans by request, the counters of the
open request, and the scan's live steps, read after the block. The program's
span tree on a CPU register_pair and run_odometry, and the scan state's live
steps against the benchmark's live-iteration rule."""

import importlib.util
import json
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.models.gmm import Gmm
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.ops import em_ref, fused_em
from hgmm_torch.pipelines.odometry import OdometryConfig, run_odometry
from hgmm_torch.pipelines.register import register_pair, register_points
from hgmm_torch.utils import profiling
from hgmm_torch.utils.profiling import count, count_later, span, trace, tracing

REPO = Path(__file__).resolve().parents[1]


def _roofline():
    """The benchmark's needed-work arithmetic (regbench/harness/roofline.py),
    loaded by path: plain Python, no import of the harness."""
    spec = importlib.util.spec_from_file_location("regbench_roofline",
                                                  REPO / "regbench" / "harness" / "roofline.py")
    mod = sys.modules[spec.name] = importlib.util.module_from_spec(spec)  # dataclasses look it up
    spec.loader.exec_module(mod)
    return mod


class _CountingRecordFunction:
    """Stands in for torch.profiler.record_function and counts its calls."""

    def __init__(self, real):
        self.real, self.calls = real, 0

    def __call__(self, name, *args):
        self.calls += 1
        return self.real(name, *args)


@pytest.fixture
def record_calls(monkeypatch):
    counting = _CountingRecordFunction(torch.profiler.record_function)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return counting


@pytest.fixture
def clock(monkeypatch):
    """A fake clock: each reading is 1 ms after the last."""
    ticks = iter(range(0, 10**12, 1_000_000))
    monkeypatch.setattr(profiling, "_clock", lambda: next(ticks))


def _pair(n=1500, seed=3):
    src = torch.from_numpy(make_cloud_np(n, "trefoil", seed=seed))
    R = so3_exp(torch.tensor([0.04, -0.03, 0.05]))
    return src, src @ R.T + torch.tensor([0.01, 0.0, -0.02])


def _tree(tracer: profiling.Tracer, request: int):
    """The span tree of one request: (name, [children]) from its top span."""
    nodes = {}
    for i, (name, _, _, parent, req) in enumerate(tracer.spans):
        if req == request:
            nodes[i] = (name, [])
            if parent >= 0:
                nodes[parent][1].append(nodes[i])
    roots = [nodes[i] for i, s in enumerate(tracer.spans) if s[4] == request and s[3] < 0]
    assert len(roots) == 1
    return roots[0]


def _leaf(name):
    return (name, [])


FIT_TREE3 = ("hgmm_torch.fit", [_leaf("hgmm_torch.fit.init"), _leaf("hgmm_torch.fit.sweeps"),
                                 _leaf("hgmm_torch.fit.group"), _leaf("hgmm_torch.fit.sweeps"),
                                 _leaf("hgmm_torch.fit.group"), _leaf("hgmm_torch.fit.sweeps")])
LEVEL = [_leaf("hgmm_torch.reg.prep"), _leaf("hgmm_torch.reg.scan")]


# (a) off


def test_span_off_is_the_shared_no_op(record_calls):
    assert profiling.tracer is None
    s = span("hgmm_torch.fit")
    assert s is profiling.NO_SPAN and span("other") is s
    with s as entered:
        assert entered is s
    src, tgt = _pair(600)
    register_pair(src, tgt, fit_iters=2, n_iters=3, complexity_threshold=0.02)
    count("reg.steps", 5)  # nothing to count into
    count_later("reg.live_steps", torch.zeros(32), 28)
    assert record_calls.calls == 0
    with torch.profiler.profile():
        with span("on"):
            pass
    assert record_calls.calls == 1  # the patch is what span() calls when a profiler runs


def test_span_off_passes_exceptions_through():
    with pytest.raises(ValueError):
        with span("x"):
            raise ValueError("inside")


# (b) on


def test_tracer_nesting_parents_requests_and_self_times(clock):
    with tracing() as tr:
        with span("a"):  # request 0: a(b(c), d)
            with span("b"):
                with span("c"):
                    pass
            with span("d"):
                pass
        with span("e"):  # request 1
            pass
        with span("a"):  # request 2
            pass
    assert [s[0] for s in tr.spans] == ["a", "b", "c", "d", "e", "a"]
    assert [s[3] for s in tr.spans] == [-1, 0, 1, 0, -1, -1]
    assert [s[4] for s in tr.spans] == [0, 0, 0, 0, 1, 2]
    # the clock ticks 1 ms a reading: a 0-7, b 1-4, c 2-3, d 5-6
    assert [(s[1] // 10**6, s[2] // 10**6) for s in tr.spans[:4]] == [(0, 7), (1, 4), (2, 3), (5, 6)]
    first, second, third = tr.summary()
    assert first["request"] == 0 and first["name"] == "a"
    assert first["ms"] == {"a": 7.0, "b": 3.0, "c": 1.0, "d": 1.0}
    assert first["self_ms"] == {"a": 3.0, "b": 2.0, "c": 1.0, "d": 1.0}
    assert first["spans"] == {"a": 1, "b": 1, "c": 1, "d": 1}
    assert (second["name"], second["ms"]) == ("e", {"e": 1.0})
    assert (third["request"], third["name"]) == (2, "a")
    assert tr.summary() == [first, second, third]  # taken again, the same


def test_tracer_span_stack_is_per_thread(clock):
    seen = {}

    def worker():
        count("lost")  # no span open on this thread: attributed to nothing
        with span("w"):
            count("n", 2)
            seen["request"] = tr._request()

    with tracing() as tr:
        with span("main"):
            count("n")
            t = threading.Thread(target=worker)
            t.start()
            t.join()
            count("n")
    out = {r["name"]: r for r in tr.summary()}
    assert seen["request"] == out["w"]["request"] != out["main"]["request"]
    assert out["main"]["counts"] == {"n": 2} and out["w"]["counts"] == {"n": 2}
    assert tr.spans[1][3] == -1  # the thread's span has no parent on the main thread


def test_tracing_is_one_per_process_and_summary_comes_after():
    with tracing() as tr:
        with pytest.raises(RuntimeError):
            with tracing():
                pass
        with pytest.raises(RuntimeError):
            tr.summary()
    assert profiling.tracer is None
    assert tr.summary() == []
    with tracing():  # on again after the block
        assert isinstance(span("x"), profiling._Span)


def test_a_span_closes_when_its_block_raises(clock):
    with tracing() as tr:
        with pytest.raises(KeyError):
            with span("outer"):
                with span("inner"):
                    raise KeyError
        with span("next"):
            pass
    assert [s[4] for s in tr.spans] == [0, 0, 1]  # the stack was emptied
    assert all(s[2] is not None for s in tr.spans)


# (c) under torch.profiler


def test_spans_are_nested_user_annotations_in_a_profiler_trace(tmp_path):
    src, tgt = _pair(600)
    with trace(tmp_path):
        register_pair(src, tgt, fit_iters=2, n_iters=3, complexity_threshold=0.02)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ann = [e for e in events if e.get("cat") == "user_annotation" and e["name"].startswith("hgmm_torch.")]
    by = {}
    for e in ann:
        by.setdefault(e["name"], []).append((e["ts"], e["ts"] + e["dur"]))
    assert {k: len(v) for k, v in by.items()} == {
        "hgmm_torch.fit": 1, "hgmm_torch.fit.init": 1, "hgmm_torch.fit.sweeps": 3,
        "hgmm_torch.fit.group": 2, "hgmm_torch.reg": 1, "hgmm_torch.reg.cut": 1,
        "hgmm_torch.reg.prep": 3, "hgmm_torch.reg.scan": 3}

    def inside(child, parent):
        (a, b), = by[parent]
        return all(a <= s and e <= b for s, e in by[child])

    assert all(inside(c, "hgmm_torch.fit") for c in ("hgmm_torch.fit.init", "hgmm_torch.fit.sweeps",
                                                     "hgmm_torch.fit.group"))
    assert all(inside(c, "hgmm_torch.reg") for c in ("hgmm_torch.reg.cut", "hgmm_torch.reg.prep",
                                                     "hgmm_torch.reg.scan"))
    assert by["hgmm_torch.fit"][0][1] <= by["hgmm_torch.reg"][0][0]


def test_spans_go_to_the_profiler_and_the_tracer_at_once(tmp_path, record_calls):
    with tracing() as tr, trace(tmp_path):
        with span("both"):
            pass
    assert record_calls.calls == 1 and tr.summary()[0]["name"] == "both"


# (d) counters


@pytest.fixture
def launches():
    saved = dict(fused_em.LAUNCHES)
    yield fused_em.LAUNCHES
    fused_em.LAUNCHES.update(saved)


def test_count_and_count_launch_go_to_the_open_request(launches):
    before = launches["reg_step"]
    with tracing() as tr:
        fused_em.count_launch("reg_step")  # no span open: LAUNCHES only
        count("x")
        with span("r0"):
            fused_em.count_launch("reg_step")
            fused_em.count_launch("em_step")
            count("x", 3)
        with span("r1"):
            fused_em.count_launch("reg_step")
    fused_em.count_launch("reg_step")  # the tracer is off: LAUNCHES only
    r0, r1 = tr.summary()
    assert r0["counts"] == {"launch.reg_step": 1, "launch.em_step": 1, "x": 3}
    assert r1["counts"] == {"launch.reg_step": 1}
    assert launches["reg_step"] == before + 4  # every launch, traced or not


def _stand_in_card(monkeypatch, lib):
    """The kernel library replaced by `lib`, torch's device and current
    stream (7) by stand-ins: a wrapper's call runs on the CPU."""
    import contextlib
    from types import SimpleNamespace

    from hgmm_torch.ops import _build

    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: SimpleNamespace(cuda_stream=7))


def _cpu_tables(gate: int, body: str, counters=None) -> fused_em.RegTables:
    """A RegTables of CPU tensors: 100 points, K = 8, 3 blocks of 2 lanes,
    reg_step on one block; what the step path passes on, unchecked."""
    rows = em_ref.RegPartials(torch.zeros((3, em_ref.REG_OUT)), 1)
    return fused_em.RegTables(torch.zeros((4, 100)), torch.zeros((8, 12)), torch.zeros((8, 12)), gate,
                              (1, -8.0), fused_em.RegPlan(lanes=2, blocks=3, kmax=0, chunk=1), body, rows,
                              em_ref.RegPartials(torch.zeros((1, em_ref.REG_OUT)), 1), counters)


def test_launch_counts_only_a_launch_that_returned_zero(launches, monkeypatch):
    """_build.launch on a stand-in library: the entry gets the arguments and
    the device's current stream; a nonzero code raises with the library's
    message and counts nothing; a zero code counts once in LAUNCHES and,
    inside tracing(), once as launch.<name> in the open request."""
    from hgmm_torch.ops import _build

    calls = []

    class Lib:
        code = 0

        def hgmm_reg_step(self, *args):
            calls.append(args)
            return self.code

        def hgmm_error_string(self, err):
            return b"invalid argument"

    lib = Lib()
    _stand_in_card(monkeypatch, lib)
    before = launches["reg_step"]
    lib.code = 1
    with tracing() as tr, span("r"):
        with pytest.raises(RuntimeError, match="reg_step: CUDA error 1: invalid argument"):
            _build.launch("reg_step", "hgmm_reg_step", "cuda:0", 3, None)
    assert launches["reg_step"] == before and tr.summary()[0]["counts"] == {}
    lib.code = 0
    with tracing() as tr, span("r"):
        _build.launch("reg_step", "hgmm_reg_step", "cuda:0", 3, None)
    assert launches["reg_step"] == before + 1 and tr.summary()[0]["counts"] == {"launch.reg_step": 1}
    assert calls == [(3, None, 7)] * 2


@pytest.mark.parametrize("gate,body", [(0, "reg_stats"), (4, "reg_stats_top_k")])
def test_reg_scan_is_one_call_counted_as_its_steps_launches(launches, monkeypatch, gate, body):
    """fused_em.reg_scan on a stand-in library: hgmm_reg_scan gets the
    tables' and the scan's pointers and plan, the schedule as [steps, 4] ints
    (scan_schedule's rows) and the device's current stream. A zero code counts
    each step's two launches under the names the wrappers count them (the
    table's body, reg_step) and adds the steps to reg.native_steps; a nonzero
    code raises with the step the entry reports and counts nothing."""
    from hgmm_torch.pipelines.register import scan_schedule

    calls = []

    class Lib:
        code, failed_at = 0, -1

        def hgmm_reg_scan(self, *args):
            *head, schedule, steps, failed, stream = args
            calls.append((head, list(schedule), steps, stream))
            failed._obj.value = self.failed_at
            return self.code

        def hgmm_error_string(self, err):
            return b"an illegal memory access was encountered"

    lib = Lib()
    _stand_in_card(monkeypatch, lib)
    tab = _cpu_tables(gate, body, torch.zeros(3, dtype=torch.int64) if gate else None)
    scan = fused_em.CardScan(*em_ref.new_scan(torch.eye(3), torch.zeros(3), 5, dtype=torch.float32))
    steps = scan_schedule(5, "horn+wls", 2)
    before = dict(launches)
    lib.code, lib.failed_at = 700, 4
    with tracing() as tr, span("r"):
        with pytest.raises(RuntimeError, match="reg_scan: CUDA error 700 at step 4: an illegal memory"):
            fused_em.reg_scan(tab, scan, steps, 1e-7)
    assert launches == before and tr.summary()[0]["counts"] == {}
    lib.code = 0
    with tracing() as tr, span("r"):
        fused_em.reg_scan(tab, scan, steps, 1e-7)
    n = len(steps)
    assert n == 2 + 3 * 2
    assert tr.summary()[0]["counts"] == {f"launch.{body}": n, "launch.reg_step": n, "reg.native_steps": n}
    assert {k: launches[k] - before[k] for k in launches if launches[k] != before[k]} == {body: n, "reg_step": n}
    head = [tab.pts4.data_ptr(), 100, scan.state.data_ptr(), tab.wn.data_ptr(), tab.aux.data_ptr(), 8, gate, 2, 1, 1,
            1, -8.0, tab.rows.partial.data_ptr(), 3, None if not gate else tab.counters.data_ptr(),
            scan.logliks.data_ptr(), scan.deltas.data_ptr(), 1e-7, 1]
    schedule = [v for step in steps for v in (step.it, step.solver, int(step.first), int(step.last))]
    assert calls == [(head, schedule, n, 7)] * 2
    fused_em.reg_scan(tab, scan, (), 1e-7)  # no step: no call
    assert len(calls) == 2
    with pytest.raises(ValueError, match="iterations"):
        fused_em.reg_scan(tab, scan, scan_schedule(6, "horn", 2), 1e-7)  # past the scan's 5 iterations


def _stand_in_flat_bodies(monkeypatch):
    """A fit's unmasked E-step through fused_em on the CPU: ops.new_fit binds
    a Prepared buffer to fused_em.flat_body (the card's plan at 132 SMs) and
    the stand-in library writes the plain statistics at the fit's table into
    the body's first partial row, the others zero, so em_step's plain twin
    sums what the plain sweep would. A tree's grouped levels stay on the
    CPU's plain path."""
    from hgmm_torch import ops
    from hgmm_torch.ops import _build

    bodies = {}

    class Lib:
        def hgmm_em_stats(self, pts4, n, wn, k, geometry, has_outlier, outlier, partial, n_rows, out, stream):
            body, table = bodies[partial]
            stats = em_ref.em_stats(body.pts4[:3].T, table, body.pts4[3])
            body.parts.partial.zero_()
            body.parts.partial[0] = em_ref.partials_of(stats).partial[0]
            return 0

        hgmm_em_stats_tiled = hgmm_em_stats

    _stand_in_card(monkeypatch, Lib())
    monkeypatch.setattr(_build, "sms", lambda dev: 132)
    monkeypatch.setattr(fused_em, "check_tensor", lambda *a, **k: None)
    plain_new_fit = ops.new_fit

    def new_fit(data, init, n_iters, total, cov_floor):
        fit = plain_new_fit(data, init, n_iters, total, cov_floor)
        if not isinstance(data, ops.Prepared):
            return fit
        body = fused_em.flat_body(data.pts4, init.k)
        bodies[body.parts.partial.data_ptr()] = (body, fit.table)
        return fit._replace(data=body)

    monkeypatch.setattr(ops, "new_fit", new_fit)


@pytest.mark.parametrize("kind", ["flat64", "tree"])
def test_em_stats_launches_count_by_body(launches, monkeypatch, kind):
    """A flat K = 64 fit launches the register-tiled E-step body once a sweep,
    counted as launch.em_stats_tiled (and em_stats_tiled in LAUNCHES); a tree
    fit's level 0 (K = 8) launches the first body, still counted as
    launch.em_stats, and a tree raises no em_stats_tiled. The fits equal the
    plain ones bit for bit: the stand-in body hands em_step the same sums."""
    from hgmm_torch.models.gmm_tree import GmmTree

    _, tgt = _pair(2000)

    def fit():
        g = torch.Generator().manual_seed(5)
        if kind == "flat64":
            return [Gmm.fit(tgt, k=64, n_iters=6, generator=g)[0].params]
        return GmmTree.fit(tgt, branch=8, levels=2, em_iters=4, generator=g)[0].levels

    plain = fit()
    _stand_in_flat_bodies(monkeypatch)
    before = dict(launches)
    with tracing() as tr:
        got = fit()
    (req,) = tr.summary()
    want = {"launch.em_stats_tiled": 6} if kind == "flat64" else {"launch.em_stats": 4}
    assert {k: v for k, v in req["counts"].items() if k.startswith("launch.")} == want
    assert {k: launches[k] - before[k] for k in launches if launches[k] != before[k]} == {
        name.split(".", 1)[1]: n for name, n in want.items()}
    assert all(torch.equal(a, b) for p, q in zip(got, plain) for a, b in zip(p, q))


@pytest.mark.parametrize("ranks", [None, 2])
def test_the_cpu_and_a_mesh_step_from_python(monkeypatch, ranks):
    """On the CPU and with a mesh the scan steps from Python: ops.reg_step
    gets scan_schedule's steps one by one (on each rank), and
    reg.native_steps stays 0 beside reg.steps."""
    from hgmm_torch import ops
    from hgmm_torch.parallel import EmulatedMesh, sharded_register_points
    from hgmm_torch.pipelines.register import scan_schedule

    seen = {}
    step = ops.reg_step

    def recording_step(rows, scan, it, solver, first, last, tol):
        seen.setdefault(threading.get_ident(), []).append((it, solver, first, last))
        return step(rows, scan, it, solver, first, last, tol)

    monkeypatch.setattr(ops, "reg_step", recording_step)
    src, tgt = _pair(600, seed=8)
    params = Gmm.fit(tgt, k=8, n_iters=4)[0].params
    kw = dict(n_iters=5, method="horn+wls", tol=0.0, wls_inner=3)
    with tracing() as tr:
        if ranks is None:
            with span("r"):
                register_points(src, params, **kw)
        else:
            sharded_register_points(src, params, EmulatedMesh(ranks, "cpu"), **kw)
    requests = tr.summary()
    assert len(requests) == (ranks or 1) == len(seen)
    want = list(scan_schedule(5, "horn+wls", 3))
    assert all(got == want for got in seen.values())
    for r in requests:
        assert r["counts"]["reg.steps"] == len(want) and "reg.native_steps" not in r["counts"]


def test_count_later_reads_the_value_after_the_block():
    state = torch.zeros(32)
    with tracing() as tr:
        count_later("off", state, 28)  # no span open: nothing
        with span("r"):
            count_later("reg.live_steps", state, 28)
            count_later("reg.live_steps", state, 29)
        state[28] = 5.0  # the work runs on after the call
        state[29] = 2.0
    assert tr.summary()[0]["counts"] == {"reg.live_steps": 7}
    assert tr.summary()[0]["counts"] == {"reg.live_steps": 7}  # read once, not added again


# (e) the program's span tree


def test_register_pair_span_tree_and_counters():
    src, tgt = _pair()
    n_iters, wls_inner = 6, 2
    with tracing() as tr:
        with span("request"):
            res = register_pair(src, tgt, fit_iters=3, n_iters=n_iters, complexity_threshold=0.02,
                                method="horn+wls", wls_inner=wls_inner, tol=1e-4)
        register_pair(src, tgt, fit_iters=3, n_iters=n_iters, method="horn+wls",
                      wls_inner=wls_inner, tol=1e-4)  # no cut; fit and registration alone
    assert _tree(tr, 0) == ("request", [FIT_TREE3, ("hgmm_torch.reg", [
        *LEVEL, *LEVEL, _leaf("hgmm_torch.reg.cut"), *LEVEL])])
    assert _tree(tr, 1) == FIT_TREE3
    assert _tree(tr, 2) == ("hgmm_torch.reg", LEVEL * 3)
    first = tr.summary()[0]
    assert first["spans"]["hgmm_torch.reg.scan"] == 3
    assert sum(first["spans"].values()) == 16  # the request's own span and 15 of the program
    steps = 3 * (n_iters // 2 + (n_iters - n_iters // 2) * wls_inner)
    assert first["counts"]["reg.steps"] == steps
    rule = _roofline()
    live = rule.live_iterations(res.deltas.tolist(), n_iters, 1e-4)
    assert first["counts"]["reg.live_steps"] == sum(
        min(m, n_iters // 2) + max(m - n_iters // 2, 0) * wls_inner for m in live)
    assert all(v >= 0 for v in first["self_ms"].values())


def _scans(n_frames=3, n=900):
    scene = make_cloud_np(n, "trefoil", seed=0)
    out = []
    for k in range(n_frames):
        R = so3_exp(torch.tensor([0.0, 0.0, 0.04 * k])).numpy()
        out.append((scene @ R.T + np.float32([0.03 * k, 0.0, 0.0])).astype(np.float32))
    return out


@pytest.mark.parametrize("kind", ["tree", "flat"])
def test_run_odometry_span_tree(kind):
    cfg = OdometryConfig(model_kind=kind, k=8, fit_iters=2, reg_iters=3, bucket=512, device="cpu")
    with tracing() as tr:
        run_odometry(_scans(), cfg)
    requests = tr.summary()
    assert [r["name"] for r in requests] == ["hgmm_torch.odo.frames"] + ["hgmm_torch.odo.pair"] * 2
    assert _tree(tr, 0) == _leaf("hgmm_torch.odo.frames")
    if kind == "tree":
        fit, reg = FIT_TREE3, ("hgmm_torch.reg", LEVEL * 3)
    else:
        fit = ("hgmm_torch.fit", [_leaf("hgmm_torch.fit.init"), _leaf("hgmm_torch.fit.sweeps")])
        reg = ("hgmm_torch.reg", LEVEL)
    upload = _leaf("hgmm_torch.odo.upload")
    for r in (1, 2):
        assert _tree(tr, r) == ("hgmm_torch.odo.pair", [upload, fit, upload, reg])
        levels = 3 if kind == "tree" else 1
        assert requests[r]["counts"]["reg.steps"] == levels * 3 * 2  # WLS, 2 steps an iteration
        assert 1 <= requests[r]["counts"]["reg.live_steps"] <= levels * 3 * 2
    if kind == "tree":
        assert sum(requests[1]["spans"].values()) == 17


# (f) the scan's live steps


@pytest.mark.parametrize("method", ["horn", "wls", "horn+wls"])
@pytest.mark.parametrize("tol", [1e-3, 0.0])
def test_scan_live_steps_follow_the_live_iteration_rule(method, tol):
    """The twin's SCAN_LIVE after a whole scan equals the live iterations of
    the benchmark's rule (up to and including the first delta below tol),
    turned into steps: a Horn iteration one, a WLS iteration wls_inner.
    tol 1e-3 stops early, tol 0 never."""
    src, tgt = _pair(1200, seed=5)
    params = Gmm.fit(tgt, k=16, n_iters=8)[0].params
    n_iters, wls_inner = 12, 3
    with tracing() as tr:
        with span("r"):
            res = register_points(src, params, init_pose=Pose.identity(device="cpu"),
                                  n_iters=n_iters, method=method, tol=tol, wls_inner=wls_inner)
    counts = tr.summary()[0]["counts"]
    (live,) = _roofline().live_iterations(res.deltas.tolist(), n_iters, tol)
    n_horn = {"horn": n_iters, "wls": 0, "horn+wls": n_iters // 2}[method]
    steps = min(live, n_horn) + max(live - n_horn, 0) * wls_inner
    assert counts["reg.live_steps"] == steps
    assert counts["reg.steps"] == n_horn + (n_iters - n_horn) * wls_inner
    assert (steps < counts["reg.steps"]) == (tol > 0)  # the early stop is exercised


def test_twin_step_adds_a_live_step_only_while_not_done():
    from hgmm_torch import ops

    src, tgt = _pair(800, seed=7)
    problem = ops.reg_problem_of(tgt, Gmm.fit(tgt, k=8, n_iters=5)[0].params)
    scan = em_ref.new_scan(torch.eye(3), torch.zeros(3), 4)
    em_ref.reg_step(ops.reg_partials(problem, scan).partial, scan, 0, 0, True, True, 0.0)
    em_ref.reg_step(ops.reg_partials(problem, scan).partial, scan, 1, 1, True, False, 0.0)
    assert float(scan.state[em_ref.SCAN_LIVE]) == 2.0 and not bool(scan.done)
    em_ref.reg_step(ops.reg_partials(problem, scan).partial, scan, 1, 1, False, True, 1.0)  # done
    assert float(scan.state[em_ref.SCAN_LIVE]) == 3.0 and bool(scan.done)
    em_ref.reg_step(torch.zeros((1, em_ref.REG_OUT)), scan, 2, 0, True, True, 1.0)
    assert float(scan.state[em_ref.SCAN_LIVE]) == 3.0


# (g) the SLAM back end: closures, the pose graph, the map


def _loop_scans(n_frames=12, n=900):
    """A scene seen from n_frames poses that come back to the start: every
    pair j - i > 5 lies near enough to be a closure candidate."""
    scene = make_cloud_np(n, "trefoil", seed=1)
    out = []
    for k in range(n_frames):
        a = 0.03 * np.sin(2 * np.pi * k / 6)
        R = so3_exp(torch.tensor([0.0, 0.0, a])).numpy()
        t = np.float32([0.02 * np.cos(2 * np.pi * k / 6), 0.0, 0.0])
        out.append((scene @ R.T + t).astype(np.float32))
    return out


def _back_end(scans, n_iters=3):
    from hgmm_torch.pipelines.loop_closure import ClosureConfig
    from hgmm_torch.pipelines.mapping import MapConfig, build_map
    from hgmm_torch.pipelines.odometry import refine_odometry

    cfg = OdometryConfig(k=8, branch=2, levels=2, fit_iters=2, reg_iters=3, bucket=512, device="cpu")
    res = run_odometry(scans, cfg, detect_closures=True,
                       closure_config=ClosureConfig(radius_steps=100.0, max_candidates=2))
    refined = refine_odometry(res, n_iters=n_iters)
    tree = build_map(scans, refined.poses(), MapConfig(branch=2, levels=2, em_iters=2, voxel=0.0,
                                                        bucket=4096))
    return res, refined, tree


def _names(tree):
    name, children = tree
    return name, [c[0] for c in children]


def test_back_end_spans_nest_and_count():
    scans = _loop_scans()
    with pytest.warns(UserWarning, match="verification budget"):
        with tracing() as tr:
            res, _, _ = _back_end(scans)
    requests = tr.summary()
    by_name = {r["name"]: (i, r) for i, r in enumerate(requests)}
    i, closures = by_name["hgmm_torch.odo.closures"]
    top, children = _names(_tree(tr, i))
    assert top == "hgmm_torch.odo.closures" and children == ["hgmm_torch.odo.closure"] * 2
    for name, kids in _tree(tr, i)[1]:  # a verification: its frames' fits and registrations
        work = [k[0] for k in kids if k[0] != "hgmm_torch.odo.upload"]
        assert work[:2] == ["hgmm_torch.fit", "hgmm_torch.reg"]
    c = closures["counts"]
    accepted = 0 if res.closures is None else int(res.closures.i.numel())
    assert c["closure.verified"] == 2 and c["closure.accepted"] == accepted
    assert c["closure.candidates"] >= c["closure.verified"]
    assert c["closure.verified"] <= c["closure.registrations"] <= 2 * c["closure.verified"]
    assert 1 <= c["closure.fits"] <= c["closure.registrations"]
    assert closures["spans"]["hgmm_torch.fit"] == c["closure.fits"]
    i, refine = by_name["hgmm_torch.pg.refine"]
    assert _tree(tr, i) == _leaf("hgmm_torch.pg.refine")
    assert refine["counts"] == {"pg.iters": 3, "pg.edges": len(scans) - 1 + accepted}
    i, mapped = by_name["hgmm_torch.map"]
    fit2 = (FIT_TREE3[0], FIT_TREE3[1][:4])  # a two-level tree
    assert _tree(tr, i) == ("hgmm_torch.map", [_leaf("hgmm_torch.map.fuse"), ("hgmm_torch.map.fit", [fit2])])
    fused = len(scans) * 900
    assert mapped["counts"] == {"map.fused_points": fused, "map.dropped_points": fused - 4096}


def test_update_map_and_the_sharded_refine_trace_as_the_dense():
    from hgmm_torch.parallel import EmulatedMesh
    from hgmm_torch.pipelines.mapping import MapConfig, build_map, update_map
    from hgmm_torch.pipelines.pose_graph import odometry_chain_edges, refine_chain_sharded

    scans = _loop_scans(n_frames=4)
    cfg = MapConfig(branch=2, levels=2, em_iters=2, voxel=0.0, bucket=4096)
    poses = [Pose.identity(device="cpu")] * 4
    tree = build_map(scans[:2], poses[:2], cfg)
    rel = [Pose(so3_exp(torch.tensor([0.0, 0.0, 0.01 * k])), torch.tensor([0.1, 0.0, 0.0])) for k in range(5)]
    edges = odometry_chain_edges(rel)
    R, t = torch.eye(3).expand(6, 3, 3).clone(), torch.zeros(6, 3)
    with tracing() as tr:
        update_map(tree, scans[2:], poses[2:], cfg)
        refine_chain_sharded(R, t, edges.R, edges.t, EmulatedMesh(2, "cpu"), n_iters=2)
    requests = tr.summary()
    assert requests[0]["name"] == "hgmm_torch.map"
    assert _names(_tree(tr, 0)) == ("hgmm_torch.map", ["hgmm_torch.map.fuse", "hgmm_torch.map.fit"])
    assert requests[0]["counts"] == {"map.fused_points": 2 * 1800, "map.dropped_points": 0}  # new + carried
    refines = [r for r in requests if r["name"] == "hgmm_torch.pg.refine"]
    assert len(refines) == 2  # one a rank
    assert all(r["counts"] == {"pg.iters": 2, "pg.edges": 5} and r["spans"] == {"hgmm_torch.pg.refine": 1}
               for r in refines)


def test_back_end_records_nothing_with_no_tracer(record_calls, monkeypatch):
    def recorded(*a, **k):
        raise AssertionError("a span was recorded with no tracer on")

    monkeypatch.setattr(profiling.Tracer, "_open", recorded)
    monkeypatch.setattr(profiling.Tracer, "_count", recorded)
    with pytest.warns(UserWarning, match="verification budget"):
        _back_end(_loop_scans())
    assert profiling.tracer is None and record_calls.calls == 0
