"""The harness's own arithmetic and its frozen copies: the rate and the
tail, the trace reductions (busy union, launch calls, device time inside
spans, the breakdown), the live-iteration count, the needed-work bounds
against the port's roofline, the input generators against their originals,
and the seed's determinism."""

from __future__ import annotations

import importlib.util
import time

import numpy as np
import pytest

from regbench.harness import common, data, requests, roofline, trace
from regbench.tests.small import REPO


def test_rate_is_every_pair_over_the_whole_window():
    assert common.rate(30, 2.0) == 15.0

    class Stub(requests.PoolEntry):
        def request(self, j, spans=None):
            time.sleep(0.002)
            return requests.Outcome(np.eye(3), np.zeros(3), None, None, None)

    entry = Stub({}, {}, 0, "cpu")
    entry.pool, entry.checked = [None] * 3, []
    lat, failed, wall = entry.window(0.05)
    assert failed == 0 and len(lat) >= 10
    assert wall >= 0.05 and sum(lat) <= wall
    assert common.rate(len(lat), wall) == len(lat) / wall


def test_setup_leaves_out_the_build(tmp_path, monkeypatch):
    """setup_s runs from the process's start to the window, less the seconds
    the build took, which the information line reports as build_s."""
    from regbench.harness import cell, layout
    from regbench.tests.small import copy_layout

    def build(device, native=False):
        time.sleep(0.5)
        return 0.5

    ends = []
    honest = requests.PoolEntry.setup

    def setup(self):
        honest(self)
        ends.append(time.perf_counter())

    monkeypatch.setattr(common, "build", build)
    monkeypatch.setattr(requests.PoolEntry, "setup", setup)
    t_process = time.perf_counter()
    out = cell.run(layout.Layout(copy_layout(tmp_path)), "dragon_pair", 2147483831, 0.2, False, "cpu",
                   t_process)
    assert out["info"]["build_s"] == 0.5
    assert out["result"]["metrics"]["setup_s"]["value"] == pytest.approx(ends[0] - t_process - 0.5,
                                                                         abs=0.05)


def test_p95_is_over_every_pair_not_over_chunks():
    lat = [1.0] * 95 + [100.0] * 5
    # numpy's linear rule over all 100: between the 95th and 96th order
    # statistics. A median of chunk p95s would read 1.0.
    assert common.p95(lat) == pytest.approx(1.0 + 0.05 * 99.0)
    assert common.p95(lat) == pytest.approx(np.percentile(lat, 95))
    assert common.p95([1.0] * 99 + [float("inf")]) == 1.0
    assert common.p95([1.0] * 90 + [float("inf")] * 10) == float("inf")


def test_busy_union_counts_overlaps_once():
    assert trace.busy_union([(0, 10), (5, 15), (20, 25), (21, 22)]) == 20
    assert trace.busy_union([]) == 0


def _events():
    run = lambda name, ts, corr: {"cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,  # noqa: E731
                                  "args": {"correlation": corr}}
    dev = lambda ts, dur, corr, cat="kernel": {"cat": cat, "name": f"k{corr}", "ts": ts,  # noqa: E731
                                               "dur": dur, "args": {"correlation": corr}}
    return [
        {"cat": "user_annotation", "name": "regbench.fit", "ts": 0, "dur": 50},
        {"cat": "user_annotation", "name": "regbench.reg", "ts": 60, "dur": 40},
        {"cat": "cpu_op", "name": "aten::randperm", "ts": 30, "dur": 25},
        run("cudaLaunchKernel", 1, 1), run("cudaLaunchKernelExC", 2, 2), run("cudaMemcpyAsync", 3, 3),
        run("cudaFuncSetAttribute", 4, 0), run("cudaStreamSynchronize", 5, 0),
        run("cudaLaunchKernel", 61, 4), run("cudaGraphLaunch", 62, 5), run("cudaMemsetAsync", 63, 6),
        {"cat": "cuda_driver", "name": "cuLaunchKernel", "ts": 64, "dur": 1, "args": {"correlation": 7}},
        dev(10, 10, 1), dev(15, 10, 2), dev(26, 2, 3, "gpu_memcpy"),
        dev(70, 5, 4), dev(80, 5, 5), dev(86, 1, 6, "gpu_memset"), dev(90, 2, 7),
    ]


def test_launch_calls_count_what_enqueues_device_work():
    assert trace.launch_calls(_events()) == 7


def test_device_time_inside_spans_follows_the_correlation():
    ev = _events()
    assert trace.busy_within(ev, trace.annotations(ev, "regbench.fit")) == 15 + 2
    assert trace.busy_within(ev, trace.annotations(ev, "regbench.reg")) == 5 + 5 + 1 + 2


def test_breakdown_names_ops_and_gaps():
    ev = _events()
    ops = dict(trace.top_device_ops(ev))
    assert ops["k1"] == pytest.approx(10e-6) and len(ops) == 7
    gaps = dict(trace.idle_gaps(ev))
    # the gap 28..70: mid 49 lies in randperm (shorter than the fit span)
    assert gaps["aten::randperm"] == pytest.approx(42e-6)
    assert sum(gaps.values()) == pytest.approx((26 - 25 + 70 - 28 + 80 - 75 + 86 - 85 + 90 - 87) * 1e-6)


def test_sync_counter_counts_nothing_off_the_card():
    c = trace.SyncCounter("cpu")
    c.start()
    assert c.stop() == 0


def test_live_iterations_stop_at_the_first_delta_below_tol():
    deltas = [1e-3, 1e-5, 5e-8, 5e-8] + [1e-2, 1e-3, 1e-4, 1e-5] + [3e-8] * 4
    assert roofline.live_iterations(deltas, 4, 1e-7) == [3, 4, 1]


@pytest.mark.parametrize("live, n_iters, method, passes", [
    (10, 50, "horn+wls", 10), (30, 50, "horn+wls", 25 + 5 * 2), (30, 30, "wls", 60)])
def test_needed_work_counts_live_passes(live, n_iters, method, passes):
    one = roofline.reg_eval(1000, 64)
    got = roofline.register(1000, [64], [live], n_iters, method, 2)
    assert got.seconds == pytest.approx(passes * one.seconds)
    assert got.flops == pytest.approx(passes * one.flops)
    assert one.flops == pytest.approx(1000 * (64 * 45 + 200) + 59 + 1500)
    # At each unit's peak: the statistics in float32, the pose solve in float64.
    assert one.peak_s == pytest.approx((1000 * (64 * 45 + 200)) / roofline.H100_FP32_FLOPS
                                       + (59 + 1500) / roofline.H100_FP64_FLOPS)
    assert got.peak_s == pytest.approx(passes * one.peak_s)


def test_pair_mfu_reads_the_unprofiled_stretch():
    read = importlib.util.spec_from_file_location("pair_mfu", REPO / "regbench" / "metrics" / "pair_mfu.py")
    mod = importlib.util.module_from_spec(read)
    read.loader.exec_module(mod)
    # The profiled stretch's wall does not enter: only the steady stretch's.
    record = {"profile": {"wall_s": 9.0, "busy_s": 1.0}, "steady": {"pairs": 16, "wall_s": 2.0, "peak_s": 0.1}}
    assert mod.read(record) == pytest.approx(5.0)
    assert mod.read({"profile": {"wall_s": 1.0, "busy_s": 1.0}}) is None


def test_bounds_are_the_ports_roofline():
    from hgmm_torch.eval import roofline as port

    n = 437645
    stats, step = port.kernel_bound("reg_stats", n=n, k=384), port.kernel_bound("reg_step", nb=1)
    assert roofline.reg_eval(n, 384).seconds == pytest.approx(stats.seconds + step.seconds)
    assert roofline.reg_eval(n, 384).flops == pytest.approx(stats.flops + step.flops)
    for k, branch, kernel in ((8, None, "em_stats"), (64, 8, "em_stats_masked")):
        e = port.kernel_bound(kernel, n=n, k=k, branch=branch or k)
        m = port.kernel_bound("em_step", k=k)
        assert roofline.em_sweep(n, k, branch).seconds == pytest.approx(e.seconds + m.seconds, rel=1e-3)
        assert roofline.em_sweep(n, k, branch).flops == pytest.approx(e.flops + m.flops)
    assert roofline.assign(n, 64, 8).seconds == pytest.approx(
        port.kernel_bound("assign", n=n, k=64, branch=8).seconds)
    assert roofline.H100_FP32_FLOPS == port.H100_FP32_FLOPS
    assert roofline.H100_HBM_BYTES == port.H100_HBM_BYTES


def test_generators_are_the_originals():
    from hgmm_torch.data.synthetic import make_cloud_np

    np.testing.assert_array_equal(data.trefoil(np.random.default_rng(4), 5000), make_cloud_np(5000, "trefoil", 4))
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    world = smoke.lidar_world(np.random.default_rng(9), 20000)
    np.testing.assert_array_equal(world, data.lidar_world(np.random.default_rng(9), 20000))


def test_scans_are_the_smoke_sequence(tmp_path):
    spec = importlib.util.spec_from_file_location("chip_smoke_copy", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    smoke.write_lidar_sequence(tmp_path, n_frames=3, n_points=5000, seed=7)
    scans = data.lidar_loop(np.random.default_rng(7), 400_000, 30, 16, 3, 5000, smoke.SEQ_STEP,
                            smoke.SEQ_RANGE, smoke.SEQ_FOV, smoke.SEQ_NOISE)
    for k, s in enumerate(scans):
        raw = np.fromfile(tmp_path / "velodyne" / f"{k:06d}.bin", "<f4").reshape(-1, 4)[:, :3]
        np.testing.assert_array_equal(s, raw)


def test_a_seed_gives_the_same_inputs_twice():
    seed = 2**31 + 12345
    a, b = data.pair_pool(seed, 3000, 3, 0.2, 0.06, 0.002), data.pair_pool(seed, 3000, 3, 0.2, 0.06, 0.002)
    for p, q in zip(a, b):
        np.testing.assert_array_equal(p.target, q.target)
        np.testing.assert_array_equal(p.source, q.source)
        assert p.fit_seed == q.fit_seed
    c = data.pair_pool(seed + 1, 3000, 3, 0.2, 0.06, 0.002)
    assert not np.array_equal(a[0].source, c[0].source)
    loop = lambda s: data.lidar_loop(np.random.default_rng(data.seeds(s, 3)), 20000, 30, 16, 2,  # noqa: E731
                                     3000, 1.0, 40.0, 1.6, 0.01)
    for s, t in zip(loop(seed), loop(seed)):
        np.testing.assert_array_equal(s, t)


def test_pool_pairs_hold_their_pose():
    for p in data.pair_pool(7, 2000, 4, 0.2, 0.06, 0.0):
        assert common.rotation_gap(p.R, np.eye(3)) <= 0.2 + 1e-12
        assert np.abs(p.t).max() <= 0.06
        np.testing.assert_allclose(p.source @ p.R.T + p.t, p.target, atol=1e-5)


def test_pose_and_mixture_gaps():
    from regbench.reference.register import se3_exp

    R, _ = se3_exp(np.array([0.0, 0.0, 1e-7, 0.0, 0.0, 0.0]))
    assert common.rotation_gap(R, np.eye(3)) == pytest.approx(1e-7, rel=1e-6)
    assert common.translation_gap(np.ones(3), np.zeros(3)) == pytest.approx(3 ** 0.5)
    pi, mu, sg = np.array([0.5, 0.5, 0.0]), np.zeros((3, 3)), np.stack([np.eye(3)] * 3)
    assert common.mixture_gap((pi, mu, sg), (pi, mu, sg)) == 0.0
    moved = mu.copy()
    moved[0, 0] = 0.1
    assert common.mixture_gap((pi, moved, sg), (pi, mu, sg)) == pytest.approx(0.05)
    assert common.mixture_gap((pi[:2], mu[:2], sg[:2]), (pi, mu, sg)) == float("inf")
    assert common.worst([1.0, float("nan")]) == float("inf")
    assert common.worst([]) == float("inf")
