"""Frame-to-frame LiDAR odometry over a closed loop of scans: a request is
``hgmm_torch.run_odometry(scans, OdometryConfig(...), metrics=hook)`` over
the whole sequence, chain after chain, the scans numpy arrays on the host.
A pair is one scan registered onto the scan before it; the hook's
``log_registration`` stamps each pair as the program reports it, and ends the
window by raising at the first pair past its end. The native reader is built
before set-up (timed apart, as the kernels are), so the scans are voxelized
as a user with the built library voxelizes them.

The traced run: one chain whose first two pairs settle (the first carries
the chain's voxelization), then ``PROFILE_PAIRS`` pairs under the profiler,
``SYNC_PAIRS`` under torch's sync debug mode, and the rest of the chain; then
one whole chain as the window runs it, on the host clock and with no
profiler, whose needed operations over its wall time give the pair's share
of the card's peak.
"""

from __future__ import annotations

import time

import numpy as np

from regbench.harness import common, data, roofline, trace

LEAD_PAIRS = 2
PROFILE_PAIRS = 20
SYNC_PAIRS = 3


class WindowClosed(Exception):
    pass


class _Hook:
    """The metrics sink run_odometry calls after each pair."""

    def __init__(self, deadline=float("inf"), on_pair=None):
        self.deadline, self.on_pair = deadline, on_pair
        self.prev = 0.0
        self.pairs = []  # (pair index, latency s, R, t, deltas)

    def log_registration(self, name: str, res) -> None:
        now = time.perf_counter()
        self.pairs.append((int(name.split("_")[1]), now - self.prev, res.pose.R, res.pose.t,
                           res.deltas))
        self.prev = now
        if self.on_pair is not None:
            self.on_pair(len(self.pairs))
        if now >= self.deadline:
            raise WindowClosed


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.done = []  # (pair index, R, t) of every pair completed

    def odometry_config(self):
        from hgmm_torch import OdometryConfig

        c, tr = self.config, self.traffic
        return OdometryConfig(model_kind="tree", branch=c["branch"], levels=c["levels"],
                              fit_iters=c["fit_iters"], reg_iters=c["reg_iters"], method=c["method"],
                              top_k=c["top_k"], outlier_logit=c["outlier_logit"],
                              complexity_threshold=c["complexity_threshold"], voxel=tr["voxel"],
                              bucket=tr["bucket"], warm_start=True, seed=self.seed, device=self.device)

    def inputs(self) -> None:
        """The scans of the loop, from the seed."""
        c = self.config
        rng = np.random.default_rng(data.seeds(self.seed, 3))
        self.scans = data.lidar_loop(rng, c["world_points"], c["boxes"], c["pillars"], c["frames"],
                                     c["scan_points"], c["step_m"], c["range_m"], c["fov_rad"],
                                     c["noise_m"])

    def build(self) -> float:
        return common.build(self.device, native=True)

    def setup(self) -> None:
        from hgmm_torch import run_odometry

        self.inputs()
        self.cfg = self.odometry_config()
        run_odometry(self.scans[:self.traffic["warm_frames"]], self.cfg)
        self._sync()

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def _chain(self, hook) -> bool:
        """One chain; False when the hook closed the window."""
        from hgmm_torch import run_odometry

        hook.prev = time.perf_counter()
        try:
            run_odometry(self.scans, self.cfg, metrics=hook)
        except WindowClosed:
            return False
        return True

    def _take(self, hook) -> list:
        self.done += [(i, R, t) for i, _, R, t, _ in hook.pairs]
        return hook.pairs

    def window(self, seconds: float):
        t_start = time.perf_counter()
        lat = []
        running = True
        while running:
            hook = _Hook(t_start + seconds)
            running = self._chain(hook)
            lat += [p[1] for p in self._take(hook)]
        wall = hook.prev - t_start
        self._sync()
        ok = [bool(np.isfinite(R.cpu().numpy()).all() and np.isfinite(t.cpu().numpy()).all())
              for _, R, t in self.done]
        return [x for x, good in zip(lat, ok) if good], ok.count(False), wall

    def traced(self) -> dict:
        from hgmm_torch.data.kitti import voxel_downsample

        c = self.config
        prof = trace.Profile(self.device)
        counter = trace.SyncCounter(self.device)
        got = {}

        def on_pair(k: int) -> None:
            if k == LEAD_PAIRS:
                got["t0"] = time.perf_counter()
                prof.start()
            elif k == LEAD_PAIRS + PROFILE_PAIRS:
                got["wall"] = time.perf_counter() - got["t0"]
                got["events"] = prof.stop()
                counter.start()
            elif k == LEAD_PAIRS + PROFILE_PAIRS + SYNC_PAIRS:
                counter.stop()

        trace.Profile.warm(self.device)
        hook = _Hook(on_pair=on_pair)
        self._chain(hook)
        pairs = self._take(hook)
        events = got["events"]
        t0 = time.perf_counter()
        steady = _Hook()
        self._chain(steady)
        steady_wall = steady.prev - t0
        steady = self._take(steady)
        voxel = self.traffic["voxel"]
        live = [min((voxel_downsample(s, voxel) if voxel else s).shape[0], self.traffic["bucket"])
                for s in self.scans]
        ks = [c["branch"] ** (lv + 1) for lv in range(c["levels"])]
        if c["complexity_threshold"] > 0:
            raise ValueError("the odometry roofline counts the leaves: a cut is not counted")

        def need(i, deltas) -> roofline.Need:
            """Pair i: the fit of scan i and the registration of scan i + 1."""
            live_its = roofline.live_iterations(deltas.cpu().tolist(), c["reg_iters"], c["tol"])
            return (roofline.fit_tree(live[i], c["branch"], c["levels"], c["fit_iters"])
                    + roofline.register(live[i + 1], ks, live_its, c["reg_iters"], c["method"],
                                        c["wls_inner"]))

        profiled = sum(need(i, d) for i, _, _, _, d in pairs[LEAD_PAIRS:LEAD_PAIRS + PROFILE_PAIRS])
        busy = trace.busy_union((e["ts"], e["ts"] + e["dur"]) for e in trace.device_events(events))
        ok = [bool(np.isfinite(R.cpu().numpy()).all()) for _, _, R, _, _ in pairs + steady]
        return {
            "attempted": len(ok), "failed": ok.count(False),
            "profile": {"pairs": PROFILE_PAIRS, "wall_s": got["wall"], "busy_s": busy * 1e-6,
                        "launch_calls": trace.launch_calls(events),
                        "device_ops": trace.top_device_ops(events),
                        "idle_gaps": trace.idle_gaps(events), "odo_bound_s": profiled.seconds},
            "steady": {"pairs": len(steady), "wall_s": steady_wall,
                       "peak_s": sum(need(i, d) for i, _, _, _, d in steady).peak_s},
            "syncs": {"pairs": SYNC_PAIRS, "syncs": counter.syncs},
        }

    def free(self) -> None:
        self.done = [(i, R.cpu().numpy(), t.cpu().numpy()) for i, R, t in self.done]
        self.cfg = None
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def check(self, dtype=None) -> dict:
        """The gaps of every pair completed to the reference chain in float64
        (or `dtype`): the worst and the median pair's (pose_rot_gap,
        pose_trans_gap, and *_median). The median is steady from seed to seed
        where one pair's float32 rounding swings the worst (PERF.md, section 2)."""
        import torch

        from regbench.reference.odometry import chain

        if not self.done:
            return {}
        c, tr = self.config, self.traffic
        n = max(i for i, _, _ in self.done) + 1
        ref = chain(self.scans, c, tr["voxel"], tr["bucket"], self.seed, n,
                    dtype or torch.float64, self.device)
        return _gaps([(R, t, *ref[i]) for i, R, t in self.done])

    def control(self, lowered) -> dict:
        """The check's numbers over the whole chain with the reference in
        float32 under `lowered` (a context of lower precision) in the
        program's place."""
        import torch

        from regbench.reference.odometry import chain

        c, tr = self.config, self.traffic
        n = c["frames"] - 1
        ref = chain(self.scans, c, tr["voxel"], tr["bucket"], self.seed, n, torch.float64, self.device)
        with lowered():
            ctl = chain(self.scans, c, tr["voxel"], tr["bucket"], self.seed, n, torch.float32,
                        self.device)
        return _gaps([(*a, *b) for a, b in zip(ctl, ref)])


def _gaps(pairs) -> dict:
    """pairs: (R, t, R_ref, t_ref) a pair; the worst and the median gaps."""
    import statistics

    rot = [common.rotation_gap(R, Rr) for R, _, Rr, _ in pairs]
    trans = [common.translation_gap(t, tr) for _, t, _, tr in pairs]
    return {"pose_rot_gap": common.worst(rot), "pose_trans_gap": common.worst(trans),
            "pose_rot_gap_median": statistics.median(rot), "pose_trans_gap_median": statistics.median(trans)}

