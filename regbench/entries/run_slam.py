"""LiDAR SLAM over a route driven twice: a request is one whole sequence as
the port's CLI runs ``odometry --detect-closures --refine --map``:

    res = run_odometry(scans, OdometryConfig(...), metrics=hook,
                       detect_closures=True, closure_config=ClosureConfig(...))
    refined = refine_odometry(res, n_iters=...)
    tree = build_map(scans, refined.poses(), MapConfig(...))

over the scans of ``harness/slam_data.two_laps`` (numpy on the host), one
client, the same sequence replayed. A pair is one scan registered onto the
scan before it; the hook's ``log_registration`` stamps each pair as the
program reports it, and its latency runs from the stamp before it (the first
from the sequence's start). The last pair's latency runs on to the map's
return, ended by a device sync, because that scan's refined pose exists only
then. The window runs whole sequences: one started before the deadline runs
to its end, and the wall time ends at the last sequence's map.

The traced run: one whole sequence under the profiler (the chain and its
back end, divided by its pairs for the per-pair metrics), one under torch's
sync debug mode, one as the window runs it on the host clock and with no
profiler (the pair's share of the card's peak: the needed work of the
chain's fits and registrations and of the map's fit over the sequence's wall
time; the closures and the pose graph are left out, so the share is a
floor), then ``trace_sequences`` sequences inside ``profiling.tracing()``,
whose back-end spans and counters give the medians a sequence.

The check: every pair completed against the float64 reference chain
(``reference/slam.chain``, as ``kitti_dense`` is checked), then the last
sequence's back end against ``reference/slam`` run from that sequence's own
chain: the closure edges, the refined poses and the map.
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np

from regbench.harness import common, data, roofline, slam_data, trace


class _Hook:
    """The metrics sink run_odometry and detect_loop_closures call."""

    def __init__(self):
        self.stamps, self.pairs = [], []

    def log_registration(self, name: str, res) -> None:
        self.stamps.append(time.perf_counter())
        self.pairs.append((int(name.split("_")[1]), res.pose.R, res.pose.t, res.deltas))

    def log(self, record: dict) -> None:
        """A closure candidate's record: the check reads the closures from
        the result, so nothing is kept."""


class Sequence:
    """What one sequence produced, on the host once taken()."""

    def __init__(self, hook: _Hook, t0: float, t_end: float, res, refined, tree):
        self.t0, self.t_end = t0, t_end
        self.hook, self.res, self.refined, self.tree = hook, res, refined, tree

    @property
    def latencies(self) -> list[float]:
        ends = self.hook.stamps[:-1] + [self.t_end]
        return list(np.diff([self.t0] + ends))

    def taken(self) -> dict:
        """The outputs the check reads, as numpy."""
        res, ref = self.res, self.refined
        edges = res.closures
        return {
            "rel": [(p.R.cpu().numpy(), p.t.cpu().numpy()) for p in res.rel_poses],
            "abs": [(p.R.cpu().numpy(), p.t.cpu().numpy()) for p in res.abs_poses],
            "logliks": list(res.logliks),
            "closures": ([] if edges is None else
                         list(zip(edges.i.cpu().tolist(), edges.j.cpu().tolist()))),
            "refined": list(zip(ref.R.cpu().numpy(), ref.t.cpu().numpy())),
            "map": [tuple(a.cpu().numpy() for a in (lv.pi, lv.mu, lv.sigma)) for lv in self.tree.levels],
        }


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.done = []  # (pair index, R, t) of every pair completed
        self.last = None  # the last sequence completed

    # --- the program's configuration
    def odometry_config(self):
        from hgmm_torch import OdometryConfig

        c, tr = self.config, self.traffic
        return OdometryConfig(model_kind="tree", branch=c["branch"], levels=c["levels"],
                              fit_iters=c["fit_iters"], reg_iters=c["reg_iters"], method=c["method"],
                              top_k=c["top_k"], outlier_logit=c["outlier_logit"],
                              complexity_threshold=c["complexity_threshold"], voxel=tr["voxel"],
                              bucket=tr["bucket"], warm_start=True, seed=self.seed, device=self.device)

    def closure_config(self):
        from hgmm_torch.pipelines.loop_closure import ClosureConfig

        return ClosureConfig(**self.config["closures"])

    def map_config(self):
        from hgmm_torch.pipelines.mapping import MapConfig

        return MapConfig(**self.config["map"])

    # --- set-up
    def inputs(self) -> None:
        """The scans of the two laps and their true poses, from the seed."""
        c = self.config
        rng = np.random.default_rng(data.seeds(self.seed, 3))
        self.scans, self.truth = slam_data.two_laps(
            rng, c["world_points"], c["boxes"], c["pillars"], c["frames"], c["laps"],
            c["scan_points"], c["step_m"], c["range_m"], c["fov_rad"], c["noise_m"], c["lap_growth_m"])

    def build(self) -> float:
        return common.build(self.device, native=True)

    def setup(self) -> None:
        self.inputs()
        self.cfg = self.odometry_config()
        self.sequence()

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def sequence(self) -> Sequence:
        """One whole sequence, as the CLI runs it."""
        from hgmm_torch import refine_odometry, run_odometry
        from hgmm_torch.pipelines.mapping import build_map

        hook = _Hook()
        t0 = time.perf_counter()
        res = run_odometry(self.scans, self.cfg, metrics=hook, detect_closures=True,
                           closure_config=self.closure_config())
        refined = refine_odometry(res, n_iters=self.config["refine"]["n_iters"],
                                  robust_delta=self.config["refine"]["robust_delta"])
        tree = build_map(self.scans, refined.poses(), self.map_config())
        self._sync()
        return Sequence(hook, t0, time.perf_counter(), res, refined, tree)

    def _keep(self, seq: Sequence) -> None:
        self.done += [(i, R, t) for i, R, t, _ in seq.hook.pairs]
        self.last = seq

    def _failed(self, pairs) -> list[bool]:
        return [not bool(np.isfinite(R.cpu().numpy()).all() and np.isfinite(t.cpu().numpy()).all())
                for _, R, t, _ in pairs]

    # --- the window
    def window(self, seconds: float):
        t_start = time.perf_counter()
        runs = []
        while time.perf_counter() < t_start + seconds:
            runs.append(self.sequence())
            self._keep(runs[-1])
        wall = runs[-1].t_end - t_start
        lat = [x for seq in runs for x in seq.latencies]
        bad = [b for seq in runs for b in self._failed(seq.hook.pairs)]
        return [x for x, b in zip(lat, bad) if not b], bad.count(True), wall

    # --- the traced run
    def _need(self, seq: Sequence) -> roofline.Need:
        """The needed work of a sequence's chain (pair i: the fit of scan i
        and the registration of scan i + 1)."""
        c, bucket = self.config, self.traffic["bucket"]
        if self.traffic["voxel"] or c["complexity_threshold"] > 0:
            raise ValueError("the SLAM roofline counts unvoxelized scans and the leaves")
        live = [min(s.shape[0], bucket) for s in self.scans]
        ks = [c["branch"] ** (lv + 1) for lv in range(c["levels"])]
        total = roofline.Need()
        for i, _, _, deltas in seq.hook.pairs:
            its = roofline.live_iterations(deltas.cpu().tolist(), c["reg_iters"], c["tol"])
            total += (roofline.fit_tree(live[i], c["branch"], c["levels"], c["fit_iters"])
                      + roofline.register(live[i + 1], ks, its, c["reg_iters"], c["method"],
                                          c["wls_inner"]))
        return total

    def _map_need(self, seq: Sequence) -> roofline.Need:
        """The map fit's needed work at its live points (the fused cloud, at
        most the bucket)."""
        from hgmm_torch.pipelines.mapping import fuse_frames

        m = self.config["map"]
        cloud = fuse_frames(self.scans, seq.refined.poses(), voxel=m["voxel"])
        return roofline.fit_tree(min(cloud.shape[0], m["bucket"]), m["branch"], m["levels"],
                                 m["em_iters"])

    def traced(self) -> dict:
        from hgmm_torch.utils import profiling

        trace.Profile.warm(self.device)
        prof = trace.Profile(self.device)
        self._sync()
        t0 = time.perf_counter()
        prof.start()
        profiled = self.sequence()
        wall = time.perf_counter() - t0
        events = prof.stop()
        counter = trace.SyncCounter(self.device)
        counter.start()
        synced = self.sequence()
        counter.stop()
        steady = self.sequence()
        runs = [profiled, synced, steady]
        with profiling.tracing() as tr:
            for _ in range(self.traffic["trace_sequences"]):
                runs.append(self.sequence())
        backend = _backend(tr.summary())
        for seq in runs:
            self._keep(seq)
        map_need = self._map_need(steady)
        pairs = len(profiled.hook.pairs)
        busy = trace.busy_union((e["ts"], e["ts"] + e["dur"]) for e in trace.device_events(events))
        failed = sum(sum(self._failed(s.hook.pairs)) for s in runs)
        return {
            "attempted": sum(len(s.hook.pairs) for s in runs), "failed": failed,
            "profile": {"pairs": pairs, "wall_s": wall, "busy_s": busy * 1e-6,
                        "launch_calls": trace.launch_calls(events),
                        "device_ops": trace.top_device_ops(events),
                        "idle_gaps": trace.idle_gaps(events),
                        "map_fit_busy_s": trace.busy_within(
                            events, trace.annotations(events, "hgmm_torch.map.fit")) * 1e-6,
                        "map_bound_s": map_need.seconds},
            "steady": {"pairs": len(steady.hook.pairs), "wall_s": steady.t_end - steady.t0,
                       "peak_s": (self._need(steady) + map_need).peak_s},
            "syncs": {"pairs": len(synced.hook.pairs), "syncs": counter.syncs},
            "backend": backend,
            "slam": self._trajectory(self.last.taken()),
        }

    def _trajectory(self, out: dict) -> dict:
        """What a sequence did against the true poses: the accepted closures,
        the longest, and the dead-reckoned and refined trajectory errors (m)."""
        return {"closures": out["closures"],
                "longest_closure": max((j - i for i, j in out["closures"]), default=0),
                "ate_dead_m": slam_data.ate(out["abs"], self.truth),
                "ate_refined_m": slam_data.ate(out["refined"], self.truth)}

    def free(self) -> None:
        self.done = [(i, R.cpu().numpy(), t.cpu().numpy()) for i, R, t in self.done]
        self.last = self.last.taken() if self.last is not None else None
        self.cfg = None
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    # --- the check
    def check(self) -> dict:
        """The gaps of every pair completed to the reference chain in float64
        (worst and median, as kitti_dense's), and of the last sequence's back
        end to the reference's, run from that sequence's chain: the closure
        edges in one set and not the other, the worst refined node, and the
        map's worst level. The trajectory against the truth goes to standard
        error."""
        import torch

        from regbench.reference import slam

        if not self.done:
            return {}
        c, tr = self.config, self.traffic
        n = max(i for i, _, _ in self.done) + 1
        t0 = time.perf_counter()
        regs, fr, trees = slam.chain(self.scans, c, tr["voxel"], tr["bucket"], self.seed, n,
                                     torch.float64, self.device)
        out = _gaps([(R, t, *regs[i].pose) for i, R, t in self.done])
        t1 = time.perf_counter()
        out.update(self._backend_gaps(self.last, fr, trees))
        print(f"slam: {self._trajectory(self.last)}, check_s: chain {t1 - t0:.1f}, back end "
              f"{time.perf_counter() - t1:.1f}", file=sys.stderr)
        return out

    def _backend_gaps(self, prog: dict, fr, trees) -> dict:
        """The back end of `prog` (a sequence's outputs as taken()) against
        the float64 reference run from prog's own chain."""
        import torch

        from regbench.reference import slam

        c = self.config
        ref_edges = slam.closures(prog["abs"], prog["logliks"], fr, trees, c, c["closures"],
                                  self.seed, torch.float64, self.device)
        ref_poses = slam.refine(prog["abs"], slam.chain_edges(prog["rel"]) + ref_edges,
                                c["refine"]["n_iters"])
        ref_map, _ = slam.build_map(self.scans, prog["refined"], c["map"], torch.float64, self.device)
        got = {(int(i), int(j)) for i, j in prog["closures"]}
        want = {(i, j) for i, j, _, _ in ref_edges}
        return {
            "closure_mismatch": float(len(got ^ want)),
            "refined_rot_gap": common.worst(common.rotation_gap(a[0], b[0])
                                            for a, b in zip(prog["refined"], ref_poses)),
            "refined_trans_gap": common.worst(common.translation_gap(a[1], b[1])
                                              for a, b in zip(prog["refined"], ref_poses)),
            "fit_gap": common.worst(common.mixture_gap(p, tuple(x.cpu().numpy() for x in r))
                                    for p, r in zip(prog["map"], ref_map)),
        }

    def control(self, lowered) -> dict:
        """The check's numbers with the reference in float32 under `lowered`
        (a context of lower precision) in the program's place: its chain, its
        closures, refinement and map from that chain, each compared as the
        program's are."""
        import torch

        from regbench.reference import slam

        c, tr = self.config, self.traffic
        n = c["frames"] - 1
        regs, fr, trees = slam.chain(self.scans, c, tr["voxel"], tr["bucket"], self.seed, n,
                                     torch.float64, self.device)
        with lowered():
            ctl, _, ctl_trees = slam.chain(self.scans, c, tr["voxel"], tr["bucket"], self.seed, n,
                                           torch.float32, self.device)
            rel = [r.pose for r in ctl]
            prog = {"rel": rel, "abs": slam.absolute(rel), "logliks": [r.loglik for r in ctl]}
            edges = slam.closures(prog["abs"], prog["logliks"], fr, ctl_trees, c, c["closures"],
                                  self.seed, torch.float32, self.device)
            prog["closures"] = [(i, j) for i, j, _, _ in edges]
            prog["refined"] = slam.refine(prog["abs"], slam.chain_edges(rel) + edges,
                                          c["refine"]["n_iters"], np.float32)
            levels, _ = slam.build_map(self.scans, prog["refined"], c["map"], torch.float32,
                                       self.device)
            prog["map"] = [tuple(x.cpu().numpy() for x in lv) for lv in levels]
        out = _gaps([(*a.pose, *b.pose) for a, b in zip(ctl, regs)])
        out.update(self._backend_gaps(prog, fr, trees))
        return out


def _backend(summary: list[dict]) -> dict:
    """A sequence's back end from the tracer's requests: host ms in the
    closures, the refinement and the map, and the closures' frame fits."""
    def of(name, key=None):
        return [r["counts"].get(key, 0) if key else r["ms"][name]
                for r in summary if r["name"] == name]

    return {"closure_ms": of("hgmm_torch.odo.closures"), "refine_ms": of("hgmm_torch.pg.refine"),
            "map_ms": of("hgmm_torch.map"),
            "closure_fits": of("hgmm_torch.odo.closures", "closure.fits")}


def _gaps(pairs) -> dict:
    """pairs: (R, t, R_ref, t_ref) a pair; the worst and the median gaps."""
    rot = [common.rotation_gap(R, Rr) for R, _, Rr, _ in pairs]
    trans = [common.translation_gap(t, tr) for _, t, _, tr in pairs]
    return {"pose_rot_gap": common.worst(rot), "pose_trans_gap": common.worst(trans),
            "pose_rot_gap_median": statistics.median(rot),
            "pose_trans_gap_median": statistics.median(trans)}
