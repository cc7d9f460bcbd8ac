"""Cells whose requests are independent object-scan registrations, cycling
through a pool of pairs made from the seed (``data.pair_pool``). An entry
subclasses ``PoolEntry`` and defines ``request(j, spans)``.

The window is a closed loop with one client: the next request starts when
the last one's pose is on the host. Every request on the pairs that the check
samples keeps its outputs; the check fits and registers those pairs again with
the plain reference in float64 and compares every such request with it.

The traced run: two requests to settle, then a profiled stretch of
PROFILE_PAIRS requests, each marked by record_function spans ("regbench.fit",
"regbench.reg") with no sync between them, so that the device time of each
phase is matched to it by correlation id; then SYNC_PAIRS requests as the
window runs them, under torch's sync debug mode; then STEADY_PAIRS requests
as the window runs them, on the host clock and with no profiler, whose needed
operations over their wall time give the pair's share of the card's peak;
then SPAN_PAIRS requests split by a device sync between the phases, each
phase timed by the host clock.
"""

from __future__ import annotations

import time

import numpy as np

from regbench.harness import common, data, roofline, trace

PROFILE_PAIRS = 20
SYNC_PAIRS = 3
STEADY_PAIRS = 16  # two turns of the pool of 8
SPAN_PAIRS = 20


class Outcome:
    """What one request produced: the pose on the host, the tree it fitted
    (None when the model was fitted in set-up), the model it registered onto,
    the per-iteration deltas (a device tensor until read), and the host
    seconds of its fit and registration when it ran split into spans."""

    def __init__(self, R, t, tree, model, deltas, span_s=None):
        self.R, self.t, self.tree, self.model, self.deltas = R, t, tree, model, deltas
        self.span_s = span_s

    @property
    def ok(self) -> bool:
        return bool(np.isfinite(self.R).all() and np.isfinite(self.t).all())


class PoolEntry:
    fits = True  # whether a request fits the target's tree

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.kept: dict[int, list[Outcome]] = {}

    # --- set-up
    def inputs(self) -> None:
        """The pool and the pairs the check samples, from the seed."""
        cfg, tr = self.config, self.traffic
        self.pool = data.pair_pool(self.seed, cfg["points"], tr["pool"], tr["max_angle"],
                                   tr["max_trans"], tr["noise"])
        rng = np.random.default_rng(data.seeds(self.seed, 4))
        self.checked = sorted(rng.choice(tr["pool"], size=tr["check_pairs"], replace=False).tolist())

    def build(self) -> float:
        return common.build(self.device)

    def setup(self) -> None:
        import torch

        self.inputs()
        tr = self.traffic
        self.targets = [torch.from_numpy(p.target).to(self.device) for p in self.pool]
        self.sources = [torch.from_numpy(p.source).to(self.device) for p in self.pool]
        self.prepare()
        for j in range(tr["warm_requests"]):
            self.request(j % tr["pool"])
        self._sync()

    def prepare(self) -> None:
        """What the cell builds once before any request."""

    def generator(self, j: int):
        import torch

        return torch.Generator().manual_seed(self.pool[j].fit_seed)

    def reg_kwargs(self) -> dict:
        c = self.config
        return dict(complexity_threshold=c["complexity_threshold"], n_iters=c["reg_iters"],
                    method=c["method"], top_k=c["top_k"], outlier_logit=c["outlier_logit"],
                    wls_inner=c["wls_inner"], tol=c["tol"])

    def fit(self, j: int):
        from hgmm_torch import GmmTree

        c = self.config
        tree, _ = GmmTree.fit(self.targets[j], branch=c["branch"], levels=c["levels"],
                              em_iters=c["fit_iters"], generator=self.generator(j))
        return tree

    def _sync(self) -> None:
        if self.device == "cuda":
            import torch

            torch.cuda.synchronize()

    def _keep(self, j: int, out: Outcome) -> None:
        if j in self.checked:
            self.kept.setdefault(j, []).append(out)

    # --- the window
    def window(self, seconds: float):
        lat, failed = [], 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i, t1 = 0, t_start
        while t1 < deadline:
            j = i % len(self.pool)
            t0 = time.perf_counter()
            out = self.request(j)
            t1 = time.perf_counter()
            if out.ok:
                lat.append(t1 - t0)
            else:
                failed += 1
            self._keep(j, out)
            i += 1
        return lat, failed, t1 - t_start

    # --- the traced run
    def traced(self) -> dict:
        """spans of a request: None (as the window runs it), "mark" (the
        phases marked for the profiler) or "time" (the phases split by a
        device sync and timed by the host clock)."""
        pool = len(self.pool)
        i = 0
        outs = []

        def nxt(spans=None):
            nonlocal i
            j = i % pool
            out = self.request(j, spans=spans)
            self._keep(j, out)
            outs.append(out)
            i += 1
            return out

        trace.Profile.warm(self.device)
        for _ in range(2):
            nxt()
        self._sync()
        prof = trace.Profile(self.device)
        t0 = time.perf_counter()
        prof.start()
        profiled = [nxt(spans="mark") for _ in range(PROFILE_PAIRS)]
        self._sync()
        wall = time.perf_counter() - t0
        events = prof.stop()
        counter = trace.SyncCounter(self.device)
        counter.start()
        for _ in range(SYNC_PAIRS):
            nxt()
        syncs = counter.stop()
        t0 = time.perf_counter()
        steady = [nxt() for _ in range(STEADY_PAIRS)]
        steady_wall = time.perf_counter() - t0
        fit_ms, reg_ms = [], []
        for _ in range(SPAN_PAIRS):
            out = nxt(spans="time")
            fit_ms.append(1e3 * out.span_s[0])
            reg_ms.append(1e3 * out.span_s[1])
        fit = PROFILE_PAIRS * self._fit_need()
        reg = sum(self._reg_need(out) for out in profiled)
        busy = trace.busy_union((e["ts"], e["ts"] + e["dur"]) for e in trace.device_events(events))
        return {
            "attempted": len(outs), "failed": sum(not o.ok for o in outs),
            "profile": {
                "pairs": PROFILE_PAIRS, "wall_s": wall, "busy_s": busy * 1e-6,
                "launch_calls": trace.launch_calls(events),
                "device_ops": trace.top_device_ops(events), "idle_gaps": trace.idle_gaps(events),
                "fit_busy_s": trace.busy_within(events, trace.annotations(events, "regbench.fit")) * 1e-6,
                "reg_busy_s": trace.busy_within(events, trace.annotations(events, "regbench.reg")) * 1e-6,
                "fit_bound_s": fit.seconds, "reg_bound_s": reg.seconds,
            },
            "steady": {"pairs": STEADY_PAIRS, "wall_s": steady_wall,
                       "peak_s": sum(self._fit_need() + self._reg_need(o) for o in steady).peak_s},
            "syncs": {"pairs": SYNC_PAIRS, "syncs": syncs},
            "spans": {"fit_ms": fit_ms if self.fits else [], "reg_ms": reg_ms},
        }

    def _fit_need(self) -> roofline.Need:
        """What one request's fit needs (nothing where the model is fitted in
        set-up)."""
        c = self.config
        if not self.fits:
            return roofline.Need()
        return roofline.fit_tree(c["points"], c["branch"], c["levels"], c["fit_iters"])

    def _reg_need(self, out: Outcome) -> roofline.Need:
        """What one request's registration needs: its live iterations, read
        from its deltas, against the components its model keeps at the cut."""
        c = self.config
        live = roofline.live_iterations(out.deltas.cpu().tolist(), c["reg_iters"], c["tol"])
        k_cut = int((out.model.cut_mixture(c["complexity_threshold"]).pi > 0).sum())
        ks = [c["branch"] ** (lv + 1) for lv in range(c["levels"] - 1)] + [k_cut]
        return roofline.register(c["points"], ks, live, c["reg_iters"], c["method"], c["wls_inner"])

    def free(self) -> None:
        """Drop the program's state on the device before the check; keep the
        outcomes on the host."""
        for outs in self.kept.values():
            for o in outs:
                if o.tree is not None:
                    o.tree = [tuple(a.detach().cpu().numpy() for a in lv) for lv in o.tree.levels]
                o.deltas = o.model = None
        self.targets = self.sources = None
        self.release()
        if self.device == "cuda":
            import torch

            torch.cuda.empty_cache()

    def release(self) -> None:
        """Drop what prepare() built."""

    # --- the check
    def reference_levels(self, j: int, dtype, device):
        import torch

        from regbench.reference.mixture import fit_tree

        c = self.config
        return fit_tree(torch.from_numpy(self.pool[j].target), None, c["branch"], c["levels"],
                        c["fit_iters"], self.generator(j), dtype, device)

    def reference_pose(self, levels, j: int):
        import torch

        from regbench.reference.register import register_tree

        c = self.config
        return register_tree(torch.from_numpy(self.pool[j].source), None, levels, c["branch"],
                             c["reg_iters"], c["method"], c["outlier_logit"],
                             c["complexity_threshold"], tol=c["tol"])

    def check(self, dtype=None) -> dict:
        """{fit_gap, pose_rot_gap, pose_trans_gap}: the worst over every
        request on the checked pairs, against the reference in float64 (or
        `dtype`)."""
        import torch

        dtype = dtype or torch.float64
        dev = self.device
        fit, rot, trans = [], [], []
        for j, levels in self.reference_models(dtype, dev):
            R, t = self.reference_pose(levels, j)
            ref = [tuple(a.cpu().numpy() for a in lv) for lv in levels]
            for o in self.kept.get(j, []):
                if o.tree is not None:
                    fit.append(max(common.mixture_gap(p, r) for p, r in zip(o.tree, ref)))
                rot.append(common.rotation_gap(o.R, R))
                trans.append(common.translation_gap(o.t, t))
        out = {"pose_rot_gap": common.worst(rot), "pose_trans_gap": common.worst(trans)}
        out["fit_gap"] = common.worst(fit) if self.fits else self.model_gap(dtype, dev)
        return out

    def control(self, lowered) -> dict:
        """The check's numbers with the reference in float32 under `lowered`
        (a context of lower precision) in the program's place."""
        import torch

        dev = self.device
        ref = list(self.reference_models(torch.float64, dev))
        with lowered():
            ctl = list(self.reference_models(torch.float32, dev))
        fit, rot, trans = [], [], []
        for (j, r_lv), (_, c_lv) in zip(ref, ctl):
            R, t = self.reference_pose(r_lv, j)
            with lowered():
                Rc, tc = self.reference_pose(c_lv, j)
            fit.append(max(common.mixture_gap([a.cpu().numpy() for a in c], [a.cpu().numpy() for a in r])
                           for c, r in zip(c_lv, r_lv)))
            rot.append(common.rotation_gap(Rc, R))
            trans.append(common.translation_gap(tc, t))
        return {"fit_gap": common.worst(fit), "pose_rot_gap": common.worst(rot),
                "pose_trans_gap": common.worst(trans)}

    def reference_models(self, dtype, device):
        for j in self.checked:
            yield j, self.reference_levels(j, dtype, device)

    def model_gap(self, dtype, device) -> float:
        raise NotImplementedError
