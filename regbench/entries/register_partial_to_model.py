"""Partial, cluttered views registered onto a model built once: config 3
(BASELINE.json config 3, hgmm_torch's CONFIG3_MAHALANOBIS). As in
``register_to_model``, the GMM tree of one full object scan (the traffic's
``model_seed``) is fitted in set-up, and a request is
``hgmm_torch.register_pair(source, model=tree, ...)`` with the configuration's
top_k gate and outlier logit. Each source of the pool is a partial view of the
object with clutter (``regbench/harness/partial_views.py``).

The check registers each checked source onto the float64 reference tree with
the gated reference (``regbench/reference/register_gated.py``). A request's
needed work counts the gate (``regbench/harness/roofline_gated.py``), and the
traced record adds ``topk_bound_s``: the bound of the profiled requests' live
passes through the register-list gated body, which ``kern_topk_roofline``
holds to the device time of ``reg_stats_top_k_kernel``."""

from __future__ import annotations

import numpy as np

from regbench.entries import register_to_model
from regbench.harness import data, partial_views, roofline, roofline_gated


class Entry(register_to_model.Entry):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        super().__init__(config, traffic, seed, device)
        self.marked = []  # the outcomes of the requests run with spans "mark"

    def inputs(self) -> None:
        c, tr = self.config, self.traffic
        self.model_pair = data.pair_pool(tr["model_seed"], c["points"], 1, tr["max_angle"],
                                         tr["max_trans"], tr["noise"])[0]
        self.pool = partial_views.partial_pool(
            self.seed, c["points"], tr["pool"], self.model_pair.target, tr["view_keep"],
            tr["outlier_share"], tr["clutter_margin"], tr["max_angle"], tr["max_trans"], tr["noise"])
        rng = np.random.default_rng(data.seeds(self.seed, 4))
        self.checked = sorted(rng.choice(tr["pool"], size=tr["check_pairs"], replace=False).tolist())

    def request(self, j: int, spans: str | None = None):
        out = super().request(j, spans)
        if spans == "mark":
            self.marked.append(out)
        return out

    def traced(self) -> dict:
        c = self.config
        self.marked.clear()
        record = super().traced()
        record["profile"]["topk_bound_s"] = sum(
            (roofline_gated.top_k_passes(c["points"], self._ks(o), self._live(o), c["reg_iters"],
                                         c["method"], c["wls_inner"], c["top_k"]) for o in self.marked),
            roofline.Need()).seconds
        self.marked.clear()
        return record

    def _live(self, out) -> list[int]:
        c = self.config
        return roofline.live_iterations(out.deltas.cpu().tolist(), c["reg_iters"], c["tol"])

    def _ks(self, out) -> list[int]:
        """Each level's components, the last level's live ones at the cut."""
        c = self.config
        k_cut = int((out.model.cut_mixture(c["complexity_threshold"]).pi > 0).sum())
        return [c["branch"] ** (lv + 1) for lv in range(c["levels"] - 1)] + [k_cut]

    def _reg_need(self, out) -> roofline.Need:
        c = self.config
        return roofline_gated.register(c["points"], self._ks(out), self._live(out), c["reg_iters"],
                                       c["method"], c["wls_inner"], c["top_k"])

    def reference_pose(self, levels, j: int):
        import torch

        from regbench.reference.register_gated import register_tree

        c = self.config
        return register_tree(torch.from_numpy(self.pool[j].source), None, levels, c["branch"],
                             c["reg_iters"], c["method"], c["outlier_logit"],
                             c["complexity_threshold"], c["top_k"], tol=c["tol"])
