"""Object-scan pairs through a flat mixture: a request fits the target's
flat K-component GMM and registers the source onto it, as
``hgmm_torch.register_pair(source, target, model_kind="flat", ...)`` does
inside (``Gmm.fit``, then ``register_pair(source, model=gmm, ...)``), called
in those two steps by the tree pair's request (``register_pair.Entry``) so
that the check can judge the fitted mixture as well as the pose. The check
compares the one mixture and the pose with ``regbench/reference/flat.py`` in
float64. The program's spans and counters a pair (``launch.em_stats_tiled``,
``launch.reg_stats``, ``reg.steps``, ``reg.live_steps``) are read by
``regbench/tools/program_spans.py --workload bunny_flat64``.
"""

from __future__ import annotations

from typing import NamedTuple

from regbench.entries import register_pair
from regbench.harness import roofline
from regbench.harness.requests import Outcome


class Flat(NamedTuple):
    """A fitted flat mixture kept as the pool's check keeps a tree: one
    level."""

    levels: list


class Entry(register_pair.Entry):
    def fit(self, j: int):
        from hgmm_torch import Gmm

        c = self.config
        gmm, _ = Gmm.fit(self.targets[j], k=c["k"], n_iters=c["fit_iters"], generator=self.generator(j),
                         cov_type=c["cov_type"])
        return gmm

    def reg_kwargs(self) -> dict:
        c = self.config
        return dict(n_iters=c["reg_iters"], method=c["method"], top_k=c["top_k"],
                    outlier_logit=c["outlier_logit"], wls_inner=c["wls_inner"], tol=c["tol"])

    def request(self, j: int, spans: str | None = None) -> Outcome:
        out = super().request(j, spans)
        out.tree = Flat([out.model.params])
        return out

    def _fit_need(self) -> roofline.Need:
        c = self.config
        return c["fit_iters"] * roofline.em_sweep(c["points"], c["k"], None)

    def _reg_need(self, out: Outcome) -> roofline.Need:
        c = self.config
        live = roofline.live_iterations(out.deltas.cpu().tolist(), c["reg_iters"], c["tol"])
        return roofline.register(c["points"], [c["k"]], live, c["reg_iters"], c["method"], c["wls_inner"])

    # --- the check
    def reference_levels(self, j: int, dtype, device):
        import torch

        from regbench.reference.flat import fit_flat

        c = self.config
        return [fit_flat(torch.from_numpy(self.pool[j].target), c["k"], c["fit_iters"], self.generator(j),
                         dtype, device)]

    def reference_pose(self, levels, j: int):
        import torch

        from regbench.reference.flat import register

        c = self.config
        return register(torch.from_numpy(self.pool[j].source), levels[0], c["reg_iters"], c["method"],
                        c["tol"])
