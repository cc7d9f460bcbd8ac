"""Scans registered onto a model built once: the GMM tree of one object
scan is fitted in set-up, and a request is ``hgmm_torch.register_pair(source,
model=tree, ...)`` for one of the pool's sources. The object scan and its
fit's start are those of the traffic's ``model_seed``, the same for every run
seed, as a deployment's model is: one model's cut sets the work of every
request, and a model drawn from the run's seed moved the rate by 70 % from
seed to seed (PERF.md, "Cells"). The check judges the tree of the set-up and
every checked request's pose."""

from __future__ import annotations

import time

from regbench.harness import common, data
from regbench.harness.requests import Outcome, PoolEntry

MODEL = -1  # the model's key among the pool's indices


class Entry(PoolEntry):
    fits = False

    def inputs(self) -> None:
        super().inputs()
        c, tr = self.config, self.traffic
        self.model_pair = data.pair_pool(tr["model_seed"], c["points"], 1, tr["max_angle"],
                                         tr["max_trans"], tr["noise"])[0]

    def prepare(self) -> None:
        import torch
        from hgmm_torch import GmmTree

        c = self.config
        self.model, _ = GmmTree.fit(torch.from_numpy(self.model_pair.target).to(self.device),
                                    branch=c["branch"], levels=c["levels"], em_iters=c["fit_iters"],
                                    generator=self.generator(MODEL))

    def generator(self, j: int):
        import torch

        pair = self.model_pair if j == MODEL else self.pool[j]
        return torch.Generator().manual_seed(pair.fit_seed)

    def reference_levels(self, j: int, dtype, device):
        import torch

        from regbench.reference.mixture import fit_tree

        if j != MODEL:
            return super().reference_levels(j, dtype, device)
        c = self.config
        return fit_tree(torch.from_numpy(self.model_pair.target), None, c["branch"], c["levels"],
                        c["fit_iters"], self.generator(MODEL), dtype, device)

    def release(self) -> None:
        self.model_levels = [tuple(a.detach().cpu().numpy() for a in lv) for lv in self.model.levels]
        self.model = None

    def request(self, j: int, spans: str | None = None) -> Outcome:
        import torch
        from hgmm_torch import register_pair

        if spans is None:
            res = register_pair(self.sources[j], model=self.model, **self.reg_kwargs())
            return Outcome(res.pose.R.cpu().numpy(), res.pose.t.cpu().numpy(), None, self.model,
                           res.deltas)
        t0 = time.perf_counter()
        with torch.profiler.record_function("regbench.reg"):
            res = register_pair(self.sources[j], model=self.model, **self.reg_kwargs())
            R, t = res.pose.R.cpu().numpy(), res.pose.t.cpu().numpy()
        return Outcome(R, t, None, self.model, res.deltas, (0.0, time.perf_counter() - t0))

    def reference_models(self, dtype, device):
        self.reference_model = self.reference_levels(MODEL, dtype, device)
        for j in self.checked:
            yield j, self.reference_model

    def model_gap(self, dtype, device) -> float:
        ref = [tuple(a.cpu().numpy() for a in lv) for lv in self.reference_model]
        return max(common.mixture_gap(p, r) for p, r in zip(self.model_levels, ref))
