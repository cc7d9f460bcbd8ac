"""Object-scan pairs: a request fits the target's GMM tree and registers the
source onto it, as ``hgmm_torch.register_pair(source, target, ...)`` does
inside (``GmmTree.fit``, then ``register_pair(source, model=tree, ...)``),
called in those two steps so that the check can judge the fitted tree as
well as the pose."""

from __future__ import annotations

import time

from regbench.harness.requests import Outcome, PoolEntry


class Entry(PoolEntry):
    fits = True

    def request(self, j: int, spans: str | None = None) -> Outcome:
        import torch
        from hgmm_torch import register_pair

        if spans is None:
            tree = self.fit(j)
            res = register_pair(self.sources[j], model=tree, **self.reg_kwargs())
            return Outcome(res.pose.R.cpu().numpy(), res.pose.t.cpu().numpy(), tree, tree,
                           res.deltas)
        t0 = time.perf_counter()
        with torch.profiler.record_function("regbench.fit"):
            tree = self.fit(j)
            if spans == "time":
                self._sync()
        t1 = time.perf_counter()
        with torch.profiler.record_function("regbench.reg"):
            res = register_pair(self.sources[j], model=tree, **self.reg_kwargs())
            R, t = res.pose.R.cpu().numpy(), res.pose.t.cpu().numpy()
        return Outcome(R, t, tree, tree, res.deltas, (t1 - t0, time.perf_counter() - t1))
