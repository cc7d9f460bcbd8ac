"""The inputs of the port's two-process gloo run (tests/_torch_mp_worker.py),
shared with the single-process oracle in tests/test_torch_parallel.py:
tests/_mp_worker.py's problem with numpy draws."""

import numpy as np
import torch

from hgmm_torch.data.synthetic import make_cloud_np
from hgmm_torch.models.se3 import Pose, so3_exp
from hgmm_torch.pipelines.pose_graph import EdgeList, odometry_chain_edges


def cloud_case():
    """512 helix points and a K=8 init drawn with numpy."""
    pts = make_cloud_np(512, "helix", seed=0)
    idx = np.random.default_rng(1).choice(512, 8, replace=False)
    var = (float(np.max(pts.max(0) - pts.min(0))) / 2.0) ** 2
    sigma = np.broadcast_to(var * np.eye(3, dtype=np.float32), (8, 3, 3)).copy()
    return pts, (np.full(8, 1 / 8, np.float32), pts[idx].copy(), sigma.astype(np.float32))


def gt_pose() -> Pose:
    return Pose(so3_exp(torch.tensor([0.0, 0.0, 0.2])), torch.tensor([0.1, -0.05, 0.02]))


def _pose(rng, angle, trans):
    return Pose(so3_exp(torch.from_numpy(rng.uniform(-angle, angle, 3).astype(np.float32))),
                torch.from_numpy(rng.uniform(-trans, trans, 3).astype(np.float32)))


def chain_case(m, device=None):
    """A noisy m-node chain of random steps and a loop closure (1, m - 2)
    from the true poses: (R0, t0, chain edges, closures) on `device`."""
    rng = np.random.default_rng(11)
    steps = [_pose(rng, 0.1, 0.2) for _ in range(m - 1)]
    gt = [Pose.identity(device="cpu")]
    for z in steps:
        gt.append(gt[-1].compose(z))
    noisy = [z.compose(_pose(rng, 0.02, 0.02)) for z in steps]
    init = [gt[0]]
    for z in noisy:
        init.append(init[-1].compose(z))
    lc = gt[1].inverse().compose(gt[m - 2])
    closures = EdgeList(torch.tensor([1]), torch.tensor([m - 2]), lc.R[None], lc.t[None],
                        torch.tensor([5.0]))

    def on(edges):
        return EdgeList(*(x.to(device) for x in edges))

    return (torch.stack([p.R for p in init]).to(device), torch.stack([p.t for p in init]).to(device),
            on(odometry_chain_edges(noisy)), on(closures))
