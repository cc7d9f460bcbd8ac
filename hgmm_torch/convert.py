"""Parameters carried across between the JAX package and the port, as numpy.

A tree fitted by ``hgmm`` is registered by ``hgmm_torch`` with
``tree_from_numpy([tuple(np.asarray(a) for a in lvl) for lvl in tree.levels],
tree.branch)``, and the reverse goes through ``*_to_numpy``. Nothing here
imports ``jax``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from hgmm_torch.models.gmm_tree import GmmTree
from hgmm_torch.models.se3 import Pose
from hgmm_torch.ops.gaussians import MixtureParams


def to_numpy(x) -> np.ndarray:
    """A tensor on any device, or anything array-like, as a numpy array."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def mixture_from_numpy(pi, mu, sigma, device=None) -> MixtureParams:
    """(pi [K], mu [K,3], sigma [K,3,3]) arrays -> float32 MixtureParams."""
    return MixtureParams(_t(pi, device), _t(mu, device), _t(sigma, device))


def mixture_to_numpy(params: MixtureParams) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    return tuple(a.detach().cpu().numpy() for a in params)


def tree_from_numpy(levels: Sequence[Sequence], branch: int, device=None) -> GmmTree:
    """levels: one (pi, mu, sigma) per level, e.g. a JAX GmmTree's levels."""
    return GmmTree(levels=tuple(mixture_from_numpy(*lvl, device=device) for lvl in levels),
                   branch=branch)


def pose_from_numpy(R, t, device=None) -> Pose:
    return Pose(_t(R, device), _t(t, device))


def pose_to_numpy(pose: Pose) -> tuple[np.ndarray, np.ndarray]:
    return pose.R.detach().cpu().numpy(), pose.t.detach().cpu().numpy()


def probe_inputs_from_numpy(*arrays, device=None) -> tuple[torch.Tensor, ...]:
    """float32 arrays -> bfloat16 tensors, rounded to nearest even as
    ``jnp.astype(bfloat16)`` rounds, so that the unit-rate probes of both
    packages compute on identical bits."""
    return tuple(_t(a, device).to(torch.bfloat16) for a in arrays)
