"""hgmm_torch — hierarchical-GMM point-cloud registration in PyTorch and CUDA.

The PyTorch port of ``hgmm`` (the JAX reference, which stays as it is). Its
module names mirror ``hgmm``'s. Everything follows the device of its input
tensors: CPU tensors run the plain PyTorch versions of the E-step
contractions (``hgmm_torch.ops.em_ref``), CUDA tensors run the hand-written
CUDA kernels of ``hgmm_torch/csrc``, built with nvcc at first use.

This package never imports ``jax`` or ``hgmm``.
"""

import torch as _torch

# Full float32 for every matmul on the card, including the plain versions
# the kernels are checked against (coordinates enter squared, and TF32 keeps
# about three decimal digits). These are PyTorch's defaults for matmul; the
# cuDNN one is not.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from hgmm_torch.models.gmm import Gmm, GmmParams, fit_gmm  # noqa: E402,F401
from hgmm_torch.models.gmm_tree import GmmTree, fit_gmm_tree  # noqa: E402,F401
from hgmm_torch.pipelines.odometry import (  # noqa: E402,F401
    OdometryConfig,
    refine_odometry,
    run_odometry,
)
from hgmm_torch.pipelines.register import register_pair  # noqa: E402,F401

__version__ = "0.1.0"
