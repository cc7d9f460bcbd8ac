"""hgmm_torch.models — the rigid pose, the flat GMM and the GMM tree.

Counterpart of ``hgmm/models/__init__.py``, with the same re-exports.
"""

from hgmm_torch.models.se3 import Pose, se3_exp, se3_log  # noqa: F401
from hgmm_torch.models.gmm import Gmm, GmmParams, fit_gmm  # noqa: F401
from hgmm_torch.models.gmm_tree import GmmTree, fit_gmm_tree  # noqa: F401
from hgmm_torch.models import pose  # noqa: F401
