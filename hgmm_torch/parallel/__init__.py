"""hgmm_torch.parallel — the sharded programs over torch.distributed.

Counterpart of ``hgmm/parallel/__init__.py``: the same public names, and the
in-process emulation of R ranks (``EmulatedMesh``) and the type of a rank's
own rows (``ShardedPoints``) besides.
"""

from hgmm_torch.parallel.mesh import (
    POINTS_AXIS,
    EmulatedMesh,
    ShardedPoints,
    initialize_multihost,
    make_mesh,
    points_sharding,
    replicated,
    shard_points_from_host,
)
from hgmm_torch.parallel.sharded import (
    ShardedRegResult,
    pad_points_for_mesh,
    sharded_em_fit,
    sharded_register_points,
    sharded_register_tree,
    sharded_tree_fit,
)

__all__ = [
    "POINTS_AXIS",
    "EmulatedMesh",
    "ShardedPoints",
    "ShardedRegResult",
    "initialize_multihost",
    "make_mesh",
    "pad_points_for_mesh",
    "points_sharding",
    "replicated",
    "shard_points_from_host",
    "sharded_em_fit",
    "sharded_register_points",
    "sharded_register_tree",
    "sharded_tree_fit",
]
