"""Multi-device parallelism: pair-level data-parallel meshes and metric
collectives (port of rpe_tpu/parallel)."""

from .collectives import sharded_error_stats
from .mesh import (
    pair_sharding,
    pairs_hyp_mesh,
    pairs_mesh,
    replicated,
    shard_pairs,
)

__all__ = [
    "pairs_mesh",
    "pairs_hyp_mesh",
    "pair_sharding",
    "replicated",
    "shard_pairs",
    "sharded_error_stats",
]
