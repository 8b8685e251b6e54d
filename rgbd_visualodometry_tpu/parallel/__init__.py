"""Multi-device scaling: sharded multi-stream tracking and tensor-parallel
descriptor matching over a jax.sharding.Mesh.

The reference is a single-process 3-thread program with no distributed
backend at all (SURVEY.md section 2c); this package is net-new capability:
throughput scaling across devices with XLA collectives.
"""

from rgbd_visualodometry_tpu.parallel.mesh import (
    make_mesh,
    map_partition_specs,
    MultiStreamVO,
    ShardedMapVO,
    sharded_match_descriptors,
)

__all__ = [
    "make_mesh",
    "map_partition_specs",
    "MultiStreamVO",
    "ShardedMapVO",
    "sharded_match_descriptors",
]
