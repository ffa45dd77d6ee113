"""Multi-chip scale-out over a JAX device mesh.

The reference *claims* multi-GPU support (``README.md:25``,
``configs/production.yaml:11``) but contains no code that shards anything
across devices — it is listed as future work (``CLAUDE_CONTEXT.md:107``) and
the only inter-process communication is gRPC (SURVEY.md §2.9). This package
is the first-class implementation of that claimed capability:
``shard_map`` over a ``jax.sharding.Mesh`` with XLA collectives (NCCL over
NVLink on GPUs), not a hand-written NCCL/MPI translation.
"""

from cuda_acceleratedvectordatabaseengine.parallel.mesh import (
    make_mesh,
    SHARD_AXIS,
)
from cuda_acceleratedvectordatabaseengine.parallel.sharded import (
    ShardedIVFFlatIndex,
    ShardedIVFPQIndex,
    sharded_kmeans_fit,
    sharded_kmeans_lloyd_step,
)
from cuda_acceleratedvectordatabaseengine.parallel.sharded_streaming import (  # noqa: E501
    ShardedStreamingIVFFlatIndex,
)

__all__ = [
    "make_mesh",
    "SHARD_AXIS",
    "ShardedIVFFlatIndex",
    "ShardedIVFPQIndex",
    "ShardedStreamingIVFFlatIndex",
    "sharded_kmeans_fit",
    "sharded_kmeans_lloyd_step",
]
