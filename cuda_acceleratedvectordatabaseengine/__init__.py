"""Vector database engine for NVIDIA GPUs, in JAX.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of the CUDA
reference engine (wedevxer/CUDA-AcceleratedVectorDatabaseEngine): IVF-Flat and
IVF-PQ approximate-nearest-neighbor indices with k-means coarse quantization,
L2 / inner-product / cosine metrics, fused distance + top-k search over
device-resident packed inverted lists, multi-device sharded search over a
device mesh, epoch-versioned persistence, and a gRPC serving layer.

Everything device-side is batched matmuls, fused elementwise ops, fixed-shape
gathers and one Triton kernel (the list-grouped scan, ``ops/grouped_scan``),
compiled once under ``jit`` — not a line-by-line translation of the
reference's CUDA kernels/streams/pinned pools (see SURVEY.md §7).
"""

from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine.models.flat import FlatIndex
from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
    IVFFlatIndex,
    IVFFlatConfig,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
    IVFPQIndex,
    IVFPQConfig,
)

__version__ = "0.1.0"

__all__ = [
    "Metric",
    "pairwise_distance",
    "FlatIndex",
    "IVFFlatIndex",
    "IVFFlatConfig",
    "IVFPQIndex",
    "IVFPQConfig",
    "SearchParams",
    "__version__",
]
