"""Device compute ops: the JAX counterparts of the reference's CUDA kernels.

Reference mapping (SURVEY.md §2.1):
  - ``distance``  → K1 metric functors (``engine/kernels.cuh:31-81``)
  - ``scan``      → K2 fused bruteforce scan + top-k (``engine/kernels.cuh:84-185``)
  - ``pq``        → K3/K4 PQ distance tables + ADC scan (``engine/kernels.cuh:188-312``)
  - ``kmeans``    → K5 k-means assign (``engine/kernels.cuh:315-354``) plus the
                    host-side train loop (``engine/ivf_flat_index.cpp:49-145``)
  - ``normalize`` → K6 vector normalization (``engine/kernels.cuh:357-385``)
  - ``topk``      → the cross-thread top-k reduction the reference left stubbed
                    (``engine/kernels.cuh:172-184``)
"""

from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
    squared_norms,
)
from cuda_acceleratedvectordatabaseengine.ops.normalize import l2_normalize
from cuda_acceleratedvectordatabaseengine.ops.topk import (
    topk_smallest,
    merge_topk,
)
from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
    kmeans_fit,
    kmeans_assign,
    kmeans_pp_init,
)
from cuda_acceleratedvectordatabaseengine.ops.scan import scan_probed_lists

__all__ = [
    "Metric",
    "pairwise_distance",
    "squared_norms",
    "l2_normalize",
    "topk_smallest",
    "merge_topk",
    "kmeans_fit",
    "kmeans_assign",
    "kmeans_pp_init",
    "scan_probed_lists",
]
