"""Index families (the reference's ``engine/ivf_flat_index.*`` layer).

  - ``flat``     → exact brute-force index (BASELINE config #1, and the
                   ground-truth oracle for the recall harness)
  - ``ivf_flat`` → IVFFlatIndex (``engine/ivf_flat_index.h:44-104``)
  - ``ivf_pq``   → IVFPQIndex — declared-only in the reference
                   (``engine/ivf_flat_index.h:107-189``), implemented here
  - ``arena``    → packed padded inverted-list storage (replacement for
                   per-list host vectors + ad-hoc GPU mirrors)
  - ``cache``    → HBM list residency/hotness tracking (the declared-only
                   ``GpuCache``, ``engine/ivf_flat_index.h:191-222``)
"""

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
from cuda_acceleratedvectordatabaseengine.models.arena import PackedListArena

__all__ = [
    "FlatIndex",
    "IVFFlatIndex",
    "IVFFlatConfig",
    "IVFPQIndex",
    "IVFPQConfig",
    "SearchParams",
    "PackedListArena",
]
