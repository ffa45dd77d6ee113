"""Storage & format layer (reference ``format/storage.*``, SURVEY.md §2.5).

  - ``manifest``    → IndexManifest JSON (F1, ``format/storage.h:15-42``)
  - ``arrow_store`` → Arrow IPC vector/centroid/codebook tables (F2,
                      ``format/storage.h:44-89``)
  - ``snapshot``    → whole-index save/load, implementing for real the
                      ``IVFFlatIndex::save/load`` the reference only declared
                      (``engine/ivf_flat_index.h:66-67``)
  - ``epoch``       → EpochManager: versioned snapshots, single-active
                      atomic switch, keep-N GC, crash recovery via
                      epochs.json (F5, ``format/storage.h:175-209``)
  - ``shard_store`` → per-list shard files + aligned reader (F3/F4 —
                      declared-only in the reference)
"""

from cuda_acceleratedvectordatabaseengine.storage.manifest import (
    IndexManifest,
    ShardEntry,
)
from cuda_acceleratedvectordatabaseengine.storage.arrow_store import (
    ArrowStorage,
)
from cuda_acceleratedvectordatabaseengine.storage.epoch import EpochManager

__all__ = ["IndexManifest", "ShardEntry", "ArrowStorage", "EpochManager"]
