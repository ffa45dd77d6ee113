"""Host-side I/O & memory tiering (reference ``engine/transfer_manager.*`` +
``engine/prefetcher.*``, SURVEY.md §2.3/§2.4).

JAX owns device streams and transfers, so the reference's CUDA machinery
maps to different primitives (SURVEY.md §2.3):

  - ``cache``      → HbmListCache: device-resident inverted-list cache with
                     LRU/LFU eviction + hit/miss counters — the declared-only
                     ``GpuCache`` (I11, ``engine/ivf_flat_index.h:191-222``),
                     doubling as the T1 pool's residency accounting.
  - ``streaming``  → StreamingIVFFlatIndex: host-RAM corpus, HBM cache tier,
                     async upload of probed lists overlapping compute — the
                     T3 ``DoubleBuffer`` role via JAX async dispatch.
  - ``host_rerank``→ HostReranker: exact second-stage rerank from the host
                     store for keep_raw=False IVF-PQ (codes on device, raw
                     rows in host RAM — the capacity tier past the HBM wall).
  - ``prefetcher`` → AdaptivePrefetcher (P2 stride/pattern prediction),
                     ListPrefetcher (P3 hotness-driven), PrefetchScheduler
                     (P4 priority + bandwidth throttle), over the aligned
                     reader in ``storage.shard_store``.
"""

from cuda_acceleratedvectordatabaseengine.io_host.cache import HbmListCache
from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
    HostListStore,
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine.io_host.host_rerank import (
    HostReranker,
)
from cuda_acceleratedvectordatabaseengine.io_host.prefetcher import (
    AccessPattern,
    AdaptivePrefetcher,
    ListPrefetcher,
    PrefetchScheduler,
)

__all__ = [
    "HbmListCache",
    "HostListStore",
    "HostReranker",
    "StreamingIVFFlatIndex",
    "AccessPattern",
    "AdaptivePrefetcher",
    "ListPrefetcher",
    "PrefetchScheduler",
]
