"""Hotness-driven residency wiring (VERDICT r3 item 4): streaming-tier
searches feed the ListPrefetcher (P3), the server's background loop
re-stages the decayed-hot working set through the PrefetchScheduler (P4),
and the AlignedReader's reads feed the AdaptivePrefetcher (P2). The
reference declares all three (``engine/prefetcher.h:90-230``) and wires
none."""

import os
import time

import numpy as np

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.io_host import (
    AccessPattern,
    StreamingIVFFlatIndex,
)

DIM = 16
NLIST = 32


def _streaming(rng, cache_slots=8):
    """Resident base with one tight mode per list, snapshotted into a
    small-cache streaming tier. Returns (tier, centroids)."""
    x = rng.standard_normal((4000, DIM)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=NLIST,
                                     dtype="float32"))
    idx.train(x)
    idx.add(x)
    tier = StreamingIVFFlatIndex(idx, cache_slots=cache_slots)
    return tier, np.asarray(idx.centroids, np.float32)


def test_search_feeds_list_prefetcher(rng):
    tier, cents = _streaming(rng)
    assert not tier.list_prefetcher.get_hot_lists(4)
    tier.search(cents[:4], SearchParams(nprobe=1, k=3))
    hot = tier.list_prefetcher.get_hot_lists(8)
    assert hot  # the probed lists were recorded
    # a centroid query at nprobe=1 probes exactly its own list
    assert set(hot) <= set(range(NLIST))


def _run_phases(tier, cents, restage: bool) -> int:
    """Heat a 4-list hot set, evict it with a cold sweep, then (maybe)
    background-restage; returns the misses added by the returning hot
    query."""
    hot_q = cents[:4]
    params = SearchParams(nprobe=1, k=3)
    for _ in range(5):                      # phase 1: heat
        tier.search(hot_q, params)
    for i in range(4, NLIST, 4):            # phase 2: cold sweep evicts
        tier.search(cents[i:i + 4], params)
    if restage:                             # the background loop's call
        staged = tier.prefetch_hot_lists(max_lists=4)
        assert len(staged) == 4
        assert set(staged) <= set(tier.cache.resident_lists())
    before = tier.cache.misses
    tier.search(hot_q, params)              # phase 3: hot set returns
    return tier.cache.misses - before


def test_hot_restage_recovers_hits(rng):
    """The done-criterion scenario: after cold traffic evicts the hot
    working set, the background re-stage makes the returning hot query
    hit; the miss-on-demand baseline misses."""
    tier_a, cents = _streaming(rng, cache_slots=8)
    missed_baseline = _run_phases(tier_a, cents, restage=False)
    assert missed_baseline > 0  # cold sweep really evicted the hot set

    tier_b, cents_b = _streaming(rng, cache_slots=8)
    missed_restaged = _run_phases(tier_b, cents_b, restage=True)
    assert missed_restaged == 0


def test_engine_background_loop_restages(tmp_path, rng):
    """The server's hotness loop schedules stage jobs into the throttled
    PrefetchScheduler for live streaming-tier indices."""
    from cuda_acceleratedvectordatabaseengine.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )

    engine = VdbEngine(ServerConfig(
        data_path=str(tmp_path), default_nlist=8,
        shard_serving="off", prefetch_hot_interval_s=0.1,
        max_batch_size=8, warm_nprobes=(),
    ))
    try:
        engine.create_index("s", DIM, "L2", 8, 0, 0, tier="streaming")
        rng_x = rng.standard_normal((600, DIM)).astype(np.float32)
        engine.add_vectors("s", rng_x, np.arange(600, dtype=np.uint64))
        engine.build_epoch("s")
        deadline = time.time() + 60
        while not engine.build_jobs["s"].done:
            assert time.time() < deadline
            time.sleep(0.1)
        assert not engine.build_jobs["s"].error
        st = engine.get_state("s")
        engine._load_epoch_into(st, engine.build_jobs["s"].epoch_id)
        st.index.search(rng_x[:4], SearchParams(nprobe=2, k=3))
        deadline = time.time() + 20
        while engine.prefetch_scheduler.completed == 0:
            assert time.time() < deadline, "hotness loop never ran"
            time.sleep(0.05)
        # the staged hot lists are resident
        hot = st.index.list_prefetcher.get_hot_lists(4)
        assert set(hot) <= set(st.index.cache.resident_lists())
    finally:
        engine.close()
    # close() is idempotent and stops the loop
    engine.close()
    assert engine._hotness_thread is None


def test_aligned_reader_feeds_adaptive_prefetcher(tmp_path):
    """P2 wired: sequential read_aligned traffic classifies SEQUENTIAL
    and issues WILLNEED readahead for the predicted next offsets."""
    from cuda_acceleratedvectordatabaseengine.storage.shard_store import (
        AlignedReader,
    )

    path = str(tmp_path / "blob.bin")
    with open(path, "wb") as f:
        f.write(os.urandom(1 << 20))
    reader = AlignedReader(io_depth=4)
    try:
        step = 64 << 10
        for off in range(0, 8 * step, step):
            data = reader.read_aligned(path, off, step)
            assert len(data) == step
        pattern, stride, score = reader.adaptive.classify(path)
        assert pattern == AccessPattern.SEQUENTIAL
        assert stride == step
        assert score == 1.0
        assert reader.adaptive.prefetches_issued > 0
        reader.wait_all()
    finally:
        reader.close()
    # opt-out stays available for raw benchmarking paths
    r2 = AlignedReader(adaptive=False)
    assert r2.adaptive is None
    r2.close()
