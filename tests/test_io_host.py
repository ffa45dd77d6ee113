"""Streaming tier tests: HBM cache eviction/hit-rate, streaming search
equivalence with the fully-resident index, prefetchers."""

import time

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.io_host import (
    AccessPattern,
    AdaptivePrefetcher,
    HbmListCache,
    ListPrefetcher,
    PrefetchScheduler,
    StreamingIVFFlatIndex,
)


def _build(rng, n=4000, dim=16, nlist=16):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=dim, nlist=nlist,
                                     dtype="float32"))
    idx.train(x)
    idx.add(x)
    return idx, x


def test_cache_hit_miss_and_eviction(rng):
    import jax.numpy as jnp

    data = {
        l: (np.full((4, 8), l, np.float32), np.zeros(4, np.float32), 4)
        for l in range(10)
    }
    cache = HbmListCache(n_slots=3, capacity=8, dim=8, dtype=jnp.float32,
                         policy="lru")
    m = cache.ensure_resident(np.array([0, 1, 2]), lambda l: data[l])
    assert sorted(m) == [0, 1, 2] and cache.misses == 3
    # hit
    cache.ensure_resident(np.array([1]), lambda l: data[l])
    assert cache.hits == 1
    # eviction: order of last_access: 0,2 old; 1 fresh
    time.sleep(0.01)
    cache.ensure_resident(np.array([5]), lambda l: data[l])
    assert 5 in cache.resident_lists()
    assert len(cache.resident_lists()) == 3
    assert 1 in cache.resident_lists()  # recently used survives
    # cached content is correct
    slot = cache.ensure_resident(np.array([5]), lambda l: data[l])[5]
    assert float(cache.cache_arena[slot, 0, 0]) == 5.0
    assert int(cache.cache_counts[slot]) == 4
    assert cache.get_hit_rate() > 0
    # explicit evict works (the reference's was a TODO)
    assert cache.evict_list(5) and 5 not in cache.resident_lists()
    assert not cache.evict_list(99)


def test_streaming_matches_resident_index(rng):
    idx, x = _build(rng)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=6)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    p = SearchParams(nprobe=4, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    st = streaming.stats()
    assert st["misses"] > 0 and st["resident"] <= 6


def test_streaming_cache_smaller_than_probes(rng):
    """nprobe > cache slots still works (within-batch residency)."""
    idx, x = _build(rng, nlist=16)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=16)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    d, ids = streaming.search(q, SearchParams(nprobe=16, k=5))
    d_ref, i_ref = idx.search(q, SearchParams(nprobe=16, k=5))
    np.testing.assert_array_equal(ids, i_ref)


def test_streaming_hit_rate_improves(rng):
    idx, _ = _build(rng)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=16)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    streaming.search(q, SearchParams(nprobe=8, k=5))
    misses_after_first = streaming.cache.misses
    streaming.search(q, SearchParams(nprobe=8, k=5))  # same lists → hits
    assert streaming.cache.misses == misses_after_first
    assert streaming.cache.hits > 0


def test_streaming_pallas_scan_parity(rng, interpret_grouped):
    """The GPU cache-scan path (grouped Pallas kernel over the slot arena,
    sentinel-padded fixed-width waves) must match the resident index."""
    idx, _ = _build(rng)
    streaming = StreamingIVFFlatIndex(
        idx, cache_slots=8, scan_impl="grouped"
    )
    q = rng.standard_normal((5, 16)).astype(np.float32)
    p = SearchParams(nprobe=6, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_streaming_pallas_multi_wave(rng, interpret_grouped):
    """Pallas cache scan across multiple waves (cache smaller than the
    probe working set) still merges to the resident answer."""
    idx, _ = _build(rng, nlist=16)
    streaming = StreamingIVFFlatIndex(
        idx, cache_slots=5, scan_impl="grouped"
    )
    q = rng.standard_normal((3, 16)).astype(np.float32)
    p = SearchParams(nprobe=12, k=5)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)


def test_streaming_from_store(rng):
    """from_store (the true >HBM entry point) matches a resident index
    built from the same data — no base index ever exists on device."""
    from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
        HostListStore,
    )
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_assign,
    )
    import jax.numpy as jnp

    idx, x = _build(rng)  # oracle only
    assigns = np.asarray(
        kmeans_assign(jnp.asarray(x), idx.centroids, idx.metric)
    )
    ids = np.arange(x.shape[0], dtype=np.uint64)
    store = HostListStore.from_assignments(x, ids, assigns, 16)
    streaming = StreamingIVFFlatIndex.from_store(
        store, idx.centroids, idx.config, cache_slots=8,
    )
    q = rng.standard_normal((4, 16)).astype(np.float32)
    p = SearchParams(nprobe=4, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids_out = streaming.search(q, p)
    np.testing.assert_array_equal(ids_out, i_ref)


def test_streaming_grouped_scan_parity(rng, interpret_grouped):
    """The grouped Pallas kernel (the GPU serving default) over the slot
    cache must match the resident index, including multi-wave splits."""
    idx, _ = _build(rng, nlist=16)
    streaming = StreamingIVFFlatIndex(
        idx, cache_slots=8, scan_impl="grouped"
    )
    q = rng.standard_normal((5, 16)).astype(np.float32)
    p = SearchParams(nprobe=12, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_streaming_int8_base_exact_parity(rng):
    """An int8-residual base snapshots into an int8 store (codes pass
    through bit-identical, no dequantize round trip) and the quantized
    cache scan must reproduce the resident index exactly."""
    x = rng.standard_normal((4000, 16)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=16, nlist=16, dtype="int8"))
    idx.train(x)
    idx.add(x)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=8)
    assert streaming.store.dtype == "int8"
    assert streaming.cache.quantized
    q = rng.standard_normal((5, 16)).astype(np.float32)
    p = SearchParams(nprobe=6, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    # device bytes: codes are 1 byte/dim (+ fp32 scale/anchor planes)
    assert streaming.cache.cache_arena.dtype == np.int8


def test_streaming_int8_grouped_multiwave(rng, interpret_grouped):
    """int8 store + grouped kernel + cache smaller than the probe working
    set: wave-split quantized scan still merges to the resident answer."""
    x = rng.standard_normal((4000, 16)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=16, nlist=16, dtype="int8"))
    idx.train(x)
    idx.add(x)
    streaming = StreamingIVFFlatIndex(
        idx, cache_slots=5, scan_impl="grouped"
    )
    q = rng.standard_normal((4, 16)).astype(np.float32)
    p = SearchParams(nprobe=16, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_host_store_lookup_ids(rng):
    from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
        HostListStore,
    )

    store = HostListStore(3, 4)
    store.ids[0] = np.array([10, 11], np.uint64)
    store.ids[1] = np.array([], np.uint64)
    store.ids[2] = np.array([30, 31, 32], np.uint64)
    lists = np.array([[0, 2, -1], [2, 0, 2]])
    offs = np.array([[1, 2, 0], [0, 0, 1]])
    got = store.lookup_ids(lists, offs)
    from cuda_acceleratedvectordatabaseengine.models.arena import (
        INVALID_ID,
    )

    np.testing.assert_array_equal(
        got, np.array([[11, 32, INVALID_ID], [30, 10, 31]], np.uint64)
    )


def test_streaming_prefetch(rng):
    idx, _ = _build(rng)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=8)
    streaming.prefetch_lists([0, 1, 2])
    assert set(streaming.cache.resident_lists()) >= {0, 1, 2}


def test_adaptive_prefetcher_classification():
    ap = AdaptivePrefetcher(reader=None, block_size=4096)
    for i in range(10):
        ap.record_access("/f/seq", i * 4096)
    assert ap.classify("/f/seq")[0] == AccessPattern.SEQUENTIAL
    for i in range(10):
        ap.record_access("/f/strided", i * 1 << 20)
    assert ap.classify("/f/strided")[0] == AccessPattern.STRIDED
    import random

    random.seed(0)
    for _ in range(20):
        ap.record_access("/f/rand", random.randrange(0, 1 << 30))
    assert ap.classify("/f/rand")[0] == AccessPattern.RANDOM


def test_adaptive_prefetcher_issues_readahead(tmp_path, rng):
    from cuda_acceleratedvectordatabaseengine.storage.shard_store import (
        AlignedReader,
    )

    p = str(tmp_path / "f")
    with open(p, "wb") as f:
        f.write(b"\0" * (1 << 20))
    reader = AlignedReader(io_depth=2)
    ap = AdaptivePrefetcher(reader=reader, block_size=4096)
    for i in range(8):
        ap.record_access(p, i * 4096)
    assert ap.prefetches_issued > 0
    reader.close()


def test_list_prefetcher_hotness():
    staged = []
    lp = ListPrefetcher(stage_fn=staged.extend, hot_threshold=0.5)
    for _ in range(10):
        lp.record_access(3)
    lp.record_access(7)
    hot = lp.prefetch_hot_lists()
    assert 3 in hot and 3 in staged
    assert 7 not in hot          # one decayed access = noise, under the
    #                              absolute staging floor (min_accesses)
    assert lp.get_hot_lists(1) == [3]
    assert lp.hotness(3) == 1.0


def test_prefetch_scheduler_priority_and_throttle():
    done = []
    sched = PrefetchScheduler(bandwidth_limit_bps=1e12)
    sched.pause()
    sched.schedule(lambda: done.append("low"), priority=0)
    sched.schedule(lambda: done.append("high"), priority=10)
    sched.resume()
    deadline = time.time() + 5
    while sched.completed < 2 and time.time() < deadline:
        time.sleep(0.01)
    assert done == ["high", "low"]
    sched.stop()
    with pytest.raises(RuntimeError):
        sched.schedule(lambda: None)


def test_streaming_multi_wave_tiny_cache(rng):
    """Cache smaller than the batch working set → wave-split scan must still
    return exactly the resident-index results."""
    idx, _ = _build(rng, nlist=16)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=5)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    p = SearchParams(nprobe=16, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_cache_soft_protect_prefers_unprotected_victim():
    """Belady-style hint: lists a later wave needs survive eviction even
    when LRU/LFU scores would pick them."""
    import jax.numpy as jnp

    data = {
        l: (np.full((2, 8), l, np.float32), np.zeros(2, np.float32), 2)
        for l in range(10)
    }
    cache = HbmListCache(n_slots=3, capacity=4, dim=8, dtype=jnp.float32,
                         policy="lru")
    cache.ensure_resident(np.array([1, 2]), lambda l: data[l])
    time.sleep(0.01)
    cache.ensure_resident(np.array([0]), lambda l: data[l])  # 0 = freshest
    # LRU alone would evict 1; the next wave needs {1, 2} → evict 0.
    cache.ensure_resident(np.array([5]), lambda l: data[l],
                          soft_protect={1, 2})
    assert 0 not in cache.resident_lists()
    assert {1, 2, 5} <= set(cache.resident_lists())
    # Soft protection never blocks: all residents soft-protected still
    # yields a victim (among them).
    cache.ensure_resident(np.array([7]), lambda l: data[l],
                          soft_protect={1, 2, 5})
    assert 7 in cache.resident_lists()


def test_streaming_column_wider_than_cache_splits_batch(rng):
    """A single probe column can touch more unique lists than the cache has
    slots (a wide cold batch). The tier must split the batch by rows — not
    raise — and still return exactly the resident-index results."""
    idx, _ = _build(rng, n=8000, nlist=32)
    streaming = StreamingIVFFlatIndex(idx, cache_slots=5)
    # 16 queries pinned near 16 distinct centroids: probe column 0 has ~16
    # unique lists > 5 slots.
    cents = np.asarray(idx.centroids)[:16]
    q = (cents + 0.01 * rng.standard_normal(cents.shape)).astype(np.float32)
    p = SearchParams(nprobe=4, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = streaming.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_list_prefetcher_skewed_set_recovery():
    """A hot working set with UNEVEN probe counts must restage as a set —
    the old relative-to-peak gate dropped every list under 0.7x the
    hottest (measured on the 20M tier: a few of several hundred)."""
    staged = []
    lp = ListPrefetcher(stage_fn=staged.extend)
    for lid, n in [(1, 20), (2, 8), (3, 5), (4, 3)]:
        lp.record_access(lid, n)
    lp.record_access(9)          # one-off cold touch stays out
    hot = lp.prefetch_hot_lists(max_lists=8)
    assert set(hot) == {1, 2, 3, 4}
    assert 9 not in staged
