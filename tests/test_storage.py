"""Storage layer tests: Arrow round trips, snapshot save/load equivalence,
epoch lifecycle (+ crash recovery), shard files."""

import json
import os

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.storage import (
    ArrowStorage,
    EpochManager,
    IndexManifest,
    ShardEntry,
)
from cuda_acceleratedvectordatabaseengine.storage.shard_store import (
    AlignedReader,
    ShardManager,
)


def test_arrow_vectors_roundtrip(tmp_path, rng):
    ids = rng.integers(0, 2 ** 60, 100).astype(np.uint64)
    vecs = rng.standard_normal((100, 32)).astype(np.float32)
    p = str(tmp_path / "v.arrow")
    ArrowStorage.write_vectors(p, ids, vecs)
    ids2, vecs2 = ArrowStorage.read_vectors(p)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(vecs, vecs2)
    # offset/length slicing
    ids3, vecs3 = ArrowStorage.read_vectors(p, offset=10, length=5)
    np.testing.assert_array_equal(ids[10:15], ids3)
    np.testing.assert_array_equal(vecs[10:15], vecs3)


def test_arrow_codebooks_roundtrip(tmp_path, rng):
    cb = rng.standard_normal((8, 256, 4)).astype(np.float32)
    p = str(tmp_path / "cb.arrow")
    ArrowStorage.write_codebooks(p, cb)
    np.testing.assert_array_equal(ArrowStorage.read_codebooks(p), cb)


def test_arrow_codes_roundtrip(tmp_path, rng):
    ids = np.arange(50, dtype=np.uint64)
    codes = rng.integers(0, 256, (50, 8)).astype(np.uint8)
    p = str(tmp_path / "c.arrow")
    ArrowStorage.write_codes(p, ids, codes)
    ids2, codes2 = ArrowStorage.read_codes(p)
    np.testing.assert_array_equal(ids, ids2)
    np.testing.assert_array_equal(codes, codes2)


def test_manifest_roundtrip(tmp_path):
    man = IndexManifest(
        name="idx", epoch="123", kind="ivf_flat", dimension=64, nlist=16,
        metric="Cosine", num_vectors=1000, capacity_per_list=128,
        dtype="bfloat16",
        shards=[ShardEntry(0, 0, 500), ShardEntry(1, 500, 500)],
    )
    man.save(str(tmp_path))
    man2 = IndexManifest.load(str(tmp_path))
    assert man2.metric == "Cosine" and len(man2.shards) == 2
    assert man2.shards[1].row_offset == 500
    assert man2.created_at_ns > 0


def test_ivf_flat_save_load_identical_results(tmp_path, rng):
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=32, nlist=8, dtype="float32"))
    idx.train(x)
    ids = np.arange(2000, dtype=np.uint64) * 3
    idx.add(x, ids=ids)
    path = str(tmp_path / "snap")
    idx.save(path)

    idx2 = IVFFlatIndex.load(path)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    p = SearchParams(nprobe=8, k=10)
    d1, i1 = idx.search(q, p)
    d2, i2 = idx2.search(q, p)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-5)
    assert idx2.ntotal == 2000


def test_ivf_flat_save_load_after_remove(tmp_path, rng):
    """Snapshots taken after deletions round-trip exactly (counts shrink,
    prefix packing holds, removed ids never resurface)."""
    x = rng.standard_normal((1500, 32)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=32, nlist=8, dtype="int8"))
    idx.train(x)
    idx.add(x)
    victims = rng.choice(1500, size=200, replace=False).astype(np.uint64)
    assert idx.remove_ids(victims) == 200
    path = str(tmp_path / "snap-rm")
    idx.save(path)
    idx2 = IVFFlatIndex.load(path)
    assert idx2.ntotal == 1300
    q = rng.standard_normal((6, 32)).astype(np.float32)
    p = SearchParams(nprobe=8, k=10)
    d1, i1 = idx.search(q, p)
    d2, i2 = idx2.search(q, p)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)
    assert not np.isin(i2, victims).any()


def test_ivf_flat_host_load_streaming_parity(tmp_path, rng):
    """load_ivf_flat_host serves the snapshot through the streaming tier
    with the same results as the resident load — without ever building a
    device arena (the >HBM activation path)."""
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.io_host import (
        StreamingIVFFlatIndex,
    )
    from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
        load_ivf_flat_host,
    )

    x = rng.standard_normal((1500, 32)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=32, nlist=8, dtype="float32"))
    idx.train(x)
    ids = np.arange(1500, dtype=np.uint64) * 7
    idx.add(x, ids=ids)
    path = str(tmp_path / "snap-host")
    idx.save(path)

    store, centroids, cfg, cap = load_ivf_flat_host(path)
    assert store.total() == 1500
    assert cap == idx.arena.capacity
    streaming = StreamingIVFFlatIndex.from_store(
        store, jnp.asarray(centroids), cfg, cache_slots=8, capacity=cap
    )
    q = rng.standard_normal((5, 32)).astype(np.float32)
    p = SearchParams(nprobe=8, k=10)
    d1, i1 = idx.search(q, p)
    d2, i2 = streaming.search(q, p)
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-4, atol=1e-4)


def test_ivf_pq_save_load_identical_results(tmp_path, rng):
    x = rng.standard_normal((2000, 32)).astype(np.float32)
    idx = IVFPQIndex(IVFPQConfig(dimension=32, nlist=8, m=8,
                                 pq_train_sample=1024))
    idx.train(x)
    idx.add(x)
    path = str(tmp_path / "snap_pq")
    idx.save(path)

    idx2 = IVFPQIndex.load(path)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    p = SearchParams(nprobe=8, k=10, use_exact_rerank=True)
    d1, i1 = idx.search(q, p)
    d2, i2 = idx2.search(q, p)
    # The reloaded raw arena's norms are recomputed from bf16-rounded
    # vectors, so exact near-ties may swap rank; the result *sets* and
    # distances must match.
    for a, b in zip(i1, i2):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(d1), np.sort(d2), rtol=1e-2,
                               atol=1e-2)


def test_ivf_pq_save_load_no_raw(tmp_path, rng):
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    idx = IVFPQIndex(IVFPQConfig(dimension=16, nlist=4, m=4, keep_raw=False,
                                 pq_train_sample=512))
    idx.train(x)
    idx.add(x)
    path = str(tmp_path / "snap_nr")
    idx.save(path)
    idx2 = IVFPQIndex.load(path)
    assert idx2.raw is None
    d1, i1 = idx.search(x[:3], SearchParams(nprobe=4, k=5))
    d2, i2 = idx2.search(x[:3], SearchParams(nprobe=4, k=5))
    np.testing.assert_array_equal(i1, i2)


def test_ivf_pq_capacity_save_load(tmp_path, rng):
    """Capacity-tier epoch: save_ivf_pq(host_rows=...) persists raw rows
    alongside keep_raw=False codes; load_ivf_pq_capacity rebuilds the
    device code arena + an int8 host store and attaches exact rerank
    (read-only). Composes the reference's declared rerank surface
    (``engine/ivf_flat_index.h:153-157``) with its declared host tier
    (``format/storage.h:124-173``)."""
    from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
        load_ivf_pq_capacity,
        save_ivf_pq,
    )

    x = rng.standard_normal((2000, 32)).astype(np.float32)
    ids = np.arange(2000, dtype=np.uint64) * 7 + 3  # non-trivial id space
    idx = IVFPQIndex(IVFPQConfig(dimension=32, nlist=8, m=8,
                                 keep_raw=False, pq_train_sample=1024))
    idx.train(x)
    idx.add(x, ids)
    path = str(tmp_path / "snap_cap")
    # host_rows in a DIFFERENT order than ingestion: save matches by id.
    perm = rng.permutation(2000)
    save_ivf_pq(path, idx, host_rows=(x[perm], ids[perm]))

    idx2 = load_ivf_pq_capacity(path, rerank_k=64)
    assert idx2.raw is None and idx2._host_rr is not None
    assert idx2.read_only
    q = x[:16] + 0.01 * rng.standard_normal((16, 32)).astype(np.float32)
    d_adc, i_adc = idx.search(q, SearchParams(nprobe=8, k=5))
    d_rr, i_rr = idx2.search(
        q, SearchParams(nprobe=8, k=5, use_exact_rerank=True)
    )
    # rerank from the host store: each query's own row wins, distance ≈ 0
    # (int8 quantization noise only).
    assert (i_rr[:, 0] == ids[:16]).all()
    assert (d_rr[:, 0] < 0.1).all()
    # plain ADC on the reloaded index still matches the original bit-exact
    d3, i3 = idx2.search(q, SearchParams(nprobe=8, k=5))
    np.testing.assert_array_equal(i_adc, i3)
    # mutation is refused while the host store is attached
    with pytest.raises(RuntimeError, match="read-only"):
        idx2.add(x[:4])

    # a keep_raw=False snapshot WITHOUT host rows refuses capacity load
    path2 = str(tmp_path / "snap_cap_norows")
    save_ivf_pq(path2, idx)
    with pytest.raises(ValueError, match="host rows"):
        load_ivf_pq_capacity(path2)


def test_epoch_lifecycle(tmp_path):
    em = EpochManager(str(tmp_path), keep_epochs=2)
    e1, d1 = em.create_epoch("idx")
    assert os.path.isdir(d1)
    assert em.active_epoch("idx") is None
    em.activate_epoch("idx", e1)
    assert em.active_epoch("idx") == e1
    # new epoch supersedes
    e2, d2 = em.create_epoch("idx")
    em.activate_epoch("idx", e2)
    assert em.active_epoch("idx") == e2
    # revert (the degrade path, storage.cpp:351-375)
    em.activate_epoch("idx", e1)
    assert em.active_epoch("idx") == e1


def test_epoch_gc_keeps_n(tmp_path):
    em = EpochManager(str(tmp_path), keep_epochs=2)
    eids = []
    for _ in range(5):
        e, d = em.create_epoch("idx")
        open(os.path.join(d, "marker"), "w").close()
        eids.append(e)
    em.activate_epoch("idx", eids[-1])
    st = em.list_epochs("idx")
    # active + at most 2 inactive survive
    assert len(st["epochs"]) <= 3
    assert eids[-1] in st["epochs"]
    assert not os.path.isdir(em.epoch_dir("idx", eids[0]))


def test_epoch_crash_recovery(tmp_path):
    em = EpochManager(str(tmp_path))
    e1, d1 = em.create_epoch("idx")
    em.activate_epoch("idx", e1)
    # new manager instance recovers state from epochs.json
    em2 = EpochManager(str(tmp_path))
    assert em2.active_epoch("idx") == e1
    assert em2.list_indices() == ["idx"]
    # registry survives corruption of a vanished dir
    import shutil

    shutil.rmtree(d1)
    em3 = EpochManager(str(tmp_path))
    assert em3.active_epoch("idx") is None


def test_shard_manager_append_load_compact(tmp_path, rng):
    sm = ShardManager(str(tmp_path), dimension=8, code_width=4)
    ids = np.arange(10, dtype=np.uint64)
    vecs = rng.standard_normal((10, 8)).astype(np.float32)
    codes = rng.integers(0, 256, (10, 4)).astype(np.uint8)
    sm.create_shard(3)
    sm.append(3, ids[:6], vecs[:6], codes[:6])
    sm.append(3, ids[6:], vecs[6:], codes[6:])
    assert sm.num_vectors(3) == 10
    i2, v2, c2 = sm.load(3)
    np.testing.assert_array_equal(np.asarray(i2), ids)
    np.testing.assert_array_equal(np.asarray(v2), vecs)
    np.testing.assert_array_equal(np.asarray(c2), codes)
    kept = sm.compact(3, {0, 5, 9})
    assert kept == 7
    i3, v3, _ = sm.load(3)
    assert 0 not in i3 and 5 not in i3
    assert sm.list_shards() == [3]


def test_aligned_reader(tmp_path, rng):
    data = rng.integers(0, 256, 100_000).astype(np.uint8).tobytes()
    p = str(tmp_path / "blob")
    with open(p, "wb") as f:
        f.write(data)
    r = AlignedReader(io_depth=4)
    # unaligned offset/size must return exact bytes
    assert r.read_aligned(p, 5000, 1234) == data[5000:6234]
    results = {}
    fut = r.read_async(p, 0, 100, callback=lambda b: results.update(got=b))
    r.wait_all()
    assert fut.result() == data[:100] and results["got"] == data[:100]
    r.prefetch(p)
    r.close()
