"""IVFFlatIndex tests: recall vs the exact oracle (the north-star gate,
SURVEY.md §7 step 3), metric coverage, ingest growth, hotness surface."""

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID


def _recall(found_ids, true_ids):
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_ids.size


def _build(rng, n=4000, dim=32, nlist=16, metric="L2", dtype="float32"):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, metric=metric, dtype=dtype)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.add(x)
    return idx, x


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_ivf_recall_full_probe_is_exact(rng, oracle, metric):
    """nprobe == nlist ⇒ IVF must recover the exact top-k."""
    idx, x = _build(rng, metric=metric)
    q = rng.standard_normal((5, 32)).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=16, k=10))
    _, ref = oracle(q, x, 10, metric)
    assert _recall(ids, ref.astype(np.uint64)) == 1.0


def test_ivf_recall_partial_probe(oracle):
    # Local generator: recall on random data is draw-sensitive, so this test
    # must not depend on the shared session RNG's consumption order.
    rng = np.random.default_rng(7)
    idx, x = _build(rng, n=8000, nlist=32)
    q = rng.standard_normal((20, 32)).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=8, k=10))
    _, ref = oracle(q, x, 10)
    # Unclustered gaussian data is IVF's worst case; nprobe=1/4 of nlist
    # still has to recover the bulk of the exact top-10.
    assert _recall(ids, ref.astype(np.uint64)) >= 0.65
    d2, ids2 = idx.search(q, SearchParams(nprobe=24, k=10))
    assert _recall(ids2, ref.astype(np.uint64)) > 0.95


def test_ivf_distances_sorted_and_exact(rng, oracle):
    idx, x = _build(rng)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=16, k=10))
    assert (np.diff(d, axis=1) >= -1e-6).all()
    d_ref, _ = oracle(q, x, 10)
    np.testing.assert_allclose(d, d_ref, rtol=1e-3, atol=1e-3)


def test_ivf_bfloat16_arena_recall(rng, oracle):
    """bf16 corpus storage must not measurably hurt top-10 recall."""
    idx, x = _build(rng, dtype="bfloat16")
    q = rng.standard_normal((10, 32)).astype(np.float32)
    _, ids = idx.search(q, SearchParams(nprobe=16, k=10))
    _, ref = oracle(q, x, 10)
    assert _recall(ids, ref.astype(np.uint64)) > 0.95


def test_ivf_incremental_add_grows_arena(rng):
    idx, x = _build(rng, n=2000, nlist=4)
    cap0 = idx.arena.capacity
    for _ in range(4):
        idx.add(rng.standard_normal((2000, 32)).astype(np.float32))
    assert idx.ntotal == 10000
    assert idx.arena.capacity > cap0
    d, ids = idx.search(x[:2], SearchParams(nprobe=4, k=3))
    assert (ids != INVALID_ID).all()


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_remove_ids_deletes_and_compacts(rng, dtype):
    idx, x = _build(rng, n=3000, nlist=8, dtype=dtype)
    # Every vector finds itself before deletion.
    victims = np.asarray([0, 1, 7, 500, 1500, 2999], np.uint64)
    d0, ids0 = idx.search(x[victims.astype(np.int64)],
                          SearchParams(nprobe=8, k=1))
    assert (ids0[:, 0] == victims).all()
    n_before = idx.ntotal
    assert idx.remove_ids(victims) == len(victims)
    assert idx.ntotal == n_before - len(victims)
    # Deleted ids never come back, at ANY k.
    d, ids = idx.search(x[victims.astype(np.int64)],
                        SearchParams(nprobe=8, k=10))
    assert not np.isin(ids, victims).any()
    # Survivors still find themselves (compaction moved rows, not values).
    keep = np.asarray([2, 100, 2000], np.uint64)
    d2, ids2 = idx.search(x[keep.astype(np.int64)],
                          SearchParams(nprobe=8, k=1))
    assert (ids2[:, 0] == keep).all()
    # Idempotent: removing again is a no-op.
    assert idx.remove_ids(victims) == 0
    # Unknown ids ignored.
    assert idx.remove_ids(np.asarray([10**12], np.uint64)) == 0


def test_remove_ids_exactness_vs_rebuild(rng):
    """Post-delete search must equal a from-scratch index of the survivors
    (same centroids): compaction may not perturb a single distance."""
    idx, x = _build(rng, n=1200, nlist=4)
    victims = rng.choice(1200, size=300, replace=False).astype(np.uint64)
    idx.remove_ids(victims)
    survivors = np.setdiff1d(np.arange(1200, dtype=np.uint64), victims)
    ref = IVFFlatIndex(idx.config)
    ref.centroids = idx.centroids
    ref.trained = True
    ref.add(x[survivors.astype(np.int64)], ids=survivors)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    d_a, ids_a = idx.search(q, SearchParams(nprobe=4, k=5))
    d_b, ids_b = ref.search(q, SearchParams(nprobe=4, k=5))
    np.testing.assert_array_equal(ids_a, ids_b)
    np.testing.assert_allclose(d_a, d_b, rtol=1e-5, atol=1e-5)


def test_remove_then_add_reuses_slots(rng):
    idx, x = _build(rng, n=1000, nlist=4)
    cap0 = idx.arena.capacity
    idx.remove_ids(np.arange(500, dtype=np.uint64))
    newv = rng.standard_normal((500, 32)).astype(np.float32)
    idx.add(newv, ids=np.arange(5000, 5500, dtype=np.uint64))
    assert idx.ntotal == 1000
    assert idx.arena.capacity == cap0  # freed slots were reused
    d, ids = idx.search(newv[:4], SearchParams(nprobe=4, k=1))
    assert (ids[:, 0] == np.arange(5000, 5004, dtype=np.uint64)).all()


def test_ivf_requires_train():
    idx = IVFFlatIndex(IVFFlatConfig(dimension=8, nlist=4))
    with pytest.raises(RuntimeError):
        idx.add(np.zeros((4, 8), np.float32))
    with pytest.raises(RuntimeError):
        idx.search(np.zeros((1, 8), np.float32))


def test_ivf_dim_mismatch_rejected(rng):
    idx, _ = _build(rng, dim=32)
    with pytest.raises(ValueError):
        idx.search(np.zeros((1, 16), np.float32))


def test_ivf_single_query_1d_input(rng):
    idx, x = _build(rng)
    d, ids = idx.search(x[0], SearchParams(nprobe=16, k=1))
    assert ids.shape == (1, 1)
    assert d[0, 0] < 1e-3  # finds itself


def test_ivf_hotness_and_warmup(rng):
    idx, x = _build(rng)
    idx.search(x[:4], SearchParams(nprobe=2, k=3))
    hot = idx.get_hot_lists(4)
    assert idx.list_access_count.sum() > 0
    idx.evict_list(int(hot[0]))
    assert idx.list_access_count[hot[0]] == 0
    idx.warmup_lists(batch_sizes=(1,))
    # nprobe is shape-static: warmup accepts explicit serving operating
    # points and the warmed shapes then serve without retracing.
    idx.warmup_lists(batch_sizes=(1, 8), nprobes=(2, 4))
    d, ids = idx.search(x[:8], SearchParams(nprobe=4, k=3))
    assert ids.shape == (8, 3)


def test_ivf_custom_ids_roundtrip(rng):
    idx, x = _build(rng, n=1000, nlist=4)
    # re-add with custom ids on a fresh index
    cfg = IVFFlatConfig(dimension=32, nlist=4, dtype="float32")
    idx2 = IVFFlatIndex(cfg)
    idx2.train(x)
    ids = np.arange(1000, dtype=np.uint64) * 7 + 3
    idx2.add(x, ids=ids)
    _, got = idx2.search(x[:3], SearchParams(nprobe=4, k=1))
    assert np.array_equal(got[:, 0], ids[:3])


def test_build_from_device_matches_add(rng, oracle):
    """Device bulk-build must produce the same search results as add()."""
    import jax.numpy as jnp

    x = rng.standard_normal((3000, 32)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=32, nlist=8, dtype="float32")
    a = IVFFlatIndex(cfg)
    a.train(x)
    a.add(x)
    b = IVFFlatIndex(cfg)
    b.train(x)  # same seed → same centroids
    b.build_from_device(jnp.asarray(x))
    q = rng.standard_normal((5, 32)).astype(np.float32)
    da, ia = a.search(q, SearchParams(nprobe=8, k=10))
    db, ib = b.search(q, SearchParams(nprobe=8, k=10))
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_allclose(da, db, rtol=1e-5)


def test_train_from_device(rng):
    import jax.numpy as jnp

    x = rng.standard_normal((2000, 16)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=16, nlist=8, dtype="float32")
    idx = IVFFlatIndex(cfg)
    idx.train_from_device(jnp.asarray(x))
    idx.build_from_device(jnp.asarray(x))
    d, ids = idx.search(x[:4], SearchParams(nprobe=8, k=1))
    assert np.array_equal(ids[:, 0], np.arange(4, dtype=np.uint64))


def test_bulk_build_balances_skewed_lists(oracle):
    """A pathologically skewed corpus must not inflate arena capacity: the
    clamp spills overflow to next-best lists and recall survives."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    # 90% of points in one tight blob, 10% spread out
    blob = 0.01 * rng.standard_normal((9000, 16)).astype(np.float32)
    rest = 5 * rng.standard_normal((1000, 16)).astype(np.float32)
    x = np.concatenate([blob, rest])
    cfg = IVFFlatConfig(dimension=16, nlist=16, dtype="float32")
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.build_from_device(jnp.asarray(x))
    counts = np.asarray(idx.arena.counts)
    assert counts.sum() == 10000          # nothing dropped
    assert counts.max() <= idx.arena.capacity
    # capacity stays near the clamp target, far below the 9000-row blob
    assert idx.arena.capacity < 9000
    # full-probe search is still exact
    q = x[:5] + 0.001
    _, ids = idx.search(q, SearchParams(nprobe=16, k=1))
    assert np.array_equal(ids[:, 0], np.arange(5, dtype=np.uint64))


def test_exact_rerank_recovers_f32_distances(rng, oracle):
    """bf16 hot scan + hi/lo rerank must return fp32-exact distances."""
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=32, nlist=8, dtype="bfloat16",
                        store_residuals=True)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.add(x)
    assert idx.arena.arena_lo is not None
    q = rng.standard_normal((6, 32)).astype(np.float32)
    d_rr, ids_rr = idx.search(
        q, SearchParams(nprobe=8, k=10, use_exact_rerank=True)
    )
    d_ref, ref = oracle(q, x, 10)
    assert np.array_equal(np.sort(ids_rr), np.sort(ref.astype(np.uint64)))
    np.testing.assert_allclose(d_rr, d_ref, rtol=1e-4, atol=1e-4)
    # plain bf16 distances are noticeably noisier than reranked ones
    d_plain, _ = idx.search(q, SearchParams(nprobe=8, k=10))
    err_rr = np.abs(d_rr - d_ref).max()
    err_plain = np.abs(d_plain - d_ref).max()
    assert err_rr < err_plain


def test_int8_arena_recall_and_paths(oracle):
    """int8 scalar-quantized arena: recall holds, save/load round-trips,
    incremental add works, rerank recovers fp32 distances."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=32, nlist=16, dtype="int8",
                        store_residuals=True)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.build_from_device(jnp.asarray(x))
    assert idx.arena.arena.dtype == jnp.int8
    assert idx.arena.arena_scale is not None
    q = rng.standard_normal((10, 32)).astype(np.float32)
    _, ids = idx.search(q, SearchParams(nprobe=16, k=10))
    _, ref = oracle(q, x, 10)
    hits = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 10
        for a, b in zip(ids, ref.astype(np.uint64))
    ])
    assert hits > 0.9, hits
    # exact rerank restores fp32 distances
    d_rr, ids_rr = idx.search(
        q, SearchParams(nprobe=16, k=10, use_exact_rerank=True)
    )
    d_ref, _ = oracle(q, x, 10)
    np.testing.assert_allclose(d_rr, d_ref, rtol=1e-3, atol=1e-3)
    # incremental add quantizes against existing scales
    more = rng.standard_normal((500, 32)).astype(np.float32)
    idx.add(more, ids=np.arange(4000, 4500, dtype=np.uint64))
    assert idx.ntotal == 4500
    _, ids3 = idx.search(more[:3], SearchParams(nprobe=16, k=1))
    assert (ids3[:, 0] == np.arange(4000, 4003, dtype=np.uint64)).all()


def test_int8_save_load_roundtrip(tmp_path):
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=16, nlist=8, dtype="int8"))
    idx.train(x)
    idx.build_from_device(jnp.asarray(x))
    path = str(tmp_path / "snap8")
    idx.save(path)
    idx2 = IVFFlatIndex.load(path)
    assert idx2.arena.arena.dtype == jnp.int8
    q = rng.standard_normal((4, 16)).astype(np.float32)
    p = SearchParams(nprobe=8, k=5)
    d1, i1 = idx.search(q, p)
    d2, i2 = idx2.search(q, p)
    # Snapshots persist values, not the original exact norms, so near-tie
    # ranks may swap; result sets and distances must agree.
    for a, b in zip(i1, i2):
        assert set(a.tolist()) == set(b.tolist())
    np.testing.assert_allclose(np.sort(d1), np.sort(d2), rtol=5e-2,
                               atol=5e-2)


def test_calibrate_nprobe_meets_target(oracle):
    """calibrate_nprobe must pick an nprobe whose measured coverage meets
    the target, and SearchParams(nprobe=0) must resolve to it."""
    rng = np.random.default_rng(21)
    idx, x = _build(rng, n=8000, nlist=32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    rep = idx.calibrate_nprobe(queries=q, target_coverage=0.9, k=10)
    assert rep["nprobe"] >= 1
    assert rep["coverage"] >= 0.9
    assert idx.calibrated_nprobe == rep["nprobe"]
    # The curve is monotone non-decreasing and exact at full probe.
    ps = sorted(rep["curve"])
    vals = [rep["curve"][p] for p in ps]
    assert all(b >= a - 1e-9 for a, b in zip(vals, vals[1:]))
    assert rep["curve"][32] == 1.0
    # nprobe=0 ⇒ auto: recall at the calibrated point must be close to
    # the measured coverage (ranking on fp32 arenas is exact).
    _, ids = idx.search(q, SearchParams(nprobe=0, k=10))
    _, ref = oracle(q, x, 10)
    assert _recall(ids, ref.astype(np.uint64)) >= 0.85


def test_calibrate_nprobe_self_sample():
    """Default calibration samples stored rows (no queries given) and
    works on int8 arenas (dequantizes through scales/anchors)."""
    rng = np.random.default_rng(22)
    idx, _ = _build(rng, n=4000, nlist=16, dtype="int8")
    rep = idx.calibrate_nprobe(sample=128, target_coverage=0.95)
    assert 1 <= rep["nprobe"] <= 16
    assert rep["coverage"] >= 0.95
    assert rep["sample"] == 128


def test_calibrate_nprobe_requires_train():
    idx = IVFFlatIndex(IVFFlatConfig(dimension=8, nlist=4))
    with pytest.raises(RuntimeError):
        idx.calibrate_nprobe()


def test_query_upload_bf16_matches_f32_results(rng, oracle):
    """query_upload_dtype=bfloat16 (the serving path's halved H2D
    transport) must not change the returned neighbor ids on separated
    data — the device program widens back to fp32, so only the query
    mantissa rounds."""
    idx, x = _build(rng, n=4000, dim=32, nlist=16, dtype="int8")
    q = rng.standard_normal((16, 32)).astype(np.float32)
    d32, ids32 = idx.search(q, SearchParams(nprobe=16, k=10))
    idx.config.query_upload_dtype = "bfloat16"
    d16, ids16 = idx.search(q, SearchParams(nprobe=16, k=10))
    # bf16 query rounding reorders statistical near-ties (unclustered
    # gaussians are the worst case) — compare result SETS, not positions
    assert _recall(ids16, ids32) >= 0.95
    np.testing.assert_allclose(d16, d32, rtol=2e-2, atol=2e-2)
    # and the full-probe search still recovers the int8-exact top-k set
    _, ref = oracle(q, x, 10)
    assert _recall(ids16, ref.astype(np.uint64)) >= 0.9


def test_dedup_topk():
    """dedup_topk keeps the nearest copy of each id, preserves order, and
    sentinel-pads rows that end up short."""
    from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
        FLT_MAX,
        dedup_topk,
    )

    ids = np.array([
        [5, 5, 7, 9],      # adjacent dup
        [1, 2, 1, 2],      # two dup pairs -> only 2 unique
        [3, 4, 5, 6],      # no dups
    ], np.uint64)
    d = np.arange(12, dtype=np.float32).reshape(3, 4)
    d2, i2 = dedup_topk(d, ids, 2)
    np.testing.assert_array_equal(i2, np.array(
        [[5, 7], [1, 2], [3, 4]], np.uint64))
    np.testing.assert_array_equal(d2[0], [0.0, 2.0])
    np.testing.assert_array_equal(d2[2], [8.0, 9.0])
    # short row after dedup: k=3 from row 1's 2 uniques pads sentinels
    d3, i3 = dedup_topk(d, ids, 3)
    assert i3[1, 2] == INVALID_ID and d3[1, 2] == FLT_MAX


def test_multi_assign_replication_and_dedup(rng, oracle):
    """multi_assign_eps: dense near-tie geometry earns second copies
    (replication factor > 1), search results carry no duplicate ids, and
    probe-limited recall does not regress vs the plain build."""
    # One dense mode spread across several lists (the zipf head-mode shape,
    # miniaturized): 6000 rows in ONE gaussian ball over 16 lists.
    n, dim, nlist, k = 6000, 24, 16, 10
    x = (0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    q = x[:32] + 0.03 * rng.standard_normal((32, dim)).astype(np.float32)

    def build(eps):
        import jax.numpy as jnp

        cfg = IVFFlatConfig(
            dimension=dim, nlist=nlist, dtype="float32",
            multi_assign_eps=eps,
        )
        idx = IVFFlatIndex(cfg)
        idx.train(x)
        cap = -(-int(n / nlist * (2.0 if eps else 1.35)) // 8) * 8
        idx.append_balanced(jnp.asarray(x), capacity=cap)
        return idx

    plain = build(0.0)
    multi = build(0.25)
    assert multi.ntotal > n  # the ratio test fired inside the dense mode
    rep = multi.ntotal / n

    _, ref = oracle(q, x, k)
    p = SearchParams(nprobe=4, k=k)
    _, ids_p = plain.search(q, p)
    d_m, ids_m = multi.search(q, p)
    # no duplicate ids in any returned row
    for row in ids_m:
        real = row[row != INVALID_ID]
        assert len(set(real.tolist())) == real.size
    assert (np.diff(d_m, axis=1) >= -1e-5).all()
    r_plain = _recall(ids_p, ref.astype(np.uint64))
    r_multi = _recall(ids_m, ref.astype(np.uint64))
    assert r_multi >= r_plain - 0.02, (r_plain, r_multi, rep)

    # full probe must still be exact (dedup returns the true set)
    _, ids_full = multi.search(q, SearchParams(nprobe=nlist, k=k))
    assert _recall(ids_full, ref.astype(np.uint64)) == 1.0


def test_multi_assign_snapshot_roundtrip(rng, tmp_path):
    """A multi-assignment snapshot reloads with the eps (so the loaded
    index keeps deduping) and identical search results."""
    import jax.numpy as jnp

    n, dim, nlist = 2000, 16, 8
    x = (0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, dtype="float32",
                        multi_assign_eps=0.3)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.append_balanced(jnp.asarray(x), capacity=len(x) // nlist * 2)
    assert idx.ntotal > n
    q = x[:8]
    d0, i0 = idx.search(q, SearchParams(nprobe=nlist, k=5))
    idx.save(str(tmp_path / "snap"))
    idx2 = IVFFlatIndex.load(str(tmp_path / "snap"))
    assert idx2.config.multi_assign_eps == pytest.approx(0.3)
    d1, i1 = idx2.search(q, SearchParams(nprobe=nlist, k=5))
    np.testing.assert_array_equal(i0, i1)
    np.testing.assert_allclose(d0, d1, rtol=1e-5, atol=1e-5)


def test_append_subchunking_parity(rng):
    """Sub-chunked device appends (the transient-bounding fix: arena.py
    ``_append_steps``) must produce byte-identical arenas to a single-shot
    append — exercised in int8-residual mode, whose anchor-gather transients
    were the OOM source."""
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.models.arena import (
        PackedListArena,
        _append_steps,
    )

    # ladder decomposition invariants
    assert _append_steps(100, 131_072) == [100]
    steps = _append_steps(500_000, 131_072)
    assert sum(steps) == 500_000
    assert len(set(steps)) <= 6  # bounded distinct shapes
    assert max(steps) == 131_072

    n, dim, nlist = 3000, 16, 8
    x = (0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, dtype="int8")
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    assigns = np.asarray(
        rng.integers(0, nlist, size=n), dtype=np.int64
    )
    ids = np.arange(n, dtype=np.uint64)

    def fresh_arena(cap):
        a = PackedListArena.create(nlist, dim, jnp.int8, capacity=cap)
        return a.__class__(
            **{**a.__dict__, "anchors": idx.centroids.astype(jnp.float32)}
        )

    cap = (n // nlist) * 2
    one = fresh_arena(cap).append(x, ids, assigns)

    old = PackedListArena.APPEND_DEVICE_ROWS
    try:
        PackedListArena.APPEND_DEVICE_ROWS = 512  # force many sub-programs
        many = fresh_arena(cap).append(x, ids, assigns)
    finally:
        PackedListArena.APPEND_DEVICE_ROWS = old

    np.testing.assert_array_equal(np.asarray(one.arena), np.asarray(many.arena))
    np.testing.assert_array_equal(np.asarray(one.counts), np.asarray(many.counts))
    np.testing.assert_allclose(
        np.asarray(one.arena_sq), np.asarray(many.arena_sq), rtol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(one.arena_scale), np.asarray(many.arena_scale), rtol=1e-6
    )
    np.testing.assert_array_equal(one.ids, many.ids)
