"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4: test
multi-device sharding without a cluster)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.parallel import (
    ShardedIVFFlatIndex,
    make_mesh,
    sharded_kmeans_lloyd_step,
)
from cuda_acceleratedvectordatabaseengine.parallel.sharded import (
    _striping_perm,
)
from jax.sharding import NamedSharding, PartitionSpec as P


def _build(rng, n=4000, dim=32, nlist=16, metric="L2"):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, metric=metric,
                        dtype="float32")
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.add(x)
    return idx, x


def test_sharded_occupied_prefix_hint_is_exact(rng, interpret_grouped):
    """A striped arena with allocation headroom (the grouped kernel bounds
    each list's loop by its own count, never the allocation) stays
    identical to the single-device search."""
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=32, nlist=8, dtype="float32",
                        max_capacity_factor=8.0)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    # Pre-grow well past the fill so the occupied prefix is a real subset.
    idx.arena = idx.arena.grow(-(-int(3000 / 8 * 3) // 128) * 128)
    idx.add(x)
    sharded = ShardedIVFFlatIndex(idx, make_mesh(2), scan_impl="grouped")
    assert int(np.asarray(idx.arena.counts).max()) < sharded.global_cap // 2
    q = rng.standard_normal((6, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    d_ref, ids_ref = idx.search(q, params)
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_sharded_refresh_after_remove(rng):
    """Deletion composes with the mesh view: remove on the base index,
    refresh() re-stripes, and the deleted ids vanish from sharded search
    while survivors keep exact parity with the base."""
    idx, x = _build(rng, n=2000, nlist=8)
    sharded = ShardedIVFFlatIndex(idx, make_mesh(4))
    victims = np.asarray([0, 3, 999, 1999], np.uint64)
    assert idx.remove_ids(victims) == len(victims)
    sharded.refresh()
    params = SearchParams(nprobe=8, k=10)
    d, ids = sharded.search(x[victims.astype(np.int64)], params)
    assert not np.isin(ids, victims).any()
    d_ref, ids_ref = idx.search(x[:6], params)
    d_s, ids_s = sharded.search(x[:6], params)
    np.testing.assert_array_equal(ids_s, ids_ref)
    np.testing.assert_allclose(d_s, d_ref, rtol=1e-5, atol=1e-5)


def test_striping_perm_is_permutation():
    perm = _striping_perm(256, 8)
    assert sorted(perm.tolist()) == list(range(256))
    # shard 0's local slots hold logical slots 0, 8, 16, ...
    assert perm[0] == 0 and perm[1] == 8


@pytest.mark.parametrize("n_shards", [2, 8])
@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_sharded_search_equals_single_chip(rng, n_shards, metric):
    """The sharded scan must return exactly the single-chip result — same
    candidates, same distances — for any mesh size."""
    idx, x = _build(rng, metric=metric)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    d_ref, ids_ref = idx.search(q, params)

    mesh = make_mesh(n_shards)
    sharded = ShardedIVFFlatIndex(idx, mesh)
    d, ids = sharded.search(q, params)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ids, ids_ref)


def test_sharded_search_device_matches_host_path(rng):
    """search_device (the no-host-transfer throughput hook, r5) must
    return the same candidates as the full search: its global positions
    mapped through the id table equal search()'s ids, with device input
    (jax.Array) and host input (numpy) both accepted."""
    import jax.numpy as jnp

    idx, x = _build(rng)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    mesh = make_mesh(2)
    sharded = ShardedIVFFlatIndex(idx, mesh)
    d_ref, ids_ref = sharded.search(q, params)

    for q_in in (q, jnp.asarray(q)):
        d_dev, pos_dev = sharded.search_device(q_in, params)
        pos = np.asarray(pos_dev)[: q.shape[0]]
        flat = idx.arena.ids.reshape(-1)
        ids = flat[np.clip(pos, 0, flat.size - 1)]
        ids[pos < 0] = np.uint64(0xFFFFFFFFFFFFFFFF)
        np.testing.assert_array_equal(ids, ids_ref)
        np.testing.assert_allclose(
            np.asarray(d_dev)[: q.shape[0]], d_ref, rtol=1e-5, atol=1e-5
        )


def test_sharded_refresh_after_add(rng):
    idx, x = _build(rng, n=2000)
    mesh = make_mesh(4)
    sharded = ShardedIVFFlatIndex(idx, mesh)
    more = rng.standard_normal((3000, 32)).astype(np.float32)
    idx.add(more)
    sharded.refresh()
    d_ref, ids_ref = idx.search(x[:5], SearchParams(nprobe=16, k=10))
    d, ids = sharded.search(x[:5], SearchParams(nprobe=16, k=10))
    np.testing.assert_array_equal(ids, ids_ref)


def test_sharded_kmeans_matches_single_device(rng):
    mesh = make_mesh(8)
    n, dim, k = 1024, 16, 8
    x = rng.standard_normal((n, dim)).astype(np.float32)
    c0 = x[:k].copy()
    x_sharded = jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P("shard", None))
    )
    c1 = np.asarray(
        sharded_kmeans_lloyd_step(mesh, x_sharded, jnp.asarray(c0), k)
    )
    # single-device oracle
    d = ((x[:, None] - c0[None]) ** 2).sum(-1)
    a = d.argmin(1)
    ref = np.stack([
        x[a == i].mean(0) if (a == i).any() else c0[i] for i in range(k)
    ])
    np.testing.assert_allclose(c1, ref, rtol=1e-4, atol=1e-4)


def test_sharded_arena_is_actually_distributed(rng):
    """Each device must hold only 1/N of the arena bytes."""
    idx, _ = _build(rng, n=4000)
    mesh = make_mesh(8)
    sharded = ShardedIVFFlatIndex(idx, mesh)
    shards = sharded.arena_s.addressable_shards
    assert len(shards) == 8
    total = sharded.arena_s.size
    for s in shards:
        assert s.data.size == total // 8


def test_sharded_int8_arena(rng, interpret_grouped):
    """int8 striped arena: per-list scales replicate; results match the
    single-chip int8 index exactly."""
    import jax.numpy as jnp

    x = rng.standard_normal((4000, 32)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=32, nlist=16, dtype="int8")
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.build_from_device(jnp.asarray(x))
    q = rng.standard_normal((5, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    d_ref, ids_ref = idx.search(q, params)
    for impl in ("gather", "grouped"):
        sharded = ShardedIVFFlatIndex(idx, make_mesh(4), scan_impl=impl)
        d, ids = sharded.search(q, params)
        np.testing.assert_array_equal(ids, ids_ref)
        np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_streaming_int8_base(rng):
    """Streaming tier over an int8 base keeps the codes quantized
    end-to-end (int8 cache + scale/anchor planes) and reproduces the
    resident index exactly — the device-built bulk-pack variant of
    tests/test_io_host.py::test_streaming_int8_base_exact_parity."""
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.io_host import (
        StreamingIVFFlatIndex,
    )

    x = rng.standard_normal((2000, 16)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=16, nlist=8, dtype="int8")
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.build_from_device(jnp.asarray(x))
    streaming = StreamingIVFFlatIndex(idx, cache_slots=8)
    assert streaming.cache.dtype == jnp.int8 and streaming.cache.quantized
    q = rng.standard_normal((3, 16)).astype(np.float32)
    d, ids = streaming.search(q, SearchParams(nprobe=8, k=5))
    d_ref, ids_ref = idx.search(q, SearchParams(nprobe=8, k=5))
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-4, atol=1e-4)


def _build_pq(rng, n=4000, dim=32, nlist=16, m=8, keep_raw=True,
              metric="L2"):
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQConfig,
        IVFPQIndex,
    )

    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFPQConfig(dimension=dim, nlist=nlist, m=m, keep_raw=keep_raw,
                      metric=metric, train_iters=8, pq_train_sample=2048)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    return idx, x


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_pq_adc_equals_single_chip(rng, n_shards):
    """Sharded ADC (rerank off) must match the single-device XLA ADC
    scan — same candidates, same quantized distances."""
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFPQIndex,
    )

    idx, x = _build_pq(rng)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10, use_exact_rerank=False)
    # Single-chip oracle: the same kernel on a 1-device mesh (the XLA
    # scan path orders ADC ties differently; exactness is vs the kernel).
    single = ShardedIVFPQIndex(idx, make_mesh(1))
    d_ref, ids_ref = single.search(q, params)
    sharded = ShardedIVFPQIndex(idx, make_mesh(n_shards))
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    # …and the candidate sets agree with the single-chip XLA ADC scan.
    d_x, ids_x = idx.search(q, params)
    same = np.mean([
        len(set(a.tolist()) & set(b.tolist())) / 10
        for a, b in zip(ids, ids_x)
    ])
    assert same > 0.9  # ADC ties may order differently across impls


def test_sharded_pq_rerank_recall_at_least_single_chip(rng):
    """Per-chip exact rerank merges a SUPERSET of the single-chip rerank
    pool — recall vs exact ground truth must not regress."""
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFPQIndex,
    )

    idx, x = _build_pq(rng)
    q = x[:16] + 0.01 * rng.standard_normal((16, 32)).astype(np.float32)
    params = SearchParams(nprobe=16, k=10, use_exact_rerank=True)
    d_ref, ids_ref = idx.search(q, params)
    sharded = ShardedIVFPQIndex(idx, make_mesh(4))
    d, ids = sharded.search(q, params)
    # exact ground truth
    dd = ((q[:, None] - x[None]) ** 2).sum(-1)
    truth = np.argsort(dd, axis=1)[:, :10]

    def recall(got):
        return np.mean([
            len(set(a.tolist()) & set(b.tolist())) / 10
            for a, b in zip(got.astype(np.int64), truth)
        ])

    assert recall(ids) >= recall(ids_ref) - 1e-9
    assert recall(ids) > 0.9


def test_sharded_pq_codes_actually_distributed(rng):
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFPQIndex,
    )

    idx, _ = _build_pq(rng)
    sharded = ShardedIVFPQIndex(idx, make_mesh(8))
    shards = sharded.codes_t_s.addressable_shards
    assert len(shards) == 8
    for s in shards:
        assert s.data.size == sharded.codes_t_s.size // 8


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_sharded_pallas_scan_equals_single_chip(rng, n_shards,
                                                interpret_grouped):
    """The grouped Pallas kernel must be exact through shard_map slot
    striping (interpret mode on the CPU mesh) — the path that makes
    multi-device serving run at single-device kernel speed."""
    idx, x = _build(rng)
    q = rng.standard_normal((7, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    d_ref, ids_ref = idx.search(q, params)
    sharded = ShardedIVFFlatIndex(idx, make_mesh(n_shards),
                                  scan_impl="grouped")
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_sharded_pallas_int8(rng, metric, interpret_grouped):
    """int8 striped arena through the grouped kernel: per-row dequant
    scales, residual anchors and stored norms must survive slot striping."""
    import jax.numpy as jnp

    impl = "grouped"
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=32, nlist=16, dtype="int8", metric=metric)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    idx.build_from_device(jnp.asarray(x))
    q = rng.standard_normal((5, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    # Striping invariance: the SAME kernel on 4 shards must match 1 shard
    # exactly…
    single = ShardedIVFFlatIndex(idx, make_mesh(1), scan_impl=impl)
    d_ref, ids_ref = single.search(q, params)
    sharded = ShardedIVFFlatIndex(idx, make_mesh(4), scan_impl=impl)
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    # …and the quantized math matches the XLA gather path.
    d_x, ids_x = idx.search(q, params)
    np.testing.assert_array_equal(ids, ids_x)
    np.testing.assert_allclose(d, d_x, rtol=1e-5, atol=1e-5)


def test_sharded_kmeans_fit_quality(rng):
    """Full DP training converges like the single-chip trainer: distortion
    on clustered data within 10% of ops.kmeans.kmeans_fit."""
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_fit,
    )
    from cuda_acceleratedvectordatabaseengine.parallel import (
        sharded_kmeans_fit,
    )

    k, dim, per = 16, 24, 200
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 4
    x = np.repeat(centers, per, 0) + 0.3 * rng.standard_normal(
        (k * per, dim)
    ).astype(np.float32)
    rng.shuffle(x)

    def distortion(c):
        d = ((x[:, None, :] - np.asarray(c)[None]) ** 2).sum(-1)
        return d.min(1).mean()

    c1, _ = kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x), k, iters=15)
    mesh = make_mesh(8)
    xs = jax.device_put(
        jnp.asarray(x), NamedSharding(mesh, P("shard", None))
    )
    c8 = sharded_kmeans_fit(mesh, jax.random.PRNGKey(0), xs, k, iters=15)
    assert distortion(c8) <= distortion(c1) * 1.1
    # replicated output: identical on every device
    shards = [np.asarray(s.data) for s in c8.addressable_shards]
    for s in shards[1:]:
        np.testing.assert_array_equal(s, shards[0])


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_build_on_mesh_matches_single_chip(rng, dtype):
    """Mesh-built index (DP assign + striped pack, shared centroids) must
    return exactly what a single-chip index built from the same centroids
    returns — same ids, same distances (same quantized representation)."""
    idx, x = _build(rng, n=3000, dim=32, nlist=16)
    if dtype == "int8":
        cfg = IVFFlatConfig(dimension=32, nlist=16, dtype="int8")
        idx = IVFFlatIndex(cfg)
        idx.train(x)
        idx.add(x)
    mesh = make_mesh(8)
    sharded = ShardedIVFFlatIndex.build_on_mesh(
        mesh, idx.config, x, centroids=idx.centroids, chunk_rows=1000,
    )
    q = rng.standard_normal((6, 32)).astype(np.float32)
    p = SearchParams(nprobe=8, k=10)
    d_ref, i_ref = idx.search(q, p)
    d, ids = sharded.search(q, p)
    np.testing.assert_array_equal(ids, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=2e-4, atol=2e-4)


def test_build_on_mesh_full_train_pack_search(rng):
    """End-to-end on the mesh with NO single-chip artifacts: DP k-means →
    striped pack → SPMD search. Every vector must find itself."""
    x = rng.standard_normal((2000, 24)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=24, nlist=8, dtype="int8",
                        train_sample_per_list=64)
    mesh = make_mesh(8)
    sharded = ShardedIVFFlatIndex.build_on_mesh(
        mesh, cfg, x, key=jax.random.PRNGKey(3), chunk_rows=512,
    )
    d, ids = sharded.search(x[:16], SearchParams(nprobe=8, k=5))
    assert (ids[:, 0] == np.arange(16)).all()
    assert (d[:, 0] < 1e-2).all()
    # the arenas really live distributed across the 8 devices
    assert len(sharded.arena_s.sharding.device_set) == 8


def test_sharded_pq_opq_equals_single_chip(rng):
    """OPQ-rotated PQ over the mesh: queries rotate into the published
    frame; mesh-N results dominate mesh-1 (per-chip rerank-pool union)."""
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQConfig,
        IVFPQIndex,
    )
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFPQIndex,
    )

    x = rng.standard_normal((3000, 32)).astype(np.float32)
    cfg = IVFPQConfig(dimension=32, nlist=8, m=8, pq_train_sample=2048,
                      opq=True, opq_iters=2)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    assert idx.opq_R is not None
    q = rng.standard_normal((5, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=5, use_exact_rerank=True)
    # mesh-1 vs mesh-N (same code path — the convention of the other
    # sharded-PQ tests: ADC near-ties make the rerank candidate cutoff
    # scan-path-sensitive, so base-vs-sharded is not bit-identical).
    single = ShardedIVFPQIndex(idx, make_mesh(1))
    d_ref, ids_ref = single.search(q, params)
    sharded = ShardedIVFPQIndex(idx, make_mesh(4))
    d, ids = sharded.search(q, params)
    # The sharded rerank pool is the UNION of per-chip top-rerank_k ADC
    # shortlists — a documented superset of the single-chip pool
    # (parallel/sharded.py::_sharded_pq_search), so the top-k ids are NOT
    # bit-stable across mesh sizes at the shortlist cutoff. Assert the
    # semantic contract instead: the head matches, mesh-4's sorted
    # distances dominate mesh-1's elementwise (superset ⇒ at least as
    # good), overlap is high, and any shared id carries the same
    # exact-rerank distance on both meshes.
    np.testing.assert_array_equal(ids[:, 0], ids_ref[:, 0])
    assert np.all(d <= d_ref + 1e-3)
    k = params.k
    overlap = np.mean(
        [len(set(a.tolist()) & set(b.tolist())) / k
         for a, b in zip(ids, ids_ref)]
    )
    assert overlap >= 0.6
    for qi in range(len(q)):
        m4 = {int(i): float(v) for i, v in zip(ids[qi], d[qi])}
        for i, v in zip(ids_ref[qi], d_ref[qi]):
            if int(i) in m4:
                np.testing.assert_allclose(
                    m4[int(i)], float(v), rtol=1e-3, atol=0.01
                )
    # and the rotated-frame search still solves the true-space problem
    dd, ii = sharded.search(
        (x[:4] + 0.01 * rng.standard_normal((4, 32))).astype(np.float32),
        params,
    )
    assert (ii[:, 0] == np.arange(4, dtype=np.uint64)).all()
