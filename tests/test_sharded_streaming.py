"""Mesh-sharded streaming tier (>HBM) on the virtual 8-device CPU mesh:
the slot-striped cache must reproduce the single-chip streaming tier (and
the resident index) exactly, while actually distributing cache bytes."""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.io_host import (
    StreamingIVFFlatIndex,
)
from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
    HostListStore,
)
from cuda_acceleratedvectordatabaseengine.parallel import (
    ShardedStreamingIVFFlatIndex,
    make_mesh,
)


def _build(rng, n=3000, dim=32, nlist=16, dtype="float32"):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, dtype=dtype)
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    if dtype == "int8":
        idx.build_from_device(jnp.asarray(x))
    else:
        idx.add(x)
    return idx, x


@pytest.mark.parametrize("n_shards", [2, 8])
def test_sharded_streaming_equals_single_chip(rng, n_shards):
    idx, x = _build(rng)
    q = rng.standard_normal((9, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    single = StreamingIVFFlatIndex(idx, cache_slots=16)
    d_ref, ids_ref = single.search(q, params)
    sharded = ShardedStreamingIVFFlatIndex.from_base(
        idx, make_mesh(n_shards), cache_slots=16
    )
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_sharded_streaming_int8_quantized_cache(rng):
    """int8 store → int8 striped cache (codes + scale/anchor planes);
    results match the RESIDENT int8 index exactly (same stored
    representation end-to-end)."""
    idx, x = _build(rng, dtype="int8")
    q = rng.standard_normal((5, 32)).astype(np.float32)
    params = SearchParams(nprobe=8, k=10)
    d_ref, ids_ref = idx.search(q, params)
    sharded = ShardedStreamingIVFFlatIndex.from_base(
        idx, make_mesh(4), cache_slots=16
    )
    assert sharded.cache.quantized and sharded.cache.dtype == jnp.int8
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_streaming_pallas_parity(rng, n_shards, interpret_grouped):
    """The striped grouped Pallas kernel (interpret mode on the CPU) must
    agree with the gather scan on the mesh tier."""
    impl = "grouped"
    idx, x = _build(rng, n=2000, nlist=8)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    params = SearchParams(nprobe=4, k=5)
    mesh = make_mesh(n_shards)
    ref = ShardedStreamingIVFFlatIndex.from_base(
        idx, mesh, cache_slots=8, scan_impl="gather"
    )
    d_ref, ids_ref = ref.search(q, params)
    pal = ShardedStreamingIVFFlatIndex.from_base(
        idx, mesh, cache_slots=8, scan_impl=impl
    )
    d, ids = pal.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)


def test_sharded_streaming_cache_actually_distributed(rng):
    """Each device holds exactly 1/N of the cache arena bytes — the
    aggregate-HBM scaling property the tier exists for."""
    idx, _ = _build(rng)
    sharded = ShardedStreamingIVFFlatIndex.from_base(
        idx, make_mesh(8), cache_slots=8
    )
    arena = sharded.cache.cache_arena
    shards = arena.addressable_shards
    assert len(shards) == 8
    for s in shards:
        assert s.data.size == arena.size // 8
    assert sharded.cache.capacity % (16 * 8) == 0


def test_sharded_streaming_waves_and_eviction(rng):
    """A cache smaller than the probe working set forces multi-wave scans
    with evictions between waves; results stay exact."""
    idx, x = _build(rng, nlist=16)
    q = rng.standard_normal((6, 32)).astype(np.float32)
    params = SearchParams(nprobe=16, k=10)  # probe ALL lists
    d_ref, ids_ref = idx.search(q, params)
    sharded = ShardedStreamingIVFFlatIndex.from_base(
        idx, make_mesh(4), cache_slots=8
    )
    d, ids = sharded.search(q, params)
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
    assert sharded.cache.misses > 8  # evictions actually happened


def test_sharded_streaming_from_store_capacity_padding(rng):
    """from_store with a ragged host store: capacity pads up to a stripe
    multiple and padded slots never contaminate results."""
    dim, nlist = 16, 8
    x = rng.standard_normal((500, dim)).astype(np.float32)
    ids = np.arange(500, dtype=np.uint64)
    cfg = IVFFlatConfig(dimension=dim, nlist=nlist, dtype="float32")
    idx = IVFFlatIndex(cfg)
    idx.train(x)
    assigns = np.asarray(
        __import__(
            "cuda_acceleratedvectordatabaseengine.ops.kmeans",
            fromlist=["kmeans_assign"],
        ).kmeans_assign(jnp.asarray(x), idx.centroids, idx.metric)
    )
    store = HostListStore.from_assignments(x, ids, assigns, nlist)
    sharded = ShardedStreamingIVFFlatIndex(
        make_mesh(8), store, idx.centroids, cfg, cache_slots=nlist
    )
    single = StreamingIVFFlatIndex.from_store(
        store, idx.centroids, cfg, cache_slots=nlist
    )
    q = x[:5] + 0.01 * rng.standard_normal((5, dim)).astype(np.float32)
    params = SearchParams(nprobe=nlist, k=5)
    d_ref, ids_ref = single.search(q, params)
    d, ids_out = sharded.search(q, params)
    np.testing.assert_array_equal(ids_out, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-5, atol=1e-5)
