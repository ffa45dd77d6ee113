"""Unit tests for the core ops layer against NumPy oracles.

Replaces (and strengthens) the reference's GPU-vs-CPU differential test
(``test/gpu_vs_cpu_test.cpp``) — which only checked finiteness/ranges — with
exactness checks per op.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine.ops import (
    Metric,
    kmeans_assign,
    kmeans_fit,
    l2_normalize,
    merge_topk,
    pairwise_distance,
    scan_probed_lists,
    topk_smallest,
)
from cuda_acceleratedvectordatabaseengine.ops.scan import scan_flat


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_pairwise_distance_matches_numpy(rng, oracle, metric):
    q = rng.standard_normal((8, 32)).astype(np.float32)
    x = rng.standard_normal((100, 32)).astype(np.float32)
    d = np.asarray(
        pairwise_distance(jnp.asarray(q), jnp.asarray(x), Metric.parse(metric))
    )
    d_ref, _ = oracle(q, x, 100, metric)
    d_ref_sorted = np.sort(d_ref, axis=1)
    np.testing.assert_allclose(np.sort(d, axis=1), d_ref_sorted, rtol=1e-4,
                               atol=1e-4)


def test_metric_parse():
    assert Metric.parse("l2") == Metric.L2
    assert Metric.parse("InnerProduct") == Metric.INNER_PRODUCT
    assert Metric.parse("cosine") == Metric.COSINE
    with pytest.raises(ValueError):
        Metric.parse("hamming")


def test_l2_normalize(rng):
    x = rng.standard_normal((10, 64)).astype(np.float32)
    y = np.asarray(l2_normalize(jnp.asarray(x)))
    np.testing.assert_allclose(np.linalg.norm(y, axis=1), 1.0, atol=1e-5)


def test_topk_smallest(rng):
    d = rng.standard_normal((4, 50)).astype(np.float32)
    vals, idx = topk_smallest(jnp.asarray(d), 5)
    vals, idx = np.asarray(vals), np.asarray(idx)
    ref_idx = np.argsort(d, axis=1)[:, :5]
    np.testing.assert_allclose(vals, np.take_along_axis(d, ref_idx, 1),
                               rtol=1e-6)
    assert np.array_equal(np.sort(idx), np.sort(ref_idx))


def test_topk_tournament_matches_sort(rng):
    # Forced tournament path (the auto gate needs production-scale shapes);
    # N=1024 exercises the 4-lane fold + loser promotion. Values must match
    # the sort path exactly and the index SET must be the true top-k (tie
    # order may legally differ).
    d = rng.standard_normal((8, 1024)).astype(np.float32)
    d[0, 5] = d[0, 17]  # a deliberate tie
    for k in (1, 3, 10):
        vt, it = topk_smallest(jnp.asarray(d), k, impl="tournament")
        vs, _ = topk_smallest(jnp.asarray(d), k, impl="sort")
        np.testing.assert_allclose(np.asarray(vt), np.asarray(vs), rtol=0)
        got = np.take_along_axis(d, np.asarray(it), 1)
        np.testing.assert_allclose(got, np.asarray(vs), rtol=0)
        assert np.asarray(it).min() >= 0
        # indices unique per row
        for row in np.asarray(it):
            assert len(set(row.tolist())) == k


def test_topk_tournament_with_idx_gather(rng):
    d = rng.standard_normal((4, 2048)).astype(np.float32)
    ids = rng.permutation(2048).astype(np.int64)[None].repeat(4, 0)
    vt, it = topk_smallest(jnp.asarray(d), 8, idx=jnp.asarray(ids),
                           impl="tournament")
    ref_cols = np.argsort(d, axis=1)[:, :8]
    assert np.array_equal(np.sort(np.asarray(it)),
                          np.sort(np.take_along_axis(ids, ref_cols, 1)))


def test_merge_topk_is_global_topk(rng):
    d = rng.standard_normal((3, 40)).astype(np.float32)
    ids = np.arange(40, dtype=np.int32)[None].repeat(3, 0)
    va, ia = topk_smallest(jnp.asarray(d[:, :20]), 4,
                           idx=jnp.asarray(ids[:, :20]))
    vb, ib = topk_smallest(jnp.asarray(d[:, 20:]), 4,
                           idx=jnp.asarray(ids[:, 20:]))
    vm, im = merge_topk(va, ia, vb, ib, 4)
    ref_idx = np.argsort(d, axis=1)[:, :4]
    assert np.array_equal(np.sort(np.asarray(im)), np.sort(ref_idx))


def test_kmeans_assign_matches_numpy(rng):
    x = rng.standard_normal((500, 16)).astype(np.float32)
    c = rng.standard_normal((8, 16)).astype(np.float32)
    a = np.asarray(kmeans_assign(jnp.asarray(x), jnp.asarray(c)))
    d = ((x[:, None] - c[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(a, d.argmin(1))


def test_kmeans_assign_chunked_equals_unchunked(rng):
    x = rng.standard_normal((1000, 8)).astype(np.float32)
    c = rng.standard_normal((16, 8)).astype(np.float32)
    a1 = np.asarray(kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                  chunk_size=128))
    a2 = np.asarray(kmeans_assign(jnp.asarray(x), jnp.asarray(c),
                                  chunk_size=10 ** 6))
    np.testing.assert_array_equal(a1, a2)


def test_kmeans_fit_reduces_inertia(rng):
    import jax

    # 4 well-separated blobs.
    centers = rng.standard_normal((4, 8)).astype(np.float32) * 10
    x = np.concatenate(
        [c + 0.1 * rng.standard_normal((50, 8)).astype(np.float32)
         for c in centers]
    )
    key = jax.random.PRNGKey(0)
    centroids, assigns = kmeans_fit(key, jnp.asarray(x), 4, iters=10)
    centroids, assigns = np.asarray(centroids), np.asarray(assigns)
    # Every blob maps to a single cluster and centroids sit near blob means.
    for i in range(4):
        blob_assign = assigns[i * 50:(i + 1) * 50]
        assert len(np.unique(blob_assign)) == 1
    inertia = ((x - centroids[assigns]) ** 2).sum()
    assert inertia / len(x) < 0.2 * 8  # ≪ blob spread


def test_kmeans_fit_tiny_trainset(rng):
    # Regression (round-2 advisor): when n < 32, the per-chunk reseed
    # top_k asked for more candidates than the chunk had rows.
    import jax

    x = rng.standard_normal((7, 8)).astype(np.float32)
    centroids, assigns = kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(x),
                                    3, iters=4)
    assert centroids.shape == (3, 8)
    assert np.asarray(assigns).shape == (7,)
    assert np.all(np.asarray(assigns) >= 0)
    assert np.all(np.asarray(assigns) < 3)


def test_scan_flat_exact(rng, oracle):
    x = rng.standard_normal((300, 16)).astype(np.float32)
    q = rng.standard_normal((4, 16)).astype(np.float32)
    n_pad = 512
    xp = np.zeros((n_pad, 16), np.float32)
    xp[:300] = x
    d, pos = scan_flat(
        jnp.asarray(q), jnp.asarray(xp),
        jnp.asarray((xp ** 2).sum(1)), jnp.int32(300),
        k=10, metric=Metric.L2, chunk_size=128,
    )
    _, ref_idx = oracle(q, x, 10)
    assert np.array_equal(np.sort(np.asarray(pos)), np.sort(ref_idx))


def test_scan_probed_lists_exact_when_probing_all(rng, oracle):
    """Probing every list must equal exact brute force."""
    nlist, cap, dim, k = 4, 32, 8, 5
    counts = np.array([32, 17, 0, 25], np.int32)
    arena = np.zeros((nlist, cap, dim), np.float32)
    rows, row_pos = [], []
    for l in range(nlist):
        v = rng.standard_normal((counts[l], dim)).astype(np.float32)
        arena[l, :counts[l]] = v
        rows.append(v)
        row_pos.extend(l * cap + np.arange(counts[l]))
    data = np.concatenate(rows)
    row_pos = np.array(row_pos)

    q = rng.standard_normal((3, dim)).astype(np.float32)
    probe_ids = np.tile(np.arange(nlist, dtype=np.int32), (3, 1))
    d, pos = scan_probed_lists(
        jnp.asarray(q), jnp.asarray(arena),
        jnp.asarray((arena ** 2).sum(-1)), jnp.asarray(counts),
        jnp.asarray(probe_ids), k, Metric.L2,
    )
    d_ref, idx_ref = oracle(q, data, k)
    np.testing.assert_allclose(np.sort(np.asarray(d)), np.sort(d_ref),
                               rtol=1e-4, atol=1e-4)
    assert np.array_equal(np.sort(np.asarray(pos)), np.sort(row_pos[idx_ref]))


def test_scan_probed_lists_handles_invalid_probe(rng):
    nlist, cap, dim = 2, 8, 4
    arena = rng.standard_normal((nlist, cap, dim)).astype(np.float32)
    counts = np.array([8, 8], np.int32)
    q = rng.standard_normal((1, dim)).astype(np.float32)
    probe_ids = np.array([[0, -1]], np.int32)
    d, pos = scan_probed_lists(
        jnp.asarray(q), jnp.asarray(arena),
        jnp.asarray((arena ** 2).sum(-1)), jnp.asarray(counts),
        jnp.asarray(probe_ids), 8, Metric.L2,
    )
    pos = np.asarray(pos)
    # Only list 0 contributes.
    assert set(pos[pos >= 0] // cap) == {0}


def test_utils_logging_and_profiling(capsys):
    from cuda_acceleratedvectordatabaseengine.utils.logging import (
        get_logger,
    )
    from cuda_acceleratedvectordatabaseengine.utils.profiling import (
        Timer,
        timed,
    )
    import jax.numpy as jnp

    log = get_logger("vdb.test")
    log.info("hello")
    t = Timer()
    with t.span():
        pass
    assert t.count == 1
    out, ms = timed(lambda v: v + 1, jnp.zeros((4,)))
    assert ms >= 0 and float(out[0]) == 1.0
