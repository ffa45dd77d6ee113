"""Host-store exact rerank (io_host/host_rerank) — the capacity tier's
second stage: device-resident PQ codes answer "which k", the int8 host
store answers "how far, exactly". Composes the reference's declared
``rerank_k`` surface (``engine/ivf_flat_index.h:153-157``) with its
declared host tier (``format/storage.h:124-173``)."""

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.io_host.host_rerank import (
    HostReranker,
)
from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
    HostListStore,
)
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.ops.distance import Metric


def _recall(found_ids, true_ids):
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_ids.size


def _int8_store(x, ids, nlist, rng):
    """Random assignment int8 store (anchors = per-list means)."""
    assigns = rng.integers(0, nlist, x.shape[0]).astype(np.int64)
    anchors = np.zeros((nlist, x.shape[1]), np.float32)
    for l in range(nlist):
        rows = x[assigns == l]
        if rows.size:
            anchors[l] = rows.mean(0)
    store = HostListStore.from_assignments(
        x, ids, assigns, nlist, dtype="int8", anchors=anchors
    )
    return store, assigns, anchors


def test_reranker_distances_exact(rng):
    """Reranked L2 distances must equal the direct dequantized computation."""
    n, dim, nlist = 500, 16, 8
    x = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    store, assigns, anchors = _int8_store(x, ids, nlist, rng)
    rr = HostReranker(store)

    q = rng.standard_normal((7, dim)).astype(np.float32)
    cand = rng.integers(0, n, (7, 12)).astype(np.uint64)
    cand[0, 3] = INVALID_ID  # padding must not crash or win
    d, out = rr.rerank(q, cand, Metric.L2, k=5)

    # Direct recomputation from the dequantized store.
    flat_deq = np.zeros((n, dim), np.float32)
    for l in range(nlist):
        for code, sc, i in zip(store.vectors[l], store.scale[l],
                               store.ids[l]):
            flat_deq[int(i)] = anchors[l] + code.astype(np.float32) * sc
    for b in range(7):
        cands = [c for c in cand[b] if c != INVALID_ID]
        ref_d = np.array([
            ((q[b] - flat_deq[int(c)]) ** 2).sum() for c in cands
        ], np.float32)
        order = np.argsort(ref_d, kind="stable")[:5]
        ref_ids = np.asarray(cands, np.uint64)[order]
        np.testing.assert_allclose(
            np.sort(d[b]), np.sort(ref_d[order]), rtol=1e-4, atol=1e-4
        )
        # ids match as sets (ties may reorder)
        assert set(out[b].tolist()) == set(ref_ids.tolist())


def test_reranker_nondense_ids(rng):
    """Arbitrary uint64 ids exercise the sorted-lookup path."""
    n, dim, nlist = 300, 8, 4
    x = rng.standard_normal((n, dim)).astype(np.float32)
    ids = (np.arange(n, dtype=np.uint64) * 977 + 12345) * 2**20
    store, _, _ = _int8_store(x, ids, nlist, rng)
    rr = HostReranker(store)
    assert rr._inv is None and rr._sorted_ids is not None

    q = x[:4] + 0.01 * rng.standard_normal((4, dim)).astype(np.float32)
    cand = np.stack([ids[:10]] * 4).astype(np.uint64)
    cand[1, 5] = np.uint64(42)  # unknown id → ignored
    d, out = rr.rerank(q, cand, Metric.L2, k=3)
    assert (d < 1e38).all()
    for b in range(4):
        assert set(out[b].tolist()) <= set(ids.tolist())
    # query b is a perturbation of row b → its own id must win
    assert out[0, 0] == ids[0]


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_ivf_pq_host_rerank_recall(rng, oracle, metric):
    """keep_raw=False + attached host store: rerank recovers the recall a
    resident raw arena would give, with no raw vectors on device."""
    n, dim, nlist, m = 4000, 32, 16, 8
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFPQConfig(dimension=dim, nlist=nlist, m=m, metric=metric,
                      keep_raw=False, pq_train_sample=2048)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    assert idx.raw is None

    # The store mirrors the index's list structure (same centroids/assigns).
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_assign,
    )
    import jax.numpy as jnp

    assign_metric = (
        Metric.INNER_PRODUCT if metric == "InnerProduct" else Metric.L2
    )
    assigns = np.asarray(kmeans_assign(
        jnp.asarray(x), idx.centroids, assign_metric
    ))
    store = HostListStore.from_assignments(
        x, np.arange(n, dtype=np.uint64), assigns, nlist,
        dtype="int8", anchors=np.asarray(idx.centroids),
    )

    q = rng.standard_normal((16, dim)).astype(np.float32)
    params = SearchParams(nprobe=16, k=10)
    _, ids_adc = idx.search(q, params)

    idx.attach_host_rerank(store, rerank_k=64)
    d_rr, ids_rr = idx.search(
        q, SearchParams(nprobe=16, k=10, use_exact_rerank=True)
    )
    _, ref = oracle(q, x, 10, metric)
    r_adc = _recall(ids_adc, ref.astype(np.uint64))
    r_rr = _recall(ids_rr, ref.astype(np.uint64))
    assert r_rr >= r_adc
    assert r_rr > 0.9  # int8 quantization noise only
    assert d_rr.shape == (16, 10)
    # distances ascend per row
    valid = ids_rr != INVALID_ID
    for b in range(16):
        dv = d_rr[b][valid[b]]
        assert (np.diff(dv) >= -1e-5).all()


def test_pipelined_batches_match_sequential(rng):
    """search_batches_pipelined (device scan of batch i+1 overlapping host
    rerank of batch i) must yield exactly what sequential search returns."""
    n, dim, nlist, m = 3000, 16, 8, 4
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFPQConfig(dimension=dim, nlist=nlist, m=m, keep_raw=False,
                      pq_train_sample=1024)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    store, _, _ = _int8_store(x, np.arange(n, dtype=np.uint64), nlist, rng)
    # store lists need not mirror index lists for rerank-by-id correctness
    idx.attach_host_rerank(store, rerank_k=32)

    params = SearchParams(nprobe=8, k=5, use_exact_rerank=True)
    batches = [rng.standard_normal((6, dim)).astype(np.float32)
               for _ in range(4)]
    seq = [idx.search(q, params) for q in batches]
    pipe = list(idx.search_batches_pipelined(batches, params))
    assert len(pipe) == len(seq)
    for (d1, i1), (d2, i2) in zip(seq, pipe):
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(d1, d2, rtol=1e-6)


@pytest.mark.parametrize(
    "metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
)
@pytest.mark.parametrize("store_dtype", ["int8", "float32"])
def test_native_rerank_matches_numpy(rng, metric, store_dtype):
    """The fused C++ rerank (native.vdb_rerank) must match the NumPy path
    on every metric and store dtype — including INVALID_ID padding,
    unknown ids, and shortlists shorter than k."""
    from cuda_acceleratedvectordatabaseengine import native

    if not native.available():
        pytest.skip("native host runtime unavailable")
    n, dim, nlist = 400, 24, 8
    x = rng.standard_normal((n, dim)).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    if store_dtype == "int8":
        store, _, _ = _int8_store(x, ids, nlist, rng)
    else:
        assigns = rng.integers(0, nlist, n).astype(np.int64)
        store = HostListStore.from_assignments(
            x, ids, assigns, nlist, dtype="float32"
        )
    rr_nat = HostReranker(store)
    rr_np = HostReranker(store, use_native=False)
    assert rr_nat.use_native and not rr_np.use_native

    q = rng.standard_normal((9, dim)).astype(np.float32)
    cand = rng.integers(0, n, (9, 17)).astype(np.uint64)
    cand[0, 2] = INVALID_ID           # padding
    cand[1, :] = INVALID_ID           # fully padded row
    cand[2, 5] = np.uint64(10**9)     # unknown id
    for k in (5, 17, 20):             # k < r, k == r, k > r
        d_nat, i_nat = rr_nat.rerank(q, cand, metric, k)
        d_np, i_np = rr_np.rerank(q, cand, metric, k)
        np.testing.assert_allclose(d_nat, d_np, rtol=1e-4, atol=1e-4)
        for b in range(9):
            # ids match as sets (near-tie distances may swap order
            # between BLAS and AVX2 accumulation)
            assert set(i_nat[b].tolist()) == set(i_np[b].tolist()), (
                metric, store_dtype, k, b
            )


def test_attach_rejects_resident_raw(rng):
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    cfg = IVFPQConfig(dimension=16, nlist=8, m=4, pq_train_sample=1024)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    store = HostListStore(8, 16)
    with pytest.raises(ValueError, match="keep_raw"):
        idx.attach_host_rerank(store)


def test_adaptive_margin_rerank(rng, oracle):
    """host_rerank_margin: a huge margin reproduces the fixed-depth
    results exactly (nothing pruned); a moderate margin prunes candidates
    (cheaper host stage) while keeping recall near the fixed-depth level."""
    n, dim, nlist, m = 4000, 32, 16, 8
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFPQConfig(dimension=dim, nlist=nlist, m=m, keep_raw=False,
                      pq_train_sample=2048)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
        kmeans_assign,
    )
    import jax.numpy as jnp

    assigns = np.asarray(kmeans_assign(jnp.asarray(x), idx.centroids))
    store = HostListStore.from_assignments(
        x, np.arange(n, dtype=np.uint64), assigns, nlist,
        dtype="int8", anchors=np.asarray(idx.centroids),
    )
    q = rng.standard_normal((16, dim)).astype(np.float32)
    p = SearchParams(nprobe=16, k=10, use_exact_rerank=True)

    idx.attach_host_rerank(store, rerank_k=64)
    d_fix, ids_fix = idx.search(q, p)

    idx.attach_host_rerank(store, rerank_k=64, margin=1e6)
    d_inf, ids_inf = idx.search(q, p)
    np.testing.assert_array_equal(ids_fix, ids_inf)
    np.testing.assert_allclose(d_fix, d_inf, rtol=1e-6)

    idx.attach_host_rerank(store, rerank_k=64, margin=0.5)
    d_ad, ids_ad = idx.search(q, p)
    _, ref = oracle(q, x, 10)
    r_fix = _recall(ids_fix, ref.astype(np.uint64))
    r_ad = _recall(ids_ad, ref.astype(np.uint64))
    assert r_ad >= r_fix - 0.05, (r_fix, r_ad)
    # rows ascend and carry no INVALID gaps before valid entries
    for b in range(16):
        valid = ids_ad[b] != INVALID_ID
        dv = d_ad[b][valid]
        assert (np.diff(dv) >= -1e-5).all()
