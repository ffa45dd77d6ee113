"""IVFPQIndex tests — the capability the reference declared but never built
(``engine/ivf_flat_index.h:107-189``): residual PQ encode, ADC search,
exact rerank, and recall vs the oracle."""

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFPQConfig,
    IVFPQIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID


def _recall(found_ids, true_ids):
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / true_ids.size


def _build(rng, n=4000, dim=32, nlist=16, m=8, metric="L2", **kw):
    x = rng.standard_normal((n, dim)).astype(np.float32)
    cfg = IVFPQConfig(dimension=dim, nlist=nlist, m=m, metric=metric,
                      pq_train_sample=2048, **kw)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    return idx, x


def test_pq_ops_roundtrip(rng):
    """Codes must reconstruct vectors well enough that ADC ≈ true distance."""
    import jax
    import jax.numpy as jnp
    from cuda_acceleratedvectordatabaseengine.ops.pq import (
        pq_adc_lookup,
        pq_distance_tables,
        pq_encode,
        train_product_quantizer,
    )

    x = rng.standard_normal((2000, 16)).astype(np.float32)
    cb = train_product_quantizer(jax.random.PRNGKey(0), jnp.asarray(x), m=4)
    codes = pq_encode(jnp.asarray(x[:100]), cb)
    assert codes.shape == (100, 4) and codes.dtype == jnp.uint8

    q = rng.standard_normal((5, 16)).astype(np.float32)
    tables = pq_distance_tables(jnp.asarray(q), cb)
    assert tables.shape == (5, 4, 256)
    # lookup takes subspace-major codes: [B, m, L]
    codes_t = jnp.asarray(codes).T[None].repeat(5, 0)
    adc = np.asarray(pq_adc_lookup(tables, codes_t))
    true = ((q[:, None] - x[None, :100]) ** 2).sum(-1)
    # ADC error bounded by quantization error; correlation must be strong.
    corr = np.corrcoef(adc.ravel(), true.ravel())[0, 1]
    assert corr > 0.9


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_ivf_pq_recall(rng, oracle, metric):
    idx, x = _build(rng, metric=metric)
    q = rng.standard_normal((10, 32)).astype(np.float32)
    _, ids = idx.search(q, SearchParams(nprobe=16, k=10))
    _, ref = oracle(q, x, 10, metric)
    assert _recall(ids, ref.astype(np.uint64)) > 0.4  # ADC-only, m=8 on d=32
    # (unclustered gaussian is PQ's worst case; the rerank test below is the
    # real recall gate)


@pytest.mark.parametrize("metric", ["L2", "InnerProduct", "Cosine"])
def test_ivf_pq_rerank_boosts_recall(rng, oracle, metric):
    idx, x = _build(rng, metric=metric)
    q = rng.standard_normal((10, 32)).astype(np.float32)
    _, ids_adc = idx.search(q, SearchParams(nprobe=16, k=10))
    _, ids_rr = idx.search(
        q, SearchParams(nprobe=16, k=10, use_exact_rerank=True)
    )
    _, ref = oracle(q, x, 10, metric)
    r_adc = _recall(ids_adc, ref.astype(np.uint64))
    r_rr = _recall(ids_rr, ref.astype(np.uint64))
    assert r_rr >= r_adc
    assert r_rr > 0.85


def test_ivf_pq_rerank_distances_exact(rng, oracle):
    idx, x = _build(rng)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=16, k=5, use_exact_rerank=True))
    # Reranked distances are true distances of the returned ids.
    for b in range(4):
        for j in range(5):
            true = ((q[b] - x[int(ids[b, j])]) ** 2).sum()
            np.testing.assert_allclose(d[b, j], true, rtol=5e-2, atol=1e-2)


@pytest.mark.parametrize("keep_raw", [True, False])
def test_ivf_pq_remove_ids(rng, keep_raw):
    idx, x = _build(rng, n=2000, nlist=8, keep_raw=keep_raw)
    victims = np.asarray([0, 3, 700, 1999], np.uint64)
    n_before = idx.ntotal
    assert idx.remove_ids(victims) == len(victims)
    assert idx.ntotal == n_before - len(victims)
    params = SearchParams(nprobe=8, k=10, use_exact_rerank=keep_raw)
    d, ids = idx.search(x[victims.astype(np.int64)], params)
    assert not np.isin(ids, victims).any()
    # Survivors still retrievable; codes and raw slots stayed aligned
    # (rerank reads raw rows at the positions the ADC shortlist emits).
    keep = np.asarray([5, 900], np.uint64)
    d2, ids2 = idx.search(x[keep.astype(np.int64)], params)
    assert np.isin(keep, ids2).all()
    assert idx.remove_ids(victims) == 0


def test_ivf_pq_no_raw_mode(rng, oracle):
    """keep_raw=False: 1 byte per subdim on device, rerank unavailable."""
    idx, x = _build(rng, keep_raw=False)
    assert idx.raw is None
    q = rng.standard_normal((5, 32)).astype(np.float32)
    _, ids = idx.search(q, SearchParams(nprobe=16, k=10))
    _, ref = oracle(q, x, 10)
    assert _recall(ids, ref.astype(np.uint64)) > 0.5
    stats = idx.memory_stats()
    assert stats["raw_bytes"] == 0


def test_ivf_pq_growth(rng):
    idx, x = _build(rng, n=1000, nlist=4)
    cap0 = idx.capacity
    for _ in range(3):
        idx.add(rng.standard_normal((1000, 32)).astype(np.float32))
    assert idx.ntotal == 4000
    assert idx.capacity > cap0
    assert idx.code_arena.shape[1] == idx.raw.capacity
    _, ids = idx.search(x[:2], SearchParams(nprobe=4, k=3))
    assert (ids != INVALID_ID).all()


def test_ivf_pq_config_validation():
    with pytest.raises(ValueError):
        IVFPQConfig(dimension=30, m=8)
    with pytest.raises(ValueError):
        IVFPQConfig(dimension=32, m=8, nbits=4)


def test_ivf_pq_int8_raw_rerank(rng, oracle):
    """int8 raw arenas must be dequantized in the exact rerank (regression:
    the rerank once cast the fp32 query down to int8 and treated codes as
    values) and in persisted snapshots."""
    idx, x = _build(rng, raw_dtype="int8")
    q = rng.standard_normal((4, 32)).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=16, k=5, use_exact_rerank=True))
    for b in range(4):
        for j in range(5):
            true = ((q[b] - x[int(ids[b, j])]) ** 2).sum()
            np.testing.assert_allclose(d[b, j], true, rtol=5e-2, atol=5e-2)
    # state_arrays persists dequantized values, not raw int8 codes
    arena = idx.state_arrays()["arena"]
    counts = np.asarray(idx.counts)
    l = int(np.argmax(counts))
    uid = int(idx.ids[l, 0])
    np.testing.assert_allclose(arena[l, 0], x[uid], rtol=0.1, atol=0.05)


def _pq_index(rng, metric="L2", n=4000, dim=32, nlist=8, m=4):
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQConfig,
        IVFPQIndex,
    )

    x = rng.standard_normal((n, dim)).astype(np.float32)
    idx = IVFPQIndex(IVFPQConfig(dimension=dim, nlist=nlist, m=m,
                                 metric=metric))
    idx.train(x)
    idx.add(x)
    return idx


def _decoded_points(idx):
    """[nlist, cap, D] fp32 decoded stored points c_l + r̂ (numpy)."""
    cb = np.asarray(idx.codebooks)                 # [m, ks, dsub]
    codes = np.asarray(idx.code_arena).astype(np.int64)   # [nlist, cap, m]
    r = cb[np.arange(cb.shape[0]), codes]          # [nlist, cap, m, dsub]
    r = r.reshape(codes.shape[0], codes.shape[1], -1)
    return r + np.asarray(idx.centroids)[:, None, :]


@pytest.mark.parametrize("metric", ["L2", "InnerProduct"])
def test_pq_adc_scan_matches_decoded_reference(rng, metric):
    """The XLA ADC scan (per-probe distance tables + gather lookup) returns
    exactly the distances to the decoded stored points, and the exact
    top-k of them over the probe union."""
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.pq import scan_probed_codes

    idx = _pq_index(rng, metric)
    nlist, k = 8, 8
    q = rng.standard_normal((6, 32)).astype(np.float32)
    probe = np.stack([rng.choice(nlist, 3, replace=False)
                      for _ in range(6)]).astype(np.int32)
    d, pos = scan_probed_codes(
        jnp.asarray(q), idx.code_arena_t, idx.counts, idx.centroids,
        idx.codebooks, jnp.asarray(probe), k,
        inner_product=metric == "InnerProduct",
    )
    d, pos = np.asarray(d), np.asarray(pos)
    dec = _decoded_points(idx)
    counts = np.asarray(idx.counts)
    cap = idx.capacity
    for b in range(6):
        cand_d, cand_p = [], []
        for l in probe[b]:
            pts = dec[l, :counts[l]].astype(np.float64)
            if metric == "InnerProduct":
                cand_d.append(-(pts @ q[b]))
            else:
                cand_d.append(((pts - q[b]) ** 2).sum(1))
            cand_p.append(l * cap + np.arange(counts[l]))
        cd, cp = np.concatenate(cand_d), np.concatenate(cand_p)
        best = np.argsort(cd, kind="stable")[:k]
        np.testing.assert_allclose(d[b], cd[best], rtol=1e-4, atol=1e-3)
        assert set(pos[b].tolist()) == set(cp[best].tolist())


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_pq_adc_striping_matches_unstriped(rng, n_shards):
    """Slot striping of the XLA ADC scan: per-stripe scans with
    ``slot_stride``/``slot_offset`` merged by top-k equal the unstriped
    scan, positions in logical slot space (the ShardedIVFPQIndex path)."""
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.pq import scan_probed_codes

    idx = _pq_index(rng)
    nlist, k = 8, 10
    q = jnp.asarray(rng.standard_normal((5, 32)).astype(np.float32))
    probe = jnp.asarray(np.stack([rng.choice(nlist, 4, replace=False)
                                  for _ in range(5)]).astype(np.int32))
    rest = (idx.counts, idx.centroids, idx.codebooks, probe, k)
    rd, rp = scan_probed_codes(q, idx.code_arena_t, *rest)
    cap = idx.capacity
    parts = [
        scan_probed_codes(q, idx.code_arena_t[:, :, s::n_shards], *rest,
                          slot_stride=n_shards, slot_offset=s,
                          global_capacity=cap)
        for s in range(n_shards)
    ]
    d = np.concatenate([np.asarray(p[0]) for p in parts], axis=1)
    pos = np.concatenate([np.asarray(p[1]) for p in parts], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    np.testing.assert_allclose(np.take_along_axis(d, order, 1),
                               np.asarray(rd), rtol=1e-5, atol=1e-5)
    for b in range(5):
        assert set(np.take_along_axis(pos, order, 1)[b].tolist()) == set(
            np.asarray(rp)[b].tolist())


def test_pq_k_inner_shortlist(rng):
    """k_inner (per-probed-list shortlist depth) feeds the host-rerank
    capacity tier: k_inner >= cap must be EXACT, and a truncated k_inner
    must return per-list-bounded, correctly ordered candidates whose
    global best matches the exact scan (rank 1 within its list is never
    truncated)."""
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.pq import scan_probed_codes

    nlist = 8
    idx = _pq_index(rng)
    q = rng.standard_normal((8, 32)).astype(np.float32)
    probe = jnp.tile(jnp.arange(nlist, dtype=jnp.int32), (8, 1))
    args = (jnp.asarray(q), idx.code_arena_t, idx.counts, idx.centroids,
            idx.codebooks, probe)
    R = 64
    d_exact, p_exact = scan_probed_codes(*args, R)
    # full-depth k_inner == exact
    d_full, p_full = scan_probed_codes(*args, R, k_inner=idx.capacity)
    np.testing.assert_array_equal(p_exact, p_full)
    np.testing.assert_allclose(d_exact, d_full, rtol=1e-6)

    d_tr, p_tr = scan_probed_codes(*args, R, k_inner=8)
    cap = idx.capacity
    for b in range(8):
        # global best always survives (its in-list rank is 1)
        assert p_tr[b, 0] == p_exact[b, 0]
        assert abs(float(d_tr[b, 0] - d_exact[b, 0])) < 1e-5
        # distances ascend
        dv = np.asarray(d_tr[b])
        fin = np.isfinite(dv)
        assert (np.diff(dv[fin]) >= -1e-6).all()
        # per-list contribution bounded by k_inner
        lists, cnts = np.unique(
            np.asarray(p_tr[b])[np.asarray(p_tr[b]) >= 0] // cap,
            return_counts=True,
        )
        assert (cnts <= 8).all()
        sub = set(np.asarray(p_exact[b]).tolist())
        overlap = len(sub & set(np.asarray(p_tr[b]).tolist()))
        assert overlap >= R // 2  # shortlist stays close to exact top-R


# ---------------------------------------------------------------------- #
# OPQ (rotation-optimized PQ — ops/pq.opq_fit; beyond the reference)
# ---------------------------------------------------------------------- #

def _anisotropic(rng, n, dim, decay=0.85):
    """Correlated gaussian whose principal axes straddle subspace
    boundaries — the geometry plain axis-aligned PQ handles worst."""
    spectrum = decay ** np.arange(dim)
    basis, _ = np.linalg.qr(rng.standard_normal((dim, dim)))
    z = rng.standard_normal((n, dim)) * spectrum
    return (z @ basis.T).astype(np.float32)


def test_opq_fit_reduces_reconstruction_error(rng):
    import jax
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.pq import (
        opq_fit,
        pq_decode,
        pq_encode,
        train_product_quantizer,
    )

    x = jnp.asarray(_anisotropic(rng, 3000, 32))
    key = jax.random.PRNGKey(0)
    cb_plain = train_product_quantizer(key, x, m=8, ks=32, iters=8)
    err_plain = float(jnp.mean(
        (x - pq_decode(pq_encode(x, cb_plain), cb_plain)) ** 2
    ))
    R, cb_opq = opq_fit(key, x, m=8, ks=32, iters=8, opq_iters=4)
    # R orthogonal
    np.testing.assert_allclose(
        np.asarray(R.T @ R), np.eye(32), atol=1e-4
    )
    xr = x @ R
    err_opq = float(jnp.mean(
        (xr - pq_decode(pq_encode(xr, cb_opq), cb_opq)) ** 2
    ))
    assert err_opq < err_plain * 0.9, (err_opq, err_plain)


def test_opq_rotation_is_isometric_at_high_dim(rng):
    """Regression for the OPQ deep-rerank plateau: fp32 matmuls may run at
    reduced precision by default, so U @ Vᵀ of the Procrustes SVD can come
    back non-orthogonal at dim ≥ 128 on decaying spectra — a systematic
    rotated-frame metric distortion well above bf16 storage noise.
    opq_fit must publish an isometry to fp32 roundoff."""
    import jax
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.ops.pq import opq_fit

    dim = 128
    x = jnp.asarray(_anisotropic(rng, 8000, dim, decay=0.96))
    R, _ = opq_fit(jax.random.PRNGKey(0), x, m=16, ks=32, iters=3,
                   opq_iters=3)
    R64 = np.asarray(R, np.float64)
    dev = np.abs(R64.T @ R64 - np.eye(dim)).max()
    assert dev < 2e-5, dev


def test_opq_index_end_to_end(rng, oracle):
    """opq=True: the whole index operates in the rotated basis; reported
    distances stay TRUE-space distances (rotation is an isometry) and
    rerank recall matches the plain index's on easy data."""
    x = _anisotropic(rng, 4000, 32)
    cfg = IVFPQConfig(dimension=32, nlist=16, m=8, pq_train_sample=2048,
                      opq=True, opq_iters=3)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    assert idx.opq_R is not None
    q = (x[:6] + 0.05 * rng.standard_normal((6, 32))).astype(np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=16, k=5,
                                        use_exact_rerank=True))
    # exact rerank distances are true-space L2: verify against numpy
    true_d = ((q[:, None] - x[None]) ** 2).sum(-1)
    np.testing.assert_allclose(
        d[:, 0], true_d[np.arange(6), ids[:, 0].astype(np.int64)],
        rtol=1e-3, atol=1e-3,
    )
    assert (ids[:, 0] == np.arange(6, dtype=np.uint64)).all()


def test_opq_adc_recall_not_worse_on_anisotropic(rng, oracle):
    """ADC-only (no rerank) on anisotropic data: OPQ must not lose to the
    axis-aligned split (it usually wins — that is its purpose)."""
    x = _anisotropic(rng, 4000, 32)
    q = (x[:32] + 0.05 * rng.standard_normal((32, 32))).astype(np.float32)
    _, truth = oracle(q, x, 5)
    recalls = {}
    for opq in (False, True):
        cfg = IVFPQConfig(dimension=32, nlist=8, m=8, pq_train_sample=2048,
                          opq=opq, opq_iters=4)
        idx = IVFPQIndex(cfg)
        idx.train(x)
        idx.add(x)
        _, ids = idx.search(q, SearchParams(nprobe=8, k=5))
        recalls[opq] = _recall(ids.astype(np.int64), truth)
    assert recalls[True] >= recalls[False] - 0.02, recalls


def test_opq_snapshot_roundtrip(rng, tmp_path):
    x = _anisotropic(rng, 2000, 16)
    cfg = IVFPQConfig(dimension=16, nlist=8, m=4, pq_train_sample=1024,
                      opq=True, opq_iters=2)
    idx = IVFPQIndex(cfg)
    idx.train(x)
    idx.add(x)
    q = rng.standard_normal((5, 16)).astype(np.float32)
    d_ref, ids_ref = idx.search(q, SearchParams(nprobe=8, k=5))
    path = str(tmp_path / "pq_opq")
    idx.save(path)
    idx2 = IVFPQIndex.load(path)
    assert idx2.opq_R is not None and idx2.config.opq
    d, ids = idx2.search(q, SearchParams(nprobe=8, k=5))
    np.testing.assert_array_equal(ids, ids_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-4, atol=1e-4)


def test_ivf_pq_calibrate_nprobe_and_persist(rng, tmp_path):
    """PQ shares the measured-coverage calibration (models/calibrate.py):
    the picked nprobe meets the target on held-out queries, nprobe=0
    serves at the calibrated point, and save/load round-trips it."""
    idx, x = _build(rng, n=4000, dim=32, nlist=16, m=8)
    q = rng.standard_normal((128, 32)).astype(np.float32)
    rep = idx.calibrate_nprobe(queries=q, target_coverage=0.9, k=10)
    assert rep["coverage"] >= 0.9 or rep["coverage_limited"]
    assert idx.calibrated_nprobe == rep["nprobe"]
    d0, i0 = idx.search(q[:8], SearchParams(nprobe=0, k=5))
    dc, ic = idx.search(q[:8], SearchParams(nprobe=rep["nprobe"], k=5))
    np.testing.assert_array_equal(i0, ic)

    # self-sampled calibration (raw rows) also works
    rep2 = idx.calibrate_nprobe(sample=64, target_coverage=0.9)
    assert rep2["nprobe"] >= 1

    snap = str(tmp_path / "pq-snap")
    idx.save(snap)
    idx2 = IVFPQIndex.load(snap)
    assert idx2.calibrated_nprobe == idx.calibrated_nprobe


def test_ivf_pq_calibrate_opq_frame(rng):
    """Under OPQ the centroids live in the rotated basis; calibration must
    rank coarse lists in that frame (and un-rotate self-sampled rows) or
    the curve would be measured against the wrong probe order."""
    idx, x = _build(rng, n=3000, dim=32, nlist=8, m=8, opq=True)
    rep = idx.calibrate_nprobe(sample=64, target_coverage=0.9, k=5)
    assert 1 <= rep["nprobe"] <= 8
    # full-probe coverage is 1.0 by construction — the curve must reach it
    assert rep["curve"][8] == pytest.approx(1.0)
