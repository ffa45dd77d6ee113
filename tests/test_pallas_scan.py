"""Grouped Pallas (Triton) scan kernel: parity in interpret mode on the CPU,
the wrapper's row packing, tiling and striping, and its GPU lowering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine.ops import grouped_scan
from cuda_acceleratedvectordatabaseengine.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine.ops.grouped_scan import (
    scan_probed_lists_grouped,
)
from cuda_acceleratedvectordatabaseengine.ops.scan import scan_probed_lists


def _arena(rng, nlist, cap, dim, counts=None, dtype=np.float32,
           normalize=False):
    arena = np.zeros((nlist, cap, dim), np.float32)
    if counts is None:
        counts = rng.integers(1, cap + 1, nlist).astype(np.int32)
    for l in range(nlist):
        arena[l, :counts[l]] = rng.standard_normal((counts[l], dim))
    if normalize:
        arena /= np.maximum(np.linalg.norm(arena, axis=-1, keepdims=True),
                            1e-12)
    arena = jnp.asarray(arena).astype(dtype)
    stored = np.asarray(arena.astype(jnp.float32))
    return arena, jnp.asarray((stored ** 2).sum(-1)), counts


def _probes(rng, nlist, b, p):
    return np.stack([
        rng.choice(nlist, p, replace=False) for _ in range(b)
    ]).astype(np.int32)


def _check(d, p, rd, rp):
    """Exact candidate sets and distances within fp32-product tolerance."""
    d, p, rd, rp = map(np.asarray, (d, p, rd, rp))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(d[fin], rd[fin], rtol=1e-5, atol=1e-5)
    assert ((p >= 0) == fin).all()
    for b in range(rd.shape[0]):
        assert set(p[b][fin[b]].tolist()) == set(rp[b][fin[b]].tolist())


@pytest.mark.parametrize(
    "metric", [Metric.L2, Metric.INNER_PRODUCT, Metric.COSINE]
)
def test_pallas_scan_matches_gather_scan(rng, metric):
    nlist, cap, dim, B, P, k = 8, 128, 32, 4, 3, 6
    arena, arena_sq, counts = _arena(
        rng, nlist, cap, dim, normalize=metric == Metric.COSINE
    )
    q = rng.standard_normal((B, dim)).astype(np.float32)
    if metric == Metric.COSINE:
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    probe = _probes(rng, nlist, B, P)
    probe[0, -1] = -1
    args = (jnp.asarray(q), arena, arena_sq, jnp.asarray(counts),
            jnp.asarray(probe), k)
    d1, p1 = scan_probed_lists(*args, metric)
    d2, p2 = scan_probed_lists_grouped(*args, metric, interpret=True)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", [Metric.L2, Metric.INNER_PRODUCT])
def test_pallas_grouped_scan_matches_gather_scan(rng, metric):
    """bf16 arenas: the stored values are exact in bf16, so the kernel
    matches the fp32 reference over the same stored values (the XLA scan
    itself would round the query to the arena dtype)."""
    nlist, cap, dim, B, P, k = 8, 128, 32, 6, 4, 5
    arena, arena_sq, counts = _arena(rng, nlist, cap, dim,
                                     dtype=jnp.bfloat16)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = _probes(rng, nlist, B, P)
    probe[0, -1] = -1
    rest = (arena_sq, jnp.asarray(counts), jnp.asarray(probe), k, metric)
    d1, p1 = scan_probed_lists(jnp.asarray(q), arena.astype(jnp.float32),
                               *rest)
    d2, p2 = scan_probed_lists_grouped(jnp.asarray(q), arena, *rest,
                                       interpret=True, m=16)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2),
                               rtol=1e-5, atol=1e-5)


def test_pallas_grouped_hot_list(rng):
    """Many queries probing the SAME list (multi-row list) stays exact."""
    nlist, cap, dim, B, k = 4, 128, 16, 40, 5
    arena, arena_sq, counts = _arena(
        rng, nlist, cap, dim, counts=np.full(nlist, cap, np.int32)
    )
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = np.zeros((B, 2), np.int32)      # all queries probe list 0
    probe[:, 1] = 1
    args = (jnp.asarray(q), arena, arena_sq, jnp.asarray(counts),
            jnp.asarray(probe), k)
    d1, p1 = scan_probed_lists(*args, Metric.L2)
    d2, p2 = scan_probed_lists_grouped(*args, Metric.L2, interpret=True,
                                       m=16)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p2))


def _quantize_per_row(arena_f, anchors=None):
    """Per-row symmetric int8 quantization (same math as the build path);
    optional residual anchors [nlist, dim]."""
    res = arena_f - (anchors[:, None, :] if anchors is not None else 0.0)
    scale = np.maximum(np.abs(res).max(axis=-1), 1e-12) / 127.0
    codes = np.clip(
        np.round(res / scale[:, :, None]), -127, 127
    ).astype(np.int8)
    deq = codes.astype(np.float32) * scale[:, :, None]
    if anchors is not None:
        deq = deq + anchors[:, None, :]
    return codes, scale.astype(np.float32), deq


def _numpy_int8_reference(q, arena_i8, scale, arena_sq, probe, cap, k,
                          anchors=None):
    """Quantized-math L2 reference: d = ‖q‖² − 2(q·a + s⊙(q·code)) + ‖x̂‖²."""
    B = q.shape[0]
    out_d, out_p = [], []
    for b in range(B):
        cand_d, cand_p = [], []
        for l in probe[b]:
            dots = arena_i8[l].astype(np.float32) @ q[b]
            qx = scale[l] * dots
            if anchors is not None:
                qx = qx + anchors[l] @ q[b]
            dd = np.maximum((q[b] ** 2).sum() - 2 * qx + arena_sq[l], 0)
            cand_d.append(dd)
            cand_p.append(l * cap + np.arange(cap))
        cand_d = np.concatenate(cand_d)
        cand_p = np.concatenate(cand_p)
        ref_order = np.argsort(cand_d, kind="stable")[:k]
        out_d.append(cand_d[ref_order])
        out_p.append(cand_p[ref_order])
    return np.stack(out_d), np.stack(out_p)


@pytest.mark.parametrize("use_anchors", [False, True])
@pytest.mark.parametrize("impl", ["grouped", "gather"])
def test_int8_per_row_scale_paths(rng, impl, use_anchors):
    """int8 quantized math (per-row scales, optional residual anchors):
    every scan implementation must match the numpy reference."""
    nlist, cap, dim, B, P, k = 8, 128, 32, 4, 3, 5
    x = rng.standard_normal((nlist * cap, dim)).astype(np.float32)
    arena_f = x.reshape(nlist, cap, dim)
    counts = np.full(nlist, cap, np.int32)
    anchors = (
        rng.standard_normal((nlist, dim)).astype(np.float32)
        if use_anchors else None
    )
    arena_i8, scale, deq = _quantize_per_row(arena_f, anchors)
    arena_sq = (deq ** 2).sum(-1).astype(np.float32)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = _probes(rng, nlist, B, P)

    kw = dict(
        arena_scale=jnp.asarray(scale),
        arena_anchors=jnp.asarray(anchors) if use_anchors else None,
    )
    args = (
        jnp.asarray(q), jnp.asarray(arena_i8), jnp.asarray(arena_sq),
        jnp.asarray(counts), jnp.asarray(probe), k, Metric.L2,
    )
    if impl == "grouped":
        d, pos = scan_probed_lists_grouped(
            *args, interpret=True, m=16, **kw
        )
    else:
        d, pos = scan_probed_lists(*args, **kw)
    d, pos = np.asarray(d), np.asarray(pos)

    ref_d, ref_p = _numpy_int8_reference(
        q, arena_i8, scale, arena_sq, probe, cap, k, anchors
    )
    for b in range(B):
        np.testing.assert_allclose(d[b], ref_d[b], rtol=1e-4, atol=1e-4)
        assert set(pos[b].tolist()) == set(ref_p[b].tolist())


def test_scan_ignores_allocation_headroom(rng):
    """Each list's loop is bounded by its own count: slots past the count
    hold garbage here, and a larger allocation changes nothing."""
    nlist, cap, dim, B, P, k = 8, 384, 32, 4, 3, 5
    counts = rng.integers(64, 201, (nlist,)).astype(np.int32)
    arena, arena_sq, _ = _arena(rng, nlist, cap, dim, counts=counts)
    junk = jnp.asarray(rng.standard_normal((nlist, cap, dim)), jnp.float32)
    live = jnp.arange(cap)[None, :, None] < jnp.asarray(counts)[:, None, None]
    dirty = jnp.where(live, arena, junk)
    q = jnp.asarray(rng.standard_normal((B, dim)).astype(np.float32))
    probe = jnp.asarray(_probes(rng, nlist, B, P))
    rest = (jnp.asarray(counts), probe, k, Metric.L2)
    d_ref, p_ref = scan_probed_lists_grouped(
        q, arena[:, :256], arena_sq[:, :256], *rest, interpret=True,
        global_capacity=cap,
    )
    d, p = scan_probed_lists_grouped(
        q, dirty, jnp.where(live[..., 0], arena_sq, 1e9), *rest,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(d), np.asarray(d_ref),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(p), np.asarray(p_ref))


@pytest.mark.parametrize("k", [1, 10, 17])
def test_grouped_topk_fold_parity(rng, k):
    """The in-kernel running top-k (tile folding with a padded candidate
    row) reproduces the exact scan, including underfull rows (fewer valid
    slots than k → inf/-1 sentinels) and k that is not a power of two."""
    nlist, cap, dim, B, P = 8, 512, 32, 6, 4
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = _probes(rng, nlist, B, P)
    for counts in (
        rng.integers(1, cap + 1, (nlist,)).astype(np.int32),
        np.full(nlist, 2, np.int32),            # underfull: valid < k
    ):
        arena, arena_sq, _ = _arena(rng, nlist, cap, dim, counts=counts)
        args = (jnp.asarray(q), arena, arena_sq, jnp.asarray(counts),
                jnp.asarray(probe), k, Metric.L2)
        _check(*scan_probed_lists_grouped(*args, interpret=True, m=16),
               *scan_probed_lists(*args))


@pytest.mark.parametrize("cap", [16, 48, 200])
def test_grouped_tile_shapes(rng, cap):
    """Capacities below the 128-slot tile or not a multiple of it: the
    kernel picks a power-of-two tile and starts the last tile early
    (overlapping slots are masked, never scored twice)."""
    nlist, dim, B, P, k = 6, 32, 5, 3, 7
    counts = rng.integers(1, cap + 1, nlist).astype(np.int32)
    counts[0] = cap                           # one completely full list
    arena, arena_sq, _ = _arena(rng, nlist, cap, dim, counts=counts)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = _probes(rng, nlist, B, P)
    probe[:, 0] = 0
    probe[:, 1:] = np.where(probe[:, 1:] == 0, 1, probe[:, 1:])
    args = (jnp.asarray(q), arena, arena_sq, jnp.asarray(counts),
            jnp.asarray(probe), k, Metric.L2)
    _check(*scan_probed_lists_grouped(*args, interpret=True),
           *scan_probed_lists(*args))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_grouped_striping_matches_unstriped(rng, n_shards):
    """Slot striping: running the kernel on each round-robin stripe with
    ``slot_stride``/``slot_offset`` and merging the per-stripe top-k gives
    the unstriped result, with positions in logical slot space."""
    nlist, cap, dim, B, P, k = 8, 128, 32, 5, 3, 6
    arena, arena_sq, counts = _arena(rng, nlist, cap, dim)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = _probes(rng, nlist, B, P)
    args = (jnp.asarray(counts), jnp.asarray(probe), k, Metric.L2)
    rd, rp = scan_probed_lists(jnp.asarray(q), arena, arena_sq, *args)
    parts = [
        scan_probed_lists_grouped(
            jnp.asarray(q), arena[:, s::n_shards], arena_sq[:, s::n_shards],
            *args, interpret=True, slot_stride=n_shards, slot_offset=s,
            global_capacity=cap,
        )
        for s in range(n_shards)
    ]
    d = np.concatenate([np.asarray(p[0]) for p in parts], axis=1)
    pos = np.concatenate([np.asarray(p[1]) for p in parts], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    _check(np.take_along_axis(d, order, 1), np.take_along_axis(pos, order, 1),
           rd, rp)


def test_pack_pairs_into_rows(rng):
    """Row packing: every valid pair lands in exactly one lane of a row of
    its own list, rows hold at most m pairs, invalid probes and unused rows
    carry sentinels, and the static row bound is never exceeded."""
    nlist, B, P, m = 5, 30, 3, 16
    probe = _probes(rng, nlist, B, P)
    probe[:, 0] = 2                               # a hot list: > m pairs
    probe[:, 1:] = np.where(probe[:, 1:] == 2, 4, probe[:, 1:])
    probe[3, 1] = -1
    n_rows = grouped_scan.row_bound(B * P, nlist, m)
    order, key_sorted, row_of_pair, m_of_pair, row_list, qrow = map(
        np.asarray,
        grouped_scan.pack_pairs_into_rows(jnp.asarray(probe), nlist, m,
                                          n_rows),
    )
    assert qrow.shape == (n_rows, m) and row_list.shape == (n_rows,)
    flat = probe.reshape(-1)[order]
    valid = flat >= 0
    assert (row_list[row_of_pair[valid]] == flat[valid]).all()
    assert (qrow[row_of_pair, m_of_pair][valid]
            == (order // P)[valid]).all()
    assert (qrow[row_of_pair, m_of_pair][~valid] == -1).all()
    lanes = set(zip(row_of_pair.tolist(), m_of_pair.tolist()))
    assert len(lanes) == B * P                    # no lane shared
    assert (row_list[row_of_pair[valid]] < nlist).all()
    unused = np.setdiff1d(np.arange(n_rows), row_of_pair)
    assert (row_list[unused] == nlist).all()
    assert (qrow[unused] == -1).all()
    # the hot list spills over several rows of at most m queries each
    hot_rows = np.unique(row_of_pair[flat == 2])
    assert len(hot_rows) == -(-B // m)


def test_auto_m_and_row_bound():
    """Row width follows the mean pairs per list within the power-of-two
    widths the tensor cores take; the row bound covers full rows plus one
    partial row per list and never exceeds the pair count."""
    assert grouped_scan.auto_m(64 * 32, 4096) == 16       # sparse batch
    assert grouped_scan.auto_m(8192 * 4, 4096) == 16      # 8 per list
    assert grouped_scan.auto_m(8192 * 16, 4096) == 32
    assert grouped_scan.auto_m(8192 * 32, 4096) == 32
    assert grouped_scan.auto_m(8192 * 128, 4096) == 32
    assert grouped_scan.row_bound(64 * 32, 4096, 16) == 64 * 32
    assert grouped_scan.row_bound(8192 * 32, 4096, 32) == (
        8192 * 32 // 32 + 4097
    )
    assert grouped_scan.row_bound(0, 8, 16) == 1


def test_residual_quantization_is_finer(rng):
    """Residual (anchored) int8 encoding reconstructs clustered data much
    more accurately than raw-value encoding — the recall lever."""
    nlist, cap, dim = 8, 64, 32
    centers = 4.0 * rng.standard_normal((nlist, dim)).astype(np.float32)
    noise = 0.25 * rng.standard_normal((nlist, cap, dim)).astype(np.float32)
    arena_f = centers[:, None, :] + noise
    _, _, deq_raw = _quantize_per_row(arena_f, None)
    _, _, deq_res = _quantize_per_row(arena_f, centers)
    err_raw = np.abs(deq_raw - arena_f).mean()
    err_res = np.abs(deq_res - arena_f).mean()
    assert err_res < err_raw / 4.0, (err_raw, err_res)


@pytest.mark.parametrize(
    "dtype, dim, cap, k",
    [
        (jnp.int8, 768, 2560, 10),      # the serving widths
        (jnp.float32, 768, 2560, 10),
        (jnp.int8, 100, 2560, 10),      # masked last feature chunk
        (jnp.int8, 768, 8, 10),         # masked sub-tile capacity
        (jnp.int8, 768, 2560, 100),     # two top-k passes
    ],
)
def test_grouped_kernel_lowers_for_gpu(dtype, dim, cap, k):
    """The kernel lowers to Triton IR, which checks every block the kernel
    loads is a power-of-two tensor and every primitive has a GPU rule (one
    Triton call per top-k pass). Lowering needs no GPU; compiling does."""
    nlist = 64
    f = jax.jit(lambda q, a, s, c, p, sc, an: scan_probed_lists_grouped(
        q, a, s, c, p, k, Metric.L2, arena_scale=sc, arena_anchors=an))
    spec = jax.ShapeDtypeStruct
    lowered = f.trace(
        spec((256, dim), jnp.float32), spec((nlist, cap, dim), dtype),
        spec((nlist, cap), jnp.float32), spec((nlist,), jnp.int32),
        spec((256, 32), jnp.int32), spec((nlist, cap), jnp.float32),
        spec((nlist, dim), jnp.float32),
    ).lower(lowering_platforms=("cuda",))
    n_pass = -(-k // grouped_scan.MAX_K)
    assert lowered.as_text().count("xla.gpu.triton") == n_pass


@pytest.mark.parametrize(
    "dim, cap, k",
    [
        (36, 128, 5),       # width under one 64-wide chunk
        (100, 64, 10),      # GloVe-100: masked last chunk
        (300, 32, 5),       # five chunks, last one masked
        (32, 8, 5),         # capacity under one 16-slot tile
        (32, 1, 3),
        (32, 256, 70),      # two top-k passes
        (20, 12, 130),      # three passes over a masked tile
    ],
)
def test_grouped_kernel_takes_any_shape(rng, dim, cap, k):
    """Widths, capacities and k outside the kernel's native tiling run on
    the kernel itself (no fallback). Every stored row has an exact twin in
    the next slot, so the passes of a deep k must resume strictly after
    each other's worst (distance, slot): the sorted distances then equal
    the reference's, with no position repeated and none lost."""
    nlist, B = 6, 5
    P = 1 if k > grouped_scan.MAX_K else 3   # one list must fill the k
    counts = rng.integers(1, cap + 1, nlist).astype(np.int32)
    counts[0] = cap
    rows = rng.standard_normal((nlist, (cap + 1) // 2, dim))
    arena = jnp.asarray(np.repeat(rows, 2, axis=1)[:, :cap], jnp.float32)
    q = jnp.asarray(rng.standard_normal((B, dim)), jnp.float32)
    probe = np.stack([                       # the full list 0 first
        np.concatenate([[0], rng.choice(np.arange(1, nlist), P - 1,
                                        replace=False)])
        for _ in range(B)
    ]).astype(np.int32)
    args = (q, arena, jnp.sum(arena * arena, -1), jnp.asarray(counts),
            jnp.asarray(probe), k, Metric.L2)
    rd, _ = map(np.asarray, scan_probed_lists(*args))
    d, p = map(np.asarray, scan_probed_lists_grouped(*args, interpret=True))
    fin = np.isfinite(rd)
    np.testing.assert_allclose(d[fin], rd[fin], rtol=1e-5, atol=1e-5)
    assert ((p >= 0) == fin).all()
    for b in range(B):
        assert len(set(p[b][fin[b]].tolist())) == int(fin[b].sum())


@pytest.mark.parametrize("k", [64, 100, 150])
def test_grouped_deep_k_exact_ties(rng, k):
    """Exact ties across a replacement: the first tile's 128 slots hold
    one row at distance 1, the next 10 slots the query itself. When the
    10 nearer rows arrive, each pass must evict its highest tied slot, so
    that the next pass resumes right after the slots it kept: the result
    is the 10 nearest plus the lowest slots of the tie, none lost."""
    nlist, cap, dim, count = 2, 256, 16, 138
    near = rng.standard_normal(dim).astype(np.float32)
    far = near.copy()
    far[0] += 1.0
    arena = np.broadcast_to(far, (nlist, cap, dim)).copy()
    arena[:, 128:] = near
    arena = jnp.asarray(arena)
    _, p = scan_probed_lists_grouped(
        jnp.asarray(np.stack([near] * 3)), arena, jnp.sum(arena * arena, -1),
        jnp.full((nlist,), count, jnp.int32), jnp.zeros((3, 1), jnp.int32),
        k, Metric.L2, interpret=True,
    )
    want = list(range(min(k - 10, 128))) + list(range(128, 138))
    for row_p in np.asarray(p):
        assert sorted(row_p[row_p >= 0].tolist()) == want


@pytest.mark.gpu
def test_grouped_kernel_on_gpu_matches_reference(gpu_device):
    """Compiled (not interpreted) kernel against the reference at a real
    width; ``chip_smoke.py``'s kernel phase runs the full-size version."""
    rng = np.random.default_rng(0)
    nlist, cap, dim, B, P, k = 64, 512, 768, 64, 8, 10
    arena, arena_sq, counts = _arena(rng, nlist, cap, dim,
                                     dtype=jnp.bfloat16)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    probe = _probes(rng, nlist, B, P)
    rest = (arena_sq, jnp.asarray(counts), jnp.asarray(probe), k, Metric.L2)
    with jax.default_matmul_precision("highest"):
        ref = scan_probed_lists(jnp.asarray(q), arena.astype(jnp.float32),
                                *rest)
    _check(*scan_probed_lists_grouped(jnp.asarray(q), arena, *rest), *ref)
