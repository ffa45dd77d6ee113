"""Probe-coverage calibration shared by the index families.

Coverage(P) = the fraction of exact top-``k`` neighbors whose inverted
list appears among a query's first ``P`` coarse probes. It is the
quantization-independent component of recall (recall ≈ coverage ×
ranking-accuracy), so the smallest ``nprobe`` meeting a coverage target
is the cheapest operating point that can reach that recall — measured on
the caller's own corpus + queries rather than read off a static table
(the reference ships only the table, ``/root/reference/README.md:154-167``).

Used by :meth:`IVFFlatIndex.calibrate_nprobe`,
:meth:`IVFPQIndex.calibrate_nprobe`, and the ``vdb-tune`` CLI.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine.ops.normalize import l2_normalize


def sample_stored_rows(arena, sample: int, seed: int = 0) -> np.ndarray:
    """Sample ``sample`` dequantized stored rows from a
    :class:`PackedListArena` to use as stand-in queries. Slightly
    optimistic for coverage (a stored row sits at the heart of its own
    list) — prefer held-out queries for tight targets."""
    rng = np.random.default_rng(seed)
    counts_h = np.asarray(arena.counts)
    lists_h = np.flatnonzero(counts_h > 0)
    lists_s = rng.choice(lists_h, size=sample)
    slots_s = (rng.random(sample) * counts_h[lists_s]).astype(np.int64)
    rows = jnp.asarray(arena.arena)[
        jnp.asarray(lists_s), jnp.asarray(slots_s)
    ].astype(jnp.float32)
    if arena.arena_scale is not None:
        rows = rows * jnp.asarray(arena.arena_scale)[
            jnp.asarray(lists_s), jnp.asarray(slots_s)
        ][:, None]
    if arena.anchors is not None:
        rows = rows + jnp.asarray(arena.anchors)[jnp.asarray(lists_s)]
    return np.asarray(rows, np.float32)


def probe_coverage_calibrate(
    *,
    centroids,
    metric: Metric,
    ids_table: np.ndarray,
    queries: np.ndarray,
    exact_search_fn,
    target_coverage: float = 0.99,
    k: int = 10,
    candidates: tuple = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
    query_transform=None,
) -> dict:
    """Measure the coverage curve and pick the smallest candidate meeting
    ``target_coverage``.

    ``ids_table`` is the ``[nlist, capacity]`` id layout (row index = list
    id). ``exact_search_fn(queries, k)`` must return the full-probe
    (``nprobe = nlist``) top-``k`` ``(dists, ids)`` on the index's stored
    representation. ``query_transform`` (optional) maps queries into the
    frame the centroids live in (e.g. an OPQ rotation) before the coarse
    ranking — the exact search receives the UNtransformed queries and
    applies its own boundary transform.

    When coverage plateaus below target on every candidate
    (duplicated-mass geometry: the true top-k scatter near-uniformly over
    a mode's many cells), escalating to a full scan would silently turn
    serving into brute force — instead the knee (smallest candidate within
    1% absolute of the best measured coverage) is chosen and
    ``coverage_limited`` is set.
    """
    nlist, cap = ids_table.shape
    queries = np.ascontiguousarray(queries, np.float32)

    d_true, ids_true = exact_search_fn(queries, k)
    ids_true = np.asarray(ids_true)

    # true list of each ground-truth id via the id table
    flat = np.asarray(ids_table).reshape(-1)
    order = np.argsort(flat, kind="stable")
    sflat = flat[order]
    locs = np.clip(
        np.searchsorted(sflat, ids_true.astype(np.uint64)),
        0, max(sflat.size - 1, 0),
    )
    matched = sflat[locs] == ids_true.astype(np.uint64)
    true_list = (order[locs] // cap).astype(np.int64)

    # Coarse rank of each true list per query.
    q = jnp.asarray(queries)
    if query_transform is not None:
        q = query_transform(q)
    if metric == Metric.COSINE:
        q = l2_normalize(q)
    coarse_metric = (
        Metric.INNER_PRODUCT if metric == Metric.INNER_PRODUCT else Metric.L2
    )
    coarse = np.asarray(pairwise_distance(q, centroids, coarse_metric))
    ranks = np.argsort(np.argsort(coarse, axis=1), axis=1)
    rank_of_true = np.take_along_axis(
        ranks, np.clip(true_list, 0, nlist - 1), axis=1
    )
    valid = matched & (ids_true != INVALID_ID)
    n_valid = max(int(valid.sum()), 1)
    curve = {}
    for p in sorted(set(int(c) for c in candidates) | {nlist}):
        if p > nlist:
            continue
        curve[p] = float((rank_of_true[valid] < p).sum() / n_valid)
    cand_curve = {p: c for p, c in curve.items() if p < nlist}
    chosen = next(
        (p for p in sorted(cand_curve) if cand_curve[p] >= target_coverage),
        None,
    )
    coverage_limited = chosen is None and bool(cand_curve)
    if coverage_limited:
        best = max(cand_curve.values())
        chosen = min(p for p, c in cand_curve.items() if c >= best - 0.01)
    elif chosen is None:
        chosen = nlist
    return {
        "nprobe": int(chosen),
        "coverage": curve.get(chosen, 1.0),
        "coverage_limited": coverage_limited,
        "curve": curve,
        "target": target_coverage,
        "sample": queries.shape[0],
    }
