"""k-means for the IVF coarse quantizer, fully on-device.

Reference counterparts:
  - ``kmeans_assign_kernel`` (K5, ``engine/kernels.cuh:315-354``): one CUDA
    thread per vector doing a scalar linear argmin over all centroids.
  - ``IVFFlatIndex::train`` (``engine/ivf_flat_index.cpp:49-145``): host-side
    k-means++ seeding (seed 42) + 10 Lloyd iterations with GPU-assisted
    assignment and a *CPU* centroid update loop.

Design: assignment is a chunked ``[C, D] x [D, K]`` distance matmul +
row argmin; the centroid update is another matmul — ``onehot(a).T @ x``
— accumulated in fp32 across chunks inside one ``lax.scan``, so the whole
Lloyd iteration is two big matmuls and never leaves the device. k-means++
seeding uses the Gumbel-max trick to sample proportional to min-squared-
distance without a host round trip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
)


def _pad_to_multiple(x: jax.Array, multiple: int):
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = jnp.concatenate([x, jnp.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)
    return x, n


@functools.partial(
    jax.jit, static_argnames=("metric", "chunk_size")
)
def kmeans_assign(
    x: jax.Array,
    centroids: jax.Array,
    metric: Metric = Metric.L2,
    chunk_size: int = 16384,
) -> jax.Array:
    """Assign each row of ``x [N, D]`` to its nearest centroid ``[K, D]``.

    Replaces K5 (``kernels.cuh:315-354``) and the CPU argmin fallback
    (``ivf_flat_index.cpp:259-295``). Chunked over N so the [C, K] distance
    tile stays small regardless of corpus size; jitted as ONE program —
    eager chunking would pay a dispatch round trip per chunk. Returns int32
    ``[N]``.
    """
    n = x.shape[0]
    if n <= chunk_size:
        d = pairwise_distance(x.astype(jnp.float32), centroids, metric)
        return jnp.argmin(d, axis=-1).astype(jnp.int32)

    xp, n_orig = _pad_to_multiple(x, chunk_size)
    chunks = xp.reshape(-1, chunk_size, x.shape[1])

    def body(_, xc):
        d = pairwise_distance(xc.astype(jnp.float32), centroids, metric)
        return None, jnp.argmin(d, axis=-1).astype(jnp.int32)

    _, assigns = jax.lax.scan(body, None, chunks)
    return assigns.reshape(-1)[:n_orig]


@functools.partial(
    jax.jit, static_argnames=("t", "metric", "chunk_size")
)
def kmeans_assign_topk(
    x: jax.Array,
    centroids: jax.Array,
    t: int = 4,
    metric: Metric = Metric.L2,
    chunk_size: int = 16384,
) -> jax.Array:
    """Top-``t`` nearest centroids per row: ``[N, t]`` int32, best first.

    Backs balanced assignment: when a list hits its capacity clamp, overflow
    rows fall back to their 2nd..t-th nearest centroid (standard
    balanced-IVF practice — static-shape hardware hates the long tail of an
    unbalanced clustering)."""
    n = x.shape[0]

    def choices(xc):
        d = pairwise_distance(xc.astype(jnp.float32), centroids, metric)
        _, idx = jax.lax.top_k(-d, t)
        return idx.astype(jnp.int32)

    if n <= chunk_size:
        return choices(x)
    xp, n_orig = _pad_to_multiple(x, chunk_size)
    chunks = xp.reshape(-1, chunk_size, x.shape[1])
    _, out = jax.lax.scan(lambda _, xc: (None, choices(xc)), None, chunks)
    return out.reshape(-1, t)[:n_orig]


@functools.partial(
    jax.jit, static_argnames=("t", "metric", "chunk_size")
)
def kmeans_assign_topk_vals(
    x: jax.Array,
    centroids: jax.Array,
    t: int = 4,
    metric: Metric = Metric.L2,
    chunk_size: int = 16384,
) -> tuple[jax.Array, jax.Array]:
    """``kmeans_assign_topk`` that also returns the distances:
    ``(vals [N, t] fp32 ascending, idx [N, t] int32)``.

    Backs multi-assignment replication (``IVFFlatConfig.multi_assign_eps``):
    the d2 ≤ (1+ε)²·d1 ratio test decides whether a row earns a second
    resident copy, and it needs the top-2 centroid distances — not just
    their indices. Dense head modes (zipf-skewed mass, many near-equidistant
    cells) fire the test naturally; well-separated corpora almost never do."""
    n = x.shape[0]

    def choices(xc):
        d = pairwise_distance(xc.astype(jnp.float32), centroids, metric)
        neg, idx = jax.lax.top_k(-d, t)
        return -neg, idx.astype(jnp.int32)

    if n <= chunk_size:
        return choices(x)
    xp, n_orig = _pad_to_multiple(x, chunk_size)
    chunks = xp.reshape(-1, chunk_size, x.shape[1])
    _, out = jax.lax.scan(
        lambda _, xc: (None, choices(xc)), None, chunks
    )
    vals, idx = out
    return (
        vals.reshape(-1, t)[:n_orig],
        idx.reshape(-1, t)[:n_orig],
    )


def kmeans_pp_init(
    key: jax.Array,
    x: jax.Array,
    k: int,
) -> jax.Array:
    """k-means++ seeding (D² sampling) on device.

    Mirrors the reference's seeding loop (``ivf_flat_index.cpp:52-104``) but
    replaces its O(k·N·D) host scalar loops with a ``fori_loop`` of matvec
    distance updates and Gumbel-max categorical sampling.
    Returns fp32 centroids ``[k, D]``.
    """
    n, dim = x.shape
    xf = x.astype(jnp.float32)
    x_sq = jnp.sum(xf * xf, axis=-1)

    key, sub = jax.random.split(key)
    first = jax.random.randint(sub, (), 0, n)
    centroids = jnp.zeros((k, dim), jnp.float32).at[0].set(xf[first])

    def dist_to(c):
        # ||x - c||² via the expanded form; one matmul.
        return jnp.maximum(x_sq - 2.0 * (xf @ c) + jnp.sum(c * c), 0.0)

    min_d2 = dist_to(xf[first])
    keys = jax.random.split(key, k)

    def body(i, carry):
        centroids, min_d2 = carry
        # Sample idx with P(idx) ∝ min_d2 via Gumbel-max on log weights.
        gumbel = jax.random.gumbel(keys[i], (n,))
        logits = jnp.where(min_d2 > 0, jnp.log(min_d2 + 1e-30), -jnp.inf)
        idx = jnp.argmax(logits + gumbel)
        c = xf[idx]
        centroids = centroids.at[i].set(c)
        min_d2 = jnp.minimum(min_d2, dist_to(c))
        return centroids, min_d2

    centroids, _ = jax.lax.fori_loop(1, k, body, (centroids, min_d2))
    return centroids


def _reseed_step(new_centroids, counts, cand_v, cand_vecs, samp_vecs,
                 samp_a, d_tot, n_total, it, iters, it_key, k: int,
                 split_thresh: float = 1.5):
    """Twin/orphan reseeding shared by the single-chip and DP trainers.

    Inputs are REPLICATED in the sharded caller (post-psum counts/d_tot,
    all-gathered candidate pools), so the update is deterministic across
    chips. ``cand_v [P]`` distortions with their rows ``cand_vecs [P, D]``;
    ``samp_vecs [S, D]`` stratified rows with assignments ``samp_a [S]``.

    Rebalance rationale (measured on the 10M headline corpus — see the
    probe-coverage notes in CLAUDE.md):
      - starved: counts < 10% of mean — serves nobody.
      - redundant: twin centroids parked inside ONE natural mode
        (NN-distance ≪ median spacing). Twins never starve, so count-based
        reseeding alone leaves a mode-less centroid deficit elsewhere.
      - donated: on mass-skewed corpora (zipf) kmeans++ seeds ~one
        centroid per mode (inter-mode D² dominates) and Lloyd cannot
        migrate centroids across modes, so a head mode holding 12% of the
        corpus keeps ONE cell and sprays its arena overflow across
        arbitrary spill lists (measured: probe coverage stuck at 0.45 on
        zipf s=1.0 where cells ∝ mass predicts ~0.89). Overfull lists
        (> 1.5x mean) demand ceil(count/(1.5·mean)) - 1 extra cells each;
        the lowest-count centroids are donated to fund them, capped per
        iteration. Balanced corpora have zero demand → no-op.

    PLACEMENT differs by trigger. Orphaned modes are repaired by placing
    the centroid AT a high-distortion row: competition is cross-mode, so
    the whole mode snaps to it. Splitting an overfull mode that way fails
    in high dim — a centroid placed at a data row captures ~only that row
    (every other mode row is ~√2× closer to the mode-center centroid;
    measured: head-mode counts unchanged after 10 iterations of
    row-placed splits). Donated slots instead BISECT: clone the target
    centroid plus a small random jitter (0.25× the global rms assignment
    radius). The Voronoi boundary between the clone and its target is the
    hyperplane through the jitter midpoint — each clone peels off ~half
    the target's mass immediately, and Lloyd polarizes the pair. Multiple
    clones of one target (distinct jitter directions) tile the mode in a
    single iteration. The twin rule carries a count condition
    (pair sum < 1.5·mean) so fresh in-mode splits aren't re-merged.

    Orphan/redundant targets rank in one Gumbel-perturbed pool (P ∝
    score): orphan-mode points (distortion / global mean ≫ 10) and
    members of overfull clusters. Reseeding is skipped on the last two
    iterations so fresh seeds settle."""
    cc = pairwise_distance(new_centroids, new_centroids, Metric.L2)
    cc = cc + jnp.where(jnp.eye(k, dtype=bool), jnp.inf, 0.0)
    nn_d = jnp.min(cc, axis=-1)
    partner = jnp.argmin(cc, axis=-1).astype(jnp.int32)
    med_nn = jnp.median(nn_d)
    mean_count = jnp.mean(counts)
    mean_d = d_tot / jnp.float32(n_total) + 1e-12
    # Twin rule count condition: only merge when the pair's combined mass
    # would NOT itself be overfull — otherwise the donated bisections
    # below get re-merged the iteration after they're planted.
    redundant = (
        (nn_d < 0.35 * med_nn)
        & (jnp.arange(k, dtype=jnp.int32) > partner)
        & (counts + counts[partner] < split_thresh * mean_count)
    )
    starved = counts < 0.1 * mean_count
    # Density adaptation (see docstring): each overfull list demands
    # ceil(count / (1.5·mean)) - 1 clones; the lowest-count centroids
    # (cheapest distortion to give up) are donated, bounded per iteration.
    demand = jnp.maximum(
        jnp.ceil(counts / (split_thresh * mean_count)) - 1.0, 0.0
    )
    d_cap = max(min(256, k // 8), 1)
    quota = jnp.minimum(jnp.sum(demand), float(d_cap)).astype(jnp.int32)
    rank_by_count = jnp.zeros((k,), jnp.int32).at[jnp.argsort(counts)].set(
        jnp.arange(k, dtype=jnp.int32)
    )
    donated = (rank_by_count < quota) & (demand == 0)
    reseed = (starved | redundant | donated) & (it < iters - 2)

    # Normalize distortion by the GLOBAL mean assignment distortion:
    # orphan-mode points score ≈ (inter-mode / intra-mode)² ≫ 10, far above
    # overfull-split donors (≈ 5-8) and ordinary tail points (≈ 2-4).
    score_dist = cand_v.reshape(-1) / mean_d
    samp_c = counts[samp_a.reshape(-1)]
    score_samp = jnp.where(
        samp_c > split_thresh * mean_count,
        4.0 + samp_c / mean_count, -jnp.inf
    )
    pool_x = jnp.concatenate(
        [cand_vecs.reshape(-1, cand_vecs.shape[-1]),
         samp_vecs.reshape(-1, samp_vecs.shape[-1])]
    )
    pool_s = jnp.concatenate([score_dist, score_samp])
    key_pool, key_eps = jax.random.split(it_key)
    gumbel = jax.random.gumbel(key_pool, pool_s.shape)
    noisy = jnp.where(
        pool_s > 0, jnp.log(jnp.maximum(pool_s, 1e-30)) + gumbel,
        -jnp.inf,
    )
    s_cand = min(pool_s.shape[0], 512)
    _, best = jax.lax.top_k(noisy, s_cand)
    cand_rows = pool_x[best]                            # [s_cand, D]
    slot = (jnp.cumsum(reseed.astype(jnp.int32)) - 1) % s_cand

    # Bisecting placement for donated slots: the r-th donated slot clones
    # the target whose demand interval contains r (targets get clones in
    # proportion to their demand), offset by a random direction scaled to
    # 0.25× the global rms assignment radius — small enough that the
    # clone/target Voronoi hyperplane passes near the mode center
    # (~50/50 mass split), large enough that Lloyd polarizes the pair.
    d_rank = jnp.cumsum(donated.astype(jnp.int32)) - 1
    cum = jnp.cumsum(demand)
    tgt = jnp.clip(
        jnp.searchsorted(cum, d_rank.astype(cum.dtype), side="right"),
        0, k - 1,
    )
    eps = jax.random.normal(
        key_eps, new_centroids.shape, jnp.float32
    )
    eps = eps * (
        0.25 * jnp.sqrt(mean_d)
        / (jnp.linalg.norm(eps, axis=-1, keepdims=True) + 1e-20)
    )
    placed = jnp.where(
        donated[:, None], new_centroids[tgt] + eps,
        cand_rows[slot].astype(jnp.float32),
    )
    return jnp.where(reseed[:, None], placed, new_centroids)


@functools.partial(
    jax.jit,
    static_argnames=("k", "iters", "chunk_size", "init", "split_thresh"),
)
def kmeans_fit(
    key: jax.Array,
    x: jax.Array,
    k: int,
    iters: int = 10,
    chunk_size: int = 16384,
    init: str = "kmeans++",
    split_thresh: float = 1.5,
) -> tuple[jax.Array, jax.Array]:
    """Train k-means: seeding + ``iters`` fixed Lloyd iterations (the
    reference also runs a fixed 10, ``ivf_flat_index.cpp:109-142``).

    Returns ``(centroids [k, D] fp32, assignments [N] int32)``.
    Empty clusters keep their previous centroid, matching the reference's
    accumulate-and-average update (``ivf_flat_index.cpp:117-141``).
    """
    n, dim = x.shape
    if init == "kmeans++":
        centroids = kmeans_pp_init(key, x, k)
    elif init == "random":
        # Degenerate tiny training sets (n < k, e.g. PQ codebooks trained
        # on a handful of rows) must duplicate seeds — Lloyd keeps empty
        # clusters on their previous centroid, so duplicates are harmless.
        idx = jax.random.choice(key, n, (k,), replace=n < k)
        centroids = x[idx].astype(jnp.float32)
    else:
        raise ValueError(f"unknown init {init!r}")

    xp, n_orig = _pad_to_multiple(x, min(chunk_size, max(n, 1)))
    cs = min(chunk_size, xp.shape[0])
    chunks = xp.reshape(-1, cs, dim)
    # Padded rows must not contribute: weight 0.
    row_ids = jnp.arange(xp.shape[0]).reshape(-1, cs)
    valid = (row_ids < n_orig).astype(jnp.float32)

    # Reseed candidates per chunk (distortion + stratified). Clamped to the
    # chunk size: tiny training sets (n < 32) make cs == n and
    # jax.lax.top_k(d_min, 32) would reject k > axis length.
    n_cand = min(32, cs)
    key, loop_key = jax.random.split(key)
    loop_keys = jax.random.split(loop_key, iters)

    def lloyd(centroids, it_and_key):
        it, it_key = it_and_key
        def chunk_body(carry, inputs):
            sums, counts, d_tot = carry
            xc, w, rows = inputs
            xcf = xc.astype(jnp.float32)
            d = pairwise_distance(xcf, centroids, Metric.L2)
            a = jnp.argmin(d, axis=-1)
            onehot = (a[:, None] == jnp.arange(k)[None, :]).astype(jnp.float32)
            onehot = onehot * w[:, None]
            # [k, C] @ [C, D] — the centroid update as a matmul.
            sums = sums + jax.lax.dot_general(
                onehot, xcf,
                dimension_numbers=(((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
            counts = counts + jnp.sum(onehot, axis=0)
            # Reseed candidates from this chunk:
            #  - highest-distortion rows (points no centroid serves —
            #    orphaned modes), and
            #  - a stratified row sample with its assignment (split
            #    donors for overfull clusters).
            d_min = jnp.where(w > 0, jnp.min(d, axis=-1), -jnp.inf)
            d_tot = d_tot + jnp.sum(jnp.maximum(d_min, 0.0) * w)
            top_v, top_i = jax.lax.top_k(d_min, n_cand)
            stride = max(d_min.shape[0] // n_cand, 1)
            samp = jnp.arange(n_cand, dtype=jnp.int32) * stride
            return (sums, counts, d_tot), (
                a.astype(jnp.int32), top_v, xcf[top_i],
                xcf[samp], a[samp].astype(jnp.int32),
            )

        (sums, counts, d_tot), (assigns, cand_v, cand_x, samp_x, samp_a) = (
            jax.lax.scan(
                chunk_body,
                (jnp.zeros((k, dim), jnp.float32),
                 jnp.zeros((k,), jnp.float32), jnp.float32(0.0)),
                (chunks, valid, row_ids),
            )
        )
        new_centroids = jnp.where(
            (counts > 0)[:, None], sums / jnp.maximum(counts, 1.0)[:, None],
            centroids,
        )
        # Rebalance (plain keep-old — the reference behavior,
        # ``ivf_flat_index.cpp:117-141`` — leaves bad seeds stuck forever):
        # twin/orphan reseeding, shared with the DP trainer — see
        # ``_reseed_step`` for the full rationale and measurements.
        new_centroids = _reseed_step(
            new_centroids, counts, cand_v, cand_x, samp_x, samp_a,
            d_tot, n_orig, it, iters, it_key, k,
            split_thresh=split_thresh,
        )
        return new_centroids, assigns

    centroids, assigns = jax.lax.scan(
        lloyd, centroids, (jnp.arange(iters), loop_keys)
    )
    # assigns from the final iteration: [iters, nchunks, C] → last iter.
    final_assigns = assigns[-1].reshape(-1)[:n_orig]
    return centroids, final_assigns
