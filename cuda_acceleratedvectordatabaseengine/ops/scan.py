"""Fused scan + top-k: the hot search op.

The plain XLA form of the reference's ``bruteforce_search_kernel`` (K2,
``engine/kernels.cuh:84-185``) without its per-(query × probe) round trip
(``engine/ivf_flat_index.cpp:521-617`` — separate alloc, H2D, kernel launch,
D2H, and stream sync for *every* list). The entire probed-list scan for a
whole query batch is one traced program: a ``lax.scan`` over probe steps, each
step doing a fixed-shape arena gather + a batched contraction + a fused
top-k merge, all device-resident with zero host round trips. It is the
reference the list-grouped kernel (``ops/grouped_scan``) is checked against,
and the scan the CPU runs.

Candidate identity is carried as an int32 *global arena position*
``list_id * list_capacity + slot`` (or row id for the flat scan); ``-1`` marks
invalid slots — the device analog of the reference's UINT64_MAX sentinel
(``engine/ivf_flat_index.cpp:380-383``). The host maps positions to user ids.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_acceleratedvectordatabaseengine.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest


def _block_distances(
    q: jax.Array,          # [B, D] fp32
    block: jax.Array,      # [B, L, D] arena dtype
    block_sq: jax.Array,   # [B, L] fp32 (only used for L2)
    q_sq: jax.Array,       # [B] fp32
    metric: Metric,
    dots_scale: jax.Array | None = None,   # [B, L] fp32 (int8 dequant)
    dots_bias: jax.Array | None = None,    # [B] fp32 (q·anchor, residual)
) -> jax.Array:
    """Per-query distances to a gathered block: [B, L] fp32.

    The contraction ``bd,bld->bl`` is a batched matvec; with the arena in
    bfloat16 it accumulates in fp32 (preferred_element_type). int8
    arenas contract in fp32 after cast; ``q·x̂`` is recovered as
    ``dots_bias + dots_scale ⊙ (q·code)`` (per-row scales, optional residual
    anchor term; norms stay exact fp32 in ``block_sq``).
    """
    cdtype = jnp.float32 if block.dtype == jnp.int8 else block.dtype
    dots = jax.lax.dot_general(
        q.astype(cdtype), block.astype(cdtype),
        dimension_numbers=(((1,), (2,)), ((0,), (0,))),
        preferred_element_type=jnp.float32,
    )
    if dots_scale is not None:
        dots = dots * dots_scale
    if dots_bias is not None:
        dots = dots + dots_bias[:, None]
    if metric == Metric.L2:
        return jnp.maximum(q_sq[:, None] - 2.0 * dots + block_sq, 0.0)
    elif metric == Metric.INNER_PRODUCT:
        return -dots
    elif metric == Metric.COSINE:
        # Arena vectors and queries are pre-normalized at ingest/entry
        # (the reference normalizes via K6 before indexing for cosine).
        return 1.0 - dots
    raise ValueError(f"unknown metric: {metric}")


def scan_probed_lists(
    queries: jax.Array,     # [B, D] fp32 (pre-normalized if cosine)
    arena: jax.Array,       # [nlist, L, D] corpus dtype (L = local capacity)
    arena_sq: jax.Array,    # [nlist, L] fp32 squared norms (L2)
    counts: jax.Array,      # [nlist] int32 live rows per list (GLOBAL counts)
    probe_ids: jax.Array,   # [B, P] int32, -1 = no probe
    k: int,
    metric: Metric = Metric.L2,
    slot_stride: int = 1,
    slot_offset: jax.Array | int = 0,
    global_capacity: int | None = None,
    vma_axes: tuple = (),
    arena_scale: jax.Array | None = None,   # [nlist, L] fp32, int8 arenas
    arena_anchors: jax.Array | None = None, # [nlist, D] fp32 residual anchors
) -> tuple[jax.Array, jax.Array]:
    """Scan each query's ``P`` probed inverted lists, fusing distance
    computation with an incremental top-k merge.

    Returns ``(dists [B, k] fp32 ascending, pos [B, k] int32 global arena
    positions, -1 for empty)``.

    Multi-chip striping (``parallel/sharded.py``): when the arena's slot axis
    is sharded round-robin across N chips, each chip's local slot ``j`` holds
    the logical slot ``j * N + shard_index``. Pass ``slot_stride=N``,
    ``slot_offset=axis_index``, and the *global* per-list capacity: validity
    masks and returned positions are then in logical (global) space, so the
    host id table needs no restriping and cross-chip merge is a plain top-k
    over gathered candidates.
    """
    batch, dim = queries.shape
    nlist, cap, _ = arena.shape
    global_cap = global_capacity if global_capacity is not None else cap
    q = queries.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    slot_logical = (
        jnp.arange(cap, dtype=jnp.int32) * slot_stride + slot_offset
    )

    init_d = jnp.full((batch, k), jnp.inf, jnp.float32)
    init_p = jnp.full((batch, k), -1, jnp.int32)
    if vma_axes:
        # Inside shard_map the carry becomes device-varying (the arena is
        # sharded); mark the replicated init accordingly for the vma checker.
        init_d = jax.lax.pcast(init_d, vma_axes, to="varying")
        init_p = jax.lax.pcast(init_p, vma_axes, to="varying")

    # q·anchor for every (query, list) once up front — one small matmul.
    qa_all = (
        jax.lax.dot_general(
            q, arena_anchors,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if arena_anchors is not None else None
    )

    def step(carry, lists):
        best_d, best_p = carry
        safe_lists = jnp.maximum(lists, 0)
        block = arena[safe_lists]                       # [B, L, D] gather
        block_sq = arena_sq[safe_lists]                 # [B, L]
        scale = (
            arena_scale[safe_lists] if arena_scale is not None else None
        )
        bias = (
            jnp.take_along_axis(qa_all, safe_lists[:, None], axis=1)[:, 0]
            if qa_all is not None else None
        )
        d = _block_distances(q, block, block_sq, q_sq, metric, scale, bias)
        valid = (slot_logical[None, :] < counts[safe_lists][:, None]) & (
            lists >= 0
        )[:, None]
        d = jnp.where(valid, d, jnp.inf)
        pos = jnp.where(
            valid, safe_lists[:, None] * global_cap + slot_logical[None, :], -1
        )
        best_d, best_p = _merge(best_d, best_p, d, pos, k)
        return (best_d, best_p), None

    (best_d, best_p), _ = jax.lax.scan(
        step, (init_d, init_p), probe_ids.T
    )
    return best_d, best_p


def _merge(best_d, best_p, d, pos, k):
    dd = jnp.concatenate([best_d, d], axis=-1)
    pp = jnp.concatenate([best_p, pos], axis=-1)
    return topk_smallest(dd, k, idx=pp)


def scan_flat(
    queries: jax.Array,    # [B, D] fp32
    data: jax.Array,       # [N_pad, D] corpus dtype
    data_sq: jax.Array,    # [N_pad] fp32, +inf on padded rows
    n_valid: jax.Array,    # scalar int32
    k: int,
    metric: Metric = Metric.L2,
    chunk_size: int = 65536,
) -> tuple[jax.Array, jax.Array]:
    """Exact brute-force scan of the whole corpus with a running top-k.

    The flat-index hot path (BASELINE config #1) and the ground-truth oracle
    for the recall harness the reference never built (``bench/recall_test.cpp``
    is referenced by ``bench/CMakeLists.txt:29-44`` but missing). Chunked over
    N so each step is a dense ``[B, D] x [D, C]`` matmul regardless of
    corpus size.
    """
    n_pad, dim = data.shape
    batch = queries.shape[0]
    cs = min(chunk_size, n_pad)
    rem = (-n_pad) % cs
    if rem:
        # Trace-time padding of the tail chunk; masked out via n_valid.
        data = jnp.pad(data, ((0, rem), (0, 0)))
        data_sq = jnp.pad(data_sq, (0, rem))
        n_pad += rem
    q = queries.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    chunks = data.reshape(-1, cs, dim)
    sq_chunks = data_sq.reshape(-1, cs)
    col_iota = jnp.arange(cs, dtype=jnp.int32)

    init_d = jnp.full((batch, k), jnp.inf, jnp.float32)
    init_p = jnp.full((batch, k), -1, jnp.int32)

    def step(carry, inputs):
        best_d, best_p = carry
        ci, xc, xc_sq = inputs
        dots = jax.lax.dot_general(
            q.astype(xc.dtype), xc,
            dimension_numbers=(((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        if metric == Metric.L2:
            d = jnp.maximum(q_sq[:, None] - 2.0 * dots + xc_sq[None, :], 0.0)
        elif metric == Metric.INNER_PRODUCT:
            d = -dots
        else:
            d = 1.0 - dots
        rows = ci * cs + col_iota
        valid = rows < n_valid
        d = jnp.where(valid[None, :], d, jnp.inf)
        pos = jnp.where(valid, rows, -1)
        best_d, best_p = _merge(
            best_d, best_p, d, jnp.broadcast_to(pos[None, :], d.shape), k
        )
        return (best_d, best_p), None

    (best_d, best_p), _ = jax.lax.scan(
        step,
        (init_d, init_p),
        (jnp.arange(chunks.shape[0], dtype=jnp.int32), chunks, sq_chunks),
    )
    return best_d, best_p
