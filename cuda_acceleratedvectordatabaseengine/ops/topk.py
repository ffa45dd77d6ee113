"""Top-k selection and merge.

This implements — correctly — the piece the reference stubbed: its CUDA
bruteforce kernel keeps a per-thread insertion-sorted top-k but never reduces
across threads ("only thread 0 for now", ``engine/kernels.cuh:172-184``), so
block results silently drop candidates. Here top-k is an XLA op
(``jax.lax.top_k``, or the 4-lane tournament below where it measures faster)
and cross-block merge is a concat + re-select.

All selection here is over *distances* (smaller = closer). Invalid slots are
encoded as ``+inf`` distance / ``-1`` index, the device analog of the
reference's FLT_MAX / UINT64_MAX sentinels (``engine/ivf_flat_index.cpp:380-383``).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _topk_tournament(d: jax.Array, k: int) -> tuple[jax.Array, jax.Array]:
    """Exact k-smallest over ``d [B, N]`` via a 4-lane tournament.

    Fold the row into four quarter-width (value, col) lanes, sort the four
    lanes per column (5 compare-swap stages), then run k min-extraction
    passes at QUARTER width with loser promotion. Exact values and an
    exact k-smallest set; tie ORDER may differ from the sort-based path
    (any consistent tie-break is a valid top-k). At the coarse
    probe-selection shape [8192, 4096] on an H100 it is faster than
    ``lax.top_k`` for k ≤ 16 and ties it at k = 32 (PERF.md, "Kernel
    decisions (H100)").
    """
    if d.ndim != 2:
        raise ValueError(f"tournament top-k needs a 2-D input, got "
                         f"shape {d.shape}")
    b, n = d.shape
    if n % 4:
        raise ValueError(f"tournament top-k needs N % 4 == 0, got N={n}")
    w = n // 4
    # Pin the input: without the barrier XLA may rematerialize the
    # producer (here: the whole coarse distance matmul) into each of the
    # k extraction passes when this runs inside a larger program.
    d = jax.lax.optimization_barrier(d)
    vals = list(jnp.split(d, 4, axis=1))
    slot0 = jnp.arange(w, dtype=jnp.int32)[None, :]
    slots = [jnp.broadcast_to(slot0 + i * w, (b, w)) for i in range(4)]

    def _cas(i, j):
        c = vals[j] < vals[i]
        vals[i], vals[j] = (
            jnp.where(c, vals[j], vals[i]), jnp.where(c, vals[i], vals[j])
        )
        slots[i], slots[j] = (
            jnp.where(c, slots[j], slots[i]),
            jnp.where(c, slots[i], slots[j]),
        )

    _cas(0, 1)
    _cas(2, 3)
    _cas(0, 2)
    _cas(1, 3)
    _cas(1, 2)

    # Same remat hazard for the lane sort: the k extraction passes must
    # consume ONE materialized sort, not k replays of it.
    w0, w1, w2, w3, s0, s1, s2, s3 = jax.lax.optimization_barrier(
        tuple(vals) + tuple(slots)
    )
    out_v, out_s = [], []
    for _ in range(k):
        v = jnp.min(w0, axis=1, keepdims=True)
        am = jnp.argmin(w0, axis=1)
        out_v.append(v)
        out_s.append(jnp.take_along_axis(s0, am[:, None], axis=1))
        sel = jax.nn.one_hot(am, w, dtype=jnp.bool_)
        w0 = jnp.where(sel, w1, w0)
        s0 = jnp.where(sel, s1, s0)
        w1 = jnp.where(sel, w2, w1)
        s1 = jnp.where(sel, s2, s1)
        w2 = jnp.where(sel, w3, w2)
        s2 = jnp.where(sel, s3, s2)
        w3 = jnp.where(sel, jnp.inf, w3)
    return jnp.concatenate(out_v, axis=1), jnp.concatenate(out_s, axis=1)


def topk_smallest(
    d: jax.Array,
    k: int,
    idx: jax.Array | None = None,
    approx: bool = False,
    recall_target: float = 0.99,
    impl: str = "auto",
) -> tuple[jax.Array, jax.Array]:
    """Select the k smallest entries of ``d [..., N]``.

    Returns ``(dists [..., k], indices [..., k])`` sorted ascending. If
    ``idx`` is given, it supplies the identity of each column (e.g. global
    arena positions) and is gathered instead of returning column numbers.

    ``approx=True`` uses ``jax.lax.approx_min_k`` (on the GPU it lowers
    to a sort as well and measured no faster; PERF.md).

    The exact path auto-dispatches to the 4-lane tournament
    (:func:`_topk_tournament`) where it measured faster than ``lax.top_k``
    on the card: 2-D input, N % 512 == 0, shallow k (3..16 — extraction
    is linear in k; at k = 32 the two tie), N in the coarse-selection
    regime (2048..8192 — wider shapes would pin 8 lane buffers of N/4
    columns across k passes), and enough total work to amortize the fold
    (B·N ≥ 2²¹; tiny shapes keep the sort path and its tie order).
    ``impl`` forces ``"sort"`` / ``"tournament"``.
    """
    if approx:
        vals, cols = jax.lax.approx_min_k(d, k, recall_target=recall_target)
    elif impl == "tournament" or (
        impl == "auto"
        and d.ndim == 2
        and jnp.issubdtype(d.dtype, jnp.floating)
        and d.shape[-1] % 512 == 0
        and 2048 <= d.shape[-1] <= 8192
        and 3 <= k <= 16
        and d.shape[0] * d.shape[-1] >= (1 << 21)
    ):
        vals, cols = _topk_tournament(d, k)
    else:
        neg_vals, cols = jax.lax.top_k(-d, k)
        vals = -neg_vals
    if idx is not None:
        out_idx = jnp.take_along_axis(idx, cols, axis=-1)
    else:
        out_idx = cols
    return vals, out_idx


def merge_topk(
    d_a: jax.Array,
    i_a: jax.Array,
    d_b: jax.Array,
    i_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Merge two top-k candidate sets along the last axis and re-select k.

    The device-side replacement for the reference's host ``merge_results``
    sort+dedup loop (``engine/ivf_flat_index.cpp:474-518``). Dedup is
    unnecessary here: every vector lives in exactly one inverted list, so a
    global arena position appears at most once across partial results.
    """
    d = jnp.concatenate([d_a, d_b], axis=-1)
    i = jnp.concatenate([i_a, i_b], axis=-1)
    return topk_smallest(d, k, idx=i)
