"""List-grouped probed-list scan: one Triton kernel fuses dequantization,
distance and a per-row top-k.

The hot search op on the GPU. Every (query, probe) pair of a batch is sorted
by list id and packed into *list-rows* of up to ``M`` same-list queries
(:func:`pack_pairs_into_rows`). One kernel program takes one row: it walks
the list's occupied slot tiles, widens each int8 tile to bf16 in registers,
multiplies it against the row's ``M`` queries on the tensor cores, applies
the per-row scale, the residual anchor and the stored norm, and folds the
tile into a running top-k kept in registers. Only ``M·k`` candidates per row
are written; a small XLA epilogue merges ``nprobe·k`` candidates per query.
The plain XLA alternative writes ``[B·P, cap]`` fp32 distances and reads
them back for the top-k.

This is the fused design the reference engine aimed at with its K2
``bruteforce_search_kernel`` (``engine/kernels.cuh:84-185``: query cached in
shared memory, per-thread top-k, cross-thread reduction left as a stub), run
over list-grouped rows instead of one launch per (query, list).

Precision: int8 and bf16 codes are exact in bf16. The fp32 query is split
into bf16 hi and lo halves (:func:`split_bf16`) and both halves are
multiplied on the tensor cores with fp32 accumulation, which keeps about 16
mantissa bits of the query. fp32 arenas take IEEE fp32 products instead
(off the tensor cores; they are not the serving layout). The anchor dot and
the query norm are fp32 sums.

Shapes. Any feature width, capacity and k run here. A width with no
power-of-two divisor of at least 16 (GloVe's 100, 200, 300) is split into
64-wide chunks whose last one is loaded under a mask; a list capacity below
one 16-slot tile is loaded under a slot mask. A k above ``MAX_K`` (deep
rerank shortlists, the API's top-1000) runs the kernel in passes of
``MAX_K``: each pass keeps only candidates above the previous pass's worst
(distance, slot), so the passes together are the exact top-k.

Quantization contract (``models/arena.PackedListArena``): a stored point is
``x̂ = anchor[l] + scale[l, slot] · code`` (anchor 0 / scale 1 when absent)
and ``arena_sq`` holds ``‖x̂‖²``, so ``q·x̂ = q·anchor[l] + scale ⊙ (q·code)``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from cuda_acceleratedvectordatabaseengine.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest

SLOT_TILE = 128              # slots per tile of the in-kernel loop
ROW_WIDTHS = (16, 32)        # queries per list-row (tensor-core M ≥ 16)
MAX_K = 64                   # deepest in-kernel top-k (registers)
_DOT_MIN = 16                # Triton's smallest dot operand dimension


def _pow2_divisor(n: int, limit: int = 256) -> int:
    """Largest power of two ≤ ``limit`` that divides ``n``."""
    p = 1
    while p * 2 <= limit and n % (p * 2) == 0:
        p *= 2
    return p


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def split_bf16(x):
    """``x ≈ hi + lo`` with both halves exact in bf16: ``hi`` is ``x``
    rounded to its top 16 bits and ``lo`` the rounded remainder, so the
    pair keeps about 16 mantissa bits. Rounded with integer arithmetic,
    which no compiler may fold away (XLA may elide an ``fp32 → bf16 →
    fp32`` round trip as excess precision, which would zero ``lo``)."""
    x = x.astype(jnp.float32)
    bits = jax.lax.bitcast_convert_type(x, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(
        (bits + jnp.uint32(0x8000)) & jnp.uint32(0xFFFF0000), jnp.float32
    )
    return hi.astype(jnp.bfloat16), (x - hi).astype(jnp.bfloat16)


def dim_chunk(dim: int) -> int:
    """Feature-axis chunk of the kernel's dot loop: the largest power-of-two
    divisor of ``dim`` up to 256 when it is at least 16 (no mask), else 64
    (or the next power of two of a smaller ``dim``), the last chunk loaded
    under a mask."""
    p = _pow2_divisor(dim)
    if p >= _DOT_MIN:
        return p
    return min(64, max(_DOT_MIN, _next_pow2(dim)))


def slot_tile(cap: int) -> int:
    """Slots per tile: the largest power of two ≤ ``cap``, within
    [16, ``SLOT_TILE``]; a capacity under 16 is loaded under a mask."""
    return max(_DOT_MIN, min(SLOT_TILE, 1 << (cap.bit_length() - 1)))


def local_counts(counts, cap, slot_stride, slot_offset):
    """Valid LOCAL slots per list under round-robin slot striping.

    With the arena's slot axis striped across N devices (local slot ``j`` on
    shard ``s`` holds logical slot ``j*N + s`` — see ``parallel/sharded``),
    the in-kernel validity test stays ``local_slot < count`` when the kernel
    gets the per-shard count ``ceil((count - offset) / N)``."""
    if slot_stride == 1:
        return jnp.minimum(counts, cap)
    lc = (counts - slot_offset + slot_stride - 1) // slot_stride
    return jnp.clip(lc, 0, cap).astype(counts.dtype)


def auto_m(n_pairs: int, nlist: int) -> int:
    """Queries per list-row: the smallest width that holds the mean number
    of pairs per list, within ``ROW_WIDTHS`` (the fastest width at every
    serving shape timed on the card; PERF.md)."""
    mean = n_pairs / max(nlist, 1)
    for w in ROW_WIDTHS:
        if mean <= w:
            return w
    return ROW_WIDTHS[-1]


def row_bound(n_pairs: int, nlist: int, m: int) -> int:
    """Static number of list-rows: full rows plus one partial row per list
    (and the invalid-probe group), and never more rows than pairs."""
    return max(min(n_pairs // m + nlist + 1, n_pairs), 1)


def pack_pairs_into_rows(probe_ids, nlist: int, m: int, n_rows: int):
    """Sort (query, probe) pairs by list id and pack them into list-rows of
    up to ``m`` same-list queries.

    Returns ``(order, key_sorted, row_of_pair, m_of_pair, row_list,
    qrow_table)``: ``row_list [n_rows]`` maps row → list id (``nlist`` for
    unused rows) and ``qrow_table [n_rows, m]`` maps (row, lane) → query
    index (−1 empty)."""
    batch, nprobe = probe_ids.shape
    n_pairs = batch * nprobe
    flat = probe_ids.reshape(-1)
    pair_b = jnp.arange(n_pairs, dtype=jnp.int32) // nprobe
    key = jnp.where(flat >= 0, flat, nlist)             # invalid → sentinel
    order = jnp.argsort(key, stable=True)
    key_sorted = key[order]
    gcounts = jax.ops.segment_sum(
        jnp.ones((n_pairs,), jnp.int32), key_sorted, num_segments=nlist + 1,
    )
    gstart = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32), jnp.cumsum(gcounts)[:-1].astype(
            jnp.int32)]
    )
    r_in_list = jnp.arange(n_pairs, dtype=jnp.int32) - gstart[key_sorted]
    rows_per_list = -(-gcounts // m)
    row_offset = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(rows_per_list)[:-1].astype(jnp.int32)]
    )
    row_of_pair = row_offset[key_sorted] + r_in_list // m
    m_of_pair = r_in_list % m
    row_list = jnp.full((n_rows,), nlist, jnp.int32).at[row_of_pair].set(
        key_sorted
    )
    qrow_table = jnp.full((n_rows, m), -1, jnp.int32).at[
        row_of_pair, m_of_pair
    ].set(jnp.where(flat[order] >= 0, pair_b[order], -1))
    return order, key_sorted, row_of_pair, m_of_pair, row_list, qrow_table


def _grouped_epilogue(out_d, out_s, pack, batch, nprobe, k, nlist,
                      global_cap, slot_stride, slot_offset, approx):
    """Per-pair candidates back to (b, p) order, local slots to logical
    positions, then one top-k over ``nprobe·w`` candidates per query
    (``w ≥ k`` candidates per pair)."""
    order, key_sorted, row_of_pair, m_of_pair, _, _ = pack
    w = out_d.shape[-1]
    pair_d = out_d[row_of_pair, m_of_pair]             # [BP, w]
    pair_s = out_s[row_of_pair, m_of_pair]
    real = (
        (pair_s >= 0) & (key_sorted[:, None] < nlist) & jnp.isfinite(pair_d)
    )
    pair_d = jnp.where(real, pair_d, jnp.inf)
    pair_pos = jnp.where(
        real,
        key_sorted[:, None] * global_cap + (pair_s * slot_stride + slot_offset),
        -1,
    )
    inv = jnp.argsort(order)
    d = pair_d[inv].reshape(batch, nprobe * w)
    pos = pair_pos[inv].reshape(batch, nprobe * w)
    return topk_smallest(d, k, idx=pos, approx=approx)


def _fold_tile(d, slot, best_d, best_s, col):
    """Merge one tile of distances ``d [M, T]`` into the running top-k
    ``best [M, K]``: extract the tile's minimum and let it replace the row's
    worst kept candidate, until no row's tile minimum beats its worst. After
    the first tiles the threshold is tight, so most tiles take one or two
    passes instead of ``k``. Order is by (distance, slot): ties keep the
    lower slot, so the kept set is exact at a tie and a later pass can
    resume strictly after its worst."""
    big = jnp.int32(2 ** 30)

    def cond(carry):
        d_cur, bd, _ = carry
        worst = jnp.max(bd, axis=1)
        better = jnp.where(jnp.min(d_cur, axis=1) < worst, 1, 0)
        return jnp.max(better) > 0

    def body(carry):
        d_cur, bd, bs = carry
        v = jnp.min(d_cur, axis=1, keepdims=True)
        s = jnp.min(jnp.where(d_cur == v, slot, big), axis=1, keepdims=True)
        worst = jnp.max(bd, axis=1, keepdims=True)
        is_worst = bd == worst
        wslot = jnp.max(jnp.where(is_worst, bs, -1), axis=1, keepdims=True)
        wcol = jnp.min(jnp.where(is_worst & (bs == wslot), col, big), axis=1,
                       keepdims=True)
        put = (col == wcol) & (v < worst)
        bd = jnp.where(put, v, bd)
        bs = jnp.where(put, s, bs)
        d_cur = jnp.where(slot == s, jnp.inf, d_cur)
        return d_cur, bd, bs

    _, best_d, best_s = jax.lax.while_loop(cond, body, (d, best_d, best_s))
    return best_d, best_s


def _kernel(*refs, metric: Metric, k: int, tile: int, dchunk: int,
            fp32_block: bool, has_scale: bool, has_anchor: bool,
            has_floor: bool):
    (row_list_ref, qrow_ref, counts_ref, q_ref, qhi_ref, qlo_ref, qsq_ref,
     arena_ref, sq_ref) = refs[:9]
    pos = 9
    scale_ref = anchor_ref = floor_d_ref = floor_s_ref = None
    if has_scale:
        scale_ref = refs[pos]
        pos += 1
    if has_anchor:
        anchor_ref = refs[pos]
        pos += 1
    if has_floor:
        floor_d_ref, floor_s_ref = refs[pos:pos + 2]
        pos += 2
    out_d_ref, out_s_ref = refs[pos:pos + 2]

    i = pl.program_id(0)
    nlist = counts_ref.shape[0]
    m = qrow_ref.shape[1]
    cap, dim = arena_ref.shape[1:]
    k_pad = out_d_ref.shape[-1]
    n_chunks = q_ref.shape[1] // dchunk    # queries are zero-padded to it
    slot_masked = cap < tile

    lid = row_list_ref[i]
    safe_l = jnp.minimum(lid, nlist - 1)
    # Unused rows carry the sentinel list id: zero tiles, inf/-1 output.
    count = jnp.where(lid < nlist, counts_ref[safe_l], 0)
    qi = jnp.maximum(qrow_ref[i, :], 0)                 # [M] query indices

    if has_anchor:
        qa = jnp.zeros((m,), jnp.float32)
        for c in range(n_chunks):
            ds = pl.ds(c * dchunk, dchunk)
            qa += jnp.sum(q_ref[qi, ds] * anchor_ref[safe_l, ds][None, :],
                          axis=1)
        qa = qa[:, None]                                # [M, 1] q·anchor
    q_sq = qsq_ref[qi][:, None] if metric == Metric.L2 else None
    if has_floor:
        floor_d = floor_d_ref[i, :][:, None]            # [M, 1]
        floor_s = floor_s_ref[i, :][:, None]

    lane = jax.lax.broadcasted_iota(jnp.int32, (m, tile), 1)
    col = jax.lax.broadcasted_iota(jnp.int32, (m, k_pad), 1)
    blk_slot = jax.lax.broadcasted_iota(jnp.int32, (tile, dchunk), 0)
    blk_feat = jax.lax.broadcasted_iota(jnp.int32, (tile, dchunk), 1)

    def load_block(t0, c):
        """Arena tile ``[T, DC]``; slots past a sub-tile capacity and
        features past ``dim`` (last chunk only) are masked to zero."""
        feat_masked = (c + 1) * dchunk > dim
        # A traced start: a static slice may not run past ``dim``.
        f0 = jnp.int32(c * dchunk) if feat_masked else c * dchunk
        ref = arena_ref.at[safe_l, pl.ds(t0, tile), pl.ds(f0, dchunk)]
        if not (slot_masked or feat_masked):
            return ref[...]
        mask = jnp.ones((tile, dchunk), jnp.bool_)
        if slot_masked:
            mask &= blk_slot < cap
        if feat_masked:
            mask &= blk_feat < dim - c * dchunk
        return plgpu.load(ref, mask=mask, other=0)

    def load_slots(ref2d, t0):
        """Per-slot values ``[T]`` of list ``safe_l`` (masked under a
        sub-tile capacity)."""
        ref = ref2d.at[safe_l, pl.ds(t0, tile)]
        if not slot_masked:
            return ref[...]
        mask = jax.lax.broadcasted_iota(jnp.int32, (tile,), 0) < cap
        return plgpu.load(ref, mask=mask, other=0)

    def tile_body(j, carry):
        best_d, best_s = carry
        base = j * tile
        # The last tile of a list whose count is not a tile multiple starts
        # early enough to stay inside the arena; slots below ``base`` were
        # folded by the previous tile and are masked here.
        t0 = base if slot_masked else jnp.minimum(base, cap - tile)
        acc = jnp.zeros((m, tile), jnp.float32)
        for c in range(n_chunks):
            ds = pl.ds(c * dchunk, dchunk)
            blk = load_block(t0, c)                         # [T, DC]
            if fp32_block:
                acc += pl.dot(q_ref[qi, ds], blk, trans_b=True,
                              precision=jax.lax.Precision.HIGHEST)
            else:
                bh = blk.astype(jnp.bfloat16)               # exact
                acc += pl.dot(qlo_ref[qi, ds], bh, trans_b=True)
                acc += pl.dot(qhi_ref[qi, ds], bh, trans_b=True)
        qx = acc
        if has_scale:
            qx = qx * load_slots(scale_ref, t0)[None, :]
        if has_anchor:
            qx = qx + qa
        if metric == Metric.L2:
            d = jnp.maximum(
                q_sq - 2.0 * qx + load_slots(sq_ref, t0)[None, :], 0.0,
            )
        elif metric == Metric.INNER_PRODUCT:
            d = -qx
        else:                   # cosine over pre-normalized vectors
            d = 1.0 - qx
        slot = t0 + lane
        keep = (slot >= base) & (slot < count)
        if has_floor:           # strictly after the previous pass's worst
            keep &= (d > floor_d) | ((d == floor_d) & (slot > floor_s))
        d = jnp.where(keep, d, jnp.inf)
        return _fold_tile(d, slot, best_d, best_s, col)

    # Padding columns (≥ k) hold -inf so they are never the worst.
    init = (
        jnp.where(col < k, jnp.inf, -jnp.inf).astype(jnp.float32),
        jnp.full((m, k_pad), -1, jnp.int32),
    )
    n_tiles = (count + tile - 1) // tile
    best_d, best_s = jax.lax.fori_loop(0, n_tiles, tile_body, init)
    out_d_ref[...] = best_d
    out_s_ref[...] = best_s


def _scan_in_passes(scan, operands, n_pass, k_pass, lanes):
    """Top ``n_pass·k_pass`` per (row, lane) from ``n_pass`` kernel passes:
    each pass keeps the ``k_pass`` best (distance, slot) strictly after the
    previous pass's worst. A pass that found fewer than ``k_pass`` exhausts
    the lane (its floor becomes +inf)."""
    floor_d = jnp.full(lanes, -jnp.inf, jnp.float32)
    floor_s = jnp.full(lanes, -1, jnp.int32)
    ds, ss = [], []
    for _ in range(n_pass):
        d, s = scan(*operands, floor_d, floor_s)
        d, s = d[:, :, :k_pass], s[:, :, :k_pass]
        ds.append(d)
        ss.append(s)
        valid = s >= 0
        worst = jnp.max(jnp.where(valid, d, -jnp.inf), axis=-1)
        floor_s = jnp.max(
            jnp.where(valid & (d == worst[..., None]), s, -1), axis=-1
        )
        floor_d = jnp.where(jnp.all(valid, axis=-1), worst, jnp.inf)
    return jnp.concatenate(ds, axis=-1), jnp.concatenate(ss, axis=-1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "approx", "interpret", "m",
                     "slot_stride", "global_capacity"),
)
def scan_probed_lists_grouped(
    queries: jax.Array,     # [B, D] fp32 (pre-normalized if cosine)
    arena: jax.Array,       # [nlist, cap, D] int8 | bf16 | fp32
    arena_sq: jax.Array,    # [nlist, cap] fp32 ‖x̂‖²
    counts: jax.Array,      # [nlist] int32 (GLOBAL counts)
    probe_ids: jax.Array,   # [B, P] int32, -1 = no probe
    k: int,
    metric: Metric = Metric.L2,
    approx: bool = False,
    interpret: bool = False,
    m: int | None = None,
    arena_scale: jax.Array | None = None,    # [nlist, cap] fp32 (int8)
    arena_anchors: jax.Array | None = None,  # [nlist, D] fp32 (int8)
    slot_stride: int = 1,
    slot_offset: jax.Array | int = 0,
    global_capacity: int | None = None,
) -> tuple[jax.Array, jax.Array]:
    """List-grouped fused scan (Triton kernel) with the
    ``ops/scan.scan_probed_lists`` contract: ``(dists [B, k] ascending,
    global positions [B, k], -1 empty)``, including slot striping.

    Each list loops over its own occupied tiles only (its count bounds the
    loop), so allocation headroom above the fill costs nothing."""
    batch, nprobe = probe_ids.shape
    nlist, cap, dim = arena.shape
    global_cap = global_capacity if global_capacity is not None else cap
    kcounts = local_counts(counts, cap, slot_stride, slot_offset)
    n_pairs = batch * nprobe
    m = m or auto_m(n_pairs, nlist)
    n_rows = row_bound(n_pairs, nlist, m)
    tile = slot_tile(cap)
    dchunk = dim_chunk(dim)
    dim_pad = -(-dim // dchunk) * dchunk
    k_pass = min(k, MAX_K)
    n_pass = -(-k // k_pass)
    k_pad = max(_DOT_MIN, _next_pow2(k_pass))

    def pad_dim(x):
        return jnp.pad(x, ((0, 0), (0, dim_pad - dim)))

    q = queries.astype(jnp.float32)
    q_sq = jnp.sum(q * q, axis=-1)
    q = pad_dim(q)
    q_hi, q_lo = split_bf16(q)
    pack = pack_pairs_into_rows(probe_ids, nlist, m, n_rows)
    row_list, qrow_table = pack[4], pack[5]

    has_scale = arena_scale is not None
    has_anchor = arena_anchors is not None
    operands = [row_list, qrow_table, kcounts.astype(jnp.int32), q, q_hi,
                q_lo, q_sq, arena, arena_sq]
    if has_scale:
        operands.append(arena_scale.astype(jnp.float32))
    if has_anchor:
        operands.append(pad_dim(arena_anchors.astype(jnp.float32)))
    out_block = pl.BlockSpec((None, m, k_pad), lambda i: (i, 0, 0))
    n_in = len(operands) + (2 if n_pass > 1 else 0)
    scan = pl.pallas_call(
        functools.partial(
            _kernel, metric=metric, k=k_pass, tile=tile, dchunk=dchunk,
            fp32_block=arena.dtype == jnp.float32, has_scale=has_scale,
            has_anchor=has_anchor, has_floor=n_pass > 1,
        ),
        grid=(n_rows,),
        in_specs=[pl.no_block_spec] * n_in,
        out_specs=(out_block, out_block),
        out_shape=(
            jax.ShapeDtypeStruct((n_rows, m, k_pad), jnp.float32),
            jax.ShapeDtypeStruct((n_rows, m, k_pad), jnp.int32),
        ),
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=4 if m * tile <= 4096 else 8, num_stages=2,
        ),
        interpret=interpret,
        name="grouped_list_scan",
    )
    if n_pass == 1:
        out_d, out_s = scan(*operands)
        out_d, out_s = out_d[:, :, :k], out_s[:, :, :k]
    else:   # all n_pass·k_pass: a pass's own output is not sorted
        out_d, out_s = _scan_in_passes(scan, operands, n_pass, k_pass,
                                       (n_rows, m))
    return _grouped_epilogue(
        out_d, out_s, pack, batch, nprobe, k, nlist,
        global_cap, slot_stride, slot_offset, approx,
    )

