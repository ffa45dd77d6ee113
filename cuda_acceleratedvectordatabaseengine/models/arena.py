"""Packed, padded inverted-list arena — the device list storage layout.

The reference stores each inverted list as a ragged host ``std::vector`` with
an optional GPU mirror (``engine/ivf_flat_index.h:24-36``) and pays a separate
alloc + H2D copy per probed list per query (``engine/ivf_flat_index.cpp:
387-444``). JAX compiles static shapes, so lists live in ONE
device-resident padded tensor:

    arena     [nlist, capacity, dim]   corpus dtype (bfloat16 by default)
    arena_sq  [nlist, capacity]        fp32 squared norms (L2 fast path)
    counts    [nlist]                  int32 live rows
    ids       [nlist, capacity]        uint64, host-side

A vector's identity on device is its int32 global position
``list_id * capacity + slot``; the host maps positions back to user ids.
Appends are device scatters (``dynamic_update_slice`` semantics via indexed
``.at[].set``); capacity growth reallocates with padding in one fused pad op,
mirroring the reference's evict-and-reload invalidation
(``ivf_flat_index.cpp:194-197``) without ever dropping device residency.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

INVALID_ID = np.uint64(0xFFFFFFFFFFFFFFFF)  # reference sentinel UINT64_MAX


@functools.partial(jax.jit, donate_argnums=(0, 1, 7))
def _append_device(arena, arena_sq, counts, lists, slots, vec_f32, per_list,
                   arena_lo=None, arena_scale=None, anchors=None):
    """Scatter-append a batch into the arena as ONE compiled program (the
    unjitted op-by-op version paid a separate XLA compile + dispatch per
    scatter, which dominated ingest time).

    int8 arenas use PER-ROW symmetric scales (``arena_scale[list, slot]``):
    each appended row quantizes independently, so no cross-row amax coupling
    and no dependence on what the list already holds. With ``anchors`` set
    (residual mode) the row encodes ``x − anchor[list]`` — residual ranges
    are ~4× tighter on clustered corpora, quartering quantization noise at
    the same 8 bits (standard IVF residual-encoding practice, cf. FAISS)."""
    if arena.dtype == jnp.int8:
        a_rows = anchors[lists] if anchors is not None else 0.0
        res = vec_f32 - a_rows
        row_amax = jnp.max(jnp.abs(res), axis=-1)
        row_scale = jnp.maximum(row_amax, 1e-12) / 127.0
        hi_f = jnp.clip(jnp.round(res / row_scale[:, None]), -127, 127)
        hi = hi_f.astype(jnp.int8)
        deq = a_rows + hi_f * row_scale[:, None]
        arena_scale = arena_scale.at[lists, slots].set(row_scale)
    else:
        hi = vec_f32.astype(arena.dtype)
        deq = hi.astype(jnp.float32)
    arena = arena.at[lists, slots].set(hi)
    # norms of the STORED (dequantized) representation — scan distances are
    # distances to the stored point (see _bulk_pack_device).
    arena_sq = arena_sq.at[lists, slots].set(jnp.sum(deq * deq, -1))
    if arena_lo is not None:
        lo = (vec_f32 - deq).astype(jnp.bfloat16)
        arena_lo = arena_lo.at[lists, slots].set(lo)
    return arena, arena_sq, counts + per_list, arena_lo, arena_scale


@functools.partial(jax.jit, donate_argnums=(0, 1, 6, 7))
def _remove_device(arena, arena_sq, counts, src, dst, count_delta,
                   arena_lo=None, arena_scale=None):
    """Swap-from-tail compaction as ONE donated program: move the surviving
    tail rows (flat global positions ``src``) into the holes (``dst``) and
    shrink ``counts``. The hole/tail plan is computed host-side (the ids
    table lives on the host anyway); the device only does one batched
    gather→scatter per plane, so a delete costs O(moved rows), not
    O(list length)."""
    nlist, cap, dim = arena.shape
    flat = arena.reshape(nlist * cap, dim)
    arena = flat.at[dst].set(flat[src]).reshape(nlist, cap, dim)
    sq = arena_sq.reshape(-1)
    arena_sq = sq.at[dst].set(sq[src]).reshape(nlist, cap)
    if arena_lo is not None:
        lo = arena_lo.reshape(nlist * cap, dim)
        arena_lo = lo.at[dst].set(lo[src]).reshape(nlist, cap, dim)
    if arena_scale is not None:
        sc = arena_scale.reshape(-1)
        arena_scale = sc.at[dst].set(sc[src]).reshape(nlist, cap)
    return arena, arena_sq, counts + count_delta, arena_lo, arena_scale


def plan_removals(
    counts: np.ndarray, lists: np.ndarray, slots: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side swap-from-tail plan for deleting ``(lists[i], slots[i])``.

    Returns ``(move_lists, src_slots, dst_slots, new_counts)``: moving row
    ``(move_lists[i], src_slots[i])`` → ``(move_lists[i], dst_slots[i])``
    compacts every affected list's live rows into its prefix. For each
    list with deletion set D (|D| = d, fill c, new fill c−d): holes =
    D ∩ [0, c−d), tail survivors = [c−d, c) \\ D — the two sets always
    have equal size, so each hole is filled by one surviving tail row and
    no other row moves. Slots ≥ the list's fill are ignored (stale)."""
    moves_l, moves_src, moves_dst = [], [], []
    new_counts = counts.copy()
    order = np.argsort(lists, kind="stable")
    ls, ss = lists[order], slots[order]
    starts = np.concatenate(
        [[0], np.flatnonzero(np.diff(ls)) + 1, [len(ls)]]
    )
    for a, b in zip(starts[:-1], starts[1:]):
        l = int(ls[a])
        d = np.unique(ss[a:b])
        cnt = int(counts[l])
        d = d[d < cnt]
        if d.size == 0:
            continue
        nc = cnt - d.size
        dset = set(d.tolist())
        holes = [s for s in d.tolist() if s < nc]
        tail = [s for s in range(nc, cnt) if s not in dset]
        moves_l.extend([l] * len(holes))
        moves_src.extend(tail)
        moves_dst.extend(holes)
        new_counts[l] = nc
    return (
        np.asarray(moves_l, np.int64),
        np.asarray(moves_src, np.int64),
        np.asarray(moves_dst, np.int64),
        new_counts,
    )


def apply_removal_to_ids(
    ids_table: np.ndarray,
    move_l: np.ndarray,
    src_s: np.ndarray,
    dst_s: np.ndarray,
    new_counts: np.ndarray,
    old_counts: np.ndarray,
) -> np.ndarray:
    """Mirror a ``plan_removals`` plan onto a host id table (copy-on-write:
    concurrent readers may hold the old table): apply the swap-from-tail
    moves, then invalidate each shrunken list's tail. The single id-side
    implementation behind ``PackedListArena.remove`` and
    ``IVFPQIndex.remove_ids``'s codes-only path."""
    new_ids = ids_table.copy()
    new_ids[move_l, dst_s] = new_ids[move_l, src_s]
    for l in np.flatnonzero(new_counts != old_counts):
        new_ids[l, new_counts[l]: old_counts[l]] = INVALID_ID
    return new_ids


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _append_steps(n: int, max_step: int) -> list[int]:
    """Decompose an append of ``n`` rows into sub-program sizes drawn from a
    fixed power-of-two ladder (plus one odd remainder < the ladder floor).
    Greedy ladder sizes keep the set of distinct jitted shapes — and hence
    compiles — bounded across a many-chunk build, where a
    naive fixed-stride split would mint a fresh trailing shape per chunk
    size. Appends at or under ``max_step`` keep their exact shape (the
    pre-existing behavior for small/server ingest batches)."""
    if n <= max_step:
        return [n]
    ladder = [max_step >> i for i in range(8)]  # 131072 … 1024 by default
    out, rem = [], n
    while rem > 0:
        step = next((s for s in ladder if s <= rem), rem)
        out.append(step)
        rem -= step
    return out


def compute_append_slots(
    counts: np.ndarray, assignments: np.ndarray
) -> np.ndarray:
    """Destination slot for each appended row: current list fill + stable rank
    among same-list rows in the batch (append order matches the reference,
    ``ivf_flat_index.cpp:171-192``)."""
    n = assignments.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.argsort(assignments, kind="stable")
    sorted_lists = assignments[order]
    boundaries = np.flatnonzero(np.diff(sorted_lists)) + 1
    starts = np.concatenate([[0], boundaries])
    sizes = np.diff(np.concatenate([starts, [n]]))
    group_start_of_row = np.repeat(starts, sizes)
    ranks_sorted = np.arange(n) - group_start_of_row
    slots = np.empty(n, np.int64)
    slots[order] = counts[sorted_lists] + ranks_sorted
    return slots


@dataclasses.dataclass
class PackedListArena:
    """Device-resident packed inverted lists + host-side id table."""

    nlist: int
    dim: int
    dtype: jnp.dtype
    capacity: int
    arena: jax.Array       # [nlist, capacity, dim]
    arena_sq: jax.Array    # [nlist, capacity] fp32
    counts: jax.Array      # [nlist] int32
    ids: np.ndarray        # [nlist, capacity] uint64 host
    # Optional residual plane: lo = fp32(x) − bf16(x), stored bf16. hi + lo
    # reconstructs x to ~16 mantissa bits, so an exact rerank can recover
    # fp32-fidelity distances while the hot scan reads only the bf16 hi
    # plane (half the bandwidth of an fp32 arena).
    arena_lo: jax.Array | None = None
    # int8 arenas: PER-ROW symmetric dequant scales ``[nlist, capacity]``
    # (value = anchor + int8 × scale). Kernels read a list's scale row
    # alongside its norms. Norms in arena_sq stay exact
    # fp32 norms of the stored (dequantized) point.
    arena_scale: jax.Array | None = None
    # Optional residual anchors ``[nlist, dim]`` fp32 (normally the coarse
    # centroids): int8 codes encode ``x − anchor[list]``. Reconstruction is
    # ``x̂ = anchor[l] + scale[l, slot] · code``; scans recover ``q·x̂`` as
    # ``q·anchor[l] + scale · (q·code)`` — one extra [1, D] dot per list.
    anchors: jax.Array | None = None

    # Slot-granularity for capacity growth; multiple of the 128-slot
    # tile so every list's block splits into whole kernel tiles.
    SLOT_ALIGN = 128

    # Max rows per `_append_device` program. The append transients scale
    # with the batch (anchor gather + residual + rounding each materialize
    # an [n, dim] fp32 plane: 3×1.43 GB at 500K×768). Sub-chunking bounds
    # them to ~3×0.38 GB while the donated arena planes alias in place; the
    # cost is one extra dispatch per sub-chunk, noise next to the scatter
    # itself.
    APPEND_DEVICE_ROWS = 131_072

    @classmethod
    def create(
        cls, nlist: int, dim: int, dtype=jnp.bfloat16, capacity: int = 128,
        store_residuals: bool = False,
    ) -> "PackedListArena":
        capacity = _round_up(max(capacity, cls.SLOT_ALIGN), cls.SLOT_ALIGN)
        lo = (
            jnp.zeros((nlist, capacity, dim), jnp.bfloat16)
            if store_residuals and jnp.dtype(dtype) != jnp.float32
            else None
        )
        return cls(
            nlist=nlist,
            dim=dim,
            dtype=jnp.dtype(dtype),
            capacity=capacity,
            arena=jnp.zeros((nlist, capacity, dim), dtype),
            arena_sq=jnp.zeros((nlist, capacity), jnp.float32),
            counts=jnp.zeros((nlist,), jnp.int32),
            ids=np.full((nlist, capacity), INVALID_ID, np.uint64),
            arena_lo=lo,
        )

    @property
    def total_vectors(self) -> int:
        return int(np.asarray(self.counts).sum())

    def nbytes_device(self) -> int:
        return (
            self.arena.size * self.arena.dtype.itemsize
            + self.arena_sq.size * 4
            + self.counts.size * 4
        )

    # ------------------------------------------------------------------ #
    # ingest
    # ------------------------------------------------------------------ #

    def append(
        self,
        vectors: np.ndarray | jax.Array,
        ids: np.ndarray,
        assignments: np.ndarray,
    ) -> "PackedListArena":
        """Append ``vectors [n, dim]`` with user ``ids [n]`` into the lists
        given by ``assignments [n]``. Returns the updated arena (functional
        style — the caller swaps its handle, which is what makes epoch swaps
        and concurrent readers trivially safe).

        ``vectors`` may already live on device (fp32) — the ingest path
        uploads once and reuses the buffer for assignment and append.
        """
        n = vectors.shape[0]
        if n == 0:
            return self
        counts_h = np.asarray(self.counts)
        per_list = np.bincount(assignments, minlength=self.nlist)
        needed = counts_h + per_list
        out = self
        max_needed = int(needed.max())
        if max_needed > self.capacity:
            out = out.grow(_round_up(max(max_needed, int(self.capacity * 1.5)),
                                     self.SLOT_ALIGN))
            counts_h = np.asarray(out.counts)

        slots = compute_append_slots(counts_h, assignments)

        scale = out.arena_scale
        if out.dtype == jnp.int8 and scale is None:
            scale = jnp.zeros((out.nlist, out.capacity), jnp.float32)
        # Sub-chunked scatter (see APPEND_DEVICE_ROWS): the slot plan above
        # is global, so disjoint row ranges commute — each program appends
        # its own rows to its own pre-assigned slots. The fp32 staging cast
        # happens PER sub-chunk too (casting the whole batch up front would
        # itself be an [n, dim] fp32 resident, 1.43 GB at 500K×768).
        arena, arena_sq, counts, arena_lo = (
            out.arena, out.arena_sq, out.counts, out.arena_lo
        )
        s0 = 0
        for step in _append_steps(n, self.APPEND_DEVICE_ROWS):
            s1 = s0 + step
            sub_assign = assignments[s0:s1]
            if isinstance(vectors, jax.Array):
                vec_d = vectors[s0:s1].astype(jnp.float32)
            else:
                vec_d = jnp.asarray(
                    np.ascontiguousarray(vectors[s0:s1], np.float32)
                )
            arena, arena_sq, counts, arena_lo, scale = _append_device(
                arena,
                arena_sq,
                counts,
                jnp.asarray(sub_assign.astype(np.int32)),
                jnp.asarray(slots[s0:s1].astype(np.int32)),
                vec_d,
                jnp.asarray(
                    np.bincount(sub_assign, minlength=out.nlist)
                    .astype(np.int32)
                ),
                arena_lo,
                scale,
                out.anchors,
            )
            s0 = s1

        new_ids = out.ids.copy()
        new_ids[assignments, slots] = ids.astype(np.uint64)
        return dataclasses.replace(
            out, arena=arena, arena_sq=arena_sq, counts=counts, ids=new_ids,
            arena_lo=arena_lo, arena_scale=scale,
        )

    def remove(
        self, lists: np.ndarray, slots: np.ndarray
    ) -> tuple["PackedListArena", int]:
        """Delete the rows at ``(lists[i], slots[i])`` by swap-from-tail
        compaction (one donated device program; see ``plan_removals``).
        Returns ``(new_arena, n_removed)``.

        The reference has no deletion at all (not even declared on
        ``IVFFlatIndex``, ``engine/ivf_flat_index.h``) — production vector
        DBs need it, and the packed layout makes it cheap: O(holes) moved
        rows, lists stay prefix-packed so every scan-kernel invariant
        (counts-masking, occupied-prefix bounds) holds unchanged."""
        if lists.size == 0:
            return self, 0
        counts_h = np.asarray(self.counts)
        move_l, src_s, dst_s, new_counts = plan_removals(
            counts_h, lists.astype(np.int64), slots.astype(np.int64)
        )
        n_removed = int((counts_h - new_counts).sum())
        if n_removed == 0:
            return self, 0
        # Host id table mirrors the same moves, then invalidates the tail.
        new_ids = apply_removal_to_ids(
            self.ids, move_l, src_s, dst_s, new_counts, counts_h
        )
        gsrc = jnp.asarray(move_l * self.capacity + src_s, jnp.int32)
        gdst = jnp.asarray(move_l * self.capacity + dst_s, jnp.int32)
        delta = jnp.asarray((new_counts - counts_h).astype(np.int32))
        arena, arena_sq, counts, arena_lo, arena_scale = _remove_device(
            self.arena, self.arena_sq, self.counts, gsrc, gdst, delta,
            self.arena_lo, self.arena_scale,
        )
        return dataclasses.replace(
            self, arena=arena, arena_sq=arena_sq, counts=counts,
            ids=new_ids, arena_lo=arena_lo, arena_scale=arena_scale,
        ), n_removed

    def grow(self, new_capacity: int) -> "PackedListArena":
        """Reallocate with a larger per-list capacity (one device pad op)."""
        assert new_capacity > self.capacity
        pad = new_capacity - self.capacity
        arena = jnp.pad(self.arena, ((0, 0), (0, pad), (0, 0)))
        arena_sq = jnp.pad(self.arena_sq, ((0, 0), (0, pad)))
        arena_lo = (
            jnp.pad(self.arena_lo, ((0, 0), (0, pad), (0, 0)))
            if self.arena_lo is not None else None
        )
        arena_scale = (
            jnp.pad(self.arena_scale, ((0, 0), (0, pad)))
            if self.arena_scale is not None else None
        )
        ids = np.full((self.nlist, new_capacity), INVALID_ID, np.uint64)
        ids[:, : self.capacity] = self.ids
        return dataclasses.replace(
            self, capacity=new_capacity, arena=arena, arena_sq=arena_sq,
            ids=ids, arena_lo=arena_lo, arena_scale=arena_scale,
        )

    # ------------------------------------------------------------------ #
    # id mapping
    # ------------------------------------------------------------------ #

    def positions_to_ids(self, pos: np.ndarray) -> np.ndarray:
        """Map device global positions (int32, -1 = empty) to user uint64 ids
        (UINT64_MAX sentinel for empties, matching ``merge_results``,
        ``engine/ivf_flat_index.cpp:474-518``)."""
        flat = self.ids.reshape(-1)
        safe = np.clip(pos, 0, flat.size - 1)
        out = flat[safe]
        out[pos < 0] = INVALID_ID
        return out

    # ------------------------------------------------------------------ #
    # (de)serialization — packed snapshot arrays for the storage layer
    # ------------------------------------------------------------------ #

    def to_host(self) -> dict:
        """Dequantized fp32 view of the stored vectors (snapshots persist
        values, not codes — per-row scales re-derive exactly on load because
        every row's max residual element saturates ±127 by construction).
        Padded slots stay exactly zero (anchor term masked by count).

        Dequantization happens HOST-side: a device-side fp32 expansion of a
        10M-scale int8 arena is a 4x-sized device transient, and
        downloading the codes moves 4x fewer bytes.
        """
        arena_np = np.asarray(self.arena).astype(np.float32)
        counts = np.asarray(self.counts)
        if self.dtype == jnp.int8 and self.arena_scale is not None:
            arena_np *= np.asarray(self.arena_scale)[:, :, None]
            if self.anchors is not None:
                anchors = np.asarray(self.anchors)
                for l in range(arena_np.shape[0]):   # in place, no 3-D temp
                    arena_np[l, : int(counts[l])] += anchors[l]
        return {
            "arena": arena_np,
            "counts": counts,
            "ids": self.ids,
        }

    @classmethod
    def from_host(
        cls, arena: np.ndarray, counts: np.ndarray, ids: np.ndarray, dtype,
        anchors: np.ndarray | None = None,
    ) -> "PackedListArena":
        nlist, capacity, dim = arena.shape
        arena_f = arena.astype(np.float32)
        arena_scale = None
        anchors_d = None
        if jnp.dtype(dtype) == jnp.int8:
            # Quantize HOST-side: uploading the fp32 arena and quantizing
            # on device needs a >3x-sized device transient — and int8 codes
            # upload 4x fewer bytes anyway.
            live = (
                np.arange(capacity)[None, :]
                < counts.astype(np.int64)[:, None]
            )
            if anchors is not None:
                anchors_f = anchors.astype(np.float32)
                res = np.where(
                    live[:, :, None], arena_f - anchors_f[:, None, :], 0.0
                )
                anchors_d = jnp.asarray(anchors_f)
            else:
                res = arena_f
            amax = np.abs(res).max(axis=-1)                 # per row
            scale_h = np.maximum(amax, 1e-12) / 127.0
            codes = np.clip(
                np.round(res / scale_h[:, :, None]), -127, 127
            ).astype(np.int8)
            # norms of the stored (requantized) representation
            deq = codes.astype(np.float32) * scale_h[:, :, None]
            if anchors is not None:
                deq = np.where(
                    live[:, :, None], deq + anchors_f[:, None, :], 0.0
                )
            sq_h = np.einsum("lcd,lcd->lc", deq, deq, dtype=np.float32)
            dev = jnp.asarray(codes)
            sq = jnp.asarray(sq_h)
            arena_scale = jnp.asarray(scale_h.astype(np.float32))
        else:
            # Cast host-side too: an fp32 upload + device cast doubles both
            # the transfer bytes and the peak HBM during reload.
            host_cast = arena_f.astype(jnp.dtype(dtype))
            dev = jnp.asarray(host_cast)
            sq_h = host_cast.astype(np.float32)
            sq = jnp.asarray(
                np.einsum("lcd,lcd->lc", sq_h, sq_h, dtype=np.float32)
            )
        return cls(
            nlist=nlist,
            dim=dim,
            dtype=jnp.dtype(dtype),
            capacity=capacity,
            arena=dev,
            arena_sq=sq,
            counts=jnp.asarray(counts.astype(np.int32)),
            ids=ids.astype(np.uint64),
            arena_scale=arena_scale,
            anchors=anchors_d,
        )
