"""HBM inverted-list cache with LRU/LFU eviction and hit statistics.

Implements the declared-only ``GpuCache`` (I11,
``engine/ivf_flat_index.h:191-222``: keyed GPU buffers, LRU eviction,
hit/miss counters, ``get_hit_rate()``) as a fixed-slot device cache:

    cache_arena  [slots, cap, dim]   device, corpus dtype
    cache_sq     [slots, cap]        fp32
    cache_counts [slots]             int32  (live rows of the cached list)

Uploads batch all missing lists into ONE scatter dispatch (host stacking +
single ``.at[slots].set``), so residency misses cost one H2D transfer per
batch, not one per list — the reference paid per-list round trips
(``ivf_flat_index.cpp:387-444``) and its eviction was a TODO that silently
skipped loads (``:398-402``). Eviction here is real: LRU or LFU victims.
"""

from __future__ import annotations

import functools
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, donate_argnums=(0, 1, 2))
def _scatter_upload(arena, sq, counts, slots, stack, sq_new, cnts):
    """Donating in-place slot update: without donation the functional
    ``.at[].set`` keeps old+new cache arenas live simultaneously — 2x a
    multi-GB cache is an HBM OOM on its own."""
    return (
        arena.at[slots].set(stack),
        sq.at[slots].set(sq_new),
        counts.at[slots].set(cnts),
    )


@functools.partial(jax.jit, donate_argnums=(0, 1, 2, 3, 4))
def _scatter_upload_q(arena, sq, counts, scale, anchors, slots, stack,
                      sq_new, cnts, scale_new, anchors_new):
    """Quantized-cache variant: also scatters the per-row dequant scales and
    per-list anchors the int8 scan kernels consume."""
    return (
        arena.at[slots].set(stack),
        sq.at[slots].set(sq_new),
        counts.at[slots].set(cnts),
        scale.at[slots].set(scale_new),
        anchors.at[slots].set(anchors_new),
    )


class HbmListCache:
    def __init__(
        self,
        n_slots: int,
        capacity: int,
        dim: int,
        dtype=jnp.bfloat16,
        policy: str = "lru",
    ):
        if policy not in ("lru", "lfu"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.n_slots = n_slots
        self.capacity = capacity
        self.dim = dim
        self.dtype = jnp.dtype(dtype)
        self.policy = policy
        # One extra SENTINEL row (index n_slots, count 0, never assigned):
        # fixed-shape scans pad ragged probe sets with it, so every probe
        # wave compiles to the same executable (static shapes, SURVEY §7
        # hard part #1) and padded probes contribute only masked +inf rows.
        self.cache_arena = self._device_zeros(
            (n_slots + 1, capacity, dim), self.dtype, cap_axis=1
        )
        self.cache_sq = self._device_zeros(
            (n_slots + 1, capacity), jnp.float32, cap_axis=1
        )
        self.cache_counts = self._device_zeros(
            (n_slots + 1,), jnp.int32, cap_axis=None
        )
        # int8 caches carry the quantization planes (per-row scales +
        # per-list anchors) alongside the codes, mirroring PackedListArena.
        self.quantized = self.dtype == jnp.int8
        self.cache_scale = (
            self._device_zeros(
                (n_slots + 1, capacity), jnp.float32, cap_axis=1
            )
            if self.quantized else None
        )
        self.cache_anchors = (
            self._device_zeros((n_slots + 1, dim), jnp.float32,
                               cap_axis=None)
            if self.quantized else None
        )
        self._lock = threading.Lock()
        self._list_to_slot: dict[int, int] = {}
        self._slot_to_list: dict[int, int] = {}
        self._free: list[int] = list(range(n_slots))
        self._last_access: dict[int, float] = {}
        self._freq: dict[int, int] = {}
        self.hits = 0
        self.misses = 0

    # ------------------------------------------------------------------ #
    # Placement hooks. The single-chip cache keeps everything on the
    # default device; parallel/sharded_streaming.ShardedHbmListCache
    # overrides these to slot-stripe the capacity axis over a device mesh
    # (same contract as the resident sharded arena, parallel/sharded).
    # ------------------------------------------------------------------ #

    def _device_zeros(self, shape, dtype, cap_axis=None):
        return jnp.zeros(shape, dtype)

    def _stage_update(self, arr, cap_axis=None):
        """Place one host-side upload operand on device. ``cap_axis`` marks
        the slot-capacity axis (the striped one under sharding)."""
        return jnp.asarray(arr)

    # ------------------------------------------------------------------ #

    def get_hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def resident_lists(self) -> list[int]:
        with self._lock:
            return sorted(self._list_to_slot)

    def _pick_victim_locked(
        self, protected: set[int], soft: set[int] | None = None
    ) -> int:
        if self._free:
            return self._free.pop()
        score = self._last_access if self.policy == "lru" else self._freq
        candidates = [
            l for l in self._list_to_slot if l not in protected
        ]
        if not candidates:
            raise ValueError(
                f"cache thrash: all {self.n_slots} slots are needed by the "
                "current batch; raise cache slots or split the batch"
            )
        if soft:
            # Belady-style preference: the caller knows which resident
            # lists the NEXT wave of this batch needs — evicting one now
            # guarantees a re-upload microseconds later. Only a preference:
            # if every candidate is soft-protected, evict among them.
            unsoft = [l for l in candidates if l not in soft]
            if unsoft:
                candidates = unsoft
        victim_list = min(candidates, key=lambda l: score.get(l, 0))
        slot = self._list_to_slot.pop(victim_list)
        del self._slot_to_list[slot]
        self._last_access.pop(victim_list, None)
        self._freq.pop(victim_list, None)
        return slot

    def evict_list(self, list_id: int) -> bool:
        """Explicit evict (``ivf_flat_index.h:63``; unlike the reference's,
        it works)."""
        with self._lock:
            slot = self._list_to_slot.pop(list_id, None)
            if slot is None:
                return False
            del self._slot_to_list[slot]
            self._last_access.pop(list_id, None)
            self._freq.pop(list_id, None)
            self._free.append(slot)
            return True

    # ------------------------------------------------------------------ #

    def ensure_resident(
        self, list_ids: np.ndarray, host_fetch,
        soft_protect: set[int] | None = None,
    ) -> dict[int, int]:
        """Make every list in ``list_ids`` device-resident; returns
        {list_id: slot}. ``host_fetch(list_id) -> (vectors [c, dim] np,
        sq [c] np, count)`` supplies host data for misses.

        ``soft_protect``: lists a later wave of the same batch will need —
        preferred survivors during eviction (never blocks a required
        upload).

        All misses upload as one batched scatter (single dispatch).
        """
        now = time.monotonic()
        wanted = [int(l) for l in np.unique(list_ids)]
        if len(wanted) > self.n_slots:
            raise ValueError(
                f"batch probes {len(wanted)} unique lists but cache has "
                f"{self.n_slots} slots; split into waves"
            )
        protected = set(wanted)
        with self._lock:
            missing = []
            for l in wanted:
                if l in self._list_to_slot:
                    self.hits += 1
                else:
                    self.misses += 1
                    missing.append(l)
                self._last_access[l] = now
                self._freq[l] = self._freq.get(l, 0) + 1
            slots_for_missing = {}
            for l in missing:
                slot = self._pick_victim_locked(protected, soft_protect)
                self._list_to_slot[l] = slot
                self._slot_to_list[slot] = l
                slots_for_missing[l] = slot
            mapping = {l: self._list_to_slot[l] for l in wanted}

        if slots_for_missing:
            from cuda_acceleratedvectordatabaseengine import native

            miss_l = list(slots_for_missing)
            miss_s = list(slots_for_missing.values())
            # Bounded upload batches: one giant fp32 staging stack (e.g. a
            # 2048-slot warm prefetch = 20+ GB fp32) neither fits host
            # staging comfortably nor one H2D transfer; the dtype cast
            # happens HOST-side so the wire carries the stored bytes.
            step = max(1, (256 << 20) // max(
                self.capacity * self.dim * self.dtype.itemsize, 1
            ))
            for b0 in range(0, len(miss_l), step):
                batch_l = miss_l[b0:b0 + step]
                batch_s = miss_s[b0:b0 + step]
                if self.quantized:
                    self._upload_quantized(batch_l, batch_s, host_fetch)
                    continue
                arrays, cnts_list = [], []
                for l in batch_l:
                    fetched = host_fetch(l)
                    v, _s, c = fetched[:3]
                    arrays.append(np.asarray(v[:c], np.float32))
                    cnts_list.append(c)
                # Parallel C++ staging assembly (pad) — the host-side hot
                # path of a cache miss; NumPy fallback without the lib.
                stack, _sq_f32 = native.gather_lists(
                    arrays, self.capacity, self.dim
                )
                # Norms of the STORED (dtype-cast) representation, not the
                # fp32 staging values: scan distances must be distances to
                # the stored point (see models/arena.py) — fp32 norms
                # against cast dots would bias L2 near ties.
                stack_cast = stack.astype(self.dtype)
                sq_new = np.asarray(
                    stack_cast, dtype=np.float32
                ) if self.dtype != jnp.float32 else stack
                sq_new = np.einsum(
                    "scd,scd->sc", sq_new, sq_new, dtype=np.float32
                )
                (self.cache_arena, self.cache_sq, self.cache_counts) = (
                    _scatter_upload(
                        self.cache_arena, self.cache_sq, self.cache_counts,
                        self._stage_update(np.asarray(batch_s, np.int32)),
                        self._stage_update(stack_cast, cap_axis=1),
                        self._stage_update(sq_new, cap_axis=1),
                        self._stage_update(np.asarray(cnts_list, np.int32)),
                    )
                )
            jax.block_until_ready(self.cache_counts)
        return mapping

    def _upload_quantized(self, batch_l, batch_s, host_fetch) -> None:
        """int8 miss upload: codes + per-row scales + stored-representation
        norms come straight from the host store (1 byte/dim on the wire —
        the tier where H2D bandwidth is scarcest), anchors per list."""
        n = len(batch_l)
        codes = np.zeros((n, self.capacity, self.dim), np.int8)
        sq_new = np.zeros((n, self.capacity), np.float32)
        scale_new = np.zeros((n, self.capacity), np.float32)
        anchors_new = np.zeros((n, self.dim), np.float32)
        cnts = np.zeros((n,), np.int32)
        for i, l in enumerate(batch_l):
            v, s, c, sc, an = host_fetch(l)
            codes[i, :c] = v[:c]
            sq_new[i, :c] = s[:c]
            scale_new[i, :c] = sc[:c]
            anchors_new[i] = an
            cnts[i] = c
        (self.cache_arena, self.cache_sq, self.cache_counts,
         self.cache_scale, self.cache_anchors) = _scatter_upload_q(
            self.cache_arena, self.cache_sq, self.cache_counts,
            self.cache_scale, self.cache_anchors,
            self._stage_update(np.asarray(batch_s, np.int32)),
            self._stage_update(codes, cap_axis=1),
            self._stage_update(sq_new, cap_axis=1),
            self._stage_update(cnts),
            self._stage_update(scale_new, cap_axis=1),
            self._stage_update(anchors_new),
        )

    def memory_bytes(self) -> int:
        n = (
            self.cache_arena.size * self.cache_arena.dtype.itemsize
            + self.cache_sq.size * 4 + self.cache_counts.size * 4
        )
        if self.quantized:
            n += self.cache_scale.size * 4 + self.cache_anchors.size * 4
        return n
