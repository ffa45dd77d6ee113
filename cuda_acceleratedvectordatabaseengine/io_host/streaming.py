"""Streaming IVF search for corpora exceeding device HBM.

Replaces the reference's transfer-manager/prefetcher stack (T1/T3 +
P1-P3) with JAX-idiomatic tiering (SURVEY.md §7 step 8): the corpus
lives packed in host RAM (``HostListStore``); an :class:`HbmListCache`
holds the hot inverted lists on device; a search batch

  1. runs the coarse probe on device (centroids are always resident),
  2. ensures its probed lists are cache-resident (one batched async H2D
     scatter for all misses — JAX async dispatch overlaps it with any
     in-flight compute, playing the role of the reference's DoubleBuffer
     ping-pong, ``transfer_manager.cpp:273-311``),
  3. scans the cache arena with the same fused kernel, probes remapped to
     cache slots, and maps result positions back to (list, slot) space.

``prefetch_lists`` lets callers (the warmup RPC, the hotness-driven
ListPrefetcher) stage lists ahead of need.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cuda_acceleratedvectordatabaseengine.io_host.cache import HbmListCache
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
    FLT_MAX,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine.ops.normalize import l2_normalize
from cuda_acceleratedvectordatabaseengine.ops.dispatch import (
    resolve_scan_impl,
    run_scan,
)
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest
from cuda_acceleratedvectordatabaseengine.utils.batching import bucket_size


class HostListStore:
    """Packed inverted lists in host RAM: the host side of the tier.

    Two storage modes:

    - ``dtype="float32"``: fp32 vectors + fp32 squared norms per list.
    - ``dtype="int8"``: int8 residual codes + PER-ROW dequant scales +
      per-list fp32 anchors (the arena quantization contract,
      ``models/arena.PackedListArena``). 4× less host RAM than fp32 and
      4× fewer upload bytes per cache miss. ``sq`` always holds norms of the STORED
      representation so scan distances are distances to the stored point.

    Built from an in-memory index snapshot or any (vectors, ids,
    assignments) triple.
    """

    def __init__(self, nlist: int, dim: int, dtype: str = "float32"):
        if dtype not in ("float32", "int8"):
            raise ValueError(f"unsupported store dtype {dtype!r}")
        self.nlist = nlist
        self.dim = dim
        self.dtype = dtype
        vdt = np.int8 if dtype == "int8" else np.float32
        self.vectors: list[np.ndarray] = [
            np.zeros((0, dim), vdt) for _ in range(nlist)
        ]
        self.sq: list[np.ndarray] = [
            np.zeros((0,), np.float32) for _ in range(nlist)
        ]
        self.ids: list[np.ndarray] = [
            np.zeros((0,), np.uint64) for _ in range(nlist)
        ]
        self.scale: list[np.ndarray] | None = (
            [np.zeros((0,), np.float32) for _ in range(nlist)]
            if dtype == "int8" else None
        )
        # [nlist, dim] fp32 residual anchors (int8 mode; zeros = no anchor).
        self.anchors: np.ndarray | None = (
            np.zeros((nlist, dim), np.float32) if dtype == "int8" else None
        )
        self._ids_cat: np.ndarray | None = None
        self._ids_start: np.ndarray | None = None

    @classmethod
    def from_assignments(cls, vectors, ids, assignments, nlist,
                         dtype: str = "float32", anchors=None):
        """Pack (vectors, ids, assignments) into a store. ``dtype="int8"``
        residual-quantizes each row against ``anchors[list]`` (per-row
        max-abs scales — the arena quantization contract); ``sq`` then
        holds norms of the DEQUANTIZED representation so scans and the
        host reranker see distances to the stored point."""
        store = cls(nlist, vectors.shape[1], dtype=dtype)
        if dtype == "int8":
            if anchors is None:
                raise ValueError("int8 stores need per-list anchors")
            store.anchors = np.ascontiguousarray(anchors, np.float32)
        order = np.argsort(assignments, kind="stable")
        sorted_lists = assignments[order]
        bounds = np.searchsorted(sorted_lists, np.arange(nlist + 1))
        for l in range(nlist):
            rows = order[bounds[l]:bounds[l + 1]]
            v = np.ascontiguousarray(vectors[rows], np.float32)
            if dtype == "int8":
                res = v - store.anchors[l]
                scale = np.maximum(
                    np.abs(res).max(axis=-1), 1e-12
                ).astype(np.float32) / np.float32(127.0)
                codes = np.clip(
                    np.round(res / scale[:, None]), -127, 127
                )
                deq = store.anchors[l] + codes * scale[:, None]
                store.vectors[l] = codes.astype(np.int8)
                store.scale[l] = scale
                store.sq[l] = np.einsum(
                    "nd,nd->n", deq, deq
                ).astype(np.float32)
            else:
                store.vectors[l] = v
                store.sq[l] = (v.astype(np.float64) ** 2).sum(-1).astype(
                    np.float32
                )
            store.ids[l] = ids[rows].astype(np.uint64)
        return store

    @classmethod
    def from_arena(cls, arena) -> "HostListStore":
        """Snapshot a resident :class:`PackedListArena` WITHOUT a dequantize
        round trip: int8 arenas keep their codes/scales/anchors verbatim
        (bit-identical stored representation, 4× less host RAM), float
        arenas download as fp32."""
        nlist, cap = arena.nlist, arena.capacity
        counts = np.asarray(arena.counts)
        if arena.dtype == jnp.int8 and arena.arena_scale is not None:
            store = cls(nlist, arena.dim, dtype="int8")
            codes = np.asarray(arena.arena)
            scales = np.asarray(arena.arena_scale)
            if arena.anchors is not None:
                store.anchors = np.asarray(arena.anchors, dtype=np.float32)
        else:
            store = cls(nlist, arena.dim, dtype="float32")
            codes = np.asarray(arena.arena).astype(np.float32)
            scales = None
        sq = np.asarray(arena.arena_sq)
        for l in range(nlist):
            c = int(counts[l])
            store.vectors[l] = codes[l, :c]
            store.sq[l] = sq[l, :c]
            store.ids[l] = arena.ids[l, :c]
            if scales is not None:
                store.scale[l] = scales[l, :c]
        return store

    def count(self, list_id: int) -> int:
        return self.vectors[list_id].shape[0]

    def max_count(self) -> int:
        return max((v.shape[0] for v in self.vectors), default=0)

    def total(self) -> int:
        return sum(v.shape[0] for v in self.vectors)

    def fetch(self, list_id: int):
        """host_fetch for HbmListCache: ``(values, sq, count)`` for fp32
        stores, ``(codes, sq, count, scale, anchor)`` for int8 stores."""
        base = (
            self.vectors[list_id], self.sq[list_id], self.count(list_id),
        )
        if self.dtype == "int8":
            return base + (self.scale[list_id], self.anchors[list_id])
        return base

    def lookup_ids(self, lists: np.ndarray, offs: np.ndarray) -> np.ndarray:
        """Vectorized (list, offset) → user id for result merge; ``-1``
        lists map to INVALID_ID. Builds a concatenated id table lazily and
        caches it (rebuild with ``invalidate_ids`` after mutation)."""
        if self._ids_cat is None:
            counts = np.asarray([i.shape[0] for i in self.ids], np.int64)
            self._ids_start = np.concatenate(
                [[0], np.cumsum(counts)]
            ).astype(np.int64)
            self._ids_cat = (
                np.concatenate(self.ids)
                if counts.sum() else np.zeros((0,), np.uint64)
            )
        out = np.full(lists.shape, INVALID_ID, np.uint64)
        valid = lists >= 0
        if valid.any():
            flat = (
                self._ids_start[lists[valid]] + offs[valid].astype(np.int64)
            )
            out[valid] = self._ids_cat[flat]
        return out

    def invalidate_ids(self) -> None:
        self._ids_cat = self._ids_start = None

    def nbytes(self) -> int:
        n = sum(
            v.nbytes + s.nbytes + i.nbytes
            for v, s, i in zip(self.vectors, self.sq, self.ids)
        )
        if self.scale is not None:
            n += sum(s.nbytes for s in self.scale) + self.anchors.nbytes
        return n


@functools.partial(jax.jit, static_argnames=("nprobe", "metric"))
def _coarse_probe(queries, centroids, nprobe, metric):
    q = queries.astype(jnp.float32)
    if metric == Metric.COSINE:
        q = l2_normalize(q)
    coarse = pairwise_distance(q, centroids, metric)
    _, probe = topk_smallest(coarse, nprobe)
    return q, probe.astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "metric", "scan_impl"))
def _cache_scan(q, cache_arena, cache_sq, cache_counts, slot_probe, k,
                metric, scan_impl="gather", cache_scale=None,
                cache_anchors=None):
    return run_scan(
        scan_impl, q, cache_arena, cache_sq, cache_counts, slot_probe, k,
        metric, arena_scale=cache_scale, arena_anchors=cache_anchors,
    )


class StreamingIVFFlatIndex:
    """IVF-Flat search over a host-RAM corpus with an HBM list-cache tier.

    Device memory is bounded by ``cache_slots * capacity * dim`` regardless
    of corpus size — the property the reference's ``max_gpu_memory`` config
    promised (``ivf_flat_index.h:21``) but whose eviction path was a silent
    TODO (``ivf_flat_index.cpp:398-402``).
    """

    def __init__(
        self,
        base: IVFFlatIndex,
        cache_slots: int | None = None,
        max_device_bytes: int | None = None,
        policy: str = "lru",
        scan_impl: str = "auto",
    ):
        if not base.trained:
            raise RuntimeError("base index must be trained")
        store = HostListStore.from_arena(base.arena)
        self._init_from_store(
            store, base.centroids, base.config, cache_slots,
            max_device_bytes, policy, scan_impl,
            capacity=base.arena.capacity,
        )

    @classmethod
    def from_store(
        cls,
        store: HostListStore,
        centroids,
        config,
        cache_slots: int | None = None,
        max_device_bytes: int | None = None,
        policy: str = "lru",
        scan_impl: str = "auto",
        capacity: int | None = None,
    ) -> "StreamingIVFFlatIndex":
        """Build directly from a host-RAM store — the true >HBM entry
        point: a corpus that never fit on device has no resident base
        index to snapshot (the reference's ``max_gpu_memory`` scenario,
        ``engine/ivf_flat_index.h:21``)."""
        self = cls.__new__(cls)
        self._init_from_store(
            store, centroids, config, cache_slots, max_device_bytes,
            policy, scan_impl, capacity,
        )
        return self

    def _init_from_store(
        self, store, centroids, config, cache_slots, max_device_bytes,
        policy, scan_impl, capacity=None,
    ) -> None:
        self.config = config
        self.metric = config.metric
        self.centroids = centroids
        self.store = store
        nlist = config.nlist
        cap = capacity if capacity is not None else max(
            -(-store.max_count() // 128) * 128, 128
        )
        if store.dtype == "int8":
            # The store carries codes + per-row scales + anchors, so the
            # cache keeps them quantized end-to-end: 1 byte/dim on the wire
            # per miss and in HBM, with exact stored-representation math
            # (per-row scale rows + anchor dots in the scan kernels).
            dtype = jnp.dtype(jnp.int8)
        else:
            dtype = jnp.dtype(config.dtype)
            if dtype == jnp.int8:
                # fp32 store + int8 config: re-quantizing per slot at upload
                # would need fresh per-row scales per miss; bf16 staging
                # keeps a bandwidth win without that cost.
                dtype = jnp.dtype(jnp.bfloat16)
        if cache_slots is None:
            per_slot = cap * config.dimension * dtype.itemsize
            budget = max_device_bytes or (per_slot * max(nlist // 4, 1))
            cache_slots = max(int(budget // max(per_slot, 1)), 1)
        cache_slots = min(cache_slots, nlist)
        self.cache = self._make_cache(
            cache_slots, cap, config.dimension, dtype, policy
        )
        self.scan_impl = scan_impl
        import threading

        from cuda_acceleratedvectordatabaseengine.io_host.prefetcher import (  # noqa: E501
            ListPrefetcher,
        )

        # Hotness-driven residency (P3, ``engine/prefetcher.h:139-183``
        # declared intent): every search feeds its probe table in, and
        # the server's background loop calls ``prefetch_hot_lists`` to
        # re-stage the decayed-hot working set after cold traffic evicted
        # it — so a returning hot query hits instead of missing.
        self.list_prefetcher = ListPrefetcher(stage_fn=self.prefetch_lists)
        # Serializes cache mutation vs the search wave pipeline: a
        # background staging that evicts a list between a search's slot
        # mapping and its scan dispatch would scan the wrong rows.
        self._cache_gate = threading.RLock()

    def _make_cache(self, cache_slots, cap, dim, dtype, policy):
        """Cache construction hook (the mesh tier substitutes a
        slot-striped cache)."""
        return HbmListCache(cache_slots, cap, dim, dtype, policy)

    # ------------------------------------------------------------------ #
    # serving surface (what the gRPC layer drives on any index tier)
    # ------------------------------------------------------------------ #

    trained = True          # from_store/ctor both require trained inputs
    read_only = True        # mutations go to the NEXT epoch's build

    @property
    def ntotal(self) -> int:
        return self.store.total()

    def warmup_lists(self, list_ids=None, batch_sizes=(1, 8, 64),
                     nprobes=None) -> None:
        """Warmup RPC on the streaming tier: stage the given lists into the
        HBM cache (real data movement — unlike the resident index, where
        the arena is already in HBM and warmup only compiles). With no
        explicit lists, compile-warm the scan executables per batch bucket
        × nprobe value (waves pad their slot-probe matrix to the full
        [B, nprobe] width, so the cache-scan executable is nprobe-static
        like the resident path's)."""
        if list_ids is not None:
            self.prefetch_lists(np.asarray(list_ids, np.int64))
            return
        if nprobes is None:
            nprobes = (1,)
        dummy = np.zeros((1, self.config.dimension), np.float32)
        for np_ in nprobes:
            params = SearchParams(nprobe=int(np_))
            for bs in batch_sizes:
                self.search(np.repeat(dummy, bs, axis=0), params)

    def evict_list(self, list_id: int) -> None:
        """Explicit eviction (``ivf_flat_index.h:63``) — on this tier the
        cache slot is truly freed (the reference's eviction body was a
        TODO, ``ivf_flat_index.cpp:398-402``)."""
        self.cache.evict_list(int(list_id))

    def memory_stats(self) -> dict:
        cent = 0 if self.centroids is None else self.centroids.size * 4
        return {
            "arena_bytes": self.cache.memory_bytes(),
            "centroid_bytes": int(cent),
            "total_bytes": self.cache.memory_bytes() + int(cent),
            "host_bytes": self.store.nbytes(),
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "capacity_per_list": self.cache.capacity,
            "cache_hit_rate": self.cache.get_hit_rate(),
        }

    def prefetch_lists(self, list_ids) -> None:
        """Warmup/prefetch path (ListPrefetcher → cache)."""
        with self._cache_gate:
            self.cache.ensure_resident(
                np.asarray(list_ids, np.int64), self.store.fetch
            )

    def prefetch_hot_lists(self, max_lists: int | None = None) -> list[int]:
        """Stage the hottest lists (recency-decayed access counts from
        every served search) back into the HBM cache — called by the
        server's background prefetch loop through the
        ``PrefetchScheduler``. Capped at half the cache by default so
        re-staging never wipes the live working set."""
        if max_lists is None:
            max_lists = max(1, self.cache.n_slots // 2)
        max_lists = min(max_lists, self.cache.n_slots)
        return self.list_prefetcher.prefetch_hot_lists(max_lists)

    def search(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        params = params or SearchParams()
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        b = queries.shape[0]
        q_in = queries                        # unpadded view, for row splits
        bs = bucket_size(b)
        if bs > b:
            queries = np.pad(queries, ((0, bs - b), (0, 0)))
        nprobe = min(params.nprobe, self.config.nlist)

        q, probe = _coarse_probe(
            jnp.asarray(queries), self.centroids, nprobe, self.metric
        )
        probe_h = np.asarray(probe)           # D2H: [B, nprobe] int32, tiny
        # hotness accounting: this batch's probe working set (P3 feed)
        uniq, cnt = np.unique(probe_h[:b], return_counts=True)
        self.list_prefetcher.record_many(uniq, cnt)

        # A single probe column whose unique-list count exceeds the cache
        # is un-stageable in one wave (every query's column-j list must be
        # resident for the same fixed-shape scan). Rows are independent, so
        # split the batch in half and recurse — exactness is preserved and
        # termination is guaranteed (a 1-row column touches 1 list).
        if b > 1:
            worst = max(
                len(np.unique(probe_h[:b, j]))
                for j in range(probe_h.shape[1])
            )
            if worst > self.cache.n_slots:
                mid = (b + 1) // 2
                d1, i1 = self.search(q_in[:mid], params)
                d2, i2 = self.search(q_in[mid:], params)
                return (np.concatenate([d1, d2], axis=0),
                        np.concatenate([i1, i2], axis=0))

        # Split probe columns into waves whose unique-list working set fits
        # the cache (one wave in the common case). Each wave: batched upload
        # of misses (async, overlaps previous wave's scan) + fused scan.
        waves = self._plan_waves(probe_h)
        k = params.k
        all_d, all_l, all_o = [], [], []
        cap = self.cache.capacity

        def convert(d_dev, pos_dev, rev):
            d = np.asarray(d_dev)[:b]
            pos = np.asarray(pos_dev)[:b]
            valid = pos >= 0
            lists = np.where(valid, rev[np.maximum(pos, 0) // cap], -1)
            offs = np.where(valid, np.maximum(pos, 0) % cap, 0)
            all_d.append(d)
            all_l.append(lists)
            all_o.append(offs)

        # Software-pipelined waves (the reference's DoubleBuffer intent,
        # ``transfer_manager.cpp:273-311``): wave i's scan is DISPATCHED
        # asynchronously, then wave i+1's miss upload proceeds while it
        # computes. Overlap safety invariant: HbmListCache.ensure_resident
        # uploads through a DONATING jitted scatter (io_host/cache.py), so
        # the arena is updated in place — correctness rests on XLA's
        # in-dispatch-order execution on a single device stream sequencing the
        # donated scatter AFTER the already-dispatched scan, not on
        # functional copy semantics. If an out-of-order backend is ever
        # targeted, drop donation for the cache arenas. Depth 2 bounds the
        # host-side result backlog.
        pending: list[tuple] = []
        wave_sets = [
            set(int(l) for l in np.unique(probe_h[:, cols]))
            for cols in waves
        ]
        for wi, cols in enumerate(waves):
            wave_probe = probe_h[:, cols]
            # The gate spans staging → scan DISPATCH: a background
            # hotness staging (prefetch_hot_lists) evicting one of this
            # wave's lists between its slot mapping and the scan dispatch
            # would scan the wrong rows. Once dispatched, in-order device
            # execution sequences any later donated scatter after it, so
            # the gate releases between waves.
            with self._cache_gate:
                mapping = self.cache.ensure_resident(
                    wave_probe.reshape(-1), self.store.fetch,
                    soft_protect=(
                        wave_sets[wi + 1] if wi + 1 < len(waves) else None
                    ),
                )
                lut = np.full(self.config.nlist, -1, np.int32)
                for l, s in mapping.items():
                    lut[l] = s
                # Fixed-width probes: pad every wave to nprobe columns
                # with -1 (invalid probe — all scan impls skip it
                # natively; the grouped kernel never even DMAs its rows)
                # so each wave reuses one compiled executable.
                slot_probe = np.full(
                    (probe_h.shape[0], nprobe), -1, np.int32
                )
                slot_probe[:, : len(cols)] = lut[wave_probe]
                d_dev, pos_dev = self._run_cache_scan(q, slot_probe, k)
            # slot→list mapping captured NOW, before the next wave remaps
            rev = np.full(self.cache.n_slots + 1, -1, np.int64)
            for l, s in mapping.items():
                rev[s] = l
            pending.append((d_dev, pos_dev, rev))
            if len(pending) > 2:
                convert(*pending.pop(0))
        for w in pending:
            convert(*w)

        d = np.concatenate(all_d, axis=1)
        lists = np.concatenate(all_l, axis=1)
        offs = np.concatenate(all_o, axis=1)
        order = np.argsort(d, axis=1, kind="stable")[:, :k]
        d = np.take_along_axis(d, order, 1).copy()
        lists = np.take_along_axis(lists, order, 1)
        offs = np.take_along_axis(offs, order, 1)
        out_ids = self.store.lookup_ids(lists, offs)
        d[lists < 0] = FLT_MAX
        return d, out_ids

    def _run_cache_scan(self, q, slot_probe: np.ndarray, k: int):
        """One wave's fused scan over the cache arena (slot-remapped
        probes). Overridden by the mesh tier
        (``parallel/sharded_streaming``) to run SPMD with an all-gather merge."""
        scan_impl = resolve_scan_impl(self.scan_impl, jax.default_backend())
        return _cache_scan(
            q, self.cache.cache_arena, self.cache.cache_sq,
            self.cache.cache_counts, jnp.asarray(slot_probe), k,
            self.metric, scan_impl, self.cache.cache_scale,
            self.cache.cache_anchors,
        )

    def _plan_waves(self, probe_h: np.ndarray) -> list[list[int]]:
        """Greedy column grouping: each wave's unique lists ≤ cache slots."""
        slots = self.cache.n_slots
        waves: list[list[int]] = []
        current: list[int] = []
        working: set[int] = set()
        for col in range(probe_h.shape[1]):
            col_lists = set(int(l) for l in np.unique(probe_h[:, col]))
            if len(col_lists) > slots:
                raise ValueError(
                    f"one probe column touches {len(col_lists)} lists but "
                    f"the cache has {slots} slots; raise cache_slots or "
                    "lower the batch size"
                )
            if current and len(working | col_lists) > slots:
                waves.append(current)
                current, working = [], set()
            current.append(col)
            working |= col_lists
        if current:
            waves.append(current)
        return waves

    def stats(self) -> dict:
        return {
            "hit_rate": self.cache.get_hit_rate(),
            "hits": self.cache.hits,
            "misses": self.cache.misses,
            "resident": len(self.cache.resident_lists()),
            "slots": self.cache.n_slots,
            "device_bytes": self.cache.memory_bytes(),
            "host_bytes": self.store.nbytes(),
        }
