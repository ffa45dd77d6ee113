"""IVF-PQ index: coarse quantizer + product-quantized inverted lists.

The reference *declares* ``IVFPQIndex`` (``engine/ivf_flat_index.h:107-189``
— train_pq, encode_vectors, compute_distance_tables, search_list_pq, exact
rerank via ``rerank_k``, GPU codebooks + distance tables) but never implements
it; its PQ kernels (K3/K4) are dead code. This module implements the intended
capability with *residual* PQ (codes quantize ``x − coarse
centroid``, the standard IVF-PQ formulation):

  search = coarse matmul → top-nprobe
         → per-probe ADC tables from the query residual (batched matmul)
         → uint8 code-arena gather + table-lookup scan (XLA gather)
         → fused top-k merge
         → optional exact rerank of the top ``rerank_k`` candidates against
           the raw-vector arena (one more contraction)

With m=dim/8 one-byte-per-8-dims codes, the scan reads ~16× less HBM than the
bf16 flat scan — PQ is the bandwidth lever that makes >HBM-rate QPS possible.
"""

from __future__ import annotations

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np

from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
    kmeans_assign,
    kmeans_fit,
)
from cuda_acceleratedvectordatabaseengine.ops.normalize import l2_normalize
from cuda_acceleratedvectordatabaseengine.ops.pq import (
    pq_encode,
    opq_fit,
    scan_probed_codes,
    train_product_quantizer,
)
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest
from cuda_acceleratedvectordatabaseengine.models.arena import (
    INVALID_ID,
    PackedListArena,
    compute_append_slots,
)
from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
    FLT_MAX,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.utils.batching import bucket_size


@dataclasses.dataclass
class IVFPQConfig:
    """Mirror of the declared ``IVFPQIndex::Config``
    (``engine/ivf_flat_index.h:140-150``)."""

    dimension: int = 768
    nlist: int = 1024
    m: int = 96                 # subquantizers; dimension % m == 0
    nbits: int = 8              # codebook bits (ks = 2^nbits); 8 → uint8 codes
    metric: Metric = Metric.L2
    keep_raw: bool = True       # retain raw vectors (bf16) for exact rerank
    raw_dtype: str = "bfloat16"
    train_iters: int = 40   # see IVFFlatConfig.train_iters
    train_sample_per_list: int = 128
    pq_train_sample: int = 65536
    seed: int = 42
    opq: bool = False           # learn an OPQ rotation (ops/pq.opq_fit).
                                # Applied as a change of basis at the index
                                # boundary: centroids/ingest/queries rotate
                                # once, every kernel downstream is unchanged
                                # (rotation is an isometry)
    opq_iters: int = 6          # OPQ alternations (Procrustes + Lloyd)
    query_upload_dtype: str = "float32"  # H2D transport dtype for search
                                # queries (see IVFFlatConfig: bf16 halves
                                # the serving path's query upload; the
                                # device program widens back to fp32)

    def __post_init__(self):
        if isinstance(self.metric, str):
            self.metric = Metric.parse(self.metric)
        if self.dimension % self.m:
            raise ValueError(f"dimension {self.dimension} % m {self.m} != 0")
        if self.nbits != 8:
            raise ValueError("only nbits=8 (uint8 codes) is supported, "
                             "matching the reference's uint8 pq_scan (K4)")

    @property
    def ks(self) -> int:
        return 1 << self.nbits


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_codes(code_arena_t, lists, slots, codes):
    """Donating code-arena update: the functional ``.at[].set`` otherwise
    keeps old+new multi-GB code arenas live through every ingest slice."""
    return code_arena_t.at[lists, :, slots].set(codes)


@functools.partial(jax.jit, donate_argnums=(0,))
def _remove_codes(code_arena_t, lists, src, dst):
    """Donating swap-from-tail compaction of the transposed code arena
    (delete path; see ``PackedListArena.remove``)."""
    return code_arena_t.at[lists, :, dst].set(code_arena_t[lists, :, src])


@functools.partial(
    jax.jit, static_argnames=("nprobe", "k", "metric", "rerank_k", "k_inner",
                              "scan_capacity")
)
def _ivf_pq_search_device(
    queries,        # [B, D] fp32
    centroids,      # [nlist, D] fp32
    codebooks,      # [m, ks, dsub] fp32
    code_arena_t,   # [nlist, m, cap] uint8 (subspace-major)
    counts,         # [nlist] int32
    raw_arena,      # [nlist, cap, D] raw dtype or None
    raw_sq,         # [nlist, cap] fp32 or None
    raw_scale,      # [nlist, cap] fp32 per-row dequant scales (int8) or None
    raw_anchors,    # [nlist, D] fp32 residual anchors (int8) or None
    nprobe: int,
    k: int,
    metric: Metric,
    rerank_k: int,  # 0 = no rerank
    opq_R=None,     # [D, D] orthogonal OPQ rotation or None
    k_inner: int = 0,   # >0: per-list shortlist depth (host-rerank mode,
                        # see ops/pq.scan_probed_codes)
    scan_capacity: int | None = None,  # occupied-prefix bound on the slots
                        # the scan reads (≥ max(counts))
):
    b, dim = queries.shape
    nlist, m, cap = code_arena_t.shape
    q0 = queries.astype(jnp.float32)       # ORIGINAL frame (rerank's frame)
    if metric == Metric.COSINE:
        q0 = l2_normalize(q0)
    q = q0
    if opq_R is not None:
        # Change of basis into the OPQ frame: centroids and CODES live
        # rotated (the subspace split needs decorrelated axes); the raw
        # rerank arena stays in the ORIGINAL frame (see _ingest — bf16
        # rounding in the rotated frame concentrates into the same few
        # high-variance coordinates as the signal, inflating rerank
        # ordering noise; storing unrotated keeps per-coordinate SNR
        # uniform). Rotation is an isometry, so probing/ADC distances are
        # unchanged. HIGHEST precision: a bf16-pass rotation perturbs the
        # query by ~1e-3 relative — a systematic metric distortion
        # (ops/pq._PREC_HI).
        q = jnp.matmul(q0, opq_R, precision=jax.lax.Precision.HIGHEST)
    q_sq = jnp.sum(q * q, axis=-1)

    # Coarse probe. For cosine the arena is normalized, so L2 ordering over
    # centroids matches cosine ordering of list residuals (standard FAISS
    # practice); report-space conversion happens at the end.
    coarse_metric = (
        Metric.INNER_PRODUCT if metric == Metric.INNER_PRODUCT else Metric.L2
    )
    coarse = pairwise_distance(q, centroids, coarse_metric)
    _, probe_ids = topk_smallest(coarse, nprobe)

    keep = max(k, rerank_k)
    best_d, best_p = scan_probed_codes(
        q, code_arena_t[:, :, :scan_capacity], counts, centroids, codebooks,
        probe_ids.astype(jnp.int32), keep,
        inner_product=metric == Metric.INNER_PRODUCT,
        k_inner=k_inner or None, global_capacity=cap,
    )

    if rerank_k > 0 and raw_arena is not None:
        # Exact rerank: gather the raw candidate vectors and recompute true
        # distances (the declared ``use_exact_rerank``/``rerank_k`` surface,
        # ``engine/ivf_flat_index.h:153-157``). Raw rows live in the
        # ORIGINAL frame regardless of OPQ (see the q0/q split above), so
        # the rerank pairs them with the UNROTATED query.
        flat = raw_arena.reshape(nlist * cap, dim)
        flat_sq = raw_sq.reshape(nlist * cap)
        safe_p = jnp.maximum(best_p, 0)
        # Dequantize candidates to fp32 (int8 arenas carry per-row scales
        # and optionally residual anchors; casting the fp32 query DOWN to
        # the arena dtype instead would destroy the rerank).
        cand = flat[safe_p].astype(jnp.float32)   # [B, keep, D]
        if raw_scale is not None:
            cand = cand * raw_scale.reshape(-1)[safe_p][:, :, None]
        if raw_anchors is not None:
            cand = cand + raw_anchors[safe_p // cap]
        # HIGHEST precision: this einsum is the EXACT stage — a default
        # reduced-precision pass injects ~5e-4-level dot error into the one
        # computation whose whole job is adjudicating near-ties the ADC
        # stage couldn't. O(B·keep·D) MACs — cost is noise.
        dots = jnp.einsum(
            "bd,bkd->bk", q0, cand,
            preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )
        if metric == Metric.INNER_PRODUCT:
            exact = -dots
        elif metric == Metric.COSINE:
            exact = 1.0 - dots
        else:
            exact = jnp.maximum(
                q_sq[:, None] - 2.0 * dots + flat_sq[safe_p], 0.0
            )
        exact = jnp.where(best_p >= 0, exact, jnp.inf)
        return topk_smallest(exact, k, idx=best_p)

    best_d, best_p = best_d[:, :k], best_p[:, :k]
    if metric == Metric.COSINE:
        # ADC ran in L2 space over unit vectors: ||q−x||² = 2(1−cos) → halve.
        best_d = jnp.where(jnp.isfinite(best_d), best_d * 0.5, best_d)
    return best_d, best_p


class IVFPQIndex:
    """IVF index with 8-bit product-quantized residual codes."""

    def __init__(self, config: IVFPQConfig):
        self.config = config
        self.metric = config.metric
        self.centroids: jax.Array | None = None
        self.codebooks: jax.Array | None = None   # [m, ks, dsub] fp32
        self.opq_R: jax.Array | None = None       # [D, D] orthogonal or None
        cap = PackedListArena.SLOT_ALIGN
        # Codes live TRANSPOSED on device ([nlist, m, cap]: a list's
        # per-subspace code rows are contiguous for the ADC gather); the
        # public ``code_arena`` property presents [nlist, cap, m].
        self.code_arena_t = jnp.zeros(
            (config.nlist, config.m, cap), jnp.uint8
        )
        self.raw: PackedListArena | None = (
            PackedListArena.create(
                config.nlist, config.dimension,
                dtype=jnp.dtype(config.raw_dtype),
            )
            if config.keep_raw
            else None
        )
        # When keep_raw=False we still need counts/ids; keep them here.
        self._counts = jnp.zeros((config.nlist,), jnp.int32)
        self._ids = np.full((config.nlist, cap), INVALID_ID, np.uint64)
        self.trained = False
        self.calibrated_nprobe: int | None = None
        self.list_access_count = np.zeros(config.nlist, np.int64)
        # Host-store exact rerank (keep_raw=False capacity tier): the raw
        # corpus stays in host RAM, the device keeps only codes. See
        # io_host/host_rerank.HostReranker and attach_host_rerank().
        self._host_rr = None
        self.host_rerank_k = 128
        self.host_rerank_margin = 0.0
        self.last_rerank_kept = None   # adaptive-depth instrumentation
        # Occupied-prefix hint cache: (counts array identity, hint). One
        # tiny D2H max() per arena version keeps scans reading only the
        # filled slot prefix.
        self._scan_cap_cache = (None, None)
        # Per-(query, list) shortlist depth in host-rerank mode. 0
        # (default) = the exact ADC top-R over the probe union; >0 opts
        # into per-list k_inner truncation (ops/pq.scan_probed_codes),
        # which caps recall on clustered corpora where every true neighbor
        # lives in the query's home list.
        self.host_rerank_k_inner = 0
        # Serializes DONATING arena mutations (_scatter_codes/_remove_codes
        # and the raw arena's append/remove) against search dispatches —
        # same invariant as IVFFlatIndex._mutate_lock: a dispatched search
        # runs before any later-donated update (in-order execution), but a
        # donation dispatched first invalidates the buffers a concurrent
        # search snapshotted.
        self._mutate_lock = threading.Lock()

    # ------------------------------------------------------------------ #

    @property
    def capacity(self) -> int:
        return self.code_arena_t.shape[2]

    @property
    def code_arena(self) -> jax.Array:
        """[nlist, cap, m] view (storage is transposed — see __init__)."""
        return self.code_arena_t.transpose(0, 2, 1)

    @code_arena.setter
    def code_arena(self, value) -> None:
        self.code_arena_t = jnp.asarray(value).transpose(0, 2, 1)

    @property
    def counts(self) -> jax.Array:
        return self.raw.counts if self.raw is not None else self._counts

    @property
    def ids(self) -> np.ndarray:
        return self.raw.ids if self.raw is not None else self._ids

    @property
    def ntotal(self) -> int:
        return int(np.asarray(self.counts).sum())

    def _scan_capacity_hint(self) -> int | None:
        """Static occupied-prefix bound for the ADC kernel — max(counts)
        rounded to the slot tile, None when the arena is filled to
        capacity. Cached per counts-array identity so the device sync runs
        once per ingest, not per search."""
        c = self.counts
        cached_for, val = self._scan_cap_cache
        if cached_for is not c:
            mx = int(np.asarray(jnp.max(c))) if c.shape[0] else 0
            align = PackedListArena.SLOT_ALIGN
            occ = -(-max(mx, 1) // align) * align
            val = occ if occ < self.capacity else None
            self._scan_cap_cache = (c, val)
        return val

    # ------------------------------------------------------------------ #
    # build
    # ------------------------------------------------------------------ #

    def train(self, vectors: np.ndarray) -> None:
        """Coarse k-means + residual PQ codebooks (the reference's declared
        ``train_pq``, ``engine/ivf_flat_index.h:160-163``, and the ghost
        ``pq_trainer.cpp``)."""
        cfg = self.config
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n < cfg.nlist:
            raise ValueError(f"need ≥ nlist={cfg.nlist} training vectors")
        if self.metric == Metric.COSINE:
            vectors = np.asarray(l2_normalize(jnp.asarray(vectors)))
        rng = np.random.default_rng(cfg.seed)
        cap = cfg.train_sample_per_list * cfg.nlist
        sample = vectors if n <= cap else vectors[
            rng.choice(n, cap, replace=False)
        ]
        key = jax.random.PRNGKey(cfg.seed)
        k1, k2 = jax.random.split(key)
        sample_d = jnp.asarray(sample)
        self.centroids, assign = kmeans_fit(
            k1, sample_d, cfg.nlist, iters=cfg.train_iters
        )
        # PQ trains on residuals of a subsample.
        nsub = min(sample.shape[0], cfg.pq_train_sample)
        sub_idx = rng.choice(sample.shape[0], nsub, replace=False)
        residuals = (
            sample_d[sub_idx] - self.centroids[assign[np.asarray(sub_idx)]]
        )
        self._train_pq(k2, residuals)
        self.trained = True

    def _train_pq(self, key, residuals) -> None:
        """PQ codebooks from a residual sample; with ``config.opq`` also an
        OPQ rotation, after which the WHOLE index operates in the rotated
        basis (centroids rotate here; ingest/queries rotate via
        :meth:`_rot`) — distances are unchanged (isometry), only the
        subspace split moves to decorrelated axes."""
        cfg = self.config
        if cfg.opq:
            self.opq_R, self.codebooks = opq_fit(
                key, residuals, cfg.m, cfg.ks, iters=cfg.train_iters,
                opq_iters=cfg.opq_iters,
            )
            self.centroids = jnp.matmul(
                self.centroids, self.opq_R,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            self.codebooks = train_product_quantizer(
                key, residuals, cfg.m, cfg.ks, iters=cfg.train_iters
            )

    def _rot(self, x: jax.Array) -> jax.Array:
        """Change of basis into the OPQ frame (no-op without OPQ). HIGHEST
        precision: stored rows must be rotated exactly or the isometry
        breaks by the matmul's bf16 pass error (see ops/pq._PREC_HI)."""
        if self.opq_R is None:
            return x
        return jnp.matmul(
            x, self.opq_R, precision=jax.lax.Precision.HIGHEST
        )

    def train_from_device(self, x_dev: jax.Array) -> None:
        """Device-resident training (parity with
        ``IVFFlatIndex.train_from_device``): no host round trip — the path
        for corpora generated or already living on device."""
        cfg = self.config
        n = x_dev.shape[0]
        if n < cfg.nlist:
            raise ValueError(f"need ≥ nlist={cfg.nlist} training vectors")
        x_dev = x_dev.astype(jnp.float32)
        if self.metric == Metric.COSINE:
            x_dev = l2_normalize(x_dev)
        rng = np.random.default_rng(cfg.seed)
        cap = cfg.train_sample_per_list * cfg.nlist
        sample_d = x_dev if n <= cap else x_dev[
            jnp.asarray(np.sort(rng.choice(n, cap, replace=False)))
        ]
        key = jax.random.PRNGKey(cfg.seed)
        k1, k2 = jax.random.split(key)
        self.centroids, assign = kmeans_fit(
            k1, sample_d, cfg.nlist, iters=cfg.train_iters
        )
        nsamp = int(sample_d.shape[0])
        nsub = min(nsamp, cfg.pq_train_sample)
        sub_idx = jnp.asarray(np.sort(rng.choice(nsamp, nsub, replace=False)))
        residuals = sample_d[sub_idx] - self.centroids[assign[sub_idx]]
        self._train_pq(k2, residuals)
        self.trained = True

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> None:
        """Assign → residual-encode (``encode_vectors``, declared at
        ``ivf_flat_index.h:164-167``) → scatter codes (+ raw) into arenas."""
        if not self.trained:
            raise RuntimeError("index must be trained before add()")
        self._guard_host_rerank_mutation()
        cfg = self.config
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n == 0:
            return
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.uint64)
        if self.metric == Metric.COSINE:
            vectors = np.asarray(l2_normalize(jnp.asarray(vectors)))
        assign_metric = (
            Metric.INNER_PRODUCT
            if self.metric == Metric.INNER_PRODUCT
            else Metric.L2
        )
        vec_orig = jnp.asarray(vectors)
        vec_d = self._rot(vec_orig)
        assignments = np.asarray(
            kmeans_assign(vec_d, self.centroids, assign_metric)
        )
        self._ingest(vec_d, ids, assignments, vec_orig=vec_orig)

    def add_from_device(
        self, x_dev: jax.Array, ids: np.ndarray | None = None
    ) -> None:
        """Device-resident ingest (parity with
        ``IVFFlatIndex.build_from_device``): assign, residual-encode and
        scatter without staging the vectors through host RAM."""
        if not self.trained:
            raise RuntimeError("index must be trained before add()")
        self._guard_host_rerank_mutation()
        n = x_dev.shape[0]
        if n == 0:
            return
        if ids is None:
            ids = np.arange(self.ntotal, self.ntotal + n, dtype=np.uint64)
        x_dev = x_dev.astype(jnp.float32)
        if self.metric == Metric.COSINE:
            x_dev = l2_normalize(x_dev)
        x_orig = x_dev
        x_dev = self._rot(x_dev)
        assign_metric = (
            Metric.INNER_PRODUCT
            if self.metric == Metric.INNER_PRODUCT
            else Metric.L2
        )
        assignments = np.asarray(
            kmeans_assign(x_dev, self.centroids, assign_metric)
        )
        self._ingest(x_dev, ids, assignments, vec_orig=x_orig)

    def _ingest(self, vec_d, ids, assignments: np.ndarray,
                vec_orig=None) -> None:
        """Shared tail of add/add_from_device: encode + scatter. ``vec_d``
        is in the index's operating (possibly OPQ-rotated) frame for the
        code path; ``vec_orig`` is the ORIGINAL-frame copy the raw rerank
        arena stores (bf16 rounding in the rotated frame concentrates into
        the signal's few high-variance coordinates — the r3-r5 OPQ
        deep-rerank plateau). Without OPQ the two coincide."""
        if vec_orig is None:
            vec_orig = vec_d
        cfg = self.config
        codes = pq_encode(
            vec_d - self.centroids[jnp.asarray(assignments)], self.codebooks
        )
        # The whole grow→slot-plan→scatter sequence sits inside the
        # mutation gate: a search dispatched between _grow's arena pad and
        # the ids-table growth (or between _grow and the scatter) would
        # otherwise snapshot the new-capacity arena against the old-stride
        # ids table and map flat positions to wrong user ids.
        with self._mutate_lock:
            counts_h = np.asarray(self.counts)
            per_list = np.bincount(assignments, minlength=cfg.nlist)
            max_needed = int((counts_h + per_list).max())
            if max_needed > self.capacity:
                new_cap = max(max_needed, int(self.capacity * 1.5))
                new_cap = -(-new_cap // PackedListArena.SLOT_ALIGN) * \
                    PackedListArena.SLOT_ALIGN
                self._grow(new_cap)
            slots = compute_append_slots(np.asarray(self.counts), assignments)

            lists_d = jnp.asarray(assignments.astype(np.int32))
            slots_d = jnp.asarray(slots.astype(np.int32))
            self.code_arena_t = _scatter_codes(
                self.code_arena_t, lists_d, slots_d, codes
            )
            if self.raw is not None:
                self.raw = self.raw.append(
                    vec_orig, np.asarray(ids), assignments
                )
            else:
                self._counts = self._counts + jnp.asarray(
                    per_list.astype(np.int32)
                )
                # copy-on-write: a concurrent _search_finalize may be
                # mapping positions through the old table
                new_ids = self._ids.copy()
                new_ids[assignments, slots] = np.asarray(ids, np.uint64)
                self._ids = new_ids

    def remove_ids(self, ids: np.ndarray) -> int:
        """Delete vectors by user id (the PQ twin of
        ``IVFFlatIndex.remove_ids`` — a capability the reference never
        declared). One swap-from-tail plan (``models.arena.plan_removals``)
        drives every plane: the transposed code arena moves
        slots on device here, and the raw arena (``keep_raw``) replays the
        SAME deterministic plan inside ``PackedListArena.remove``, so code
        and raw slots stay aligned."""
        from cuda_acceleratedvectordatabaseengine.models.arena import (
            apply_removal_to_ids,
            plan_removals,
        )

        ids = np.unique(np.asarray(ids, np.uint64))
        ids = ids[ids != INVALID_ID]
        if ids.size == 0 or self.ntotal == 0:
            return 0
        with self._mutate_lock:
            mask = np.isin(self.ids, ids)
            lists, slots = np.nonzero(mask)
            if lists.size == 0:
                return 0
            counts_h = np.asarray(self.counts)
            move_l, src_s, dst_s, new_counts = plan_removals(
                counts_h, lists.astype(np.int64), slots.astype(np.int64)
            )
            n_removed = int((counts_h - new_counts).sum())
            if n_removed == 0:
                return 0
            ml = jnp.asarray(move_l, jnp.int32)
            src = jnp.asarray(src_s, jnp.int32)
            dst = jnp.asarray(dst_s, jnp.int32)
            self.code_arena_t = _remove_codes(
                self.code_arena_t, ml, src, dst
            )
            if self.raw is not None:
                # Same (lists, slots) → same deterministic plan inside.
                self.raw, _ = self.raw.remove(lists, slots)
            else:
                self._ids = apply_removal_to_ids(
                    self._ids, move_l, src_s, dst_s, new_counts, counts_h
                )
                self._counts = jnp.asarray(new_counts.astype(np.int32))
        return n_removed

    def reserve(self, capacity: int) -> None:
        """Pre-size the code arena for a bulk build: one pad instead of the
        repeated 1.5× ``_grow`` steps, whose old+new arenas transiently
        double multi-GB device footprints (the flat builder's
        capacity-planning analog, ``models/ivf_flat.py`` bulk pack)."""
        cap = -(-capacity // PackedListArena.SLOT_ALIGN) * \
            PackedListArena.SLOT_ALIGN
        if cap > self.capacity:
            with self._mutate_lock:
                if cap > self.capacity:
                    self._grow(cap)

    def _grow(self, new_cap: int) -> None:
        pad = new_cap - self.capacity
        self.code_arena_t = jnp.pad(
            self.code_arena_t, ((0, 0), (0, 0), (0, pad))
        )
        if self.raw is None:
            ids = np.full(
                (self.config.nlist, new_cap), INVALID_ID, np.uint64
            )
            ids[:, : self._ids.shape[1]] = self._ids
            self._ids = ids
        # raw arena grows itself inside append()
        elif self.raw.capacity < new_cap:
            self.raw = self.raw.grow(new_cap)

    # ------------------------------------------------------------------ #
    # search
    # ------------------------------------------------------------------ #

    def search(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        return self._search_finalize(*self._search_dispatch(queries, params))

    def search_async(
        self, queries: np.ndarray, params: SearchParams | None = None
    ):
        """Dispatch/finalize split with the IVF-Flat contract (see
        ``IVFFlatIndex.search_async``): the returned thunk forces the
        device shortlist and runs the host-side stages (id mapping +
        host-store exact rerank when attached)."""
        state = self._search_dispatch(queries, params)
        return lambda: self._search_finalize(*state)

    def _search_dispatch(
        self, queries: np.ndarray, params: SearchParams | None = None
    ):
        """Stage 1: dispatch the device scan (async — the returned arrays
        are unforced JAX values). ``_search_finalize`` forces them and runs
        the host-side stages; splitting the two lets a caller overlap the
        device scan of batch i+1 with the host rerank of batch i
        (``search_batches_pipelined``)."""
        params = params or SearchParams()
        if not self.trained:
            raise RuntimeError("index must be trained before search()")
        queries = np.ascontiguousarray(queries, np.float32)
        if queries.ndim == 1:
            queries = queries[None]
        b = queries.shape[0]
        bs = bucket_size(b)
        if bs > b:
            queries = np.pad(queries, ((0, bs - b), (0, 0)))
        if self.config.query_upload_dtype == "bfloat16":
            # Halved H2D query upload (see IVFFlatIndex.search_async).
            import ml_dtypes

            queries = queries.astype(ml_dtypes.bfloat16)
        nprobe = params.nprobe
        if nprobe <= 0:  # measured-coverage calibration, as in IVF-Flat
            nprobe = self.calibrated_nprobe or SearchParams().nprobe
        nprobe = min(nprobe, self.config.nlist)
        rerank_k = 0
        if params.use_exact_rerank and self.raw is not None:
            rerank_k = min(max(4 * params.k, params.k), 256)
        # Past the HBM wall (keep_raw=False + attached host store) the
        # exact rerank runs HOST-side: the device returns a top-R ADC
        # shortlist and the host recomputes exact distances from the int8
        # store (io_host/host_rerank; the composition of the reference's
        # declared rerank_k surface, ``engine/ivf_flat_index.h:153-157``,
        # with its declared host tier, ``format/storage.h:124-173``).
        host_rr = (
            params.use_exact_rerank
            and self.raw is None
            and self._host_rr is not None
        )
        k_dev = params.k
        if host_rr:
            k_dev = min(
                max(self.host_rerank_k, params.k), self.capacity * nprobe
            )

        # Snapshot device handles + the host id table and dispatch under
        # the mutation gate (see _mutate_lock); finalize maps positions
        # through the SNAPSHOTTED table so a concurrent donating
        # append/remove can neither invalidate the dispatched buffers nor
        # remap positions to the wrong user ids.
        with self._mutate_lock:
            raw_arena = self.raw.arena if self.raw is not None else None
            raw_sq = self.raw.arena_sq if self.raw is not None else None
            raw_scale = (
                self.raw.arena_scale if self.raw is not None else None
            )
            raw_anchors = self.raw.anchors if self.raw is not None else None
            ids_table = self.ids
            capacity = self.capacity
            d, pos = _ivf_pq_search_device(
                jnp.asarray(queries),
                self.centroids,
                self.codebooks,
                self.code_arena_t,
                self.counts,
                raw_arena,
                raw_sq,
                raw_scale,
                raw_anchors,
                nprobe,
                k_dev,
                self.metric,
                rerank_k,
                opq_R=self.opq_R,
                # Host-rerank shortlists may cap each list's contribution
                # at a per-list depth (opt-in; the exact rerank absorbs the
                # truncation); exact searches keep the full ADC top-k.
                k_inner=(self.host_rerank_k_inner if host_rr else 0),
                scan_capacity=self._scan_capacity_hint(),
            )
        return d, pos, b, host_rr, queries, params, ids_table, capacity

    def _search_finalize(
        self, d, pos, b, host_rr, queries, params, ids_table, capacity
    ):
        """Stage 2: force the device results (blocks), map arena positions
        to ids, and run the host-store exact rerank when attached."""
        d = np.asarray(d)[:b].copy()
        pos = np.asarray(pos)[:b]
        flat_ids = ids_table.reshape(-1)
        safe = np.clip(pos, 0, flat_ids.size - 1)
        out_ids = flat_ids[safe]
        out_ids[pos < 0] = INVALID_ID
        d[pos < 0] = FLT_MAX
        probed = np.unique(pos[pos >= 0] // capacity)
        self.list_access_count[probed] += 1
        if host_rr:
            q_rr = queries[:b]
            if self.metric == Metric.COSINE:
                nrm = np.linalg.norm(q_rr, axis=1, keepdims=True)
                q_rr = q_rr / np.maximum(nrm, 1e-12)
            if self.host_rerank_margin > 0 and d.shape[1] > params.k:
                # Adaptive depth: candidates whose ADC distance exceeds
                # (1+margin)× the query's k-th ADC distance can't
                # plausibly enter the exact top-k — drop them before the
                # host gather+dot (INVALID_ID candidates map to row -1,
                # which the rerank kernel skips). ADC distances are on the
                # squared scale for L2; the margin is calibrated there.
                dk = d[:, params.k - 1: params.k]
                cut = dk + self.host_rerank_margin * np.abs(dk)
                keep = d <= cut
                # instrumentation: mean kept candidates per query (the
                # host stage's work scales with this, not rerank_k)
                self.last_rerank_kept = float(keep.sum(1).mean())
                out_ids = np.where(keep, out_ids, INVALID_ID)
            if q_rr.dtype != np.float32:   # bf16 upload transport
                q_rr = q_rr.astype(np.float32)
            d, out_ids = self._host_rr.rerank(
                q_rr, out_ids, self.metric, params.k
            )
        return d, out_ids

    def search_batches_pipelined(
        self, batches, params: SearchParams | None = None
    ):
        """Two-stage pipelined serving loop: the device ADC scan of batch
        i+1 is dispatched (async XLA) before batch i's host-side stages
        (id mapping + host-store exact rerank) run, so device and host work
        overlap — the capacity tier's production loop, where each stage is
        a comparable fraction of batch time. Yields (dists, ids) per input
        batch, in order."""
        pending = None
        for q in batches:
            nxt = self._search_dispatch(q, params)
            if pending is not None:
                yield self._search_finalize(*pending)
            pending = nxt
        if pending is not None:
            yield self._search_finalize(*pending)

    def search_batch(self, queries, params=None):
        return self.search(queries, params)

    # ------------------------------------------------------------------ #
    # residency surface (parity with IVFFlatIndex / declared GpuCache)
    # ------------------------------------------------------------------ #

    def warmup_lists(self, list_ids=None, batch_sizes=(1, 8, 64),
                     nprobes=None) -> None:
        """Warm = compile the search executables per batch bucket × nprobe
        value (the arena is already HBM-resident; nprobe is shape-static —
        see IVFFlatIndex.warmup_lists)."""
        if not self.trained:
            return
        if nprobes is None:
            nprobes = (SearchParams().nprobe,)
        dummy = np.zeros((1, self.config.dimension), np.float32)
        # The rerank path is a DIFFERENT device program (its shortlist
        # k_dev / rerank_k is shape-static): when an exact-rerank stage
        # exists (resident raw arena or attached host store), warm both.
        reranks = (False, True) if (
            self.raw is not None or self._host_rr is not None
        ) else (False,)
        for np_ in nprobes:
            for bs in batch_sizes:
                for rr in reranks:
                    self.search(np.repeat(dummy, bs, axis=0),
                                SearchParams(nprobe=int(np_),
                                             use_exact_rerank=rr))
        if list_ids is not None:
            self.list_access_count[np.asarray(list_ids, np.int64)] += 1

    def _guard_host_rerank_mutation(self) -> None:
        """Adding rows the host store doesn't have would make the exact
        rerank silently DROP them (unknown ids map to no row → FLT_MAX):
        refuse mutation while a host reranker is attached."""
        if self._host_rr is not None:
            raise RuntimeError(
                "index is serving with an attached host-rerank store "
                "(read-only); rebuild the epoch to add vectors"
            )

    def attach_host_rerank(self, store, rerank_k: int = 128,
                           k_inner: int = 0,
                           margin: float = 0.0) -> None:
        """Enable exact rerank from a host-RAM :class:`HostListStore` when
        ``keep_raw=False`` (the capacity tier: codes resident on device,
        raw int8 rows in host RAM). After this, ``use_exact_rerank``
        searches fetch a top-``rerank_k`` ADC shortlist from the device and
        rerank it host-side — see ``io_host/host_rerank``.

        ``k_inner=0`` (default) serves the exact ADC top-R shortlist over
        the probe union; >0 opts into per-list k_inner truncation, which
        caps recall on clustered data (all true neighbors share the
        query's home list).

        ``margin > 0`` enables ADAPTIVE per-query rerank depth: only
        candidates whose ADC distance is within ``(1+margin)×`` the
        query's k-th ADC distance (squared scale for L2) are reranked —
        the rest cannot plausibly enter the exact top-k, so the host
        skips their gather+dot entirely. Easy queries (sharp ADC
        separation) then cost a fraction of ``rerank_k`` while hard ones
        keep the full depth; the fixed-depth alternative pays the
        worst-case cost on every query."""
        from cuda_acceleratedvectordatabaseengine.io_host.host_rerank import (  # noqa: E501
            HostReranker,
        )

        if self.raw is not None:
            raise ValueError(
                "host rerank is the keep_raw=False path; a resident raw "
                "arena already reranks on device"
            )
        self._host_rr = (
            store if isinstance(store, HostReranker) else HostReranker(store)
        )
        self.host_rerank_k = int(rerank_k)
        self.host_rerank_k_inner = int(k_inner)
        self.host_rerank_margin = float(margin)

    def evict_list(self, list_id: int) -> None:
        self.list_access_count[list_id] = 0

    def get_hot_lists(self, n: int) -> np.ndarray:
        return np.argsort(-self.list_access_count, kind="stable")[:n]

    # ------------------------------------------------------------------ #
    # persistence
    # ------------------------------------------------------------------ #

    def state_arrays(self) -> dict:
        out = {
            "centroids": np.asarray(self.centroids),
            "codebooks": np.asarray(self.codebooks),
            "codes": np.asarray(self.code_arena),
            "counts": np.asarray(self.counts),
            "ids": self.ids,
        }
        if self.opq_R is not None:
            out["opq_R"] = np.asarray(self.opq_R)
        if self.raw is not None:
            # to_host() dequantizes int8 arenas (scale × code); a bare
            # astype(float32) would persist raw codes as if they were values.
            out["arena"] = self.raw.to_host()["arena"]
        return out

    def calibrate_nprobe(
        self,
        queries: np.ndarray | None = None,
        target_coverage: float = 0.99,
        k: int = 10,
        candidates: tuple = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128),
        sample: int = 512,
        seed: int = 0,
    ) -> dict:
        """Measured-coverage nprobe calibration (same semantics as
        :meth:`IVFFlatIndex.calibrate_nprobe`; shared implementation in
        ``models/calibrate.py``). Ground truth is the full-probe search on
        the index's own stored representation — with exact rerank when raw
        rows are retained, so the curve reflects probing loss rather than
        PQ ranking noise. Sets ``self.calibrated_nprobe`` (used by
        ``SearchParams(nprobe=0)``)."""
        if not self.trained:
            raise RuntimeError("index must be trained before calibration")
        from cuda_acceleratedvectordatabaseengine.models.calibrate import (  # noqa: E501
            probe_coverage_calibrate,
            sample_stored_rows,
        )

        if queries is None:
            if self.raw is None:
                raise ValueError(
                    "keep_raw=False index has no stored rows to sample — "
                    "pass held-out queries"
                )
            # raw rows live in the ORIGINAL frame (the rerank's frame) —
            # directly usable as query-space samples, OPQ or not.
            queries = sample_stored_rows(self.raw, sample, seed)
        result = probe_coverage_calibrate(
            centroids=self.centroids,
            metric=self.metric,
            ids_table=self.ids,
            queries=queries,
            exact_search_fn=lambda q, kk: self.search(
                q, SearchParams(
                    nprobe=self.config.nlist, k=kk,
                    use_exact_rerank=self.raw is not None,
                )
            ),
            target_coverage=target_coverage,
            k=k,
            candidates=candidates,
            # centroids are stored rotated under OPQ; rank in that frame
            query_transform=self._rot if self.opq_R is not None else None,
        )
        self.calibrated_nprobe = result["nprobe"]
        return result

    def save(self, path: str) -> None:
        from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
            save_ivf_pq,
        )

        # Mutation gate: the snapshot must fetch one consistent arena
        # state, and a donating append/remove dispatched mid-fetch would
        # invalidate the buffers being read (see _mutate_lock).
        with self._mutate_lock:
            save_ivf_pq(path, self)

    @classmethod
    def load(cls, path: str) -> "IVFPQIndex":
        from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
            load_ivf_pq,
        )

        return load_ivf_pq(path)

    def memory_stats(self) -> dict:
        code_bytes = self.code_arena_t.size
        raw_bytes = self.raw.nbytes_device() if self.raw is not None else 0
        cb_bytes = 0 if self.codebooks is None else self.codebooks.size * 4
        cent_bytes = 0 if self.centroids is None else self.centroids.size * 4
        return {
            "code_bytes": code_bytes,
            "raw_bytes": raw_bytes,
            "total_bytes": code_bytes + raw_bytes + cb_bytes + cent_bytes,
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "capacity_per_list": self.capacity,
        }
