"""Sharded IVF search + data-parallel k-means (shard_map + collectives).

Design (SURVEY.md §7 step 7, §2.9): the arena's **slot axis** is sharded
round-robin across the mesh — every chip holds slice ``j → logical slot
j*N + s`` of *every* inverted list. Compared to sharding whole lists across
chips this is:

  - perfectly load-balanced (each chip scans exactly 1/N of every probed
    list — no per-chip probe-budget heuristics, no worst-case skew), and
  - fixed-shape by construction (the same ``scan_probed_lists`` kernel runs
    with ``slot_stride=N``), so the merge is a plain ``all_gather`` of
    ``[B, k]`` candidates + one replicated top-k.

The k-means trainer is data-parallel: each chip reduces its partial
``onehot.T @ x`` centroid sums and counts, combined with ``psum`` — the
classic DP allreduce pattern, over XLA collectives (NCCL on GPUs), which the reference
never had.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from cuda_acceleratedvectordatabaseengine.ops.distance import (
    Metric,
    pairwise_distance,
)
from cuda_acceleratedvectordatabaseengine.ops.kmeans import (
    _reseed_step,
    kmeans_assign,
    kmeans_pp_init,
)
from cuda_acceleratedvectordatabaseengine.ops.normalize import l2_normalize
from cuda_acceleratedvectordatabaseengine.ops.dispatch import (
    resolve_scan_impl,
    run_scan,
)
from cuda_acceleratedvectordatabaseengine.ops.pq import scan_probed_codes
from cuda_acceleratedvectordatabaseengine.ops.topk import topk_smallest
from cuda_acceleratedvectordatabaseengine.parallel.mesh import SHARD_AXIS
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
    FLT_MAX,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.utils.batching import bucket_size


def _prep_queries(queries):
    """Bucket-pad a query batch for the SPMD search, keeping device-resident
    input ON device (a numpy round trip would re-upload ~25 MB per b8192
    batch). Returns ``(queries, b)``."""
    if isinstance(queries, jax.Array):
        q = queries.astype(jnp.float32)
        if q.ndim == 1:
            q = q[None]
        b = q.shape[0]
        bs = bucket_size(b)
        if bs > b:
            q = jnp.pad(q, ((0, bs - b), (0, 0)))
        return q, b
    q = np.ascontiguousarray(queries, np.float32)
    if q.ndim == 1:
        q = q[None]
    b = q.shape[0]
    bs = bucket_size(b)
    if bs > b:
        q = np.pad(q, ((0, bs - b), (0, 0)))
    return q, b


def sharded_zeros(shape, dtype, sharding) -> jax.Array:
    """Zeros created shard by shard on their devices: building the full
    array on one device first and then splitting it would need the whole
    (multi-GB) arena on the first device."""
    return jax.jit(
        lambda: jnp.zeros(shape, dtype), out_shardings=sharding
    )()


def _striping_perm(capacity: int, n_shards: int) -> np.ndarray:
    """Physical slot → logical slot permutation for round-robin striping.

    Physical slot p lives on shard ``s = p // (cap/N)`` at local offset
    ``j = p % (cap/N)`` and holds logical slot ``j*N + s``."""
    local = capacity // n_shards
    p = np.arange(capacity)
    s, j = p // local, p % local
    return (j * n_shards + s).astype(np.int32)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "nprobe", "k", "metric", "n_shards",
                     "global_cap", "scan_impl", "has_scale", "has_anchor"),
)
def _sharded_search(
    queries, centroids, arena_s, arena_sq_s, counts, arena_scale,
    arena_anchors, mesh, nprobe, k, metric, n_shards, global_cap,
    scan_impl="gather", has_scale=False, has_anchor=False,
):
    def local_fn(q, c, arena_l, arena_sq_l, cnt, scale, anchors):
        s = jax.lax.axis_index(SHARD_AXIS)
        scale_arg = scale if has_scale else None
        anchor_arg = anchors if has_anchor else None
        qf = q.astype(jnp.float32)
        if metric == Metric.COSINE:
            qf = l2_normalize(qf)
        coarse = pairwise_distance(qf, c, metric)       # replicated [B,nlist]
        _, probe = topk_smallest(coarse, nprobe)
        probe = probe.astype(jnp.int32)
        d, pos = run_scan(
            scan_impl, qf, arena_l, arena_sq_l, cnt, probe, k, metric,
            arena_scale=scale_arg, arena_anchors=anchor_arg,
            slot_stride=n_shards, slot_offset=s, global_capacity=global_cap,
            vma_axes=(SHARD_AXIS,),
        )
        # Cross-chip merge: k candidates per chip → all_gather →
        # replicated global top-k. k·B·8 bytes per chip — tiny next to the scan.
        d_all = jax.lax.all_gather(d, SHARD_AXIS, axis=-1, tiled=True)
        p_all = jax.lax.all_gather(pos, SHARD_AXIS, axis=-1, tiled=True)
        return topk_smallest(d_all, k, idx=p_all)

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(None, SHARD_AXIS, None), P(None, SHARD_AXIS), P(),
            P(None, SHARD_AXIS), P(),
        ),
        out_specs=(P(), P()),
        # Outputs ARE replicated (identical all_gather + top-k on every
        # chip) but the static vma checker can't prove it through top_k.
        check_vma=False,
    )
    return fn(queries, centroids, arena_s, arena_sq_s, counts, arena_scale,
              arena_anchors)


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "n_shards", "quantize", "has_anchor"),
    donate_argnums=(0, 1, 2),
)
def _pack_stripe(
    arena_s, sq_s, scale_s, x, lists, slots, anchors,
    mesh, n_shards, quantize, has_anchor,
):
    """Scatter one replicated chunk into the slot-striped arenas: each chip
    writes only the rows whose logical slot lands on its stripe (slot % N ==
    shard); foreign rows divert to the per-chip TRASH slot (local index
    cap_l − 1, logical slot ≥ global capacity — never valid in any scan).
    Donated arenas: the functional update would otherwise hold old+new
    multi-GB arenas per chunk. Quantization math is identical to the
    single-chip bulk pack (``models/ivf_flat._bulk_pack_device``)."""

    def local_fn(arena_l, sq_l, scale_l, x, lists, slots, anch):
        s = jax.lax.axis_index(SHARD_AXIS)
        cap_l = arena_l.shape[1]
        mine = (slots % n_shards) == s
        lslot = jnp.where(mine, slots // n_shards, cap_l - 1)
        xf = x.astype(jnp.float32)
        if quantize:
            a_rows = anch[lists] if has_anchor else 0.0
            res = xf - a_rows
            row_scale = jnp.maximum(
                jnp.max(jnp.abs(res), axis=-1), 1e-12
            ) / 127.0
            hi = jnp.clip(
                jnp.round(res / row_scale[:, None]), -127, 127
            ).astype(jnp.int8)
            deq = a_rows + hi.astype(jnp.float32) * row_scale[:, None]
            scale_l = scale_l.at[lists, lslot].set(row_scale)
        else:
            hi = xf.astype(arena_l.dtype)
            deq = hi.astype(jnp.float32)
        arena_l = arena_l.at[lists, lslot].set(hi)
        sq_l = sq_l.at[lists, lslot].set(jnp.sum(deq * deq, -1))
        return arena_l, sq_l, scale_l

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(
            P(None, SHARD_AXIS, None), P(None, SHARD_AXIS),
            P(None, SHARD_AXIS), P(), P(), P(), P(),
        ),
        out_specs=(
            P(None, SHARD_AXIS, None), P(None, SHARD_AXIS),
            P(None, SHARD_AXIS),
        ),
    )
    return fn(arena_s, sq_s, scale_s, x, lists, slots, anchors)


class _ShardedServingSurface:
    """The server-facing index protocol over a sharded view.

    ``server.service.VdbEngine`` drives every live index through one
    duck-typed surface — ``trained``/``ntotal``/``add``/``remove_ids``/
    ``save``/``warmup_lists``/``memory_stats``/``calibrated_nprobe`` — so a
    sharded index can swap in at epoch activation (the multi-GPU serving the
    reference *claimed* with zero code behind it:
    ``/root/reference/README.md:25``, ``configs/production.yaml:11``).

    Mutations delegate to the single-chip base index, then ``refresh()``
    re-publishes the stripes — one resharding ``device_put`` per mutation
    batch, amortized over every subsequent SPMD search. A view built by
    ``build_on_mesh`` has no base and is read-only: like the streaming
    tier, its mutation path is the epoch rebuild pipeline.

    Publication is guarded by ``_publish_lock``: ``refresh`` stages every
    new array first and swaps the attributes atomically, while ``search``
    snapshots them under the same lock — a search concurrent with a
    mutation serves the *previous* consistent epoch of stripes (device
    arrays are functional; nothing donates them, so in-flight scans stay
    valid).
    """

    base = None

    def _init_serving(self) -> None:
        import threading

        self._publish_lock = threading.Lock()

    def _require_base(self, op: str) -> None:
        if self.base is None:
            raise PermissionError(
                f"{op}: mesh-built sharded index has no base to mutate; "
                "rebuild an epoch instead (read-only serving view)"
            )

    @property
    def trained(self) -> bool:
        return bool(getattr(self, "_published", False))

    @property
    def read_only(self) -> bool:
        return self.base is None or getattr(self.base, "read_only", False)

    @property
    def ntotal(self) -> int:
        if self.base is not None:
            return self.base.ntotal
        return int(np.asarray(self.counts).sum())

    @property
    def calibrated_nprobe(self):
        return getattr(self.base, "calibrated_nprobe", None)

    @calibrated_nprobe.setter
    def calibrated_nprobe(self, value):
        self._require_base("calibrated_nprobe")
        self.base.calibrated_nprobe = value

    def add(self, vectors, ids=None) -> None:
        self._require_base("add")
        self.base.add(vectors, ids)
        self.refresh()

    def remove_ids(self, ids) -> int:
        self._require_base("remove_ids")
        n = self.base.remove_ids(ids)
        if n:
            self.refresh()
        return n

    def save(self, path: str) -> None:
        self._require_base("save")
        self.base.save(path)

    def _warmup_params(self):
        return (SearchParams(),)

    def warmup_lists(self, list_ids=None, batch_sizes=(1, 8, 64),
                     nprobes=None) -> None:
        """Compile-warm the SPMD search executable per batch bucket ×
        nprobe (× rerank variant on PQ) — same contract as the single-chip
        ``warmup_lists`` the server calls at epoch activation. ``list_ids``
        is accepted for signature parity (stripes are HBM-resident; there
        is no per-list residency to warm)."""
        if not self.trained:
            return
        if nprobes is None:
            nprobes = (SearchParams().nprobe,)
        dim = self.config.dimension
        dummy = np.zeros((1, dim), np.float32)
        for np_ in nprobes:
            for bs in batch_sizes:
                q = np.repeat(dummy, bs, axis=0)
                for base_params in self._warmup_params():
                    import dataclasses as _dc

                    self.search(
                        q, _dc.replace(base_params, nprobe=int(np_))
                    )

    def _device_arrays(self) -> dict:
        raise NotImplementedError

    def memory_stats(self) -> dict:
        """Mesh-wide device accounting. ``total_bytes`` sums the published
        stripes and replicated smalls across ALL shards, plus the retained
        base arena (held for mutation/persistence) when present."""
        striped = sum(int(a.nbytes) for a in self._device_arrays().values())
        base_bytes = (
            self.base.memory_stats()["total_bytes"]
            if self.base is not None else 0
        )
        return {
            "striped_bytes": striped,
            "base_bytes": base_bytes,
            "total_bytes": striped + base_bytes,
            "total_vectors": self.ntotal,
            "nlist": self.config.nlist,
            "n_shards": self.n_shards,
            "capacity_per_list": self.global_cap,
        }


class ShardedIVFFlatIndex(_ShardedServingSurface):
    """Multi-chip serving view over a trained :class:`IVFFlatIndex`.

    Build/ingest happen on the base index; ``refresh()`` (re)publishes its
    arena onto the mesh — the multi-chip analog of the reference's epoch
    activation swap (``server/query_service.cpp:254-257``). Searches then run
    SPMD across all chips with an all-gather merge.

    :meth:`build_on_mesh` instead trains AND packs on the mesh with no
    single-chip base at all — the path for corpora sized for the whole
    slice rather than one chip.
    """

    def __init__(self, base: IVFFlatIndex, mesh, scan_impl: str = "auto"):
        if not base.trained:
            raise RuntimeError("base index must be trained")
        self.base = base
        self.config = base.config
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        self.metric = base.metric
        self.scan_impl = scan_impl
        self._init_serving()
        self._published = False
        self.refresh()

    @classmethod
    def build_on_mesh(
        cls,
        mesh,
        config,
        x,
        ids: np.ndarray | None = None,
        key: jax.Array | None = None,
        centroids: jax.Array | None = None,
        chunk_rows: int = 250_000,
        scan_impl: str = "auto",
        train_iters: int | None = None,
    ) -> "ShardedIVFFlatIndex":
        """Train AND build entirely on the mesh — no single-chip base index
        ever exists. Training is the full DP k-means
        (:func:`sharded_kmeans_fit`: psum'd Lloyd + replicated twin/orphan
        reseeding); packing scatters each chunk onto the slot-striped
        arenas via :func:`_pack_stripe` (each chip quantizes and writes its
        1/N stripe). This is the capability the reference only claimed
        (``README.md:25`` multi-GPU; zero sharding code — SURVEY §2.9).
        """
        self = cls.__new__(cls)
        self.base = None
        self.config = config
        self.mesh = mesh
        n_shards = self.n_shards = mesh.devices.size
        self.metric = config.metric
        self.scan_impl = scan_impl
        self._init_serving()

        n, dim = x.shape
        if ids is None:
            ids = np.arange(n, dtype=np.uint64)
        repl = NamedSharding(mesh, P())
        shard_rows = NamedSharding(mesh, P(SHARD_AXIS, None))

        # ---- train (DP over the mesh) -------------------------------- #
        if centroids is None:
            key = key if key is not None else jax.random.PRNGKey(config.seed)
            cap_train = config.train_sample_per_list * config.nlist
            if n > cap_train:
                stride = n // cap_train
                sample = x[:: stride][:cap_train]
            else:
                sample = x
            sample = jnp.asarray(sample, jnp.float32)
            if self.metric == Metric.COSINE:
                sample = l2_normalize(sample)
            pad = (-sample.shape[0]) % n_shards
            if pad:
                sample = jnp.concatenate(
                    [sample, jnp.zeros((pad, dim), jnp.float32)]
                )
            centroids = sharded_kmeans_fit(
                mesh, key, jax.device_put(sample, shard_rows), config.nlist,
                iters=train_iters or config.train_iters,
            )
        self.centroids = jax.device_put(
            jnp.asarray(centroids, jnp.float32), repl
        )

        # ---- assign (chunked, row-parallel) -------------------------- #
        assign_metric = (
            Metric.INNER_PRODUCT if self.metric == Metric.INNER_PRODUCT
            else Metric.L2
        )
        assigns = []
        for i0 in range(0, n, chunk_rows):
            xc = jnp.asarray(x[i0:i0 + chunk_rows], jnp.float32)
            if self.metric == Metric.COSINE:
                xc = l2_normalize(xc)
            assigns.append(
                np.asarray(kmeans_assign(xc, self.centroids, assign_metric))
            )
        assignments = np.concatenate(assigns)
        counts_h = np.bincount(
            assignments, minlength=config.nlist
        ).astype(np.int64)
        # Local capacity: stripe share of the fullest list + 1 TRASH slot
        # (foreign rows divert there during the pack), 16-aligned so the
        # grouped kernel's slot tile fits.
        cap_l = max(-(-(
            -(-int(counts_h.max()) // n_shards) + 1
        ) // 16) * 16, 16)
        global_cap = cap_l * n_shards

        # ---- pack (chunked scatter onto the striped arenas) ---------- #
        dtype = jnp.dtype(config.dtype)
        quantize = dtype == jnp.int8
        nlist = config.nlist
        shard3 = NamedSharding(mesh, P(None, SHARD_AXIS, None))
        shard2 = NamedSharding(mesh, P(None, SHARD_AXIS))
        arena_s = sharded_zeros((nlist, global_cap, dim), dtype, shard3)
        sq_s = sharded_zeros((nlist, global_cap), jnp.float32, shard2)
        scale_s = sharded_zeros((nlist, global_cap), jnp.float32, shard2)
        self.has_scale = quantize
        self.has_anchor = quantize
        anchors = (
            self.centroids if quantize
            else jax.device_put(jnp.zeros((nlist, dim), jnp.float32), repl)
        )
        from cuda_acceleratedvectordatabaseengine.models.arena import (
            compute_append_slots,
        )

        running = np.zeros(nlist, np.int64)
        ids_table = np.full((nlist, global_cap), INVALID_ID, np.uint64)
        for i0 in range(0, n, chunk_rows):
            i1 = min(i0 + chunk_rows, n)
            a_c = assignments[i0:i1]
            slots = compute_append_slots(running, a_c)
            running += np.bincount(a_c, minlength=nlist)
            xc = jnp.asarray(x[i0:i1], jnp.float32)
            if self.metric == Metric.COSINE:
                xc = l2_normalize(xc)
            arena_s, sq_s, scale_s = _pack_stripe(
                arena_s, sq_s, scale_s, xc,
                jnp.asarray(a_c.astype(np.int32)),
                jnp.asarray(slots.astype(np.int32)),
                anchors, mesh, n_shards, quantize, self.has_anchor,
            )
            ids_table[a_c, slots] = ids[i0:i1].astype(np.uint64)

        self.arena_s = arena_s
        self.arena_sq_s = sq_s
        self.arena_scale = scale_s
        self.arena_anchors = anchors
        self.counts = jax.device_put(
            jnp.asarray(counts_h.astype(np.int32)), repl
        )
        self._ids_table = ids_table
        self.global_cap = global_cap
        self._published = True
        return self

    def refresh(self) -> None:
        """Re-stripe the base arena across the mesh (one gather + resharding
        device_put; the permutation is count-independent so no host work)."""
        arena = self.base.arena
        cap = arena.capacity
        n = self.n_shards
        if cap % n:
            pad = n - cap % n
            self.base.arena = arena = arena.grow(cap + pad)
            cap += pad
        shard3 = NamedSharding(self.mesh, P(None, SHARD_AXIS, None))
        shard2 = NamedSharding(self.mesh, P(None, SHARD_AXIS))
        repl = NamedSharding(self.mesh, P())
        # Stage every new array first, publish atomically below: a search
        # thread snapshotting mid-refresh must never mix stripe epochs
        # (e.g. a grown arena with the previous ids table).
        has_scale = arena.arena_scale is not None
        if n == 1:
            # The striping permutation is the identity on a 1-device mesh
            # (local=cap ⇒ perm[p]=p); skip the gather so publish is a
            # zero-copy resharding — the permuted copy would briefly
            # DOUBLE the arena in HBM, which cannot fit next to a
            # device-filling base.
            arena_s = jax.device_put(arena.arena, shard3)
            arena_sq_s = jax.device_put(arena.arena_sq, shard2)
            arena_scale = jax.device_put(
                arena.arena_scale if has_scale
                else jnp.zeros((arena.nlist, n), jnp.float32),
                shard2,
            )
        else:
            perm = jnp.asarray(_striping_perm(cap, n))
            arena_s = jax.device_put(arena.arena[:, perm, :], shard3)
            arena_sq_s = jax.device_put(arena.arena_sq[:, perm], shard2)
            # int8 arenas: per-row dequant scales stripe with the slot
            # axis; residual anchors (tiny [nlist, D]) replicate.
            arena_scale = jax.device_put(
                arena.arena_scale[:, perm] if has_scale
                else jnp.zeros((arena.nlist, n), jnp.float32),
                shard2,
            )
        counts = jax.device_put(arena.counts, repl)
        centroids = jax.device_put(self.base.centroids, repl)
        has_anchor = arena.anchors is not None
        arena_anchors = jax.device_put(
            arena.anchors if has_anchor
            else jnp.zeros((arena.nlist, arena.dim), jnp.float32),
            repl,
        )
        with self._publish_lock:
            self.arena_s = arena_s
            self.arena_sq_s = arena_sq_s
            self.counts = counts
            self.centroids = centroids
            self.has_scale = has_scale
            self.arena_scale = arena_scale
            self.has_anchor = has_anchor
            self.arena_anchors = arena_anchors
            self._ids_table = arena.ids
            self.global_cap = cap
            self._published = True

    def search(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.search_async(queries, params)()

    def search_device(
        self, queries, params: SearchParams | None = None
    ):
        """Dispatch the SPMD search and return the DEVICE result arrays
        ``(distances, global positions)`` — no host transfer, no id
        mapping. The device-throughput measurement hook (mirrors the
        unsharded bench loop, which also never fetches per batch) and the
        building block for device-side pipelines."""
        params = params or SearchParams()
        queries, b = _prep_queries(queries)
        d_dev, pos_dev, _ids = self._dispatch(queries, params)
        return d_dev, pos_dev

    def _dispatch(self, queries, params):
        """Shared dispatch: snapshot one stripe epoch, launch the SPMD
        search, return ``(d_dev, pos_dev, ids_table)``."""
        nprobe = params.nprobe
        if nprobe <= 0:
            # auto: the base's measured-coverage calibration, same contract
            # as the single-chip search (SearchParams(nprobe=0)).
            nprobe = self.calibrated_nprobe or SearchParams().nprobe
        nprobe = min(nprobe, self.config.nlist)
        with self._publish_lock:
            # one consistent stripe epoch (see refresh)
            centroids, arena_s, arena_sq_s = (
                self.centroids, self.arena_s, self.arena_sq_s
            )
            counts, scale, anchors = (
                self.counts, self.arena_scale, self.arena_anchors
            )
            has_scale, has_anchor = self.has_scale, self.has_anchor
            global_cap, ids_table = self.global_cap, self._ids_table
        scan_impl = resolve_scan_impl(
            self.scan_impl, self.mesh.devices.flat[0].platform
        )
        d_dev, pos_dev = _sharded_search(
            jax.device_put(
                jnp.asarray(queries), NamedSharding(self.mesh, P())
            ),
            centroids, arena_s, arena_sq_s, counts, scale, anchors,
            self.mesh, nprobe, params.k, self.metric, self.n_shards,
            global_cap, scan_impl, has_scale, has_anchor,
        )
        return d_dev, pos_dev, ids_table

    def search_async(
        self, queries: np.ndarray, params: SearchParams | None = None
    ):
        """Dispatch/finalize split (``IVFFlatIndex.search_async``
        contract): the SPMD search dispatches now; the thunk forces the
        all-gather-merged results and maps positions through the snapshotted
        stripe-epoch id table."""
        params = params or SearchParams()
        queries, b = _prep_queries(queries)
        d_dev, pos_dev, ids_table = self._dispatch(queries, params)

        def finalize():
            d = np.asarray(d_dev)[:b].copy()
            pos = np.asarray(pos_dev)[:b]
            flat = ids_table.reshape(-1)
            safe = np.clip(pos, 0, flat.size - 1)
            ids = flat[safe]
            ids[pos < 0] = INVALID_ID
            d[pos < 0] = FLT_MAX
            return d, ids

        return finalize

    def _device_arrays(self) -> dict:
        return {
            "arena": self.arena_s,
            "arena_sq": self.arena_sq_s,
            "scale": self.arena_scale,
            "centroids": self.centroids,
            "anchors": self.arena_anchors,
        }


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "nprobe", "k", "metric", "n_shards",
                     "global_cap", "rerank_k", "has_raw", "has_scale",
                     "has_anchor"),
)
def _sharded_pq_search(
    queries, queries_orig, centroids, codebooks, codes_t_s,
    counts, raw_s, raw_sq_s, raw_scale_s, raw_anchors,
    mesh, nprobe, k, metric, n_shards, global_cap, rerank_k,
    has_raw=False, has_scale=False, has_anchor=False,
):
    """SPMD IVF-PQ search: per-chip grouped ADC over the slot-striped code
    arena, optional per-chip exact rerank against the striped raw arena,
    all_gather + replicated top-k merge.

    Covers the reference's declared GPU-resident PQ surface
    (``engine/ivf_flat_index.h:140-170``: device codebooks, distance tables,
    ``rerank_k``) at multi-chip scale. Rerank note: each chip reranks its
    own local top-``rerank_k`` ADC candidates, so the merged pool is the
    union of per-chip reranks — a superset of the single-chip pool (the
    standard distributed-top-k refinement; recall ≥ single-chip)."""

    def local_fn(q, q0, c, cb, codes_l, cnt, raw_l, raw_sq_l, raw_scale_l,
                 anchors):
        s = jax.lax.axis_index(SHARD_AXIS)
        qf = q.astype(jnp.float32)
        q0f = q0.astype(jnp.float32)        # original frame (rerank)
        if metric == Metric.COSINE:
            qf = l2_normalize(qf)
            q0f = l2_normalize(q0f)
        coarse_metric = (
            Metric.INNER_PRODUCT if metric == Metric.INNER_PRODUCT
            else Metric.L2
        )
        coarse = pairwise_distance(qf, c, coarse_metric)
        _, probe = topk_smallest(coarse, nprobe)
        keep = max(k, rerank_k)
        d, pos = scan_probed_codes(
            qf, codes_l, cnt, c, cb, probe.astype(jnp.int32), keep,
            inner_product=metric == Metric.INNER_PRODUCT,
            slot_stride=n_shards, slot_offset=s, global_capacity=global_cap,
            vma_axes=(SHARD_AXIS,),
        )
        if rerank_k > 0 and has_raw:
            # Positions are GLOBAL (logical slot space) but every local
            # candidate's slot ≡ s (mod N): map back to the local stripe
            # and gather from the chip-resident raw arena.
            nlist = cnt.shape[0]
            cap_l = raw_l.shape[1]
            dim = raw_l.shape[2]
            safe_p = jnp.maximum(pos, 0)
            lists = safe_p // global_cap
            slot_l = (safe_p % global_cap - s) // n_shards
            flat_idx = lists * cap_l + jnp.clip(slot_l, 0, cap_l - 1)
            cand = raw_l.reshape(nlist * cap_l, dim)[flat_idx].astype(
                jnp.float32
            )
            if has_scale:
                cand = cand * raw_scale_l.reshape(-1)[flat_idx][:, :, None]
            if has_anchor:
                cand = cand + anchors[lists]
            # Original-frame rerank at HIGHEST precision (the exact stage
            # — see models/ivf_pq's rerank block for both rationales).
            dots = jnp.einsum(
                "bd,bkd->bk", q0f, cand,
                preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST,
            )
            if metric == Metric.INNER_PRODUCT:
                exact = -dots
            elif metric == Metric.COSINE:
                c_sq = jnp.sum(cand * cand, axis=-1)
                exact = 1.0 - dots * jax.lax.rsqrt(jnp.maximum(c_sq, 1e-12))
            else:
                q_sq = jnp.sum(q0f * q0f, axis=-1)
                c_sq = jnp.sum(cand * cand, axis=-1)
                exact = jnp.maximum(
                    q_sq[:, None] - 2.0 * dots + c_sq, 0.0
                )
            d = jnp.where(pos >= 0, exact, jnp.inf)
        d_all = jax.lax.all_gather(d, SHARD_AXIS, axis=-1, tiled=True)
        p_all = jax.lax.all_gather(pos, SHARD_AXIS, axis=-1, tiled=True)
        out_d, out_p = topk_smallest(d_all, k, idx=p_all)
        if metric == Metric.COSINE and rerank_k == 0:
            # ADC ran in L2 space over unit vectors: ||q−x||² = 2(1−cos).
            out_d = jnp.where(jnp.isfinite(out_d), out_d * 0.5, out_d)
        return out_d, out_p

    fn = jax.shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(
            P(), P(), P(), P(), P(None, None, SHARD_AXIS),
            P(), P(None, SHARD_AXIS, None), P(None, SHARD_AXIS),
            P(None, SHARD_AXIS), P(),
        ),
        out_specs=(P(), P()),
        check_vma=False,    # see _sharded_search
    )
    return fn(queries, queries_orig, centroids, codebooks, codes_t_s,
              counts, raw_s, raw_sq_s, raw_scale_s, raw_anchors)


class ShardedIVFPQIndex(_ShardedServingSurface):
    """Multi-chip serving view over a trained :class:`IVFPQIndex`.

    Same striping design as :class:`ShardedIVFFlatIndex`: the code arena's
    slot axis is round-robin striped across the mesh (each chip ADC-scans
    exactly 1/N of every probed list); codebooks, centroids and counts
    replicate; the merge is one all_gather + replicated top-k. With
    ``keep_raw`` the raw arena stripes the same way, enabling per-chip
    exact rerank (``SearchParams.use_exact_rerank``)."""

    def __init__(self, base, mesh, scan_impl: str = "auto"):
        if not base.trained:
            raise RuntimeError("base index must be trained")
        self.base = base
        self.config = base.config
        self.mesh = mesh
        self.n_shards = mesh.devices.size
        self.metric = base.metric
        self._init_serving()
        self._published = False
        self.refresh()

    def refresh(self) -> None:
        """(Re)stripe the base arenas across the mesh — the multi-chip
        epoch-activation analog (``server/query_service.cpp:254-257``)."""
        base = self.base
        n = self.n_shards
        cap = base.capacity
        if cap % n:
            base._grow(cap + (n - cap % n))
            cap = base.capacity
        perm = jnp.asarray(_striping_perm(cap, n))
        shard_codes = NamedSharding(self.mesh, P(None, None, SHARD_AXIS))
        shard2 = NamedSharding(self.mesh, P(None, SHARD_AXIS))
        shard3 = NamedSharding(self.mesh, P(None, SHARD_AXIS, None))
        repl = NamedSharding(self.mesh, P())
        # Stage first, publish atomically (see _ShardedServingSurface).
        codes_t_s = jax.device_put(base.code_arena_t[:, :, perm],
                                   shard_codes)
        counts = jax.device_put(base.counts, repl)
        centroids = jax.device_put(base.centroids, repl)
        codebooks = jax.device_put(base.codebooks, repl)
        raw = base.raw
        has_raw = raw is not None
        if has_raw:
            if raw.capacity < cap:
                base.raw = raw = raw.grow(cap)
            raw_s = jax.device_put(raw.arena[:, perm, :], shard3)
            raw_sq_s = jax.device_put(raw.arena_sq[:, perm], shard2)
            has_scale = raw.arena_scale is not None
            raw_scale_s = jax.device_put(
                raw.arena_scale[:, perm] if has_scale
                else jnp.zeros((raw.nlist, n), jnp.float32), shard2,
            )
            has_anchor = raw.anchors is not None
            raw_anchors = jax.device_put(
                raw.anchors if has_anchor
                else jnp.zeros((raw.nlist, raw.dim), jnp.float32), repl,
            )
        else:
            nlist = base.config.nlist
            dim = base.config.dimension
            has_scale = has_anchor = False
            raw_s = jax.device_put(
                jnp.zeros((nlist, n, dim), jnp.bfloat16), shard3
            )
            raw_sq_s = jax.device_put(
                jnp.zeros((nlist, n), jnp.float32), shard2
            )
            raw_scale_s = jax.device_put(
                jnp.zeros((nlist, n), jnp.float32), shard2
            )
            raw_anchors = jax.device_put(
                jnp.zeros((nlist, dim), jnp.float32), repl
            )
        ids_table = base.ids
        with self._publish_lock:
            self.codes_t_s = codes_t_s
            self.counts = counts
            self.centroids = centroids
            self.codebooks = codebooks
            self.has_raw = has_raw
            self.raw_s = raw_s
            self.raw_sq_s = raw_sq_s
            self.has_scale = has_scale
            self.raw_scale_s = raw_scale_s
            self.has_anchor = has_anchor
            self.raw_anchors = raw_anchors
            self._ids_table = ids_table
            self.global_cap = cap
            self._published = True

    def search(
        self, queries: np.ndarray, params: SearchParams | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        return self.search_async(queries, params)()

    def search_async(
        self, queries: np.ndarray, params: SearchParams | None = None
    ):
        """Dispatch/finalize split (``IVFFlatIndex.search_async``
        contract) over the SPMD ADC search."""
        params = params or SearchParams()
        queries, b = _prep_queries(queries)
        nprobe = params.nprobe
        if nprobe <= 0:
            nprobe = self.calibrated_nprobe or SearchParams().nprobe
        nprobe = min(nprobe, self.config.nlist)
        with self._publish_lock:
            # one consistent stripe epoch (see refresh)
            centroids, codebooks = self.centroids, self.codebooks
            codes_t_s = self.codes_t_s
            counts = self.counts
            raw_s, raw_sq_s, raw_scale_s, raw_anchors = (
                self.raw_s, self.raw_sq_s, self.raw_scale_s,
                self.raw_anchors,
            )
            has_raw, has_scale, has_anchor = (
                self.has_raw, self.has_scale, self.has_anchor
            )
            global_cap, ids_table = self.global_cap, self._ids_table
        rerank_k = 0
        if params.use_exact_rerank and has_raw:
            rerank_k = min(max(4 * params.k, params.k), 256)
        q0 = jnp.asarray(queries)           # ORIGINAL frame (rerank's)
        q = q0
        if getattr(self.base, "opq_R", None) is not None:
            # Centroids/codes were published in the OPQ frame; the striped
            # raw rerank arena stays ORIGINAL-frame (models/ivf_pq._ingest
            # — rotated-frame bf16 storage concentrates rounding into the
            # signal coordinates). HIGHEST precision: see ops/pq._PREC_HI.
            q = jnp.matmul(
                q0, self.base.opq_R, precision=jax.lax.Precision.HIGHEST
            )
        repl = NamedSharding(self.mesh, P())
        d_dev, pos_dev = _sharded_pq_search(
            jax.device_put(q, repl), jax.device_put(q0, repl),
            centroids, codebooks, codes_t_s,
            counts, raw_s, raw_sq_s, raw_scale_s,
            raw_anchors, self.mesh, nprobe, params.k, self.metric,
            self.n_shards, global_cap, rerank_k, has_raw,
            has_scale, has_anchor,
        )

        def finalize():
            d = np.asarray(d_dev)[:b].copy()
            pos = np.asarray(pos_dev)[:b]
            flat_ids = ids_table.reshape(-1)
            safe = np.clip(pos, 0, flat_ids.size - 1)
            ids = flat_ids[safe]
            ids[pos < 0] = np.uint64(0xFFFFFFFFFFFFFFFF)
            d[pos < 0] = FLT_MAX
            return d, ids

        return finalize

    def _warmup_params(self):
        # The rerank path is a different device program (shape-static
        # shortlist depth): warm both when a raw arena exists.
        if self.has_raw:
            return (SearchParams(), SearchParams(use_exact_rerank=True))
        return (SearchParams(),)

    def _device_arrays(self) -> dict:
        return {
            "codes": self.codes_t_s,
            "raw": self.raw_s,
            "raw_sq": self.raw_sq_s,
            "raw_scale": self.raw_scale_s,
            "centroids": self.centroids,
            "codebooks": self.codebooks,
        }


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "k", "iters", "chunk_size", "n_cand",
                     "seed_per_chip"),
)
def sharded_kmeans_fit(
    mesh,
    key: jax.Array,
    x_sharded: jax.Array,       # [N, D] sharded P(SHARD_AXIS, None);
                                # padded rows must be exactly zero
    k: int,
    iters: int = 10,
    chunk_size: int = 16384,
    n_cand: int = 32,
    seed_per_chip: int = 8192,
) -> jax.Array:
    """Full data-parallel k-means over the mesh — the multi-chip twin of
    ``ops.kmeans.kmeans_fit`` (same Lloyd-as-matmuls update AND the same
    twin/orphan reseeding, via the shared ``_reseed_step``).

    SPMD structure per iteration: each chip scans its row shard in chunks
    accumulating partial ``onehot.T @ x`` sums / counts / total distortion
    plus a local candidate pool (top-distortion rows + stratified sample);
    sums ride a ``psum`` allreduce and the pools an ``all_gather``, after
    which the reseed update runs replicated (deterministic, so
    centroids stay bit-identical across chips). Seeding is Gumbel-max
    k-means++ on an all-gathered stratified per-chip sample.

    Returns replicated centroids ``[k, D]`` fp32. This is the trainer the
    reference *claimed* at multi-GPU scale but never wrote (its multi-GPU
    support is config-only, ``configs/production.yaml:11``; training is a
    host loop, ``engine/ivf_flat_index.cpp:49-145``)."""
    n, dim = x_sharded.shape
    n_shards = mesh.devices.size
    n_local = n // n_shards
    cs = min(chunk_size, max(n_local, 1))
    nc = min(n_cand, cs)
    k_seed, k_loop = jax.random.split(key)
    loop_keys = jax.random.split(k_loop, iters)

    def local_fn(x_l):
        # ---- seeding: stratified local sample → all_gather → kmeans++
        stride = max(n_local // min(seed_per_chip, n_local), 1)
        samp_local = x_l[::stride][: min(seed_per_chip, n_local)]
        seed_pool = jax.lax.all_gather(
            samp_local, SHARD_AXIS, axis=0, tiled=True
        )
        centroids = kmeans_pp_init(k_seed, seed_pool, k)

        pad = (-n_local) % cs
        x_p = (
            jnp.concatenate(
                [x_l, jnp.zeros((pad,) + x_l.shape[1:], x_l.dtype)]
            ) if pad else x_l
        )
        chunks = x_p.reshape(-1, cs, dim)
        row_ids = jnp.arange(x_p.shape[0]).reshape(-1, cs)
        valid = (row_ids < n_local).astype(jnp.float32)

        def lloyd(centroids, it_and_key):
            it, it_key = it_and_key

            def chunk_body(carry, inputs):
                sums, counts, d_tot = carry
                xc, w = inputs
                xcf = xc.astype(jnp.float32)
                d = pairwise_distance(xcf, centroids, Metric.L2)
                a = jnp.argmin(d, axis=-1)
                onehot = (
                    a[:, None] == jnp.arange(k)[None, :]
                ).astype(jnp.float32) * w[:, None]
                sums = sums + jax.lax.dot_general(
                    onehot, xcf,
                    dimension_numbers=(((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32,
                )
                counts = counts + jnp.sum(onehot, axis=0)
                d_min = jnp.where(w > 0, jnp.min(d, axis=-1), -jnp.inf)
                d_tot = d_tot + jnp.sum(jnp.maximum(d_min, 0.0) * w)
                top_v, top_i = jax.lax.top_k(d_min, nc)
                stride_c = max(cs // nc, 1)
                samp = jnp.arange(nc, dtype=jnp.int32) * stride_c
                return (sums, counts, d_tot), (
                    top_v, xcf[top_i], xcf[samp], a[samp].astype(jnp.int32),
                )

            (sums, counts, d_tot), (cand_v, cand_x, samp_x, samp_a) = (
                jax.lax.scan(
                    chunk_body,
                    (jnp.zeros((k, dim), jnp.float32),
                     jnp.zeros((k,), jnp.float32), jnp.float32(0.0)),
                    (chunks, valid),
                )
            )
            # DP allreduce (the NCCL the reference never had → psum).
            sums = jax.lax.psum(sums, SHARD_AXIS)
            counts = jax.lax.psum(counts, SHARD_AXIS)
            d_tot = jax.lax.psum(d_tot, SHARD_AXIS)
            new_centroids = jnp.where(
                (counts > 0)[:, None],
                sums / jnp.maximum(counts, 1.0)[:, None], centroids,
            )
            # Candidate pools all_gather so the replicated reseed sees the
            # global top-distortion rows, not one chip's.
            g = functools.partial(
                jax.lax.all_gather, axis_name=SHARD_AXIS, axis=0,
                tiled=True,
            )
            new_centroids = _reseed_step(
                new_centroids, counts,
                g(cand_v.reshape(-1)), g(cand_x.reshape(-1, dim)),
                g(samp_x.reshape(-1, dim)), g(samp_a.reshape(-1)),
                d_tot, n, it, iters, it_key, k,
            )
            return new_centroids, None

        centroids, _ = jax.lax.scan(
            lloyd, centroids, (jnp.arange(iters), loop_keys)
        )
        return centroids

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(SHARD_AXIS, None),), out_specs=P(),
        check_vma=False,    # replicated by determinism (see _sharded_search)
    )
    return fn(x_sharded)


def sharded_kmeans_lloyd_step(mesh, x_sharded, centroids, k: int):
    """One data-parallel Lloyd iteration: local assign + partial centroid
    sums, ``psum`` allreduce, replicated update. ``x_sharded`` is
    ``[N, D]`` sharded ``P(SHARD_AXIS, None)``; padded rows must be zero
    (they contribute to cluster 0's sum with weight 0 via the mask below —
    callers pass ``n_valid`` masking by zero rows being exactly zero)."""

    def local_fn(x_l, c):
        xf = x_l.astype(jnp.float32)
        d = pairwise_distance(xf, c, Metric.L2)
        a = jnp.argmin(d, axis=-1)
        valid = jnp.any(x_l != 0, axis=-1)
        onehot = (
            (a[:, None] == jnp.arange(k)[None, :]) & valid[:, None]
        ).astype(jnp.float32)
        sums = jax.lax.dot_general(
            onehot, xf,
            dimension_numbers=(((0,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        cnts = jnp.sum(onehot, axis=0)
        sums = jax.lax.psum(sums, SHARD_AXIS)
        cnts = jax.lax.psum(cnts, SHARD_AXIS)
        return jnp.where(
            (cnts > 0)[:, None], sums / jnp.maximum(cnts, 1.0)[:, None], c
        )

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(SHARD_AXIS, None), P()), out_specs=P(),
    )
    centroids = jax.device_put(centroids, NamedSharding(mesh, P()))
    return fn(x_sharded, centroids)
