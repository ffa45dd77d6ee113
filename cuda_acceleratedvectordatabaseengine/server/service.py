"""QueryService / AdminService implementations (S2/S3,
``server/query_service.{h,cpp}``) over the device engine.

Differences from the reference worth knowing:
  - Search actually goes through the request coalescer → one fixed-shape
    device batch per window (the reference's batch queue existed but was
    never fed, ``query_service.cpp:267-401``).
  - Rate limiter / circuit breaker / concurrency caps are wired in (the
    reference implemented them but never instantiated them).
  - BuildEpoch performs a real train→add→save pipeline (the reference's
    build worker is a placeholder skeleton, ``query_service.cpp:549-584``).
  - AddVectors gives the ingest path its integration tests lamented the
    absence of.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import os
import threading
import time

import grpc
import numpy as np
from google.protobuf import empty_pb2

from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
    IVFPQConfig,
    IVFPQIndex,
)
from cuda_acceleratedvectordatabaseengine.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine.server.balancer import (
    AdaptiveController,
    CircuitBreaker,
    ConcurrencyLimiter,
    Priority,
)
from cuda_acceleratedvectordatabaseengine.server.coalescer import (
    QueueFullError,
    RequestCoalescer,
)
from cuda_acceleratedvectordatabaseengine.server.config import ServerConfig
from cuda_acceleratedvectordatabaseengine.server.metrics import (
    MetricsCollector,
)
from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2
from cuda_acceleratedvectordatabaseengine.server.ratelimit import (
    RateLimiter,
)
from cuda_acceleratedvectordatabaseengine.storage.epoch import EpochManager
from cuda_acceleratedvectordatabaseengine.storage.manifest import (
    IndexManifest,
)
from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
    load_ivf_flat,
    load_ivf_pq,
)
from cuda_acceleratedvectordatabaseengine.utils.logging import get_logger

log = get_logger("vdb.server")

MAX_TOPK = 1000       # reference bound (query_service.cpp:80-86)
MAX_QUERIES = 8192    # one device batch; rate limiting is per-request, so
                      # this is the per-token work bound (see Search)
MAX_DIMENSION = 65536  # reference bound (query_service.cpp:436)


@dataclasses.dataclass
class IndexState:
    """Per-index live state (reference ``IndexState``,
    ``query_service.h:51-59``)."""

    name: str
    config: dict                      # creation parameters
    index: object | None = None       # IVFFlatIndex | IVFPQIndex
    epoch: str = ""
    coalescer: RequestCoalescer | None = None
    pending_vectors: list = dataclasses.field(default_factory=list)
    pending_ids: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class BuildJob:
    epoch_id: str
    progress: float = 0.0
    error: str = ""
    done: bool = False


class VdbEngine:
    """Shared engine state: index registry, epochs, metrics, admission."""

    def __init__(self, config: ServerConfig):
        self.config = config
        os.makedirs(config.data_path, exist_ok=True)
        self.epochs = EpochManager(
            os.path.join(config.data_path, "epochs"),
            keep_epochs=config.keep_epochs,
        )
        self.indices_dir = os.path.join(config.data_path, "indices")
        os.makedirs(self.indices_dir, exist_ok=True)
        self.metrics = MetricsCollector()
        self.rate_limiter = RateLimiter(
            config.rate_limit_rps, config.rate_limit_burst
        )
        self.breaker = CircuitBreaker(
            config.breaker_error_threshold,
            config.breaker_open_seconds,
            config.breaker_decay,
        )
        self.limiter = ConcurrencyLimiter(config.max_concurrent_requests)
        self.adaptive = AdaptiveController(config.max_batch_size)
        self.lock = threading.RLock()
        self.indices: dict[str, IndexState] = {}
        self.build_jobs: dict[str, BuildJob] = {}
        # In-memory mirror of each index's tombstone log (sorted unique
        # u64). The file is the WAL; this cache makes the per-AddVectors
        # unmark check O(set) instead of a full-file read under the
        # engine lock, and lets appends dedupe so repeated deletes of the
        # same id can't grow the log unboundedly between builds.
        self._tomb_cache: dict[str, np.ndarray] = {}
        # Multi-chip serving mesh (SURVEY §2.9): the capability the
        # reference claims with a dead flag
        # (``/root/reference/configs/production.yaml:11``
        # ``enable_multi_gpu: true`` — nothing reads it). When active,
        # epoch activation wraps resident indices in the sharded SPMD
        # views and builds streaming tiers directly on the mesh, so every
        # coalesced batch dispatches one mesh-wide search.
        self.mesh = None
        mode = config.shard_serving
        if mode not in ("auto", "on", "off"):
            raise ValueError(
                f"shard_serving must be auto|on|off, got {mode!r}"
            )
        if mode != "off":
            import jax

            n = config.mesh_shards or len(jax.devices())
            if n > 1 or mode == "on":
                from cuda_acceleratedvectordatabaseengine.parallel import (  # noqa: E501
                    make_mesh,
                )

                self.mesh = make_mesh(n)
                log.info("sharded serving over %d devices", n)
        # Background hotness-driven residency (P3+P4 wired together —
        # declared-only in the reference, engine/prefetcher.h:139-230):
        # a timer enqueues each streaming-tier index's hot-list re-staging
        # into the byte-rate-throttled PrefetchScheduler.
        from cuda_acceleratedvectordatabaseengine.io_host.prefetcher import (  # noqa: E501
            PrefetchScheduler,
        )

        self.prefetch_scheduler = PrefetchScheduler(
            bandwidth_limit_bps=config.prefetch_bandwidth_bps
        )
        self._stop_event = threading.Event()
        self._hotness_thread = None
        if config.prefetch_hot_interval_s > 0:
            self._hotness_thread = threading.Thread(
                target=self._hotness_loop, name="hotness-prefetch",
                daemon=True,
            )
            self._hotness_thread.start()
        self._recover()

    def _hotness_loop(self) -> None:
        interval = self.config.prefetch_hot_interval_s
        while not self._stop_event.wait(interval):
            with self.lock:
                live = [
                    st.index for st in self.indices.values()
                    if st.index is not None
                    and hasattr(st.index, "prefetch_hot_lists")
                ]
            for idx in live:
                cache = getattr(idx, "cache", None)
                if cache is None:
                    continue
                n_max = max(1, cache.n_slots // 2)
                per_slot = int(cache.memory_bytes() // max(cache.n_slots, 1))
                self.prefetch_scheduler.schedule(
                    idx.prefetch_hot_lists,
                    priority=0, nbytes=per_slot * n_max,
                )

    def close(self) -> None:
        """Stop background machinery (hotness loop + prefetch scheduler);
        idempotent."""
        self._stop_event.set()
        if self._hotness_thread is not None:
            self._hotness_thread.join(timeout=2)
            self._hotness_thread = None
        try:
            self.prefetch_scheduler.stop()
        except RuntimeError:
            pass

    # ------------------------------------------------------------------ #
    # recovery: re-register created indices, reload active epochs
    # ------------------------------------------------------------------ #

    def _recover(self) -> None:
        for name in sorted(os.listdir(self.indices_dir)):
            cfg_path = os.path.join(self.indices_dir, name, "config.json")
            if not os.path.isfile(cfg_path):
                continue
            with open(cfg_path) as f:
                cfg = json.load(f)
            st = IndexState(name=name, config=cfg)
            self.indices[name] = st
            active = self.epochs.active_dir(name)
            if active and os.path.isfile(
                os.path.join(active, IndexManifest.FILENAME)
            ):
                try:
                    self._load_epoch_into(st, self.epochs.active_epoch(name))
                except Exception as e:  # noqa: BLE001 — degrade, don't die
                    print(f"[vdb] failed to reload {name}: {e}")

    # ------------------------------------------------------------------ #
    # index lifecycle
    # ------------------------------------------------------------------ #

    def create_index(self, name, dimension, metric, nlist, m, nbits,
                     tier: str = "") -> None:
        with self.lock:
            if name in self.indices:
                raise KeyError(f"index {name!r} already exists")
            cfg = {
                "dimension": dimension,
                "metric": metric,
                "nlist": nlist or self.config.default_nlist,
                "m": m,
                "nbits": nbits or 8,
                "dtype": self.config.arena_dtype,
                "tier": tier or "resident",
            }
            d = os.path.join(self.indices_dir, name)
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "config.json"), "w") as f:
                json.dump(cfg, f, indent=2)
            self.indices[name] = IndexState(name=name, config=cfg)

    def _new_index(self, cfg: dict):
        if cfg.get("m"):
            return IVFPQIndex(IVFPQConfig(
                dimension=cfg["dimension"], nlist=cfg["nlist"], m=cfg["m"],
                nbits=cfg.get("nbits", 8), metric=cfg["metric"],
                raw_dtype=cfg.get("dtype", "bfloat16"),
                # Capacity tier: only codes live on device (~m bytes/row);
                # exact rerank comes from the epoch's host-RAM row store.
                keep_raw=cfg.get("tier") != "pq_capacity",
            ))
        return IVFFlatIndex(IVFFlatConfig(
            dimension=cfg["dimension"], nlist=cfg["nlist"],
            metric=cfg["metric"], dtype=cfg.get("dtype", "bfloat16"),
        ))

    def _make_coalescer(self, st: IndexState) -> RequestCoalescer:
        return RequestCoalescer(
            dispatch_fn=lambda items: self._dispatch_batch(st, items),
            window_s=self.config.coalesce_window_ms / 1000.0,
            max_batch=self.config.max_batch_size,
            name=f"coalesce-{st.name}",
            # max_batch counts QUERIES, not requests: a drained batch of
            # multi-query requests must never exceed the device batch
            # width the warmed executables cover (an 8192-query surprise
            # tensor = a cold XLA compile mid-SLA — the r4 wire bench's
            # deadline cascade).
            weight_fn=lambda item: int(item[0].shape[0]),
            # Latency-adaptive draining (reference intent, never wired
            # there: ``load_balancer.cpp:75-85``) — shrinks the batch cap
            # only when measured batch wall time blows the budget; see
            # AdaptiveController.batch_size for why load-based shrinking
            # is backwards on this hardware.
            max_batch_fn=lambda: self.adaptive.batch_size(
                self.limiter.active, self.limiter.max_concurrent
            ),
            # Fail-fast backlog bound: work queued deeper than this would
            # blow the adaptive deadline anyway — shed at admission instead
            # of burning device time on answers nobody will read.
            max_queue=self.config.max_queued_requests or None,
        )

    def _load_epoch_into(self, st: IndexState, epoch_id: str) -> None:
        path = self.epochs.epoch_dir(st.name, epoch_id)
        man = IndexManifest.load(path)
        if (
            st.config.get("tier") == "streaming" and man.kind == "ivf_flat"
        ):
            # >HBM tier: the epoch loads into HOST RAM and serves through
            # an HBM list cache — activation never materializes a device
            # arena, so epochs larger than the chip activate cleanly.
            from cuda_acceleratedvectordatabaseengine.io_host import (
                StreamingIVFFlatIndex,
            )
            from cuda_acceleratedvectordatabaseengine.storage.snapshot import (  # noqa: E501
                load_ivf_flat_host,
            )

            store, centroids, cfg, cap = load_ivf_flat_host(path)
            import jax.numpy as jnp

            # Size the cache so one probe column of the coalescer's largest
            # batch fits without row-splitting (the tier splits oversized
            # batches correctly, but splits halve the device batch width).
            slots = None
            if not self.config.streaming_cache_bytes:
                slots = min(
                    cfg.nlist,
                    max(cfg.nlist // 4, self.config.max_batch_size),
                )
            if self.mesh is not None:
                # Mesh-served streaming tier: the HBM cache's slot bytes
                # stripe across the mesh, so the aggregate cached working
                # set (and miss-upload H2D bandwidth) scales with the
                # slice. Same host store, same serving surface.
                from cuda_acceleratedvectordatabaseengine.parallel import (  # noqa: E501
                    ShardedStreamingIVFFlatIndex,
                )

                index = ShardedStreamingIVFFlatIndex(
                    self.mesh, store, jnp.asarray(centroids), cfg,
                    cache_slots=slots,
                    max_device_bytes=(
                        self.config.streaming_cache_bytes or None
                    ),
                    capacity=cap,
                    policy=self.config.streaming_cache_policy,
                )
            else:
                index = StreamingIVFFlatIndex.from_store(
                    store, jnp.asarray(centroids), cfg,
                    cache_slots=slots,
                    max_device_bytes=(
                        self.config.streaming_cache_bytes or None
                    ),
                    capacity=cap,
                    policy=self.config.streaming_cache_policy,
                )
        elif (
            st.config.get("tier") == "pq_capacity" and man.kind == "ivf_pq"
        ):
            # Capacity tier: codes rebuild the device arena (~m bytes/row);
            # raw rows load into an int8 host store serving exact rerank.
            # Like streaming, epochs far past the HBM wall activate without
            # a device raw arena — but with no workload-locality premium.
            from cuda_acceleratedvectordatabaseengine.storage.snapshot import (  # noqa: E501
                load_ivf_pq_capacity,
            )

            index = load_ivf_pq_capacity(
                path, rerank_k=self.config.pq_rerank_k,
                margin=self.config.pq_rerank_margin,
            )
        else:
            index = (
                load_ivf_pq(path) if man.kind == "ivf_pq"
                else load_ivf_flat(path)
            )
        # Warm the search executables BEFORE the swap goes live: the first
        # compile of a new shape can take tens of seconds and would
        # otherwise blow the request deadline right after activation. Every
        # bucket the coalescer can emit gets warmed — an intermediate-size
        # batch must never hit a cold compile mid-SLA.
        from cuda_acceleratedvectordatabaseengine.utils.batching import (
            BUCKETS,
        )

        # Serving-path transport dtype (config: query_upload_dtype): set
        # BEFORE warmup so the warmed executables compile against the
        # dtype live traffic will carry.
        up = self.config.query_upload_dtype
        if (
            up and up != "float32"
            and hasattr(getattr(index, "config", None), "query_upload_dtype")
        ):
            index.config.query_upload_dtype = up

        # Re-apply persisted tombstones: snapshots are immutable, so
        # deletions accepted since the last build live in the per-index
        # log and must be replayed on every load (idempotent by id).
        tombs = self._read_tombstones(st.name)
        if tombs.size:
            if hasattr(index, "remove_ids") and not getattr(
                index, "read_only", False
            ):
                index.remove_ids(tombs)
            else:
                log.warning(
                    "index %s: %d tombstoned ids NOT applied (read-only "
                    "serving tier) — rebuild an epoch to bake them",
                    st.name, int(tombs.size),
                )

        if (
            self.mesh is not None
            and isinstance(index, (IVFFlatIndex, IVFPQIndex))
            and not getattr(index, "read_only", False)
        ):
            # Resident tier on a mesh: publish the freshly loaded (and
            # tombstone-replayed) arena as slot stripes and serve the SPMD
            # search. The base index stays attached for mutations and
            # re-snapshots; the pq_capacity tier stays single-chip (its
            # second stage is the host reranker, which has no mesh to
            # ride — it is excluded here by read_only).
            from cuda_acceleratedvectordatabaseengine.parallel import (
                ShardedIVFFlatIndex,
                ShardedIVFPQIndex,
            )

            index = (
                ShardedIVFPQIndex(index, self.mesh)
                if isinstance(index, IVFPQIndex)
                else ShardedIVFFlatIndex(index, self.mesh)
            )

        sizes = [b for b in BUCKETS if b <= self.config.max_batch_size]
        if self.config.max_batch_size not in sizes:
            sizes.append(self.config.max_batch_size)
        # nprobe is shape-static too: warm every configured serving
        # operating point, not just the default (warm_nprobes) — and the
        # snapshot's persisted calibration, which nprobe-unset requests
        # will serve at.
        nprobes = sorted(
            {int(self.config.default_nprobe)}
            | {int(p) for p in (self.config.warm_nprobes or ())}
            | ({int(index.calibrated_nprobe)}
               if getattr(index, "calibrated_nprobe", None) else set())
        )
        try:
            index.warmup_lists(batch_sizes=tuple(sizes),
                               nprobes=tuple(nprobes))
        except Exception:  # noqa: BLE001 — warmup is best-effort
            pass
        with self.lock:
            # Deletes accepted during the (tens of seconds of) warmup
            # above hit the OLD index + the log but missed this replay —
            # apply the delta before the new index goes live, under the
            # lock so no further RemoveVectors can race the swap.
            fresh = self._read_tombstones(st.name)
            delta = (
                fresh[~np.isin(fresh, tombs)] if tombs.size else fresh
            )
            if delta.size and hasattr(index, "remove_ids") and not getattr(
                index, "read_only", False
            ):
                index.remove_ids(delta)
            st.index = index
            st.epoch = epoch_id
            if st.coalescer is None:
                st.coalescer = self._make_coalescer(st)
        self._update_memory_gauge()

    def _update_memory_gauge(self) -> None:
        total = 0
        for st in self.indices.values():
            if st.index is not None:
                total += st.index.memory_stats()["total_bytes"]
        self.metrics.set_device_memory(total)

    def get_state(self, name: str) -> IndexState:
        with self.lock:
            if name not in self.indices:
                raise KeyError(name)
            return self.indices[name]

    # ------------------------------------------------------------------ #
    # ingest + build
    # ------------------------------------------------------------------ #

    def add_vectors(self, name, vectors, ids) -> tuple[int, int]:
        st = self.get_state(name)
        with self.lock:
            self._unmark_tombstones(name, np.asarray(ids, np.uint64))
            if (
                st.index is not None and st.index.trained
                and not getattr(st.index, "read_only", False)
            ):
                st.index.add(vectors, ids)
                total = st.index.ntotal
            else:
                # untrained index OR a read-only serving tier (streaming):
                # buffer for the next BuildEpoch.
                st.pending_vectors.append(vectors)
                st.pending_ids.append(ids)
                total = sum(len(v) for v in st.pending_vectors)
        self._update_memory_gauge()
        return len(vectors), total

    def remove_vectors(self, name, ids) -> tuple[int, int]:
        """Delete by user id (no reference analog — its API has no delete).
        Only a mutable resident index supports in-place deletes; read-only
        serving tiers (streaming/pq_capacity snapshots) must rebuild
        through the epoch pipeline instead.

        Durability: accepted deletions also append to a per-index
        tombstone log (``deletions.u64``) that is re-applied whenever an
        epoch snapshot loads (``_load_epoch_into``) and baked-then-cleared
        by the next successful build — so a restart or epoch reload never
        resurrects a deleted id."""
        st = self.get_state(name)
        with self.lock:
            if st.index is None or not st.index.trained:
                raise ValueError("index has no live data to remove from")
            if getattr(st.index, "read_only", False) or not hasattr(
                st.index, "remove_ids"
            ):
                raise PermissionError(
                    "serving tier is read-only; rebuild an epoch without "
                    "the removed ids instead"
                )
            ids = np.asarray(ids, np.uint64)
            removed = st.index.remove_ids(ids)
            total = st.index.ntotal
            self._append_tombstones(name, ids)
        self._update_memory_gauge()
        return removed, total

    # ------------------------------------------------------------------ #
    # deletion tombstones (durability across epoch reloads / restarts)
    # ------------------------------------------------------------------ #

    def _tombstone_path(self, name: str) -> str:
        return os.path.join(self.indices_dir, name, "deletions.u64")

    def _append_tombstones(self, name: str, ids: np.ndarray) -> None:
        with self.lock:
            existing = self._read_tombstones(name)
            fresh = np.asarray(ids, np.uint64)
            if existing.size:
                fresh = fresh[~np.isin(fresh, existing)]
            fresh = np.unique(fresh)
            if fresh.size == 0:
                return
            with open(self._tombstone_path(name), "ab") as f:
                f.write(np.ascontiguousarray(fresh, "<u8").tobytes())
                # An acked RemoveVectors must survive power loss just like
                # the rewrite path (_write_tombstones fsyncs) — otherwise a
                # deleted id can resurrect on reload.
                f.flush()
                os.fsync(f.fileno())
            self._tomb_cache[name] = np.union1d(existing, fresh)

    def _read_tombstones(self, name: str) -> np.ndarray:
        with self.lock:
            cached = self._tomb_cache.get(name)
            if cached is not None:
                return cached
            try:
                raw = open(self._tombstone_path(name), "rb").read()
            except FileNotFoundError:
                raw = b""
            # Tolerate a torn final record (crash mid-append): drop the
            # trailing partial u64 instead of failing the whole index load.
            # Complete earlier records are still applied — same recovery
            # stance as the epoch registry (epochs.json last-good state).
            raw = raw[: len(raw) - (len(raw) % 8)]
            tombs = np.unique(np.frombuffer(raw, "<u8"))
            self._tomb_cache[name] = tombs
            return tombs

    def _write_tombstones(self, name: str, ids: np.ndarray) -> None:
        """Atomic full rewrite (temp + rename): a crash mid-rewrite must
        never leave a truncated log that silently resurrects deletions."""
        path = self._tombstone_path(name)
        ids = np.unique(np.asarray(ids, np.uint64))
        if ids.size == 0:
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        else:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(np.ascontiguousarray(ids, "<u8").tobytes())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        self._tomb_cache[name] = ids

    def _clear_tombstones(self, name: str) -> None:
        with self.lock:
            self._tomb_cache[name] = np.zeros(0, np.uint64)
            try:
                os.remove(self._tombstone_path(name))
            except FileNotFoundError:
                pass

    def _consume_tombstones(self, name: str, baked: np.ndarray) -> None:
        """Drop exactly the tombstones a finished build baked into its
        snapshot — NOT the whole log: deletions accepted while the build
        was training/packing (minutes at scale) are absent from that
        snapshot and must survive to be replayed on the next load."""
        with self.lock:
            existing = self._read_tombstones(name)
            if existing.size == 0:
                return
            kept = existing[~np.isin(existing, np.asarray(baked, np.uint64))]
            if kept.size == existing.size:
                return
            self._write_tombstones(name, kept)

    def _unmark_tombstones(self, name: str, ids: np.ndarray) -> None:
        """Re-adding an id revokes its tombstone — otherwise the next
        build's bake would silently drop a legitimately re-used id."""
        with self.lock:
            existing = self._read_tombstones(name)
            if existing.size == 0:
                return
            kept = existing[
                ~np.isin(existing, np.asarray(ids, np.uint64))
            ]
            if kept.size == existing.size:
                return
            self._write_tombstones(name, kept)

    def build_epoch(self, name: str, source_path: str = "") -> str:
        """Asynchronous epoch build (reference S3 BuildJob pattern,
        ``query_service.cpp:472-513`` — but the pipeline is real here)."""
        st = self.get_state(name)
        with self.lock:
            job = self.build_jobs.get(name)
            if job and not job.done:
                raise RuntimeError(f"build already running for {name!r}")
            epoch_id, epoch_dir = self.epochs.create_epoch(name)
            job = BuildJob(epoch_id=epoch_id)
            self.build_jobs[name] = job

        def worker():
            try:
                self._build_worker(st, job, epoch_dir, source_path)
            except Exception as e:  # noqa: BLE001
                job.error = str(e)
            finally:
                job.done = True

        threading.Thread(
            target=worker, name=f"build-{name}", daemon=True
        ).start()
        return epoch_id

    def _build_worker(self, st, job, epoch_dir, source_path) -> None:
        """CHUNKED build pipeline (the reference's ghost ``indexmgr``
        builder, ``indexmgr/CMakeLists.txt:8-47``, for real): the source
        file streams through the balanced device pack one chunk at a
        time — peak host RAM ≈ one chunk + the training sample, the arena
        capacity is clamped by the same 1.35×-mean law as the headline
        bench build, and BuildJob progress advances per chunk."""
        cfg = st.config
        with self.lock:
            pending_v = st.pending_vectors
            pending_i = st.pending_ids
            st.pending_vectors, st.pending_ids = [], []
        if not source_path and not pending_v:
            if (
                st.index is not None and st.index.trained
                and not getattr(st.index, "read_only", False)
            ):
                # re-snapshot the live index (epoch checkpoint of current
                # state; in-place deletes are already baked into the
                # arena). Read the log BEFORE save: a delete accepted
                # mid-save may or may not land in the snapshot, so its
                # tombstone must survive to be replayed on load — consume
                # only what save captured.
                tombs = self._read_tombstones(st.name)
                st.index.save(epoch_dir)
                self._consume_tombstones(st.name, tombs)
                job.progress = 1.0
                return
            raise ValueError(
                "no data: provide source_path or AddVectors first"
            )

        from cuda_acceleratedvectordatabaseengine.builder import (
            build_index_chunked,
            train_sample_rows,
        )
        from cuda_acceleratedvectordatabaseengine.storage import (
            ArrowStorage,
        )

        # Tombstones read up front: ids deleted since the last build must
        # not enter the new epoch (filtered per chunk); the log entries
        # baked here clear once the build succeeds.
        tombs = self._read_tombstones(st.name)
        index = self._new_index(cfg)
        chunk_rows = max(1, self.config.build_chunk_rows)
        n_pending = sum(len(v) for v in pending_v)
        n_source = ArrowStorage.num_rows(source_path) if source_path else 0
        n_total = n_source + n_pending
        job.progress = 0.05

        # Training sample: evenly spaced slices across the source file
        # (bounded RAM, robust to clustered file order) + the pending
        # buffers (which already sit in RAM).
        budget = train_sample_rows(index.config)
        parts = []
        if n_source:
            parts.append(ArrowStorage.read_train_sample(
                source_path, min(budget, n_source)
            ))
        parts.extend(
            np.ascontiguousarray(v, np.float32) for v in pending_v
        )
        sample = np.concatenate(parts)
        job.progress = 0.1

        # pq_capacity epochs stream their host-rerank rows to the epoch's
        # vectors file as chunks ingest (arrival order; the loader matches
        # rows to the arena by id) — the fp32 corpus never sits in RAM.
        writer = None
        row_sink = None
        if cfg.get("tier") == "pq_capacity":
            from cuda_acceleratedvectordatabaseengine.storage.arrow_store import (  # noqa: E501
                VectorFileWriter,
            )
            from cuda_acceleratedvectordatabaseengine.storage.snapshot import (  # noqa: E501
                VECTORS_FILE,
            )

            os.makedirs(epoch_dir, exist_ok=True)
            writer = VectorFileWriter(os.path.join(epoch_dir, VECTORS_FILE))
            normalize = Metric.parse(cfg["metric"]) == Metric.COSINE

            def row_sink(ids_c, vecs_c):
                if normalize:
                    vecs_c = vecs_c / np.maximum(
                        np.linalg.norm(vecs_c, axis=1, keepdims=True),
                        1e-12,
                    )
                writer.append(ids_c, vecs_c)

        def chunks():
            if source_path:
                yield from ArrowStorage.iter_vector_chunks(
                    source_path, chunk_rows
                )
            for v, i in zip(pending_v, pending_i):
                yield (
                    np.asarray(i, np.uint64),
                    np.ascontiguousarray(v, np.float32),
                )

        try:
            build_index_chunked(
                index, chunks(), n_total,
                train_sample=sample, tombstones=tombs,
                progress=lambda f: setattr(
                    job, "progress", 0.1 + 0.75 * f
                ),
                row_sink=row_sink,
            )
        finally:
            if writer is not None:
                writer.close()
        job.progress = 0.85
        if self.config.auto_calibrate_nprobe:
            # Measured-coverage calibration on a corpus sample, persisted
            # in the epoch manifest — served for requests with nprobe
            # unset. Opt-in: it costs one full-probe sweep per build.
            try:
                rng = np.random.default_rng(0)
                pick = rng.choice(
                    len(sample), size=min(512, len(sample)), replace=False
                )
                index.calibrate_nprobe(queries=sample[pick])
            except Exception as e:  # noqa: BLE001 — tuning must not
                log.warning(                      # fail the build
                    "auto-calibration skipped for %s: %s", st.name, e
                )
        if cfg.get("tier") == "pq_capacity":
            # Capacity-tier epoch = codes (device) + the raw rows the
            # sink already streamed to the epoch's vectors file.
            from cuda_acceleratedvectordatabaseengine.storage.snapshot import (  # noqa: E501
                save_ivf_pq,
            )

            save_ivf_pq(epoch_dir, index, host_rows_file=True)
        else:
            index.save(epoch_dir)
        # Consume exactly the tombstones this build baked out (read at
        # progress 0.05) — deletions accepted during the minutes-long
        # train/ingest/save are NOT in the snapshot and stay in the log.
        self._consume_tombstones(st.name, tombs)
        job.progress = 1.0

    # ------------------------------------------------------------------ #
    # the batched search path
    # ------------------------------------------------------------------ #

    def _dispatch_batch(self, st: IndexState, items: list):
        """Dispatch stage of a drained coalescer batch → grouped
        fixed-shape ASYNC device calls; returns the finalize thunk the
        pipelined coalescer forces one batch later (batch N's device
        compute overlaps batch N−1's result fetch).

        items: [(queries [m, D] np, SearchParams, t_submit)] → thunk() →
        per-item (dists, ids) slices. Groups by search params so each
        group is one device dispatch (the reference groups by index only
        and would mix params, ``query_service.cpp:330-370``). Indices
        without a dispatch/finalize split (streaming tier: host-driven
        waves) run synchronously here, preserving behavior."""
        index = st.index
        t_start = time.monotonic()
        groups: dict[tuple, list[int]] = {}
        for i, (_, p, *_) in enumerate(items):
            groups.setdefault(
                (p.nprobe, p.k, p.use_exact_rerank), []
            ).append(i)
        for it in items:
            if len(it) > 2:
                self.metrics.record_stage(
                    "queue_wait", (t_start - it[2]) * 1000
                )
        thunks: list[tuple[list[int], object]] = []
        for (nprobe, k, rerank), idxs in groups.items():
            qs = np.concatenate([items[i][0] for i in idxs])
            params = SearchParams(
                nprobe=nprobe, k=k, use_exact_rerank=rerank
            )
            if hasattr(index, "search_async"):
                fin = index.search_async(qs, params)
            else:
                d, out_ids = index.search(qs, params)
                fin = lambda d=d, out_ids=out_ids: (d, out_ids)  # noqa: E731
            thunks.append((idxs, fin))
        self.metrics.record_stage(
            "dispatch", (time.monotonic() - t_start) * 1000
        )

        def finalize() -> list:
            t_f = time.monotonic()
            results: list = [None] * len(items)
            for idxs, fin in thunks:
                d, out_ids = fin()
                off = 0
                for i in idxs:
                    m = items[i][0].shape[0]
                    results[i] = (d[off:off + m], out_ids[off:off + m])
                    off += m
            now = time.monotonic()
            self.metrics.record_stage("fetch", (now - t_f) * 1000)
            # Adaptive sizing sees the full dispatch→fetch wall time of
            # this batch (what a caller would have paid unpipelined).
            self.adaptive.record_latency_ms((now - t_start) * 1000)
            return results

        return finalize


def _abort(context, code, msg):
    context.abort(code, msg)


def _wire_priority(request) -> Priority:
    """SearchRequest.priority wire values (0/unset=normal, 1=low, 2=normal,
    3=high, 4=urgent) → coalescer Priority."""
    mapping = {
        1: Priority.LOW, 2: Priority.NORMAL,
        3: Priority.HIGH, 4: Priority.URGENT,
    }
    return mapping.get(getattr(request, "priority", 0), Priority.NORMAL)


class QueryServiceImpl:
    """gRPC QueryService (S2)."""

    def __init__(self, engine: VdbEngine):
        self.engine = engine

    # ------------------------------------------------------------------ #

    def Search(self, request, context):
        # validation first — client errors (INVALID_ARGUMENT/NOT_FOUND) must
        # never trip the breaker; same codes as query_service.cpp:72-92.
        t_in = time.monotonic()
        st, queries, params = self._validate(request, context)
        self.engine.metrics.record_stage(
            "decode", (time.monotonic() - t_in) * 1000
        )
        t0 = time.monotonic()
        fut = self._admit_and_submit(st, queries, params, request, context)
        return self._finish(fut, request, context, t0, queries.shape[0])

    def StreamSearch(self, request_iterator, context):
        """Bidirectional streaming search. The reference README claims
        "High-performance RPC with streaming support" (``README.md:20``)
        but declares no streaming method on either service
        (``proto/vdb.proto:90-109``) — here it is real. Responses come
        back in request order; up to ``config.stream_window`` requests
        are pipelined into the coalescer at once, so one streaming client
        overlaps network transfer, batch formation and device compute
        without opening concurrent unary RPCs (each of which pays HTTP/2
        stream setup and its own admission token). Validation/admission
        failures abort the whole stream with the same status the unary
        path returns (a gRPC stream has a single terminal status)."""
        eng = self.engine
        window = max(1, eng.config.stream_window)
        pending: collections.deque = collections.deque()
        try:
            for request in request_iterator:
                st, queries, params = self._validate(request, context)
                t0 = time.monotonic()
                fut = self._admit_and_submit(
                    st, queries, params, request, context
                )
                pending.append((fut, request, t0, queries.shape[0]))
                while len(pending) >= window:
                    fut, req, t0, nq = pending.popleft()
                    yield self._finish(fut, req, context, t0, nq)
            while pending:
                fut, req, t0, nq = pending.popleft()
                yield self._finish(fut, req, context, t0, nq)
        finally:
            # Stream aborted or client cancelled with work in flight:
            # release the admission slots of unfinished items (their
            # results are dropped; still-queued ones never hit the device).
            while pending:
                fut, _req, _t0, _nq = pending.popleft()
                fut.cancel()
                eng.limiter.exit()
                eng.breaker.record(True)

    def _admit_and_submit(self, st, queries, params, request, context):
        """Admission control (all wired, unlike the reference) + coalescer
        submit. On success the concurrency-limiter slot is HELD — it is
        released by :meth:`_finish`."""
        eng = self.engine
        if not eng.breaker.allow():
            _abort(context, grpc.StatusCode.UNAVAILABLE,
                   "circuit breaker open")
        # One token per REQUEST, not per query: the config key is
        # requests_per_second (configs/production.yaml:32) and the
        # reference's bucket is refilled in request units
        # (query_service.cpp:639-677). Charging per query made a burst of
        # batch=64 packed requests eat 64x tokens and shed a third of a
        # perfectly sustainable load (measured, wire bench r3). Per-batch
        # work is bounded separately: _validate caps the query tensor and
        # the coalescer sheds past max_queued_requests.
        if not eng.rate_limiter.try_acquire(1):
            _abort(context, grpc.StatusCode.RESOURCE_EXHAUSTED,
                   "rate limit exceeded")
        if not eng.limiter.try_enter():
            _abort(context, grpc.StatusCode.RESOURCE_EXHAUSTED,
                   "too many concurrent requests")
        try:
            return st.coalescer.submit(
                (queries, params, time.monotonic()),
                priority=_wire_priority(request),
            )
        except QueueFullError as e:
            eng.limiter.exit()
            eng.breaker.record(True)  # shedding is not an engine failure
            _abort(context, grpc.StatusCode.RESOURCE_EXHAUSTED, str(e))

    def _finish(self, fut, request, context, t0, n_queries):
        """Await a submitted search and encode the response; always
        releases the limiter slot taken by :meth:`_admit_and_submit`."""
        eng = self.engine
        ok = False
        try:
            try:
                d, ids = fut.result(timeout=eng.adaptive.timeout_s())
            except concurrent.futures.TimeoutError:
                # Deadline expired. If the item is still queued, cancel()
                # keeps the device from ever running it; if it is already
                # inside a running batch, the result is simply dropped.
                cancelled = fut.cancel()
                ok = True  # client-deadline expiry must not trip the breaker
                _abort(
                    context, grpc.StatusCode.DEADLINE_EXCEEDED,
                    "queue wait exceeded adaptive deadline ("
                    + ("cancelled while queued" if cancelled
                       else "batch already running") + ")",
                )
            t_enc = time.monotonic()
            resp = vdb_pb2.SearchResponse()
            if request.packed_response:
                # One memcpy instead of b·k python-proto message appends.
                resp.packed_ids = np.ascontiguousarray(
                    ids, dtype="<u8"
                ).tobytes()
                resp.packed_distances = np.ascontiguousarray(
                    d, dtype="<f4"
                ).tobytes()
            else:
                for row_d, row_i in zip(d, ids):
                    result = resp.results.add()
                    for dist, nid in zip(row_d, row_i):
                        if nid == INVALID_ID:  # sentinel skip (cpp:142-156)
                            continue
                        result.neighbors.add(
                            id=int(nid), distance=float(dist)
                        )
            eng.metrics.record_stage(
                "encode", (time.monotonic() - t_enc) * 1000
            )
            ok = True
            return resp
        finally:
            eng.limiter.exit()
            eng.breaker.record(ok)
            if ok:
                eng.metrics.record_search(
                    request.index,
                    (time.monotonic() - t0) * 1000,
                    n_queries,
                )

    def _validate(self, request, context):
        eng = self.engine
        if not request.queries and not request.packed_queries:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "no queries provided")
        if request.topk <= 0 or request.topk > MAX_TOPK:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   f"topk must be in (0, {MAX_TOPK}]")
        if not request.index:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "index name required")
        try:
            st = eng.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        if st.index is None or not st.index.trained:
            _abort(context, grpc.StatusCode.FAILED_PRECONDITION,
                   f"index {request.index!r} has no active epoch")
        index = st.index
        dim = index.config.dimension
        if request.metric:
            try:
                req_metric = Metric.parse(request.metric)
            except ValueError as e:
                _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
            if req_metric != index.metric:
                _abort(
                    context, grpc.StatusCode.INVALID_ARGUMENT,
                    f"index metric is {index.metric.value}, "
                    f"request asked {request.metric}",
                )
        if request.packed_queries:
            raw = request.packed_queries
            if len(raw) % (4 * dim):
                _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                       f"packed_queries length {len(raw)} is not a "
                       f"multiple of 4*dim ({4 * dim})")
            queries = np.frombuffer(raw, dtype="<f4").reshape(-1, dim)
            queries = np.ascontiguousarray(queries, np.float32)
            if queries.shape[0] > MAX_QUERIES:
                _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                       f"at most {MAX_QUERIES} queries per request")
        else:
            if len(request.queries) > MAX_QUERIES:
                _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                       f"at most {MAX_QUERIES} queries per request")
            queries = np.zeros((len(request.queries), dim), np.float32)
            for i, v in enumerate(request.queries):
                if len(v.values) != dim:
                    _abort(
                        context, grpc.StatusCode.INVALID_ARGUMENT,
                        f"query {i} has dim {len(v.values)}, "
                        f"index dim {dim}",
                    )
                queries[i] = v.values
        nprobe = request.nprobe
        if not nprobe:
            # unset → the index's persisted measured-coverage calibration
            # (vdb-tune --persist / calibrate_nprobe) when present, else
            # the config default (reference defaulted a hardcoded 8,
            # query_service.cpp:94-108)
            nprobe = (
                getattr(st.index, "calibrated_nprobe", None)
                or self.engine.config.default_nprobe
            )
        params = SearchParams(
            nprobe=nprobe, k=request.topk,
            use_exact_rerank=request.rerank_exact,
        )
        return st, queries, params

    def Warmup(self, request, context):
        try:
            st = self.engine.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        if st.index is not None:
            st.index.warmup_lists(
                list(request.lists) if request.lists else None
            )
        return empty_pb2.Empty()

    def LoadIndex(self, request, context):
        eng = self.engine
        try:
            st = eng.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        epoch = request.epoch or eng.epochs.active_epoch(request.index)
        if not epoch:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   "no epoch to load")
        try:
            eng._load_epoch_into(st, epoch)
        except FileNotFoundError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"epoch {epoch!r} has no snapshot")
        return empty_pb2.Empty()


class AdminServiceImpl:
    """gRPC AdminService (S3)."""

    def __init__(self, engine: VdbEngine):
        self.engine = engine

    def CreateIndex(self, request, context):
        if not request.name:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "index name required")
        if request.dimension <= 0 or request.dimension > MAX_DIMENSION:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   f"dimension must be in (0, {MAX_DIMENSION}]")
        metric = request.metric or "L2"
        try:
            Metric.parse(metric)
        except ValueError as e:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT, str(e))
        tier = getattr(request, "tier", "") or "resident"
        if tier not in ("resident", "streaming", "pq_capacity"):
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   f"unknown tier {tier!r} "
                   "(resident|streaming|pq_capacity)")
        if tier == "streaming" and request.m:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "streaming tier supports IVF-Flat only (m must be 0)")
        if tier == "pq_capacity" and not request.m:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "pq_capacity tier is IVF-PQ: m must be > 0")
        try:
            self.engine.create_index(
                request.name, request.dimension, metric,
                request.nlist, request.m, request.nbits, tier,
            )
        except KeyError as e:
            _abort(context, grpc.StatusCode.ALREADY_EXISTS, str(e))
        return empty_pb2.Empty()

    def AddVectors(self, request, context):
        if not request.vectors:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "no vectors provided")
        try:
            st = self.engine.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        dim = st.config["dimension"]
        vecs = np.zeros((len(request.vectors), dim), np.float32)
        ids = np.zeros(len(request.vectors), np.uint64)
        for i, v in enumerate(request.vectors):
            if len(v.values) != dim:
                _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                       f"vector {i} has dim {len(v.values)}, index dim {dim}")
            vecs[i] = v.values
            ids[i] = v.id
        added, total = self.engine.add_vectors(request.index, vecs, ids)
        return vdb_pb2.AddVectorsResponse(added=added, total=total)

    def RemoveVectors(self, request, context):
        if not request.ids:
            _abort(context, grpc.StatusCode.INVALID_ARGUMENT,
                   "no ids provided")
        try:
            removed, total = self.engine.remove_vectors(
                request.index, np.asarray(request.ids, np.uint64)
            )
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        except ValueError as e:
            _abort(context, grpc.StatusCode.FAILED_PRECONDITION, str(e))
        except PermissionError as e:
            _abort(context, grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return vdb_pb2.RemoveVectorsResponse(removed=removed, total=total)

    def BuildEpoch(self, request, context):
        try:
            self.engine.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        try:
            self.engine.build_epoch(request.index, request.source_path)
        except RuntimeError as e:
            _abort(context, grpc.StatusCode.ALREADY_EXISTS, str(e))
        except ValueError as e:
            _abort(context, grpc.StatusCode.FAILED_PRECONDITION, str(e))
        return empty_pb2.Empty()

    def ActivateEpoch(self, request, context):
        eng = self.engine
        try:
            st = eng.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        epoch = request.epoch
        if not epoch:
            job = eng.build_jobs.get(request.index)
            if job is None:
                _abort(context, grpc.StatusCode.NOT_FOUND, "no epoch given")
            if not job.done:
                _abort(context, grpc.StatusCode.FAILED_PRECONDITION,
                       f"build in progress ({job.progress:.0%})")
            if job.error:
                _abort(context, grpc.StatusCode.INTERNAL,
                       f"build failed: {job.error}")
            epoch = job.epoch_id
        try:
            eng._load_epoch_into(st, epoch)
            eng.epochs.activate_epoch(request.index, epoch)
        except (KeyError, FileNotFoundError) as e:
            _abort(context, grpc.StatusCode.NOT_FOUND, str(e))
        return empty_pb2.Empty()

    def GetStats(self, request, context):
        eng = self.engine
        try:
            st = eng.get_state(request.index)
        except KeyError:
            _abort(context, grpc.StatusCode.NOT_FOUND,
                   f"index {request.index!r} not found")
        if getattr(request, "reset", False):
            # Clear this index's percentile windows (and the stage spans)
            # BEFORE answering: the caller is delimiting a measurement.
            eng.metrics.reset_windows(request.index)
        total = indexed = 0
        mem_gb = 0.0
        if st.index is not None:
            stats = st.index.memory_stats()
            total = indexed = stats["total_vectors"]
            mem_gb = stats["total_bytes"] / (1 << 30)
        pending = sum(len(v) for v in st.pending_vectors)
        pct = eng.metrics.get_percentiles(request.index)
        return vdb_pb2.StatsResponse(
            total_vectors=total + pending,
            indexed_vectors=indexed,
            current_epoch=st.epoch,
            gpu_memory_used=mem_gb,
            nvme_usage=0.0,
            latency_p50_ms=pct["p50"],
            latency_p95_ms=pct["p95"],
            latency_p99_ms=pct["p99"],
        )
