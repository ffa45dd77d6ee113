"""Whole-index snapshots: the ``save``/``load`` the reference declared but
never implemented (``engine/ivf_flat_index.h:66-67``; acknowledged broken in
SURVEY.md §5 checkpoint/resume).

Layout of a snapshot directory:
    manifest.json      — IndexManifest (kind, params, shard table)
    centroids.arrow    — [nlist, dim] fp32
    vectors.arrow      — compacted rows in (list, slot) order + uint64 ids
    codebooks.arrow    — PQ only: [m, ks, dsub] fp32
    codes.arrow        — PQ only: [n, m] uint8 in the same row order

Vectors are stored *compacted* (no padding) with per-list extents in the
manifest shard table, so snapshot size is data size; the padded device arena
is rebuilt on load.
"""

from __future__ import annotations

import os

import numpy as np

from cuda_acceleratedvectordatabaseengine.storage.arrow_store import (
    ArrowStorage,
)
from cuda_acceleratedvectordatabaseengine.storage.manifest import (
    IndexManifest,
    ShardEntry,
)

VECTORS_FILE = "vectors.arrow"
CENTROIDS_FILE = "centroids.arrow"
CODEBOOKS_FILE = "codebooks.arrow"
CODES_FILE = "codes.arrow"


def _compact(arena: np.ndarray, counts: np.ndarray, ids: np.ndarray):
    """Padded [nlist, cap, ...] → compact rows in (list, slot) order."""
    nlist, cap = arena.shape[0], arena.shape[1]
    mask = np.arange(cap)[None, :] < counts[:, None]
    return arena[mask], ids[mask], mask


def _shard_table(counts: np.ndarray) -> list[ShardEntry]:
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    return [
        ShardEntry(list_id=i, row_offset=int(offsets[i]),
                   num_vectors=int(counts[i]))
        for i in range(len(counts))
    ]


def _rebuild_padded(vectors, ids, counts, capacity):
    """Compact rows (list order) → padded [nlist, cap, dim] + id table."""
    nlist = len(counts)
    dim = vectors.shape[1]
    arena = np.zeros((nlist, capacity, dim), np.float32)
    from cuda_acceleratedvectordatabaseengine.models.arena import (
        INVALID_ID,
    )

    id_table = np.full((nlist, capacity), INVALID_ID, np.uint64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    row_list = np.repeat(np.arange(nlist), counts)
    slot = np.arange(len(vectors)) - offsets[row_list]
    arena[row_list, slot] = vectors
    id_table[row_list, slot] = ids
    return arena, id_table


# ---------------------------------------------------------------------- #
# IVF-Flat
# ---------------------------------------------------------------------- #

def save_ivf_flat(path: str, index) -> None:
    os.makedirs(path, exist_ok=True)
    state = index.state_arrays()
    counts = state["counts"]
    vecs, ids, _ = _compact(state["arena"], counts, state["ids"])
    ArrowStorage.write_vectors(os.path.join(path, VECTORS_FILE), ids, vecs)
    ArrowStorage.write_centroids(
        os.path.join(path, CENTROIDS_FILE), state["centroids"]
    )
    cfg = index.config
    extra = {}
    if getattr(index, "calibrated_nprobe", None):
        # measured-coverage calibration (vdb-tune / calibrate_nprobe)
        # survives the snapshot so a recovering server serves nprobe=0
        # requests with the tuned value
        extra["calibrated_nprobe"] = int(index.calibrated_nprobe)
    if getattr(cfg, "multi_assign_eps", 0.0):
        # a multi-assignment arena stores replicated ids; a loaded index
        # must keep scanning 2k + deduping or results would carry dups
        extra["multi_assign_eps"] = float(cfg.multi_assign_eps)
    IndexManifest(
        kind="ivf_flat",
        dimension=cfg.dimension,
        nlist=cfg.nlist,
        metric=cfg.metric.value,
        num_vectors=int(counts.sum()),
        capacity_per_list=index.arena.capacity,
        dtype=str(cfg.dtype),
        shards=_shard_table(counts),
        extra=extra,
    ).save(path)


def load_ivf_flat(path: str):
    from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
        IVFFlatConfig,
        IVFFlatIndex,
    )

    man = IndexManifest.load(path)
    if man.kind != "ivf_flat":
        raise ValueError(f"snapshot at {path} is kind={man.kind!r}")
    ids, vecs = ArrowStorage.read_vectors(os.path.join(path, VECTORS_FILE))
    centroids = ArrowStorage.read_centroids(
        os.path.join(path, CENTROIDS_FILE)
    )
    counts = np.array([s.num_vectors for s in man.shards], np.int64)
    arena, id_table = _rebuild_padded(
        vecs, ids, counts, man.capacity_per_list
    )
    cfg = IVFFlatConfig(
        dimension=man.dimension, nlist=man.nlist, metric=man.metric,
        dtype=man.dtype,
        multi_assign_eps=float(man.extra.get("multi_assign_eps", 0.0)),
    )
    idx = IVFFlatIndex.from_state(cfg, centroids, arena, counts, id_table)
    if man.extra.get("calibrated_nprobe"):
        idx.calibrated_nprobe = int(man.extra["calibrated_nprobe"])
    return idx


def load_ivf_flat_host(path: str):
    """Load an IVF-Flat snapshot into HOST RAM only — no device arena is
    ever materialized. This is the >HBM serving path: the streaming tier
    (``io_host/streaming.StreamingIVFFlatIndex.from_store``) serves the
    returned store through an HBM list cache, so an epoch larger than the
    chip's memory activates without OOM (the scenario the reference's
    ``max_gpu_memory`` config promised, ``engine/ivf_flat_index.h:21``).

    Returns ``(store, centroids_host, config, capacity_per_list)``.
    """
    from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
        HostListStore,
    )
    from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
        IVFFlatConfig,
    )

    man = IndexManifest.load(path)
    if man.kind != "ivf_flat":
        raise ValueError(f"snapshot at {path} is kind={man.kind!r}")
    ids, vecs = ArrowStorage.read_vectors(os.path.join(path, VECTORS_FILE))
    centroids = ArrowStorage.read_centroids(
        os.path.join(path, CENTROIDS_FILE)
    )
    cfg = IVFFlatConfig(
        dimension=man.dimension, nlist=man.nlist, metric=man.metric,
        dtype=man.dtype,
    )
    store = HostListStore(man.nlist, man.dimension)
    for s in man.shards:
        rows = slice(s.row_offset, s.row_offset + s.num_vectors)
        v = np.ascontiguousarray(vecs[rows], np.float32)
        store.vectors[s.list_id] = v
        store.sq[s.list_id] = (
            (v.astype(np.float64) ** 2).sum(-1).astype(np.float32)
        )
        store.ids[s.list_id] = ids[rows].astype(np.uint64)
    return store, centroids, cfg, man.capacity_per_list


# ---------------------------------------------------------------------- #
# IVF-PQ
# ---------------------------------------------------------------------- #

def save_ivf_pq(path: str, index, host_rows=None,
                host_rows_file: bool = False) -> None:
    """Snapshot an IVF-PQ index.

    ``host_rows_file=True`` marks that the caller ALREADY streamed the
    raw rows to the epoch's vectors file chunk-by-chunk
    (``ArrowStorage``/``VectorFileWriter`` — the chunked builder path),
    in arrival order; ``load_ivf_pq_capacity`` matches rows to the arena
    by id, so the full fp32 corpus never has to sit in host RAM here.

    ``host_rows=(vectors, ids)`` additionally persists the ORIGINAL-frame
    raw rows (any order; matched to the arena by id) even when
    ``keep_raw=False`` — the PQ *capacity* tier's epoch format: codes
    rebuild the device arena, rows feed the host-RAM exact reranker
    (``load_ivf_pq_capacity``). For cosine the rows are L2-normalized
    before writing, matching what the index ingested.
    """
    os.makedirs(path, exist_ok=True)
    state = index.state_arrays()
    counts = state["counts"]
    cap = index.capacity
    nlist = index.config.nlist
    mask = np.arange(cap)[None, :] < counts[:, None]
    ids = state["ids"][mask]
    codes = state["codes"][mask]
    ArrowStorage.write_codes(os.path.join(path, CODES_FILE), ids, codes)
    ArrowStorage.write_codebooks(
        os.path.join(path, CODEBOOKS_FILE), state["codebooks"]
    )
    ArrowStorage.write_centroids(
        os.path.join(path, CENTROIDS_FILE), state["centroids"]
    )
    if "opq_R" in state:
        # OPQ rotation: the whole index lives in the rotated basis, so the
        # rotation must survive persistence or reloaded queries would be
        # scanned in the wrong frame.
        np.save(os.path.join(path, "opq_rotation.npy"),
                state["opq_R"].astype(np.float32))
    if "arena" in state:
        vecs = state["arena"][mask]
        ArrowStorage.write_vectors(
            os.path.join(path, VECTORS_FILE), ids, vecs
        )
    elif host_rows is not None:
        hx, hids = host_rows
        hids = np.asarray(hids, np.uint64)
        order = np.argsort(hids, kind="stable")
        pos = np.searchsorted(hids[order], ids)
        pos = np.minimum(pos, len(hids) - 1)
        if not (hids[order][pos] == ids).all():
            raise ValueError("host_rows ids do not cover the arena's ids")
        rows = np.ascontiguousarray(hx, np.float32)[order[pos]]
        if index.config.metric.value == "Cosine":
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-12
            )
        ArrowStorage.write_vectors(
            os.path.join(path, VECTORS_FILE), ids, rows
        )
    cfg = index.config
    IndexManifest(
        kind="ivf_pq",
        dimension=cfg.dimension,
        nlist=nlist,
        metric=cfg.metric.value,
        pq_m=cfg.m,
        pq_nbits=cfg.nbits,
        num_vectors=int(counts.sum()),
        capacity_per_list=cap,
        dtype=str(cfg.raw_dtype),
        shards=_shard_table(counts),
        extra={
            "keep_raw": "arena" in state,
            "host_rows": (
                "arena" in state or host_rows is not None or host_rows_file
            ),
            **({"calibrated_nprobe": int(index.calibrated_nprobe)}
               if getattr(index, "calibrated_nprobe", None) else {}),
        },
    ).save(path)


def load_ivf_pq(path: str):
    import jax.numpy as jnp

    from cuda_acceleratedvectordatabaseengine.models.arena import (
        INVALID_ID,
        PackedListArena,
    )
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQConfig,
        IVFPQIndex,
    )

    man = IndexManifest.load(path)
    if man.kind != "ivf_pq":
        raise ValueError(f"snapshot at {path} is kind={man.kind!r}")
    keep_raw = bool(man.extra.get("keep_raw", False))
    rot_path = os.path.join(path, "opq_rotation.npy")
    cfg = IVFPQConfig(
        dimension=man.dimension, nlist=man.nlist, m=man.pq_m,
        nbits=man.pq_nbits, metric=man.metric, keep_raw=keep_raw,
        raw_dtype=man.dtype, opq=os.path.isfile(rot_path),
    )
    idx = IVFPQIndex(cfg)
    if cfg.opq:
        idx.opq_R = jnp.asarray(np.load(rot_path))
    idx.centroids = jnp.asarray(
        ArrowStorage.read_centroids(os.path.join(path, CENTROIDS_FILE))
    )
    idx.codebooks = jnp.asarray(
        ArrowStorage.read_codebooks(os.path.join(path, CODEBOOKS_FILE))
    )
    ids, codes = ArrowStorage.read_codes(os.path.join(path, CODES_FILE))
    counts = np.array([s.num_vectors for s in man.shards], np.int64)
    cap = man.capacity_per_list
    nlist = man.nlist
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    row_list = np.repeat(np.arange(nlist), counts)
    slot = np.arange(len(ids)) - offsets[row_list]
    code_arena = np.zeros((nlist, cap, cfg.m), np.uint8)
    code_arena[row_list, slot] = codes
    idx.code_arena = jnp.asarray(code_arena)
    if keep_raw:
        _, vecs = ArrowStorage.read_vectors(os.path.join(path, VECTORS_FILE))
        arena, id_table = _rebuild_padded(vecs, ids, counts, cap)
        idx.raw = PackedListArena.from_host(
            arena, counts, id_table, jnp.dtype(man.dtype)
        )
    else:
        idx.raw = None
        id_table = np.full((nlist, cap), INVALID_ID, np.uint64)
        id_table[row_list, slot] = ids
        idx._counts = jnp.asarray(counts.astype(np.int32))
        idx._ids = id_table
    idx.trained = True
    if man.extra.get("calibrated_nprobe"):
        idx.calibrated_nprobe = int(man.extra["calibrated_nprobe"])
    return idx


def load_ivf_pq_capacity(path: str, rerank_k: int = 128,
                         margin: float = 0.0):
    """Load a ``keep_raw=False`` IVF-PQ snapshot as the *capacity* tier:
    codes rebuild the device arena (~m bytes/row), the snapshot's raw rows
    load into an int8 host-RAM store feeding exact second-stage rerank
    (``io_host/host_rerank.HostReranker``). This serves corpora past the
    HBM wall with no workload-locality requirement — the composition of
    the reference's declared ``rerank_k`` surface
    (``engine/ivf_flat_index.h:153-157``) with its declared host tier
    (``format/storage.h:124-173``).

    The returned index is read-only (adds would desynchronize the host
    store — ``IVFPQIndex.add`` guards this).
    """
    from cuda_acceleratedvectordatabaseengine.io_host.streaming import (
        HostListStore,
    )

    man = IndexManifest.load(path)
    if man.kind != "ivf_pq":
        raise ValueError(f"snapshot at {path} is kind={man.kind!r}")
    if man.extra.get("keep_raw", False):
        raise ValueError(
            "snapshot has a device-resident raw arena (keep_raw=True); the "
            "capacity tier expects keep_raw=False codes + host rows"
        )
    if not man.extra.get("host_rows", False):
        raise ValueError(
            "snapshot has no host rows — save with "
            "save_ivf_pq(..., host_rows=(vectors, ids))"
        )
    idx = load_ivf_pq(path)
    ids, vecs = ArrowStorage.read_vectors(os.path.join(path, VECTORS_FILE))
    # Rows may be in (list, slot) order (RAM-path save) or arrival order
    # (the chunked builder streams them per chunk) — derive each row's
    # list by matching its id against the code arena's id table, so the
    # store's tested int8 quantization path does the packing either way.
    # Anchors must be in the rows' ORIGINAL frame: un-rotate OPQ
    # centroids.
    from cuda_acceleratedvectordatabaseengine.models.arena import (
        INVALID_ID,
    )

    ids_tab = np.asarray(idx.ids)
    valid = ids_tab != INVALID_ID
    a_lists = np.nonzero(valid)[0]
    a_ids = ids_tab[valid]
    order = np.argsort(a_ids, kind="stable")
    pos = np.searchsorted(a_ids[order], ids)
    pos = np.minimum(pos, max(len(a_ids) - 1, 0))
    if len(a_ids) == 0 or not (a_ids[order][pos] == ids).all():
        raise ValueError(
            "vectors file ids do not match the code arena's id table"
        )
    assignments = a_lists[order][pos].astype(np.int64)
    centroids = np.asarray(idx.centroids, np.float32)
    if idx.opq_R is not None:
        centroids = centroids @ np.asarray(idx.opq_R, np.float32).T
    store = HostListStore.from_assignments(
        vecs, ids, assignments, man.nlist, dtype="int8", anchors=centroids
    )
    idx.attach_host_rerank(store, rerank_k=rerank_k, margin=margin)
    idx.read_only = True
    return idx
