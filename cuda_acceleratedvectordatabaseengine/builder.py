"""Chunked balanced index builds (the real ``indexmgr`` offline builder,
``/root/reference/indexmgr/CMakeLists.txt:8-47`` — a ghost binary there).

Both build surfaces — the server's BuildEpoch worker and the
``vdb-build-index`` CLI — drive this module, so a 10M×768 build never
stages the corpus through host RAM: chunks stream off the memory-mapped
Arrow file one at a time, train on an evenly spaced cross-file sample,
and append through the *balanced* device pack (capacity clamped near the
mean list size, overflow spilled to next-nearest lists) — the same
arena-shaping law the headline benchmark uses (``bench.py``), instead of
the ``np.concatenate`` + ``add()`` path that needed ~30 GB host RAM and
produced an unbalanced arena.
"""

from __future__ import annotations

from typing import Callable, Iterable

import jax.numpy as jnp
import numpy as np

from cuda_acceleratedvectordatabaseengine.models.arena import (
    PackedListArena,
)

# The measured arena-shaping law from the headline chunked build
# (bench.py): capacity ≈ 1.35× the mean list size, slot-aligned. Balanced
# assignment spills the overflow of fat lists to their next-nearest
# centroid, so the padded arena stays ~35% over the ideal dense size
# instead of tracking the fattest cluster.
CAPACITY_FACTOR = 1.35


def chunked_capacity(n_total: int, nlist: int) -> int:
    mean = max(1, n_total // max(nlist, 1))
    align = PackedListArena.SLOT_ALIGN
    return -(-int(mean * CAPACITY_FACTOR) // align) * align


def build_index_chunked(
    index,
    chunks: Iterable[tuple[np.ndarray, np.ndarray]],
    n_total: int,
    *,
    train_sample: np.ndarray | None = None,
    tombstones: np.ndarray | None = None,
    progress: Callable[[float], None] | None = None,
    row_sink: Callable[[np.ndarray, np.ndarray], None] | None = None,
) -> int:
    """Stream ``chunks`` of ``(ids, vectors)`` into ``index``.

    - Trains on ``train_sample`` first when the index is untrained.
    - IVF-Flat chunks go through ``append_balanced`` with a capacity
      fixed up front from ``n_total`` (no mid-build reallocation); IVF-PQ
      pre-``reserve``\\ s the same capacity and ingests via
      ``add_from_device``.
    - ``tombstones``: ids filtered out of every chunk (deletions baked at
      build time, ``server/service.py`` semantics).
    - ``progress(frac)`` is called after every chunk with rows_done /
      n_total — BuildJob progress advances per chunk.
    - ``row_sink(ids, vectors)`` receives every ingested (post-filter)
      chunk — the pq_capacity tier streams its host-rerank rows to the
      epoch's vectors file through this.

    Returns the number of rows ingested. Peak host RAM is one chunk plus
    the training sample.
    """
    is_pq = hasattr(index, "codebooks")
    if not index.trained:
        if train_sample is None or not len(train_sample):
            raise ValueError("untrained index needs a train_sample")
        index.train(np.ascontiguousarray(train_sample, np.float32))
    cap = chunked_capacity(n_total, index.config.nlist)
    if is_pq:
        index.reserve(cap)
    done = 0
    for ids, vecs in chunks:
        ids = np.asarray(ids, np.uint64)
        vecs = np.ascontiguousarray(vecs, np.float32)
        if tombstones is not None and tombstones.size:
            keep = ~np.isin(ids, tombstones)
            ids, vecs = ids[keep], vecs[keep]
        if not len(ids):
            continue
        x_dev = jnp.asarray(vecs)
        if is_pq:
            index.add_from_device(x_dev, ids)
        else:
            index.append_balanced(x_dev, ids=ids, capacity=cap)
        if row_sink is not None:
            row_sink(ids, vecs)
        done += len(ids)
        if progress is not None:
            progress(min(1.0, done / max(n_total, 1)))
    return done


def train_sample_rows(config) -> int:
    """Training subsample budget for a config (same law as
    ``IVFFlatIndex.train``: ``train_sample_per_list * nlist``)."""
    return int(config.train_sample_per_list) * int(config.nlist)
