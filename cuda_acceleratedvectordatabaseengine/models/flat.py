"""Exact brute-force flat index.

BASELINE config #1 ("Flat brute-force exact L2 search, top-10") and the
ground-truth oracle for the recall harness (the reference planned but never
built one — ``bench/recall_test.cpp`` missing, ``bench/CMakeLists.txt:29-44``).

Device layout: one padded ``[N_pad, dim]`` tensor scanned in fixed chunks so
every step is a dense matmul. Search is a single jitted program; batch
sizes are bucketed to avoid recompilation (SURVEY.md §7 hard part #3).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from cuda_acceleratedvectordatabaseengine.ops.distance import Metric
from cuda_acceleratedvectordatabaseengine.ops.normalize import l2_normalize
from cuda_acceleratedvectordatabaseengine.ops.scan import scan_flat
from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.utils.batching import bucket_size

_ROW_ALIGN = 1024


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "chunk_size")
)
def _flat_search(queries, data, data_sq, n_valid, k, metric, chunk_size):
    return scan_flat(queries, data, data_sq, n_valid, k,
                     metric=metric, chunk_size=chunk_size)


class FlatIndex:
    """Exact nearest-neighbor index over a single device-resident block."""

    def __init__(self, dimension: int, metric: Metric = Metric.L2,
                 dtype=jnp.bfloat16, chunk_size: int = 65536):
        self.dimension = dimension
        self.metric = Metric.parse(metric) if isinstance(metric, str) else metric
        self.dtype = jnp.dtype(dtype)
        self.chunk_size = chunk_size
        self._n = 0
        self._data = jnp.zeros((_ROW_ALIGN, dimension), self.dtype)
        self._data_sq = jnp.zeros((_ROW_ALIGN,), jnp.float32)
        self._ids = np.full((_ROW_ALIGN,), INVALID_ID, np.uint64)

    def __len__(self) -> int:
        return self._n

    def add(self, vectors: np.ndarray, ids: np.ndarray | None = None) -> None:
        vectors = np.ascontiguousarray(vectors, np.float32)
        n = vectors.shape[0]
        if n == 0:
            return
        assert vectors.shape[1] == self.dimension
        if ids is None:
            ids = np.arange(self._n, self._n + n, dtype=np.uint64)
        if self.metric == Metric.COSINE:
            vectors = np.asarray(l2_normalize(jnp.asarray(vectors)))

        new_n = self._n + n
        cap = self._data.shape[0]
        if new_n > cap:
            new_cap = max(new_n, int(cap * 2))
            new_cap = ((new_cap + _ROW_ALIGN - 1) // _ROW_ALIGN) * _ROW_ALIGN
            self._data = jnp.pad(self._data, ((0, new_cap - cap), (0, 0)))
            self._data_sq = jnp.pad(self._data_sq, (0, new_cap - cap))
            ids_new = np.full((new_cap,), INVALID_ID, np.uint64)
            ids_new[: self._n] = self._ids[: self._n]
            self._ids = ids_new

        vec_d = jnp.asarray(vectors)
        rows = jnp.arange(self._n, new_n)
        self._data = self._data.at[rows].set(vec_d.astype(self.dtype))
        self._data_sq = self._data_sq.at[rows].set(jnp.sum(vec_d * vec_d, -1))
        self._ids[self._n:new_n] = ids.astype(np.uint64)
        self._n = new_n

    def remove_ids(self, ids: np.ndarray) -> int:
        """Delete by user id via swap-from-tail within the flat block (the
        exact-index twin of ``IVFFlatIndex.remove_ids`` — no reference
        analog). Unknown ids are ignored; rows keep prefix packing so the
        count-masked search is untouched."""
        from cuda_acceleratedvectordatabaseengine.models.arena import (
            plan_removals,
        )

        ids = np.unique(np.asarray(ids, np.uint64))
        ids = ids[ids != INVALID_ID]
        if ids.size == 0 or self._n == 0:
            return 0
        d = np.flatnonzero(np.isin(self._ids[: self._n], ids))
        if d.size == 0:
            return 0
        # The flat block is the single-list case of the shared
        # swap-from-tail plan (counts=[n], every row in list 0).
        _, src_s, dst_s, new_counts = plan_removals(
            np.asarray([self._n], np.int64),
            np.zeros(d.size, np.int64),
            d.astype(np.int64),
        )
        new_n = int(new_counts[0])
        if src_s.size:
            hj = jnp.asarray(dst_s)
            tj = jnp.asarray(src_s)
            self._data = self._data.at[hj].set(self._data[tj])
            self._data_sq = self._data_sq.at[hj].set(self._data_sq[tj])
            self._ids[dst_s] = self._ids[src_s]
        self._ids[new_n: self._n] = INVALID_ID
        removed = self._n - new_n
        self._n = new_n
        return removed

    def search(
        self, queries: np.ndarray, k: int = 10
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k. Returns ``(distances [B, k] fp32, ids [B, k] uint64)``
        with FLT_MAX / UINT64_MAX sentinels on underfull results, matching the
        reference's merge semantics (``engine/ivf_flat_index.cpp:474-518``)."""
        queries = np.ascontiguousarray(queries, np.float32)
        b = queries.shape[0]
        bs = bucket_size(b)
        if bs > b:
            queries = np.pad(queries, ((0, bs - b), (0, 0)))
        q = jnp.asarray(queries)
        if self.metric == Metric.COSINE:
            q = l2_normalize(q)
        chunk = min(self.chunk_size, self._data.shape[0])
        d, pos = _flat_search(
            q, self._data, self._data_sq, jnp.int32(self._n),
            k, self.metric, chunk,
        )
        d = np.asarray(d)[:b].copy()
        pos = np.asarray(pos)[:b]
        ids = self._ids[np.clip(pos, 0, self._ids.size - 1)]
        ids[pos < 0] = INVALID_ID
        d[pos < 0] = np.float32(np.finfo(np.float32).max)
        return d, ids
