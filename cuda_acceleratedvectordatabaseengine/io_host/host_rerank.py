"""Host-store exact rerank: the capacity tier's second stage.

The reference declares exact rerank against GPU-resident raw vectors
(``use_exact_rerank``/``rerank_k``, ``engine/ivf_flat_index.h:153-157``)
— which presumes the raw corpus fits device memory. Past the HBM wall
(int8-flat at 768D ≈ 20M rows on a 16 GB chip) that premise fails, and the
reference's own answer is its host/NVMe tier (``ShardManager``,
``format/storage.h:124-173`` — declared, never built). This module is the
composition of the two ideas:

  device: IVF-PQ ADC scan over the resident code arena (~8 B/row at
          m=96 vs 768 B/row int8-flat) → top-``R`` candidate ids
  host:   gather those R rows per query from the int8-residual
          :class:`HostListStore` in host RAM, dequantize, recompute exact
          distances (one batched BLAS contraction), keep top-k.

Unlike the >HBM *streaming* tier (``io_host/streaming.py``), which must
move whole inverted lists over H2D on a cache miss and therefore lives or
dies by workload locality, the rerank stage touches only ``B × R`` rows of
host RAM per batch and never ships them to the device — uniform query
traffic costs the same as a hot working set. PQ codes answer "which k",
the host store answers "how far, exactly".

Quantization contract matches ``HostListStore`` int8 mode: a stored row is
``anchor[list] + code · scale_row`` and ``sq`` holds the norm of that
stored representation, so reranked distances are exact distances to the
stored point (int8 quantization noise ~1% recall at 768D, measured in
round 2).
"""

from __future__ import annotations

import numpy as np

from cuda_acceleratedvectordatabaseengine.models.arena import INVALID_ID
from cuda_acceleratedvectordatabaseengine.ops.distance import Metric

FLT_MAX = np.float32(3.4028235e38)


def _flatten_lists(arrs, empty_shape, dtype):
    """Concatenate per-list arrays — zero-copy when they are consecutive
    contiguous views tiling one backing array start to end (the persisted
    store load path: list ``l`` = ``base[off_l:off_l+c_l]``). At 20M×768
    the int8 copy is 15 GB and minutes of IO; the base (often a memmap)
    serves gathers directly through the page cache instead."""
    from numpy.lib.array_utils import byte_bounds

    nonempty = [a for a in arrs if a.shape[0]]
    if not nonempty:
        return np.zeros(empty_shape, dtype)
    first = nonempty[0]
    owner = first.base if first.base is not None else first
    zero_copy = (
        isinstance(owner, np.ndarray)
        and owner.flags["C_CONTIGUOUS"]
        and owner.dtype == first.dtype
        and all(
            (a.base is owner or a is owner) and a.flags["C_CONTIGUOUS"]
            and a.dtype == first.dtype
            for a in nonempty
        )
    )
    if zero_copy:
        prev = byte_bounds(first)[0]
        for a in nonempty:
            lo, hi = byte_bounds(a)
            if lo != prev:
                zero_copy = False
                break
            prev = hi
    if zero_copy:
        olo, _ = byte_bounds(owner)
        start = (byte_bounds(first)[0] - olo) // first.dtype.itemsize
        inner = int(np.prod(first.shape[1:], dtype=np.int64))
        total = sum(a.shape[0] for a in nonempty)
        return owner.reshape(-1)[start:start + total * inner].reshape(
            (total,) + first.shape[1:]
        )
    return np.concatenate(nonempty)


class HostReranker:
    """Exact second-stage rerank over a flattened :class:`HostListStore`.

    Flattens the per-list store arrays once at construction (zero-copy
    when they already view one backing buffer is not attempted — the flat
    copy is int8, i.e. the same footprint as the store itself, and makes
    every later gather a single contiguous fancy-index).
    """

    def __init__(self, store, batch_rows: int = 131072,
                 use_native: bool = True):
        self.dim = store.dim
        self.quantized = store.dtype == "int8"
        self.use_native = use_native
        counts = np.asarray(
            [v.shape[0] for v in store.vectors], dtype=np.int64
        )
        n = int(counts.sum())
        self.ntotal = n
        self.batch_rows = int(batch_rows)
        vdt = np.int8 if self.quantized else np.float32
        self.vecs = _flatten_lists(store.vectors, (0, store.dim), vdt)
        self.sq = _flatten_lists(store.sq, (0,), np.float32)
        ids = _flatten_lists(store.ids, (0,), np.uint64)
        self.ids = ids
        if self.quantized:
            self.scale = _flatten_lists(store.scale, (0,), np.float32)
            self.anchors = np.asarray(store.anchors, np.float32)
            self.anchor_row = np.repeat(
                np.arange(store.nlist, dtype=np.int32), counts
            )
        else:
            self.scale = None
            self.anchors = None
            self.anchor_row = None

        # id → flat row. Dense-ish ids get an O(1) inverse table; sparse
        # uint64 ids fall back to sorted binary search. The admission is
        # deliberately generous — up to 32× id-space slack, capped at a
        # 4 GB table — because the searchsorted path costs real money at
        # serving batch sizes (R=512 × b512 is 262K lookups × ~24
        # cache-missing probes each): trading idle host RAM for it is
        # the right default on rerank hosts, which hold the multi-GB row
        # store anyway.
        self._inv = None
        self._order = None
        self._sorted_ids = None
        if n:
            ids64 = ids.astype(np.int64, copy=False)
            max_id = int(ids64.max())
            if max_id < min(32 * n + 1024, 1 << 29):
                inv = np.full(max_id + 1, -1, np.int64)
                inv[ids64] = np.arange(n, dtype=np.int64)
                self._inv = inv
            else:
                self._order = np.argsort(ids, kind="stable")
                self._sorted_ids = ids[self._order]

    def preload(self, chunk_rows: int = 1 << 20) -> None:
        """Page the backing row store into RAM sequentially. The zero-copy
        flatten can leave ``vecs`` a memmap whose pages fault in on first
        gather — random 4K faults are seek-bound (~10K IOPS measured: a
        cold 262K-row shortlist cost ~26 s that sequential read-through
        covers at disk bandwidth). Call once before serving when the store
        fits RAM; no-op cost when already resident."""
        for s in range(0, self.vecs.shape[0], chunk_rows):
            np.sum(self.vecs[s:s + chunk_rows, :1].astype(np.int32))

    def nbytes(self) -> int:
        total = self.vecs.nbytes + self.sq.nbytes + self.ids.nbytes
        for a in (self.scale, self.anchors, self.anchor_row, self._inv,
                  self._order, self._sorted_ids):
            if a is not None:
                total += a.nbytes
        return total

    def _rows_of_ids(self, flat_ids: np.ndarray) -> np.ndarray:
        """Map candidate ids → flat store rows (-1 for unknown/invalid)."""
        valid = flat_ids != INVALID_ID
        rows = np.full(flat_ids.shape, -1, np.int64)
        if not valid.any() or self.ntotal == 0:
            return rows
        ids64 = flat_ids[valid].astype(np.int64)
        if self._inv is not None:
            in_range = (ids64 >= 0) & (ids64 < self._inv.size)
            got = np.full(ids64.shape, -1, np.int64)
            got[in_range] = self._inv[ids64[in_range]]
            rows[valid] = got
        else:
            pos = np.searchsorted(self._sorted_ids, flat_ids[valid])
            pos = np.minimum(pos, self.ntotal - 1)
            hit = self._sorted_ids[pos] == flat_ids[valid]
            got = np.where(hit, self._order[pos], -1)
            rows[valid] = got
        return rows

    _METRIC_CODE = {
        Metric.L2: 0, Metric.INNER_PRODUCT: 1, Metric.COSINE: 2,
    }

    def _anchor_dots(self, queries, rows):
        """Per-candidate query·anchor terms ``[B, R]`` via each query's
        UNIQUE candidate anchors (≤ nprobe of them — every candidate comes
        from a probed list). Replaces the dense ``[B, nlist]`` GEMM, which
        at B=512, nlist=8192, D=768 is 6.4 GFLOP of host BLAS per batch —
        measured as the single largest term of the rerank stage on the
        1-vCPU harness host. This path is ~B·(R log R + nprobe·D) ≈ 50×
        less arithmetic at the 20M capacity-tier operating point."""
        b, r = rows.shape
        lists = self.anchor_row[np.maximum(rows, 0)]        # [B, R]
        qa_cand = np.empty((b, r), np.float32)
        for i in range(b):
            u, inv = np.unique(lists[i], return_inverse=True)
            qa_cand[i] = (queries[i] @ self.anchors[u].T)[inv]
        return qa_cand

    def _rerank_native(self, queries, q_sq, rows, cand_ids, metric, k,
                       qa_cand):
        """Fused C++ rerank (``native.vdb_rerank``): gather + factored
        dequant + dot + top-k in one pass over each candidate row — no
        [B, R, D] fp32 transient. Measured ~6× over the NumPy path at
        B=512, R=512, D=768 on one core (AVX2); returns None (→ NumPy
        fallback) when the library is unavailable or inputs are
        non-contiguous."""
        from cuda_acceleratedvectordatabaseengine import native

        if self.ntotal == 0 or not self.vecs.flags["C_CONTIGUOUS"]:
            return None
        return native.rerank(
            self.vecs, rows, cand_ids, queries,
            q_sq if metric == Metric.L2 else None,
            self._METRIC_CODE[metric], k,
            scale=self.scale,
            sq=self.sq if metric == Metric.L2 else None,
            anchor_row=self.anchor_row,
            qa_cand=qa_cand,
        )

    def rerank(
        self,
        queries: np.ndarray,   # [B, D] fp32 — ORIGINAL (unrotated) space
        cand_ids: np.ndarray,  # [B, R] uint64, INVALID_ID padding allowed
        metric: Metric,
        k: int,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Exact distances of each query to its R candidates; top-k.

        For cosine the caller passes L2-normalized queries and a store
        built from normalized vectors (the index normalizes at ingest).
        """
        b, r = cand_ids.shape
        queries = np.ascontiguousarray(queries, np.float32)
        out_d = np.full((b, k), FLT_MAX, np.float32)
        out_i = np.full((b, k), INVALID_ID, np.uint64)
        rows = self._rows_of_ids(cand_ids)
        q_sq = np.einsum("bd,bd->b", queries, queries)
        # Factored int8 dots: q·x̂ = q·anchor[l] + scale·(q·code). The
        # anchor term is computed per query over its UNIQUE candidate
        # anchors (≤ nprobe), not as a [B, nlist] GEMM — see _anchor_dots.
        qa_cand = (
            self._anchor_dots(queries, rows) if self.quantized else None
        )

        if self.use_native:
            native_out = self._rerank_native(
                queries, q_sq, rows, cand_ids, metric, k, qa_cand
            )
            if native_out is not None:
                return native_out

        # Chunk over queries so the fp32 cast transient stays bounded
        # (B·R·D fp32 at B=512, R=256, D=768 would be ~400 MB).
        step = max(self.batch_rows // max(r, 1), 1)
        for s in range(0, b, step):
            e = min(s + step, b)
            rs = rows[s:e]                       # [c, R]
            safe = np.maximum(rs, 0)
            cand = self.vecs[safe.ravel()].astype(np.float32)
            cand = cand.reshape(e - s, r, self.dim)
            # One batched BLAS contraction: [c, R, D] @ [c, D, 1].
            dots = np.matmul(
                cand, queries[s:e, :, None], dtype=np.float32
            )[..., 0]                            # [c, R]
            if self.quantized:
                dots *= self.scale[safe]
                dots += qa_cand[s:e]
            if metric == Metric.INNER_PRODUCT:
                d = -dots
            elif metric == Metric.COSINE:
                d = 1.0 - dots
            else:
                d = np.maximum(
                    q_sq[s:e, None] - 2.0 * dots + self.sq[safe], 0.0
                )
            d = np.where(rs >= 0, d, FLT_MAX).astype(np.float32)
            if r > k:
                part = np.argpartition(d, k - 1, axis=1)[:, :k]
            else:
                part = np.broadcast_to(np.arange(r), (e - s, r))
            dk = np.take_along_axis(d, part, axis=1)
            order = np.argsort(dk, axis=1, kind="stable")
            top = np.take_along_axis(part, order, axis=1)[:, :k]
            dd = np.take_along_axis(d, top, axis=1)
            ii = np.take_along_axis(cand_ids[s:e], top, axis=1)
            ii = np.where(dd < FLT_MAX, ii, INVALID_ID)
            nk = min(k, r)
            out_d[s:e, :nk] = dd[:, :nk]
            out_i[s:e, :nk] = ii[:, :nk]
        return out_d, out_i
