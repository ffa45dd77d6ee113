"""Per-list shard files + aligned reader — implementing the declared-only
``ShardManager`` (F4, ``format/storage.h:124-173``) and
``NVMeOptimizedReader`` (F3, ``format/storage.h:91-122``).

A shard is one inverted list on disk as three appendable files (the
reference's "3 mmaps: vectors/ids/codes" design):

    <list_id>.ids   uint64[n]
    <list_id>.vec   float32[n, dim]
    <list_id>.code  uint8[n, m]        (PQ only)

Appends are O_APPEND writes; loads are zero-copy ``np.memmap`` views;
``compact`` rewrites dropping tombstoned ids. The aligned reader issues
4 KiB-aligned preads with fadvise readahead and a thread-pool async path —
the POSIX equivalent of the reference's io_depth-32 O_DIRECT design.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading

import numpy as np

ALIGN = 4096


class ShardManager:
    """Filesystem manager for per-list shards of one index."""

    def __init__(self, base_dir: str, dimension: int, code_width: int = 0):
        self.base_dir = base_dir
        self.dimension = dimension
        self.code_width = code_width
        os.makedirs(base_dir, exist_ok=True)
        self._locks: dict[int, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def _lock(self, list_id: int) -> threading.Lock:
        with self._locks_guard:
            return self._locks.setdefault(list_id, threading.Lock())

    def _paths(self, list_id: int) -> tuple[str, str, str]:
        stem = os.path.join(self.base_dir, f"{list_id:08d}")
        return stem + ".ids", stem + ".vec", stem + ".code"

    # ------------------------------------------------------------------ #

    def create_shard(self, list_id: int) -> None:
        ids_p, vec_p, code_p = self._paths(list_id)
        for p in (ids_p, vec_p) + ((code_p,) if self.code_width else ()):
            open(p, "ab").close()

    def append(
        self,
        list_id: int,
        ids: np.ndarray,
        vectors: np.ndarray,
        codes: np.ndarray | None = None,
    ) -> None:
        assert vectors.shape[1] == self.dimension
        ids_p, vec_p, code_p = self._paths(list_id)
        with self._lock(list_id):
            with open(ids_p, "ab") as f:
                f.write(np.ascontiguousarray(ids, np.uint64).tobytes())
            with open(vec_p, "ab") as f:
                f.write(np.ascontiguousarray(vectors, np.float32).tobytes())
            if codes is not None:
                assert self.code_width == codes.shape[1]
                with open(code_p, "ab") as f:
                    f.write(np.ascontiguousarray(codes, np.uint8).tobytes())

    def num_vectors(self, list_id: int) -> int:
        ids_p, _, _ = self._paths(list_id)
        try:
            return os.path.getsize(ids_p) // 8
        except OSError:
            return 0

    def load(
        self, list_id: int, mmap: bool = True
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray | None]:
        """Returns (ids [n], vectors [n, dim], codes [n, m] | None)."""
        ids_p, vec_p, code_p = self._paths(list_id)
        n = self.num_vectors(list_id)
        if n == 0:
            return (
                np.empty(0, np.uint64),
                np.empty((0, self.dimension), np.float32),
                np.empty((0, self.code_width), np.uint8)
                if self.code_width else None,
            )
        mode = "r"
        if mmap:
            ids = np.memmap(ids_p, np.uint64, mode, shape=(n,))
            vec = np.memmap(vec_p, np.float32, mode,
                            shape=(n, self.dimension))
            codes = (
                np.memmap(code_p, np.uint8, mode, shape=(n, self.code_width))
                if self.code_width else None
            )
        else:
            ids = np.fromfile(ids_p, np.uint64)
            vec = np.fromfile(vec_p, np.float32).reshape(n, self.dimension)
            codes = (
                np.fromfile(code_p, np.uint8).reshape(n, self.code_width)
                if self.code_width else None
            )
        return ids, vec, codes

    def unload(self, arrays) -> None:
        """Drop memmap references (the reference's explicit unload,
        ``format/storage.h:144``); Python GC unmaps once unreferenced."""
        del arrays

    def compact(self, list_id: int, drop_ids: set[int]) -> int:
        """Rewrite a shard dropping the given ids (the ghost ``compactor``
        translation unit, ``indexmgr/CMakeLists.txt:8-47``). Returns rows
        kept."""
        ids, vec, codes = self.load(list_id, mmap=False)
        keep = ~np.isin(ids.astype(np.int64), list(drop_ids))
        ids_p, vec_p, code_p = self._paths(list_id)
        with self._lock(list_id):
            with open(ids_p + ".tmp", "wb") as f:
                f.write(ids[keep].tobytes())
            os.replace(ids_p + ".tmp", ids_p)
            with open(vec_p + ".tmp", "wb") as f:
                f.write(np.ascontiguousarray(vec[keep]).tobytes())
            os.replace(vec_p + ".tmp", vec_p)
            if codes is not None and self.code_width:
                with open(code_p + ".tmp", "wb") as f:
                    f.write(np.ascontiguousarray(codes[keep]).tobytes())
                os.replace(code_p + ".tmp", code_p)
        return int(keep.sum())

    def list_shards(self) -> list[int]:
        out = []
        for name in os.listdir(self.base_dir):
            if name.endswith(".ids"):
                out.append(int(name[:-4]))
        return sorted(out)


class AlignedReader:
    """4 KiB-aligned reads with OS readahead hints and an async thread-pool
    path — the capability surface of ``NVMeOptimizedReader`` (F3):
    ``read_aligned``, ``read_async`` + callback, ``prefetch``, ``wait_all``."""

    def __init__(self, io_depth: int = 32, readahead_bytes: int = 4 << 20,
                 adaptive: bool = True):
        self.readahead_bytes = readahead_bytes
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=io_depth, thread_name_prefix="aligned-reader"
        )
        self._pending: list[concurrent.futures.Future] = []
        self._pending_lock = threading.Lock()
        # Access-pattern-adaptive readahead (P2,
        # ``engine/prefetcher.cpp:379-537``): every read records into the
        # stride classifier, and a Sequential/Strided verdict issues
        # fire-and-forget WILLNEED prefetches for the predicted next
        # offsets. Lazy import: io_host ↔ storage layering.
        if adaptive:
            from cuda_acceleratedvectordatabaseengine.io_host.prefetcher import (  # noqa: E501
                AdaptivePrefetcher,
            )

            self.adaptive = AdaptivePrefetcher(reader=self)
        else:
            self.adaptive = None

    def read_aligned(self, path: str, offset: int, size: int) -> bytes:
        if self.adaptive is not None:
            self.adaptive.record_access(path, offset)
        a_off = (offset // ALIGN) * ALIGN
        a_end = -(-(offset + size) // ALIGN) * ALIGN
        fd = os.open(path, os.O_RDONLY)
        try:
            if hasattr(os, "posix_fadvise"):
                os.posix_fadvise(
                    fd, a_off, min(a_end - a_off, self.readahead_bytes),
                    os.POSIX_FADV_WILLNEED,
                )
            data = os.pread(fd, a_end - a_off, a_off)
        finally:
            os.close(fd)
        return data[offset - a_off: offset - a_off + size]

    def read_async(self, path: str, offset: int, size: int, callback=None):
        def task():
            data = self.read_aligned(path, offset, size)
            if callback:
                callback(data)
            return data

        fut = self._pool.submit(task)
        with self._pending_lock:
            self._pending.append(fut)
        return fut

    def prefetch(self, path: str, offset: int = 0, size: int | None = None):
        """Fire-and-forget page-cache warm (fadvise WILLNEED)."""
        def task():
            fd = os.open(path, os.O_RDONLY)
            try:
                length = size or os.fstat(fd).st_size
                if hasattr(os, "posix_fadvise"):
                    os.posix_fadvise(fd, offset, length,
                                     os.POSIX_FADV_WILLNEED)
            finally:
                os.close(fd)

        self._pool.submit(task)

    def wait_all(self) -> None:
        with self._pending_lock:
            pending, self._pending = self._pending, []
        concurrent.futures.wait(pending)

    def close(self) -> None:
        self._pool.shutdown(wait=True)
