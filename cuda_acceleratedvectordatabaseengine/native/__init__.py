"""ctypes bindings for the native host runtime (``vdbhost.cc``).

Builds the shared library from ``vdbhost.cc`` on first use (``make`` + g++;
``make -C cuda_acceleratedvectordatabaseengine/native`` builds it ahead of
time; the ``.so`` is not committed) and falls back to NumPy implementations
when no toolchain is available — the same degrade-don't-die posture the reference applies to its
GPU paths (``ivf_flat_index.cpp:526-544``).

All entry points hold no Python objects across the call, and ctypes releases
the GIL during foreign calls, so staging/gather runs truly parallel under
the serving threads.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_DIR, "libvdbhost.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src = os.path.join(_DIR, "vdbhost.cc")
        stale = not os.path.exists(_SO) or (
            os.path.exists(src)
            and os.path.getmtime(src) > os.path.getmtime(_SO)
        )
        if stale:
            # Build under a private name, then rename into place: several
            # processes (test workers, server + tools) may build at once.
            tmp = f"{_SO}.{os.getpid()}.tmp"
            try:
                subprocess.run(
                    ["make", "-C", _DIR, "-s", "-B",
                     f"SONAME={os.path.basename(tmp)}"],
                    check=True, capture_output=True, timeout=120,
                )
                os.replace(tmp, _SO)
            except Exception:  # noqa: BLE001 — fall back to numpy
                if os.path.exists(tmp):
                    os.remove(tmp)
                if not os.path.exists(_SO):
                    return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.vdb_gather_lists.argtypes = [
            ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ]
        lib.vdb_gather_rows.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.vdb_f32_to_bf16.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        lib.vdb_readahead.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.vdb_readahead.restype = ctypes.c_int32
        lib.vdb_hardware_concurrency.restype = ctypes.c_int32
        if hasattr(lib, "vdb_rerank"):
            lib.vdb_rerank.argtypes = [
                ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
                ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,   # qa_cand [b, r] (nullable)
            ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def gather_lists(
    list_arrays: list[np.ndarray], cap: int, dim: int
) -> tuple[np.ndarray, np.ndarray]:
    """Stack ragged fp32 lists into a padded staging block + squared norms:
    returns (vectors [n, cap, dim], sq [n, cap])."""
    n = len(list_arrays)
    out = np.empty((n, cap, dim), np.float32)
    out_sq = np.empty((n, cap), np.float32)
    lib = _load()
    if lib is None:
        out[:] = 0
        out_sq[:] = 0
        for i, arr in enumerate(list_arrays):
            c = min(arr.shape[0], cap)
            out[i, :c] = arr[:c]
            out_sq[i, :c] = (arr[:c] ** 2).sum(-1)
        return out, out_sq
    arrs = [np.ascontiguousarray(a, np.float32) for a in list_arrays]
    ptrs = (ctypes.c_void_p * n)(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrs]
    )
    counts = np.array([a.shape[0] for a in arrs], np.int32)
    lib.vdb_gather_lists(
        ptrs,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n, cap, dim,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out_sq.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out, out_sq


def gather_rows(src: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """out[i] = src[rows[i]]; rows < 0 → zeros."""
    src = np.ascontiguousarray(src, np.float32)
    rows = np.ascontiguousarray(rows, np.int64)
    out = np.empty((rows.shape[0], src.shape[1]), np.float32)
    lib = _load()
    if lib is None:
        safe = np.clip(rows, 0, src.shape[0] - 1)
        out[:] = src[safe]
        out[rows < 0] = 0
        return out
    lib.vdb_gather_rows(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.shape[0], src.shape[1],
        rows.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        rows.shape[0],
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def f32_to_bf16(src: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even fp32 → bf16 (as uint16 bit pattern)."""
    src = np.ascontiguousarray(src, np.float32)
    out = np.empty(src.shape, np.uint16)
    lib = _load()
    if lib is None:
        bits = src.view(np.uint32)
        rounding = np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & 1)
        return ((bits + rounding) >> np.uint32(16)).astype(np.uint16)
    lib.vdb_f32_to_bf16(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        src.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
    )
    return out


def rerank(
    vecs: np.ndarray,            # [n_rows, dim] int8 or fp32, C-contiguous
    rows: np.ndarray,            # [b, r] int64, -1 = invalid candidate
    cand_ids: np.ndarray,        # [b, r] uint64
    queries: np.ndarray,         # [b, dim] fp32
    q_sq: np.ndarray | None,     # [b] fp32 (L2 only)
    metric_code: int,            # 0=L2, 1=IP, 2=cosine
    k: int,
    scale: np.ndarray | None = None,       # [n_rows] fp32 (int8 store)
    sq: np.ndarray | None = None,          # [n_rows] fp32 (L2 only)
    anchor_row: np.ndarray | None = None,  # [n_rows] int32 (int8 store)
    qa: np.ndarray | None = None,          # [b, nlist] fp32 (int8 store)
    qa_cand: np.ndarray | None = None,     # [b, r] fp32 per-candidate
                                           # anchor dots (preferred over
                                           # the dense qa — see vdb_rerank)
) -> tuple[np.ndarray, np.ndarray] | None:
    """Fused gather+dequant+dot+top-k shortlist rerank (``vdb_rerank``).

    Returns None when the native library is unavailable — the caller
    (``io_host/host_rerank.HostReranker``) falls back to its NumPy path.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "vdb_rerank"):
        return None
    is_int8 = vecs.dtype == np.int8
    if not vecs.flags["C_CONTIGUOUS"]:
        return None  # never copy the (multi-GB) row store
    b, r = rows.shape
    dim = vecs.shape[1]
    rows = np.ascontiguousarray(rows, np.int64)
    cand_ids = np.ascontiguousarray(cand_ids, np.uint64)
    queries = np.ascontiguousarray(queries, np.float32)
    out_d = np.empty((b, k), np.float32)
    out_i = np.empty((b, k), np.uint64)

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    if q_sq is not None:
        q_sq = np.ascontiguousarray(q_sq, np.float32)
    if scale is not None:
        scale = np.ascontiguousarray(scale, np.float32)
    if sq is not None:
        sq = np.ascontiguousarray(sq, np.float32)
    if anchor_row is not None:
        anchor_row = np.ascontiguousarray(anchor_row, np.int32)
    if qa is not None:
        qa = np.ascontiguousarray(qa, np.float32)
    if qa_cand is not None:
        qa_cand = np.ascontiguousarray(qa_cand, np.float32)
    lib.vdb_rerank(
        ptr(vecs), 1 if is_int8 else 0, vecs.shape[0], dim,
        ptr(scale), ptr(sq), ptr(anchor_row),
        ptr(qa), qa.shape[1] if qa is not None else 0,
        ptr(queries), ptr(q_sq), b, r,
        ptr(rows), ptr(cand_ids), metric_code, k,
        ptr(out_d), ptr(out_i), ptr(qa_cand),
    )
    return out_d, out_i


def readahead(path: str, offset: int = 0, length: int = 0,
              touch_bytes: int = 0) -> bool:
    lib = _load()
    if lib is None:
        return False
    return lib.vdb_readahead(
        path.encode(), offset, length or (1 << 40), touch_bytes
    ) == 0
