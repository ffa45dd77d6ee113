"""Chunked balanced builds (VERDICT r3 item 3): BuildEpoch and
``vdb-build-index`` stream the corpus chunk-wise through the balanced
device pack — peak host RAM is bounded by one chunk, the arena capacity
follows the headline bench's 1.35×-mean clamp (overflow spills to
next-nearest lists), and BuildJob progress advances per chunk. The
reference's intended builder (``indexmgr/CMakeLists.txt:8-47``) is a
ghost binary; its RPC build worker is a placeholder skeleton
(``query_service.cpp:549-584``)."""

import json
import time

import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine import (
    IVFFlatConfig,
    IVFFlatIndex,
    SearchParams,
)
from cuda_acceleratedvectordatabaseengine.builder import (
    build_index_chunked,
    chunked_capacity,
)
from cuda_acceleratedvectordatabaseengine.storage import ArrowStorage

DIM = 16


def _clustered(rng, n, n_clusters=32, dim=DIM, spread=0.15):
    centers = rng.standard_normal((n_clusters, dim)).astype(np.float32) * 3
    assign = rng.integers(0, n_clusters, n)
    return (
        centers[assign]
        + spread * rng.standard_normal((n, dim)).astype(np.float32)
    ).astype(np.float32)


def _chunks_of(x, ids, chunk):
    for off in range(0, len(x), chunk):
        yield ids[off:off + chunk], x[off:off + chunk]


def test_build_index_chunked_progress_capacity_and_sink(rng):
    """Unit contract: per-chunk progress, the capacity law, tombstone
    filtering, and the row sink seeing exactly the ingested rows."""
    n, nlist = 2048, 16
    x = _clustered(rng, n, n_clusters=nlist)
    ids = np.arange(n, dtype=np.uint64)
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=nlist))
    progress, sunk = [], []
    tombs = np.array([5, 1000, 2047], np.uint64)
    built = build_index_chunked(
        idx, _chunks_of(x, ids, 512), n,
        train_sample=x[:1024],
        tombstones=tombs,
        progress=progress.append,
        row_sink=lambda i, v: sunk.append((i.copy(), v.copy())),
    )
    assert built == n - 3
    assert idx.ntotal == n - 3
    # progress advanced once per chunk, monotonically to ~1
    assert len(progress) == 4
    assert progress == sorted(progress)
    assert progress[-1] >= (n - 3) / n
    # capacity law: same clamp as the headline chunked bench build
    assert idx.arena.capacity == chunked_capacity(n, nlist)
    assert int(np.asarray(idx.arena.counts).max()) <= idx.arena.capacity
    # the sink saw exactly the post-filter rows
    sunk_ids = np.concatenate([i for i, _ in sunk])
    assert len(sunk_ids) == built
    assert not np.isin(tombs, sunk_ids).any()
    # tombstoned ids are absent; everyone else finds themselves
    d, got = idx.search(x[8:16], SearchParams(nprobe=nlist, k=3))
    assert (got[:, 0] == np.arange(8, 16)).all()
    d, got = idx.search(x[5:6], SearchParams(nprobe=nlist, k=3))
    assert 5 not in got  # filtered at ingest
    assert idx.remove_ids(tombs) == 0  # never ingested


def test_build_index_chunked_spills_fat_lists(rng):
    """A pathologically skewed corpus (half the rows in one mode) must
    not inflate the arena: capacity stays at the 1.35×-mean clamp and
    the overflow spills to next-nearest lists, staying findable."""
    n, nlist = 4096, 16
    centers = rng.standard_normal((nlist, DIM)).astype(np.float32) * 3
    assign = np.where(
        rng.random(n) < 0.5, 0, rng.integers(0, nlist, n)
    )
    x = (centers[assign]
         + 0.1 * rng.standard_normal((n, DIM))).astype(np.float32)
    ids = np.arange(n, dtype=np.uint64)
    # fp32 arena: 2048 near-duplicates in one mode make the self-match
    # sensitive to storage quantization noise; this test is about spill,
    # not quantization.
    idx = IVFFlatIndex(IVFFlatConfig(dimension=DIM, nlist=nlist,
                                     dtype="float32"))
    built = build_index_chunked(
        idx, _chunks_of(x, ids, 1024), n, train_sample=x[:2048]
    )
    assert built == n
    cap = chunked_capacity(n, nlist)
    assert idx.arena.capacity == cap
    counts = np.asarray(idx.arena.counts)
    assert counts.max() <= cap          # the fat mode was clamped
    assert counts.sum() == n            # nothing dropped — spilled
    # spilled rows stay findable at full probe depth
    d, got = idx.search(x[:32], SearchParams(nprobe=nlist, k=3))
    assert (got[:, 0] == np.arange(32)).all()


@pytest.fixture
def spy_reads(monkeypatch):
    """Record the length of every ArrowStorage.read_vectors call."""
    lengths = []
    orig = ArrowStorage.read_vectors

    def spy(path, offset=0, length=None):
        lengths.append(length)
        return orig(path, offset, length)

    monkeypatch.setattr(ArrowStorage, "read_vectors", staticmethod(spy))
    return lengths


def _wait_build(engine, name, deadline_s=120):
    deadline = time.time() + deadline_s
    while not engine.build_jobs[name].done:
        assert time.time() < deadline, "build never finished"
        time.sleep(0.1)
    assert not engine.build_jobs[name].error, engine.build_jobs[name].error


def test_build_epoch_from_source_is_chunked(tmp_path, rng, spy_reads):
    """BuildEpoch with a source file: every host read is ≤ one chunk
    (never the whole corpus), and the activated epoch serves."""
    from cuda_acceleratedvectordatabaseengine.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )

    n, nlist, chunk = 3000, 8, 700
    x = _clustered(rng, n, n_clusters=nlist)
    ids = np.arange(n, dtype=np.uint64)
    src = str(tmp_path / "corpus.arrow")
    ArrowStorage.write_vectors(src, ids, x)

    engine = VdbEngine(ServerConfig(
        data_path=str(tmp_path / "data"), default_nlist=nlist,
        build_chunk_rows=chunk, shard_serving="off",
    ))
    engine.create_index("c", DIM, "L2", nlist, 0, 0)
    engine.build_epoch("c", source_path=src)
    _wait_build(engine, "c")
    # peak host RAM ∝ the largest single read: bounded by one chunk
    assert spy_reads, "no reads recorded"
    assert all(ln is not None for ln in spy_reads), \
        "whole-file read on the build path"
    assert max(ln for ln in spy_reads) <= chunk
    st = engine.get_state("c")
    epoch = engine.build_jobs["c"].epoch_id
    engine._load_epoch_into(st, epoch)
    assert st.index.ntotal == n
    assert st.index.arena.capacity == chunked_capacity(n, nlist)
    d, got = st.index.search(x[:8], SearchParams(nprobe=nlist, k=3))
    assert (got[:, 0] == np.arange(8)).all()


def test_build_epoch_pq_capacity_chunked(tmp_path, rng):
    """pq_capacity builds stream host-rerank rows to the epoch's vectors
    file per chunk (multiple record batches, arrival order); the loader
    matches rows to the arena by id and exact rerank works."""
    import pyarrow as pa
    import pyarrow.ipc as ipc

    from cuda_acceleratedvectordatabaseengine.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )
    from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
        VECTORS_FILE,
    )

    n, nlist, chunk = 1500, 8, 400
    x = _clustered(rng, n, n_clusters=nlist)
    ids = np.arange(n, dtype=np.uint64)
    src = str(tmp_path / "corpus.arrow")
    ArrowStorage.write_vectors(src, ids, x)

    engine = VdbEngine(ServerConfig(
        data_path=str(tmp_path / "data"), default_nlist=nlist,
        build_chunk_rows=chunk, shard_serving="off",
    ))
    engine.create_index("cap", DIM, "L2", nlist, 4, 8, tier="pq_capacity")
    engine.build_epoch("cap", source_path=src)
    _wait_build(engine, "cap")
    epoch = engine.build_jobs["cap"].epoch_id
    epoch_dir = engine.epochs.epoch_dir("cap", epoch)
    import os

    with pa.memory_map(os.path.join(epoch_dir, VECTORS_FILE)) as f:
        nb = ipc.open_file(f).num_record_batches
    assert nb >= 4  # streamed per chunk, not one concatenated table
    st = engine.get_state("cap")
    engine._load_epoch_into(st, epoch)
    assert st.index.ntotal == n
    assert getattr(st.index, "read_only", False)
    d, got = st.index.search(
        x[:8], SearchParams(nprobe=nlist, k=3, use_exact_rerank=True)
    )
    assert (got[:, 0] == np.arange(8)).all()


def test_build_index_cli_chunked(tmp_path, rng, spy_reads, capsys):
    """vdb-build-index --source streams chunks; the snapshot round-trips
    and every read stays within --chunk-rows."""
    from cuda_acceleratedvectordatabaseengine.storage.snapshot import (
        load_ivf_flat,
    )
    from cuda_acceleratedvectordatabaseengine.tools.build_index import (
        main,
    )

    n, nlist, chunk = 2000, 8, 600
    x = _clustered(rng, n, n_clusters=nlist)
    src = str(tmp_path / "corpus.arrow")
    ArrowStorage.write_vectors(src, np.arange(n, dtype=np.uint64), x)
    out = str(tmp_path / "snap")
    rc = main([
        "--source", src, "--output", out,
        "--nlist", str(nlist), "--chunk-rows", str(chunk),
    ])
    assert rc == 0
    assert max(ln for ln in spy_reads if ln is not None) <= chunk
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["vectors"] == n
    idx = load_ivf_flat(out)
    assert idx.ntotal == n
    assert idx.arena.capacity == chunked_capacity(n, nlist)
    d, got = idx.search(x[:8], SearchParams(nprobe=nlist, k=3))
    assert (got[:, 0] == np.arange(8)).all()
