"""gRPC integration tests — black-box against a live in-process server
(reference X3, ``test/integration/grpc_integration_test.cpp``), plus the
full ingest→build→activate→search lifecycle its tests couldn't cover
because the reference has no RPC ingest path."""

import threading

import grpc
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine.server.config import ServerConfig
from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
    AdminServiceClient,
    HealthClient,
    QueryServiceClient,
)
from cuda_acceleratedvectordatabaseengine.server.main import build_server
from cuda_acceleratedvectordatabaseengine.server.proto import (
    health_pb2,
    vdb_pb2,
)


@pytest.fixture(scope="module")
def live_server(tmp_path_factory):
    config = ServerConfig(
        shard_serving="off",  # single-chip semantics under the 8-dev CPU mesh
        address="127.0.0.1:0",
        data_path=str(tmp_path_factory.mktemp("vdb-data")),
        coalesce_window_ms=1.0,
        default_nlist=8,
    )
    server, engine, health, port = build_server(config)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(channel).result(timeout=10)
    yield {
        "channel": channel,
        "query": QueryServiceClient(channel),
        "admin": AdminServiceClient(channel),
        "health": HealthClient(channel),
        "engine": engine,
        "config": config,
    }
    channel.close()
    server.stop(grace=None)


def _vectors(rng, n, dim, id0=0):
    return [
        vdb_pb2.Vector(id=id0 + i,
                       values=rng.standard_normal(dim).astype(float))
        for i in range(n)
    ]


def test_health_check(live_server):
    resp = live_server["health"].Check(health_pb2.HealthCheckRequest())
    assert resp.status == health_pb2.HealthCheckResponse.SERVING
    resp = live_server["health"].Check(
        health_pb2.HealthCheckRequest(service="nope")
    )
    assert resp.status == health_pb2.HealthCheckResponse.SERVICE_UNKNOWN


def test_full_lifecycle(live_server):
    rng = np.random.default_rng(0)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="docs", dimension=16, metric="L2", nlist=8
    ))
    # ingest 600 vectors in batches
    for b in range(3):
        resp = admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="docs", vectors=_vectors(rng, 200, 16, id0=b * 200)
        ))
        assert resp.added == 200
    # build + activate
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="docs"))
    # poll for completion via ActivateEpoch(no epoch → last build)
    import time

    deadline = time.time() + 60
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="docs"))
            break
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline, "build never finished"
            time.sleep(0.2)
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="docs"))
    assert stats.indexed_vectors == 600
    assert stats.current_epoch != ""
    # search: each vector finds itself
    probe = rng.standard_normal(16).astype(np.float32)
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=probe)], topk=5, nprobe=8,
        index="docs",
    ))
    assert len(resp.results) == 1
    assert 1 <= len(resp.results[0].neighbors) <= 5
    dists = [n.distance for n in resp.results[0].neighbors]
    assert dists == sorted(dists)


def test_remove_vectors_rpc(live_server):
    """RemoveVectors deletes by id on the live index (runs after
    test_full_lifecycle activated the 'docs' epoch). No reference analog —
    its API has no delete at all."""
    rng = np.random.default_rng(3)
    admin, query = live_server["admin"], live_server["query"]
    st = live_server["engine"].get_state("docs")
    total0 = st.index.ntotal
    # Search for a known vector by reconstructing one we just ingest.
    vec = rng.standard_normal(16).astype(np.float32)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=[vdb_pb2.Vector(id=99_999, values=vec)]
    ))
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=1, nprobe=8, index="docs"
    ))
    assert resp.results[0].neighbors[0].id == 99_999
    out = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[99_999]
    ))
    assert out.removed == 1
    assert out.total == total0
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=5, nprobe=8, index="docs"
    ))
    assert all(n.id != 99_999 for n in resp.results[0].neighbors)
    # idempotent + error codes
    out = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[99_999]
    ))
    assert out.removed == 0
    with pytest.raises(grpc.RpcError) as e:
        admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
            index="nope", ids=[1]
        ))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as e:
        admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(index="docs"))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_remove_vectors_durable_across_epoch_reload(live_server):
    """Deletions survive an epoch reload: snapshots are immutable, so
    accepted deletes persist in the per-index tombstone log and re-apply
    on every load — a restart/reload must never resurrect a deleted id."""
    admin, query = live_server["admin"], live_server["query"]
    st = live_server["engine"].get_state("docs")
    # pick an id that IS in the active epoch snapshot (ingested by
    # test_full_lifecycle) and recover its stored vector from the arena
    victim = np.uint64(42)
    l, s = (int(a[0]) for a in np.nonzero(st.index.arena.ids == victim))
    vec = np.asarray(st.index.arena.arena[l, s], dtype=np.float32)
    if st.index.arena.arena_scale is not None:  # int8 arenas dequantize
        vec = vec * float(np.asarray(st.index.arena.arena_scale[l, s]))
    out = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[int(victim)]
    ))
    assert out.removed == 1
    # Reload the active epoch from disk — without the tombstone log this
    # would resurrect the deleted row.
    query.LoadIndex(vdb_pb2.LoadIndexRequest(index="docs"))
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=10, nprobe=8,
        index="docs",
    ))
    assert all(n.id != victim for n in resp.results[0].neighbors)
    # Re-adding a deleted id revokes its tombstone (else the next build's
    # bake would drop it again) and restores the corpus for later tests.
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=[vdb_pb2.Vector(id=int(victim), values=vec)]
    ))
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=vec)], topk=1, nprobe=8,
        index="docs",
    ))
    assert resp.results[0].neighbors[0].id == victim
    eng = live_server["engine"]
    assert not np.isin(victim, eng._read_tombstones("docs"))


def test_search_error_codes(live_server):
    """Same codes the reference asserts (grpc_integration_test.cpp:186-245)."""
    query = live_server["query"]

    def expect(code, **kw):
        with pytest.raises(grpc.RpcError) as e:
            query.Search(vdb_pb2.SearchRequest(**kw))
        assert e.value.code() == code, e.value.details()

    v = vdb_pb2.Vector(values=[0.0] * 16)
    expect(grpc.StatusCode.INVALID_ARGUMENT, topk=5, index="docs")  # empty
    expect(grpc.StatusCode.INVALID_ARGUMENT, queries=[v], topk=0,
           index="docs")
    expect(grpc.StatusCode.INVALID_ARGUMENT, queries=[v], topk=2000,
           index="docs")
    expect(grpc.StatusCode.INVALID_ARGUMENT, queries=[v], topk=5)  # no index
    expect(grpc.StatusCode.NOT_FOUND, queries=[v], topk=5, index="ghost")
    # dim mismatch
    expect(grpc.StatusCode.INVALID_ARGUMENT,
           queries=[vdb_pb2.Vector(values=[0.0] * 3)], topk=5, index="docs")
    # metric mismatch with the index's metric
    expect(grpc.StatusCode.INVALID_ARGUMENT, queries=[v], topk=5,
           index="docs", metric="Cosine")
    expect(grpc.StatusCode.INVALID_ARGUMENT, queries=[v], topk=5,
           index="docs", metric="hamming")


def test_admin_error_codes(live_server):
    admin = live_server["admin"]
    with pytest.raises(grpc.RpcError) as e:
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(name="", dimension=8))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="docs", dimension=16
        ))
    assert e.value.code() == grpc.StatusCode.ALREADY_EXISTS
    with pytest.raises(grpc.RpcError) as e:
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="big", dimension=100_000
        ))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        admin.GetStats(vdb_pb2.StatsRequest(index="ghost"))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND
    with pytest.raises(grpc.RpcError) as e:
        admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="ghost"))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_concurrent_search(live_server):
    """4 threads × 5 requests with ≥80% success — the reference's bar
    (grpc_integration_test.cpp:248-300); here all must succeed.
    Self-sufficient: builds its own index so it never depends on sibling
    tests' state."""
    import time

    rng = np.random.default_rng(1)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="conc", dimension=16, nlist=8
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="conc", vectors=_vectors(rng, 300, 16)
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="conc"))
    deadline = time.time() + 60
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="conc"))
            break
        except grpc.RpcError:
            assert time.time() < deadline
            time.sleep(0.2)
    errors = []

    def worker():
        wrng = np.random.default_rng(2)
        for _ in range(5):
            try:
                resp = query.Search(vdb_pb2.SearchRequest(
                    queries=[vdb_pb2.Vector(
                        values=wrng.standard_normal(16).astype(float)
                    )],
                    topk=3, nprobe=8, index="conc",
                ))
                assert len(resp.results) == 1
            except Exception as e:  # noqa: BLE001
                errors.append(e)

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:2]
    # Coalescing actually happened (batches fed, not per-query dispatch).
    st = live_server["engine"].get_state("conc")
    assert st.coalescer.stats()["items"] >= 20


def test_warmup(live_server):
    live_server["query"].Warmup(vdb_pb2.WarmupRequest(
        index="docs", lists=[0, 1, 2]
    ))
    with pytest.raises(grpc.RpcError) as e:
        live_server["query"].Warmup(vdb_pb2.WarmupRequest(index="ghost"))
    assert e.value.code() == grpc.StatusCode.NOT_FOUND


def test_epoch_rebuild_and_swap(live_server):
    """Second build → activate swaps epochs with zero downtime."""
    rng = np.random.default_rng(2)
    admin, query = live_server["admin"], live_server["query"]
    engine = live_server["engine"]
    e1 = engine.get_state("docs").epoch
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs", vectors=_vectors(rng, 100, 16, id0=600)
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="docs"))
    import time

    deadline = time.time() + 60
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="docs"))
            break
        except grpc.RpcError as err:
            if err.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline
            time.sleep(0.2)
    st = engine.get_state("docs")
    assert st.epoch != e1
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="docs"))
    assert stats.indexed_vectors == 700


def test_load_index_previous_epoch(live_server):
    """LoadIndex can revert to an earlier epoch (the reference's
    degrade/rollback path)."""
    engine = live_server["engine"]
    epochs = engine.epochs.list_epochs("docs")["epochs"]
    assert len(epochs) >= 2
    older = sorted(epochs)[0]
    live_server["query"].LoadIndex(vdb_pb2.LoadIndexRequest(
        index="docs", epoch=older
    ))
    assert engine.get_state("docs").epoch == older


def test_metrics_exposition(live_server):
    engine = live_server["engine"]
    text = engine.metrics.prometheus_text().decode()
    assert "vdb_searches_total" in text
    assert "vdb_search_duration_milliseconds" in text
    pct = engine.metrics.get_percentiles("docs")
    assert pct["count"] > 0 and pct["p99"] >= pct["p50"] >= 0


def test_http_metrics_and_health_endpoints(live_server):
    """The :8080 HTTP surface the reference documented but stubbed
    (README.md:133-140, health_service.cpp:161-218): /metrics serves
    Prometheus text, /health serves a JSON liveness signal with a real
    status code, anything else 404s."""
    import json
    import urllib.error
    import urllib.request

    engine = live_server["engine"]
    health = {"healthy": True, "device_ok": True}
    port = engine.metrics.start_exposition(0, health_fn=lambda: health)
    try:
        base = f"http://127.0.0.1:{port}"
        text = urllib.request.urlopen(f"{base}/metrics", timeout=5).read()
        assert b"vdb_searches_total" in text

        resp = urllib.request.urlopen(f"{base}/health", timeout=5)
        body = json.loads(resp.read())
        assert resp.status == 200
        assert body["status"] == "healthy" and body["device_ok"] is True
        assert body["uptime_s"] >= 0

        health["healthy"] = False
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/health", timeout=5)
        assert ei.value.code == 503
        assert json.loads(ei.value.read())["status"] == "unhealthy"

        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nope", timeout=5)
        assert ei.value.code == 404
    finally:
        engine.metrics.stop_exposition()


def test_stream_search_matches_unary(live_server):
    """StreamSearch pipelines a whole query stream through one RPC and
    returns responses in request order, each identical to what the unary
    Search returns for the same request (the reference claims 'streaming
    support', README.md:20, but declares no streaming method)."""
    rng = np.random.default_rng(7)
    query = live_server["query"]
    reqs = []
    for i in range(12):
        q = rng.standard_normal(16).astype(np.float32)
        if i % 3 == 0:  # exercise the packed form inside the stream too
            reqs.append(vdb_pb2.SearchRequest(
                index="docs", topk=5, nprobe=8,
                packed_queries=q.tobytes(), packed_response=True,
            ))
        else:
            reqs.append(vdb_pb2.SearchRequest(
                index="docs", topk=5, nprobe=8,
                queries=[vdb_pb2.Vector(values=q)],
            ))
    streamed = list(query.StreamSearch(iter(reqs)))
    assert len(streamed) == len(reqs)

    def decode(req, resp):
        if req.packed_response:
            ids = np.frombuffer(resp.packed_ids, dtype="<u8")
            d = np.frombuffer(resp.packed_distances, dtype="<f4")
            return ids, d
        ns = resp.results[0].neighbors
        return (np.array([n.id for n in ns], dtype=np.uint64),
                np.array([n.distance for n in ns], dtype=np.float32))

    for req, got in zip(reqs, streamed):
        want = query.Search(req)
        got_ids, got_d = decode(req, got)
        want_ids, want_d = decode(req, want)
        # ids must match exactly; distances to float tolerance (the
        # coalescer may batch streamed items, changing XLA reduction
        # order vs the solo unary dispatch)
        assert np.array_equal(got_ids, want_ids)
        np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-5)
    assert live_server["engine"].limiter._active == 0


def test_stream_search_invalid_message_aborts_stream(live_server):
    """An invalid message mid-stream terminates the stream with the same
    status code the unary path returns, and releases every admission
    slot held by in-flight items."""
    rng = np.random.default_rng(8)
    query = live_server["query"]
    good = vdb_pb2.SearchRequest(
        index="docs", topk=5, nprobe=8,
        queries=[vdb_pb2.Vector(
            values=rng.standard_normal(16).astype(np.float32)
        )],
    )
    bad = vdb_pb2.SearchRequest(index="docs", topk=0)  # invalid topk
    with pytest.raises(grpc.RpcError) as ei:
        list(query.StreamSearch(iter([good, good, bad, good])))
    assert ei.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert live_server["engine"].limiter._active == 0


def test_engine_recovery_after_restart(live_server, tmp_path):
    """A new engine over the same data path reloads indices + active epoch
    (the reference recovers via epochs.json, storage.cpp:511-579)."""
    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )

    engine2 = VdbEngine(live_server["config"])
    st = engine2.get_state("docs")
    assert st.index is not None and st.index.trained
    assert st.epoch == engine2.epochs.active_epoch("docs")


def test_pq_index_via_rpc(live_server):
    """IVF-PQ lifecycle through the API (CreateIndex with m>0)."""
    rng = np.random.default_rng(5)
    admin, query = live_server["admin"], live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="pq", dimension=32, metric="L2", nlist=8, m=8, nbits=8,
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="pq", vectors=[
            vdb_pb2.Vector(id=i, values=rng.standard_normal(32))
            for i in range(800)
        ],
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="pq"))
    import time

    deadline = time.time() + 120
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="pq"))
            break
        except grpc.RpcError as e:
            assert e.code() in (grpc.StatusCode.FAILED_PRECONDITION,), \
                e.details()
            assert time.time() < deadline
            time.sleep(0.3)
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=[0.0] * 32)], topk=5, nprobe=8,
        index="pq", rerank_exact=True,
    ))
    assert len(resp.results[0].neighbors) == 5
    engine = live_server["engine"]
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQIndex,
    )

    assert isinstance(engine.get_state("pq").index, IVFPQIndex)


def test_build_from_arrow_source_via_rpc(live_server, tmp_path_factory):
    """BuildEpoch with a source_path (the reference's intended flow)."""
    rng = np.random.default_rng(6)
    from cuda_acceleratedvectordatabaseengine.storage import ArrowStorage

    src_dir = tmp_path_factory.mktemp("src")
    src = str(src_dir / "v.arrow")
    ArrowStorage.write_vectors(
        src, np.arange(500, dtype=np.uint64) + 10_000,
        rng.standard_normal((500, 24)).astype(np.float32),
    )
    admin = live_server["admin"]
    query = live_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="arrowidx", dimension=24, nlist=4,
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(
        index="arrowidx", source_path=src,
    ))
    import time

    deadline = time.time() + 120
    while True:
        try:
            admin.ActivateEpoch(
                vdb_pb2.ActivateEpochRequest(index="arrowidx"))
            break
        except grpc.RpcError:
            assert time.time() < deadline
            time.sleep(0.3)
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=[0.0] * 24)], topk=3, nprobe=4,
        index="arrowidx",
    ))
    ids = [n.id for n in resp.results[0].neighbors]
    assert all(i >= 10_000 for i in ids)   # custom ids survived the path


def test_failed_build_reports_error(live_server):
    """A build with no data fails in its async worker and surfaces the
    error at activation — degrade-don't-die (SURVEY.md §5 failure
    detection): the serving path is never poisoned by a failed build."""
    import time

    admin = live_server["admin"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(name="empty", dimension=8))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="empty"))
    deadline = time.time() + 30
    while True:
        with pytest.raises(grpc.RpcError) as e:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="empty"))
        if e.value.code() == grpc.StatusCode.INTERNAL:
            assert "no data" in e.value.details()
            break
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert time.time() < deadline
        time.sleep(0.1)
    # the index remains searchable-empty, not corrupted
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="empty"))
    assert stats.indexed_vectors == 0


def test_coalescer_priority_and_adaptive_batch():
    """S8 priority queue + adaptive batch sizing are live in the coalescer:
    urgent submissions drain ahead of earlier low-priority ones, and the
    drain size follows max_batch_fn."""
    import time

    from cuda_acceleratedvectordatabaseengine.server.balancer import (
        Priority,
    )
    from cuda_acceleratedvectordatabaseengine.server.coalescer import (
        RequestCoalescer,
    )

    seen_batches = []
    gate = threading.Event()

    def batch_fn(items):
        gate.wait(timeout=5)
        seen_batches.append(list(items))
        return items

    co = RequestCoalescer(
        batch_fn, window_s=0.05, max_batch=64, max_batch_fn=lambda: 2
    )
    try:
        # First submission occupies the worker once the window closes; the
        # gate keeps batch_fn busy while we stack up prioritized work.
        futs = [co.submit("low", Priority.LOW)]
        time.sleep(0.002)
        futs.append(co.submit("normal", Priority.NORMAL))
        futs.append(co.submit("urgent", Priority.URGENT))
        gate.set()
        for f in futs:
            assert f.result(timeout=5) in ("low", "normal", "urgent")
        # max_batch_fn=2 caps every drained batch at 2
        assert all(len(b) <= 2 for b in seen_batches)
        # the urgent item must never drain after the low one in a later
        # batch: find positions in the flattened drain order
        order = [x for b in seen_batches for x in b]
        assert order.index("urgent") < order.index("low") or \
            seen_batches[0][0] == "low"  # low drained alone before urgent came
    finally:
        co.stop()


def test_search_priority_field_accepted(live_server):
    """SearchRequest.priority is wire-accepted end-to-end (urgent queries
    jump the coalescer line; wire value 4 = URGENT)."""
    import time

    rng = np.random.default_rng(3)
    admin, query = live_server["admin"], live_server["query"]
    name = "prio-idx"
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name=name, dimension=16, metric="L2", nlist=4
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 128, 16)
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index=name))
    deadline = time.time() + 60
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index=name))
            break
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline, "build never finished"
            time.sleep(0.2)
    probe = rng.standard_normal(16).astype(np.float32)
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=probe)], topk=4, nprobe=4,
        index=name, priority=4,
    ))
    assert len(resp.results) == 1
    assert len(resp.results[0].neighbors) >= 1


def _build_and_activate(admin, name, deadline_s=60):
    import time

    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index=name))
    deadline = time.time() + deadline_s
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index=name))
            return
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline, "build never finished"
            time.sleep(0.2)


def test_streaming_tier_lifecycle(live_server):
    """VERDICT r2 #9: a `tier: streaming` index serves a >HBM-style epoch
    over gRPC — activation loads the snapshot into HOST RAM only, Search
    runs through the HBM list cache, and Warmup(lists) does REAL data
    movement (prefetches those lists into the cache)."""
    from cuda_acceleratedvectordatabaseengine.io_host import (
        StreamingIVFFlatIndex,
    )

    rng = np.random.default_rng(11)
    admin, query = live_server["admin"], live_server["query"]
    name = "stream-idx"
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name=name, dimension=16, metric="L2", nlist=8, tier="streaming"
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 400, 16)
    ))
    _build_and_activate(admin, name)

    st = live_server["engine"].get_state(name)
    assert isinstance(st.index, StreamingIVFFlatIndex)

    # Warmup with explicit lists = prefetch into the cache tier.
    query.Warmup(vdb_pb2.WarmupRequest(index=name, lists=[0, 1, 2]))
    assert {0, 1, 2} <= set(st.index.cache.resident_lists())

    # Search end-to-end: an ingested vector finds itself.
    v0 = st.index.store.vectors[0][0]
    ids0 = st.index.store.ids[0][0]
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=v0.astype(float))], topk=3,
        nprobe=8, index=name,
    ))
    assert resp.results[0].neighbors[0].id == int(ids0)
    assert resp.results[0].neighbors[0].distance < 1e-3

    # Stats flow from the streaming tier's memory accounting.
    stats = admin.GetStats(vdb_pb2.StatsRequest(index=name))
    assert stats.indexed_vectors == 400
    assert stats.gpu_memory_used > 0

    # Read-only tier: deletes must be refused and routed to the epoch
    # rebuild path (not silently mutate the snapshot-backed cache).
    with pytest.raises(grpc.RpcError) as e:
        admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
            index=name, ids=[int(ids0)]
        ))
    assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION

    # AddVectors against the live (read-only) streaming index buffers for
    # the NEXT epoch instead of failing (epoch contents = fed data, same
    # as the resident tier's build semantics).
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 50, 16, id0=1000)
    ))
    assert sum(len(v) for v in st.pending_vectors) == 50
    _build_and_activate(admin, name)
    stats = admin.GetStats(vdb_pb2.StatsRequest(index=name))
    assert stats.indexed_vectors == 50
    assert isinstance(st.index, StreamingIVFFlatIndex)


def test_streaming_tier_validation(live_server):
    admin = live_server["admin"]
    with pytest.raises(grpc.RpcError) as e:
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="bad-tier", dimension=8, tier="nvme"
        ))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="stream-pq", dimension=8, m=4, tier="streaming"
        ))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    with pytest.raises(grpc.RpcError) as e:
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="cap-flat", dimension=8, tier="pq_capacity"
        ))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_pq_capacity_tier_lifecycle(live_server):
    """`tier: pq_capacity` over gRPC: the epoch activates with only PQ
    codes on device (no raw arena), and rerank_exact searches run the
    exact second stage from the epoch's int8 host-RAM row store
    (io_host/host_rerank). The >HBM tier with no locality requirement."""
    from cuda_acceleratedvectordatabaseengine.models.ivf_pq import (
        IVFPQIndex,
    )

    rng = np.random.default_rng(13)
    admin, query = live_server["admin"], live_server["query"]
    name = "cap-idx"
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name=name, dimension=16, metric="L2", nlist=8, m=4,
        tier="pq_capacity",
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 400, 16)
    ))
    _build_and_activate(admin, name)

    st = live_server["engine"].get_state(name)
    assert isinstance(st.index, IVFPQIndex)
    assert st.index.raw is None                  # no device raw arena
    assert st.index._host_rr is not None         # host rerank attached
    assert getattr(st.index, "read_only", False)

    # rerank_exact search end-to-end: an ingested vector finds itself
    # with ~zero distance (int8 host-store quantization noise only).
    v0 = np.asarray(st.index._host_rr.vecs[0], np.float32)
    if st.index._host_rr.quantized:
        v0 = v0 * st.index._host_rr.scale[0] + st.index._host_rr.anchors[
            st.index._host_rr.anchor_row[0]
        ]
    id0 = int(st.index._host_rr.ids[0])
    resp = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=v0.astype(float))], topk=3,
        nprobe=8, index=name, rerank_exact=True,
    ))
    assert resp.results[0].neighbors[0].id == id0
    assert resp.results[0].neighbors[0].distance < 0.05

    # AddVectors against the live (read-only) capacity index buffers for
    # the next epoch; a rebuild serves the new data.
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index=name, vectors=_vectors(rng, 50, 16, id0=1000)
    ))
    assert sum(len(v) for v in st.pending_vectors) == 50
    _build_and_activate(admin, name)
    stats = admin.GetStats(vdb_pb2.StatsRequest(index=name))
    assert stats.indexed_vectors == 50
    assert st.index._host_rr is not None


def test_coalescer_cancel_while_queued():
    """A future cancelled after its deadline (VERDICT r2 weak #8) must
    never reach batch_fn — the device never runs abandoned work."""
    import threading
    import time

    from cuda_acceleratedvectordatabaseengine.server.coalescer import (
        RequestCoalescer,
    )

    gate = threading.Event()
    ran = []

    def batch_fn(items):
        gate.wait(timeout=5)
        ran.extend(items)
        return items

    co = RequestCoalescer(batch_fn, window_s=0.01, max_batch=1)
    try:
        f1 = co.submit("a")           # drains alone (max_batch=1), blocks
        time.sleep(0.05)
        f2 = co.submit("b")           # still queued behind the gate
        assert f2.cancel()            # deadline expired while queued
        gate.set()
        assert f1.result(timeout=5) == "a"
        time.sleep(0.2)
        assert "b" not in ran
        with pytest.raises(Exception):
            f2.result(timeout=0.1)    # CancelledError
    finally:
        co.stop()


def test_coalescer_queue_shedding():
    """Backlog past max_queue is rejected at submit() (fail-fast) instead
    of queueing work that will outlive its deadline."""
    import threading

    from cuda_acceleratedvectordatabaseengine.server.coalescer import (
        QueueFullError,
        RequestCoalescer,
    )

    gate = threading.Event()
    co = RequestCoalescer(
        lambda items: (gate.wait(5), items)[1],
        window_s=0.01, max_batch=1, max_queue=2,
    )
    try:
        import time

        futs = [co.submit(0)]         # drains alone, blocks on the gate
        time.sleep(0.1)
        futs += [co.submit(i) for i in (1, 2)]   # exactly fills the queue
        with pytest.raises(QueueFullError):
            co.submit(99)
        assert co.stats()["shed"] == 1
        gate.set()
        for f in futs:
            f.result(timeout=5)
    finally:
        co.stop()


def test_production_yaml_parses_warm_nprobes():
    """The shipped production.yaml actually drives the server (the
    reference's YAML was parsed by nothing, SURVEY §5), including the
    round-3 warm_nprobes operating points."""
    import os

    from cuda_acceleratedvectordatabaseengine.server.config import (
        ServerConfig,
    )

    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "production.yaml")
    cfg = ServerConfig.from_yaml(path)
    assert cfg.default_nprobe == 32
    assert list(cfg.warm_nprobes) == [8, 32]
    assert cfg.streaming_cache_policy == "lfu"


def test_tombstone_wal_tolerates_torn_write(live_server):
    """A crash mid-append leaves a partial trailing u64 in the deletion
    WAL; recovery must apply the complete records and drop the torn tail
    instead of failing the index load."""
    import os

    engine = live_server["engine"]
    path = engine._tombstone_path("torn-scratch")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    engine._append_tombstones(
        "torn-scratch", np.array([11, 22, 33], np.uint64)
    )
    with open(path, "ab") as f:
        f.write(b"\x01\x02\x03")  # torn final record
    # drop the in-memory mirror: recovery reads the FILE, as a restarted
    # process would
    engine._tomb_cache.pop("torn-scratch", None)
    got = engine._read_tombstones("torn-scratch")
    assert np.array_equal(got, np.array([11, 22, 33], np.uint64))


def test_unset_nprobe_uses_persisted_calibration(live_server):
    """A request with nprobe unset serves at the index's calibrated
    operating point when one exists (vdb-tune --persist), else the config
    default — so tuning actually reaches wire clients."""
    engine = live_server["engine"]
    query_impl = __import__(
        "cuda_acceleratedvectordatabaseengine.server.service",
        fromlist=["QueryServiceImpl"],
    ).QueryServiceImpl(engine)
    st = engine.get_state("docs")
    req = vdb_pb2.SearchRequest(
        index="docs", topk=3,
        queries=[vdb_pb2.Vector(values=np.zeros(16, np.float32))],
    )

    class _Ctx:  # aborts raise, as grpc does
        def abort(self, code, msg):
            raise AssertionError(f"abort {code}: {msg}")

    old = st.index.calibrated_nprobe
    try:
        st.index.calibrated_nprobe = 7
        _, _, params = query_impl._validate(req, _Ctx())
        assert params.nprobe == 7
        st.index.calibrated_nprobe = None
        _, _, params = query_impl._validate(req, _Ctx())
        assert params.nprobe == live_server["config"].default_nprobe
        req.nprobe = 3  # explicit wins
        _, _, params = query_impl._validate(req, _Ctx())
        assert params.nprobe == 3
    finally:
        st.index.calibrated_nprobe = old


def test_auto_calibrate_nprobe_on_build(tmp_path):
    """With auto_calibrate_nprobe on, every built epoch carries a
    measured calibration in its manifest and the loaded index serves
    nprobe-unset requests at that point."""
    import time

    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )
    from cuda_acceleratedvectordatabaseengine.storage.manifest import (
        IndexManifest,
    )

    config = ServerConfig(
        shard_serving="off",  # single-chip semantics under the 8-dev CPU mesh
        data_path=str(tmp_path), default_nlist=8,
        auto_calibrate_nprobe=True,
    )
    engine = VdbEngine(config)
    engine.create_index("auto", 16, "L2", 8, 0, 0)
    rng = np.random.default_rng(5)
    engine.add_vectors(
        "auto", rng.standard_normal((600, 16)).astype(np.float32),
        np.arange(600, dtype=np.uint64),
    )
    engine.build_epoch("auto")
    deadline = time.time() + 60
    while not engine.build_jobs["auto"].done:
        assert time.time() < deadline, "build never finished"
        time.sleep(0.2)
    assert not engine.build_jobs["auto"].error
    st = engine.get_state("auto")
    epoch = engine.build_jobs["auto"].epoch_id
    engine._load_epoch_into(st, epoch)
    assert st.index.calibrated_nprobe is not None
    man = IndexManifest.load(engine.epochs.epoch_dir("auto", epoch))
    assert man.extra["calibrated_nprobe"] == st.index.calibrated_nprobe


def test_activation_warms_calibrated_nprobe(tmp_path, monkeypatch):
    """Activation must compile-warm the persisted calibrated nprobe:
    nprobe-unset requests serve at it (see
    test_unset_nprobe_uses_persisted_calibration), and nprobe is
    shape-static — an unwarmed point pays a cold compile on the first
    live request (the recurring ~1 s server-p99 outlier)."""
    import time

    from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
        IVFFlatIndex,
    )
    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )
    from cuda_acceleratedvectordatabaseengine.storage.manifest import (
        IndexManifest,
    )

    config = ServerConfig(
        shard_serving="off",  # single-chip semantics under the 8-dev CPU mesh
        data_path=str(tmp_path), default_nlist=8,
        auto_calibrate_nprobe=True,
    )
    engine = VdbEngine(config)
    engine.create_index("warmcal", 16, "L2", 8, 0, 0)
    rng = np.random.default_rng(11)
    engine.add_vectors(
        "warmcal", rng.standard_normal((600, 16)).astype(np.float32),
        np.arange(600, dtype=np.uint64),
    )
    engine.build_epoch("warmcal")
    deadline = time.time() + 60
    while not engine.build_jobs["warmcal"].done:
        assert time.time() < deadline, "build never finished"
        time.sleep(0.2)
    assert not engine.build_jobs["warmcal"].error
    epoch = engine.build_jobs["warmcal"].epoch_id
    man = IndexManifest.load(engine.epochs.epoch_dir("warmcal", epoch))
    calibrated = int(man.extra["calibrated_nprobe"])
    # Make the assertion non-vacuous: the calibration must not already
    # be a configured warm point.
    assert calibrated != config.default_nprobe
    assert calibrated not in (config.warm_nprobes or ())

    warmed: list[int] = []
    orig = IVFFlatIndex.warmup_lists

    def spy(self, list_ids=None, batch_sizes=(1, 8, 64), nprobes=None):
        warmed.extend(int(p) for p in (nprobes or ()))
        return orig(self, list_ids=list_ids, batch_sizes=batch_sizes,
                    nprobes=nprobes)

    monkeypatch.setattr(IVFFlatIndex, "warmup_lists", spy)
    st = engine.get_state("warmcal")
    engine._load_epoch_into(st, epoch)
    assert calibrated in warmed
    assert config.default_nprobe in warmed


def test_tombstone_consume_keeps_deletes_accepted_during_build(live_server):
    """A finished build clears only the tombstones it BAKED (read at bake
    time) — a delete accepted while the build trained/packed is absent
    from that snapshot and must survive in the log to replay on the next
    load (the round-3 review's resurrected-delete hole)."""
    import os

    engine = live_server["engine"]
    name = "consume-scratch"
    os.makedirs(os.path.join(engine.indices_dir, name), exist_ok=True)
    engine._clear_tombstones(name)
    engine._append_tombstones(name, np.array([1, 2, 3], np.uint64))
    # build read {1,2,3}; a delete of 9 lands mid-build
    baked = engine._read_tombstones(name)
    engine._append_tombstones(name, np.array([9], np.uint64))
    engine._consume_tombstones(name, baked)
    # survivor: the mid-build delete — from the in-memory mirror AND from
    # a cold read of the rewritten file (restart path)
    assert np.array_equal(
        engine._read_tombstones(name), np.array([9], np.uint64)
    )
    engine._tomb_cache.pop(name, None)
    assert np.array_equal(
        engine._read_tombstones(name), np.array([9], np.uint64)
    )
    # the atomic rewrite leaves no temp droppings
    d = os.path.dirname(engine._tombstone_path(name))
    assert not [f for f in os.listdir(d) if f.endswith(".tmp")]


def test_tombstone_append_dedupes(live_server):
    """Repeated deletes of the same id must not grow the WAL unboundedly
    between builds: appends dedupe against the in-memory mirror."""
    import os

    engine = live_server["engine"]
    name = "dedupe-scratch"
    os.makedirs(os.path.join(engine.indices_dir, name), exist_ok=True)
    engine._clear_tombstones(name)
    for _ in range(5):
        engine._append_tombstones(name, np.array([7, 7, 8], np.uint64))
    path = engine._tombstone_path(name)
    assert os.path.getsize(path) == 2 * 8  # two unique records, once each
    assert np.array_equal(
        engine._read_tombstones(name), np.array([7, 8], np.uint64)
    )


def test_delete_during_warmup_lands_in_swapped_index(live_server,
                                                     monkeypatch):
    """A RemoveVectors accepted while _load_epoch_into warms the NEW index
    (tens of seconds of cold compiles) hits the OLD index + the
    WAL — the locked swap must replay that delta or the reload resurrects
    the id until the next reload."""
    from cuda_acceleratedvectordatabaseengine.models.ivf_flat import (
        IVFFlatIndex,
    )

    engine = live_server["engine"]
    admin, query = live_server["admin"], live_server["query"]
    st = engine.get_state("docs")
    victim = np.uint64(57)
    assert np.isin(victim, st.index.arena.ids)

    orig = IVFFlatIndex.warmup_lists
    fired = []

    def delete_mid_warmup(self, list_ids=None, batch_sizes=(1, 8, 64),
                          nprobes=None):
        out = orig(self, list_ids=list_ids, batch_sizes=batch_sizes,
                   nprobes=nprobes)
        if not fired:  # only the reload's warmup, once
            fired.append(True)
            engine.remove_vectors("docs", np.array([victim], np.uint64))
        return out

    monkeypatch.setattr(IVFFlatIndex, "warmup_lists", delete_mid_warmup)
    try:
        engine._load_epoch_into(st, engine.epochs.active_epoch("docs"))
        assert fired, "warmup hook never ran"
        # the delete raced the reload — the swapped-in index must not
        # serve the id, and its tombstone must still be in the WAL
        assert not np.isin(victim, st.index.arena.ids)
        assert np.isin(victim, engine._read_tombstones("docs"))
    finally:
        # restore the corpus for later tests: re-add revokes the tombstone
        vec = np.random.default_rng(57).standard_normal(16).astype(
            np.float32
        )
        admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="docs",
            vectors=[vdb_pb2.Vector(id=int(victim), values=vec)],
        ))


def test_coalescer_weight_bounded_drain():
    """With weight_fn, max_batch bounds total WEIGHT (queries), not item
    count — so multi-query requests can never assemble a device batch
    wider than the warmed buckets (the r4 wire-bench deadline cascade)."""
    from cuda_acceleratedvectordatabaseengine.server.coalescer import (
        RequestCoalescer,
    )

    batches: list[list[int]] = []
    gate = threading.Event()

    def batch_fn(items):
        gate.wait(timeout=5)   # let the queue fill so drains coalesce
        batches.append(list(items))
        return [None] * len(items)

    co = RequestCoalescer(
        batch_fn, window_s=0.005, max_batch=32,
        weight_fn=lambda w: w,
    )
    futs = [co.submit(16) for _ in range(9)]
    futs.append(co.submit(100))   # oversize single item must still drain
    gate.set()
    for f in futs:
        f.result(timeout=10)
    co.stop()
    for b in batches:
        assert len(b) == 1 or sum(b) <= 32
    assert any(len(b) == 2 for b in batches)   # coalescing still happens
    assert [100] in batches                    # first item always taken


def test_coalescer_pipelined_finalize_overlap():
    """Pipelined mode: batch N dispatches while batch N-1's finalize
    (result fetch) is still in flight — the fetch/upload overlap that
    makes serving throughput one batch per device round trip."""
    import time as _time

    from cuda_acceleratedvectordatabaseengine.server.coalescer import (
        RequestCoalescer,
    )

    release = threading.Event()
    dispatched: list[int] = []

    def dispatch_fn(items):
        n = len(dispatched)
        dispatched.append(len(items))

        def thunk():
            if n == 0:
                release.wait(timeout=10)
            return list(items)

        return thunk

    co = RequestCoalescer(
        dispatch_fn=dispatch_fn, window_s=0.002, max_batch=4
    )
    f1 = co.submit("a")
    for _ in range(500):
        if dispatched:
            break
        _time.sleep(0.005)
    assert dispatched == [1]
    f2 = co.submit("b")   # must dispatch while f1's fetch is blocked
    for _ in range(500):
        if len(dispatched) == 2:
            break
        _time.sleep(0.005)
    assert len(dispatched) == 2
    assert not f1.done()
    release.set()
    assert f1.result(timeout=5) == "a"
    assert f2.result(timeout=5) == "b"
    co.stop()


def test_adaptive_batch_size_latency_policy():
    """Batch sizing is load-invariant (shrinking under load is backwards
    when per-dispatch cost is fixed) and shrinks only when the measured
    batch latency blows the budget."""
    from cuda_acceleratedvectordatabaseengine.server.balancer import (
        AdaptiveController,
    )

    a = AdaptiveController(base_batch=64, latency_budget_ms=100.0)
    assert a.batch_size(512, 512) == 64        # full load, fast batches
    for _ in range(200):
        a.record_latency_ms(150.0)             # budget < ema < 2x budget
    assert a.batch_size(0, 512) == 32
    for _ in range(200):
        a.record_latency_ms(500.0)             # ema > 2x budget
    assert a.batch_size(0, 512) == 16


def test_stats_reset_isolates_percentile_windows(live_server):
    """GetStats(reset=true) clears the sample windows, so a benchmark
    scenario's server percentiles are its own (the r3/r4 wire artifacts'
    b1 "server p50" was really the preceding warm pass's)."""
    import time

    admin, query = live_server["admin"], live_server["query"]
    rng = np.random.default_rng(11)
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="statsreset", dimension=16, metric="L2", nlist=8
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="statsreset", vectors=_vectors(rng, 200, 16)
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="statsreset"))
    deadline = time.time() + 60
    while True:
        try:
            admin.ActivateEpoch(
                vdb_pb2.ActivateEpochRequest(index="statsreset")
            )
            break
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline, "build never finished"
            time.sleep(0.2)
    live_server["engine"].metrics.reset_windows("statsreset")
    query.Search(vdb_pb2.SearchRequest(
        queries=_vectors(rng, 1, 16), topk=5, nprobe=8, index="statsreset",
    ))
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="statsreset"))
    assert stats.latency_p50_ms > 0.0
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="statsreset", reset=True))
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="statsreset"))
    assert stats.latency_p50_ms == 0.0
    # the engine-level stage spans are cleared too
    assert live_server["engine"].metrics.get_stage_percentiles() == {}
    # ...and recording resumes normally after a reset
    query.Search(vdb_pb2.SearchRequest(
        queries=_vectors(rng, 1, 16), topk=5, nprobe=8, index="statsreset",
    ))
    stats = admin.GetStats(vdb_pb2.StatsRequest(index="statsreset"))
    assert stats.latency_p50_ms > 0.0
