"""Admission-stack failure tests (VERDICT r2 #7): every wired admission
control — circuit breaker, rate limiter, concurrency cap — is tripped over
the wire and recovers, and client errors never poison the breaker.

Reference pattern: black-box error-code assertions against a live server
(``test/integration/grpc_integration_test.cpp:186-245``); the reference
implemented these controls but never instantiated them (SURVEY.md §2.6
S5/S7), so it could not test them.
"""

import time

import grpc
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine.server.balancer import (
    CircuitState,
    ConcurrencyLimiter,
)
from cuda_acceleratedvectordatabaseengine.server.config import ServerConfig
from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
    AdminServiceClient,
    QueryServiceClient,
)
from cuda_acceleratedvectordatabaseengine.server.main import build_server
from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2
from cuda_acceleratedvectordatabaseengine.server.ratelimit import (
    RateLimiter,
)

DIM = 16


@pytest.fixture(scope="module")
def adm_server(tmp_path_factory):
    """Live server with fast breaker recovery and a built index."""
    config = ServerConfig(
        shard_serving="off",  # single-chip semantics under the 8-dev CPU mesh
        address="127.0.0.1:0",
        data_path=str(tmp_path_factory.mktemp("vdb-adm")),
        coalesce_window_ms=1.0,
        default_nlist=4,
        breaker_open_seconds=1.0,
    )
    server, engine, health, port = build_server(config)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(channel).result(timeout=10)
    admin = AdminServiceClient(channel)
    query = QueryServiceClient(channel)
    rng = np.random.default_rng(0)
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="adm", dimension=DIM, metric="L2", nlist=4
    ))
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="adm", vectors=[
            vdb_pb2.Vector(id=i, values=rng.standard_normal(DIM))
            for i in range(256)
        ],
    ))
    admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="adm"))
    deadline = time.time() + 60
    while True:
        try:
            admin.ActivateEpoch(vdb_pb2.ActivateEpochRequest(index="adm"))
            break
        except grpc.RpcError as e:
            if e.code() != grpc.StatusCode.FAILED_PRECONDITION:
                raise
            assert time.time() < deadline, "build never finished"
            time.sleep(0.2)
    yield {
        "query": query, "admin": admin, "engine": engine, "config": config,
    }
    channel.close()
    server.stop(grace=None)


def _search(query, **kw):
    kw.setdefault("queries", [vdb_pb2.Vector(values=[0.0] * DIM)])
    kw.setdefault("topk", 3)
    kw.setdefault("nprobe", 4)
    kw.setdefault("index", "adm")
    return query.Search(vdb_pb2.SearchRequest(**kw))


def _code_of(fn):
    try:
        fn()
        return None
    except grpc.RpcError as e:
        return e.code()


def test_breaker_opens_on_server_faults_and_recovers(adm_server):
    """Inject a failing index → repeated server errors open the breaker
    (UNAVAILABLE); after ``open_seconds`` the half-open probe succeeds and
    the breaker closes again — the reference's auto-recovery intent
    (``load_balancer.cpp:193-268``), wired and proven here."""
    query, engine = adm_server["query"], adm_server["engine"]
    st = engine.get_state("adm")
    # the serving path dispatches through search_async (pipelined
    # coalescer); break both entry points
    good_search = st.index.search
    good_async = st.index.search_async

    def broken(*a, **k):
        raise RuntimeError("injected device fault")

    st.index.search = broken
    st.index.search_async = broken
    try:
        codes = []
        deadline = time.time() + 30
        # Hammer until the breaker opens: each request fails server-side
        # (UNKNOWN from the raised fault) until error-rate > threshold.
        while time.time() < deadline:
            code = _code_of(lambda: _search(query))
            codes.append(code)
            if code == grpc.StatusCode.UNAVAILABLE:
                break
        assert grpc.StatusCode.UNAVAILABLE in codes, codes[-5:]
        assert engine.breaker.state == CircuitState.OPEN
        # while open, requests are rejected up front — no device work
        assert _code_of(lambda: _search(query)) == \
            grpc.StatusCode.UNAVAILABLE
    finally:
        st.index.search = good_search
        st.index.search_async = good_async

    # recovery: after open_seconds (1 s here) the next request is the
    # half-open probe; it succeeds and closes the breaker.
    time.sleep(adm_server["config"].breaker_open_seconds + 0.1)
    resp = _search(query)
    assert len(resp.results) == 1
    assert engine.breaker.state == CircuitState.CLOSED
    # steady state restored
    assert _code_of(lambda: _search(query)) is None


def test_client_errors_never_trip_breaker(adm_server):
    """INVALID_ARGUMENT / NOT_FOUND are rejected before admission control,
    so they must not move the breaker's error counts."""
    query, engine = adm_server["query"], adm_server["engine"]
    before = (engine.breaker._errors, engine.breaker._total)
    for _ in range(20):
        assert _code_of(lambda: _search(query, topk=0)) == \
            grpc.StatusCode.INVALID_ARGUMENT
        assert _code_of(lambda: _search(query, index="ghost")) == \
            grpc.StatusCode.NOT_FOUND
    after = (engine.breaker._errors, engine.breaker._total)
    assert after == before
    assert engine.breaker.state == CircuitState.CLOSED
    # and the server still serves
    assert len(_search(query).results) == 1


def test_rate_limit_rejects_with_resource_exhausted(adm_server):
    """Exhausting the token bucket → RESOURCE_EXHAUSTED, refill → serves
    again; rejected requests never count as breaker errors."""
    query, engine = adm_server["query"], adm_server["engine"]
    orig = engine.rate_limiter
    engine.rate_limiter = RateLimiter(rate_per_s=0.0, burst=2)
    try:
        codes = [_code_of(lambda: _search(query)) for _ in range(4)]
        assert codes[-1] == grpc.StatusCode.RESOURCE_EXHAUSTED
        assert codes[0] is None          # burst tokens served first
        assert engine.breaker.state == CircuitState.CLOSED
    finally:
        engine.rate_limiter = orig
    assert _code_of(lambda: _search(query)) is None


def test_concurrency_cap_rejects_with_resource_exhausted(adm_server):
    """At the concurrency cap, requests are shed with RESOURCE_EXHAUSTED
    (``load_balancer.cpp:47-51``) instead of queueing unboundedly."""
    query, engine = adm_server["query"], adm_server["engine"]
    orig = engine.limiter
    cap = ConcurrencyLimiter(1)
    assert cap.try_enter()               # saturate the only slot
    engine.limiter = cap
    try:
        assert _code_of(lambda: _search(query)) == \
            grpc.StatusCode.RESOURCE_EXHAUSTED
        cap.exit()
        assert _code_of(lambda: _search(query)) is None
    finally:
        engine.limiter = orig


def test_packed_wire_roundtrip(adm_server):
    """packed_queries / packed_response round-trip: same answers as the
    repeated-Vector form with ~30x less python-proto serialization work."""
    query = adm_server["query"]
    rng = np.random.default_rng(7)
    q = rng.standard_normal((8, DIM)).astype(np.float32)
    resp_packed = query.Search(vdb_pb2.SearchRequest(
        packed_queries=q.tobytes(), topk=3, nprobe=4, index="adm",
        packed_response=True,
    ))
    ids = np.frombuffer(resp_packed.packed_ids, dtype="<u8").reshape(8, 3)
    dists = np.frombuffer(
        resp_packed.packed_distances, dtype="<f4"
    ).reshape(8, 3)
    resp_msg = query.Search(vdb_pb2.SearchRequest(
        queries=[vdb_pb2.Vector(values=row) for row in q.astype(float)],
        topk=3, nprobe=4, index="adm",
    ))
    for i, res in enumerate(resp_msg.results):
        got = [(n.id, pytest.approx(n.distance, rel=1e-5))
               for n in res.neighbors]
        want = list(zip(ids[i].tolist(), dists[i].tolist()))[:len(got)]
        assert [(g[0],) for g in got] == [(w[0],) for w in want]
        for (gid, gdist), (wid, wdist) in zip(got, want):
            assert gdist == wdist


def test_packed_queries_bad_length(adm_server):
    query = adm_server["query"]
    with pytest.raises(grpc.RpcError) as e:
        query.Search(vdb_pb2.SearchRequest(
            packed_queries=b"\x00" * 7, topk=3, index="adm",
        ))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT


def test_rate_limit_charges_per_request_not_per_query(adm_server):
    """A multi-query (batched) request consumes ONE token: the config key
    is requests_per_second (``configs/production.yaml:32``) and the
    reference bucket refills in request units
    (``query_service.cpp:639-677``). Charging per query made packed
    batch=64 requests eat 64x tokens and shed sustainable load."""
    query, engine = adm_server["query"], adm_server["engine"]
    orig = engine.rate_limiter
    engine.rate_limiter = RateLimiter(rate_per_s=0.0, burst=2)
    try:
        q = np.zeros((64, DIM), np.float32)
        # two batched requests fit the 2-token burst...
        for _ in range(2):
            resp = query.Search(vdb_pb2.SearchRequest(
                packed_queries=q.tobytes(), topk=3, nprobe=4, index="adm",
            ))
            assert len(resp.results) == 64
        # ...the third request (even a single-query one) is shed
        assert _code_of(lambda: _search(query)) == \
            grpc.StatusCode.RESOURCE_EXHAUSTED
    finally:
        engine.rate_limiter = orig


def test_oversized_batch_rejected(adm_server):
    """Per-request rate limiting needs a per-request work bound: more than
    MAX_QUERIES queries in one request is INVALID_ARGUMENT (the
    repeated-Vector form shares the same cap in _validate)."""
    from cuda_acceleratedvectordatabaseengine.server.service import (
        MAX_QUERIES,
    )
    query = adm_server["query"]
    big = np.zeros((MAX_QUERIES + 1, DIM), np.float32)
    with pytest.raises(grpc.RpcError) as e:
        query.Search(vdb_pb2.SearchRequest(
            packed_queries=big.tobytes(), topk=3, index="adm",
        ))
    assert e.value.code() == grpc.StatusCode.INVALID_ARGUMENT
