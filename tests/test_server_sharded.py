"""Multi-chip SERVING over the wire (VERDICT r3 item 1).

The reference claims multi-GPU serving with a dead config flag
(``/root/reference/configs/production.yaml:11`` ``enable_multi_gpu: true``
— nothing reads it; ``CLAUDE_CONTEXT.md:107`` lists it as future work).
Here the full gRPC lifecycle runs against an engine whose epoch
activation loads indices into the sharded SPMD views (``parallel/``) on
the virtual 8-device CPU mesh, and wire results are checked identical to
a single-chip server over the same data.
"""

import time

import grpc
import numpy as np
import pytest

from cuda_acceleratedvectordatabaseengine.server.config import ServerConfig
from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
    AdminServiceClient,
    QueryServiceClient,
)
from cuda_acceleratedvectordatabaseengine.server.main import build_server
from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2

DIM = 16


def _make_server(tmp_path, shard_serving: str):
    config = ServerConfig(
        address="127.0.0.1:0",
        data_path=str(tmp_path),
        coalesce_window_ms=1.0,
        default_nlist=8,
        max_batch_size=16,
        warm_nprobes=(),        # bound activation compiles on the CPU mesh
        shard_serving=shard_serving,
    )
    server, engine, health, port = build_server(config)
    server.start()
    channel = grpc.insecure_channel(f"127.0.0.1:{port}")
    grpc.channel_ready_future(channel).result(timeout=10)
    return {
        "server": server,
        "channel": channel,
        "engine": engine,
        "admin": AdminServiceClient(channel),
        "query": QueryServiceClient(channel),
    }


def _close(h):
    h["channel"].close()
    h["server"].stop(grace=None)


@pytest.fixture(scope="module")
def sharded_server(tmp_path_factory):
    h = _make_server(tmp_path_factory.mktemp("vdb-sharded"), "on")
    yield h
    _close(h)


def _vectors(rng, n, dim=DIM, id0=0):
    return [
        vdb_pb2.Vector(id=id0 + i,
                       values=rng.standard_normal(dim).astype(float))
        for i in range(n)
    ]


def _build_and_activate(admin, name, deadline_s=120):
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


def _packed_search(query, name, qs, k=5, nprobe=8, rerank=False):
    resp = query.Search(vdb_pb2.SearchRequest(
        index=name, topk=k, nprobe=nprobe,
        packed_queries=np.ascontiguousarray(qs, "<f4").tobytes(),
        packed_response=True, rerank_exact=rerank,
    ))
    ids = np.frombuffer(resp.packed_ids, "<u8").reshape(len(qs), k)
    d = np.frombuffer(resp.packed_distances, "<f4").reshape(len(qs), k)
    return d, ids


def test_engine_mesh_modes(tmp_path):
    """auto shards when >1 device is visible; off never does."""
    import jax

    from cuda_acceleratedvectordatabaseengine.server.service import (
        VdbEngine,
    )

    on = VdbEngine(ServerConfig(data_path=str(tmp_path / "a"),
                                shard_serving="auto"))
    assert on.mesh is not None
    assert on.mesh.devices.size == len(jax.devices())
    off = VdbEngine(ServerConfig(data_path=str(tmp_path / "b"),
                                 shard_serving="off"))
    assert off.mesh is None
    with pytest.raises(ValueError):
        VdbEngine(ServerConfig(data_path=str(tmp_path / "c"),
                               shard_serving="sideways"))


def test_enable_multi_gpu_yaml_alias(tmp_path):
    """The reference's enable_multi_gpu bool maps onto shard_serving."""
    p = tmp_path / "c.yaml"
    p.write_text("server:\n  enable_multi_gpu: false\n")
    assert ServerConfig.from_yaml(str(p)).shard_serving == "off"
    p.write_text("server:\n  enable_multi_gpu: true\n")
    assert ServerConfig.from_yaml(str(p)).shard_serving == "auto"
    p.write_text(
        "server:\n  enable_multi_gpu: true\n  shard_serving: \"off\"\n"
    )
    # an explicit shard_serving key wins over the legacy alias
    assert ServerConfig.from_yaml(str(p)).shard_serving == "off"


def test_sharded_lifecycle_flat(sharded_server):
    """create → ingest → build → activate → the live index is the SPMD
    sharded view over the full mesh and every vector finds itself."""
    import jax

    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFFlatIndex,
    )

    rng = np.random.default_rng(0)
    admin, query = sharded_server["admin"], sharded_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="docs", dimension=DIM, metric="L2", nlist=8
    ))
    x = rng.standard_normal((600, DIM)).astype(np.float32)
    for b in range(3):
        admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="docs",
            vectors=[vdb_pb2.Vector(id=b * 200 + i, values=x[b * 200 + i])
                     for i in range(200)],
        ))
    _build_and_activate(admin, "docs")

    st = sharded_server["engine"].get_state("docs")
    assert isinstance(st.index, ShardedIVFFlatIndex)
    assert st.index.n_shards == len(jax.devices())
    assert st.index.ntotal == 600

    d, ids = _packed_search(query, "docs", x[:8], k=5, nprobe=8)
    assert (ids[:, 0] == np.arange(8)).all()
    assert (d[:, 0] <= d[:, 1]).all()

    stats = admin.GetStats(vdb_pb2.StatsRequest(index="docs"))
    assert stats.indexed_vectors == 600
    assert stats.gpu_memory_used > 0


def test_wire_parity_sharded_vs_single(sharded_server, tmp_path):
    """Identical corpus + deterministic build on a single-chip server:
    the wire responses must match the sharded server's exactly (same
    distances, same ids) — sharding is a pure layout/serving change."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((500, DIM)).astype(np.float32)
    qs = x[:16]

    def drive(h, name):
        h["admin"].CreateIndex(vdb_pb2.CreateIndexRequest(
            name=name, dimension=DIM, metric="L2", nlist=8
        ))
        h["admin"].AddVectors(vdb_pb2.AddVectorsRequest(
            index=name,
            vectors=[vdb_pb2.Vector(id=i, values=x[i])
                     for i in range(len(x))],
        ))
        _build_and_activate(h["admin"], name)
        return _packed_search(h["query"], name, qs, k=10, nprobe=4)

    d_sh, ids_sh = drive(sharded_server, "parity")
    single = _make_server(tmp_path, "off")
    try:
        d_1c, ids_1c = drive(single, "parity")
    finally:
        _close(single)

    np.testing.assert_array_equal(ids_sh, ids_1c)
    np.testing.assert_allclose(d_sh, d_1c, rtol=1e-5, atol=1e-5)


def test_sharded_mutations_over_wire(sharded_server):
    """AddVectors / RemoveVectors against the LIVE sharded index: the
    serving surface delegates to the base and re-publishes the stripes."""
    rng = np.random.default_rng(3)
    admin, query = sharded_server["admin"], sharded_server["query"]
    # distinct far-out vectors so int8 quantization can't blur the match
    new = (rng.standard_normal((4, DIM)) * 4).astype(np.float32)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="docs",
        vectors=[vdb_pb2.Vector(id=70_000 + i, values=new[i])
                 for i in range(4)],
    ))
    d, ids = _packed_search(query, "docs", new, k=3, nprobe=8)
    assert (ids[:, 0] == np.arange(70_000, 70_004)).all()

    resp = admin.RemoveVectors(vdb_pb2.RemoveVectorsRequest(
        index="docs", ids=[70_000, 70_001]
    ))
    assert resp.removed == 2
    d, ids = _packed_search(query, "docs", new, k=3, nprobe=8)
    assert not (set(ids.ravel().tolist()) & {70_000, 70_001})
    assert ids[2, 0] == 70_002 and ids[3, 0] == 70_003


def test_sharded_tombstone_replay_on_reload(sharded_server):
    """Epoch reload re-applies the deletion WAL to the base BEFORE the
    stripes publish — a deleted id must not resurrect on LoadIndex."""
    engine = sharded_server["engine"]
    admin, query = sharded_server["admin"], sharded_server["query"]
    st = engine.get_state("docs")
    epoch = st.epoch
    engine._load_epoch_into(st, epoch)
    d, ids = _packed_search(
        query, "docs",
        np.zeros((1, DIM), np.float32), k=10, nprobe=8,
    )
    assert not (set(ids.ravel().tolist()) & {70_000, 70_001})


def test_sharded_pq_lifecycle(sharded_server):
    """IVF-PQ epoch activates into the sharded ADC view; exact rerank
    (striped raw arena) recovers self-matches over the wire."""
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedIVFPQIndex,
    )

    rng = np.random.default_rng(11)
    admin, query = sharded_server["admin"], sharded_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="pq", dimension=DIM, metric="L2", nlist=8, m=4
    ))
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="pq",
        vectors=[vdb_pb2.Vector(id=i, values=x[i]) for i in range(len(x))],
    ))
    _build_and_activate(admin, "pq")
    st = sharded_server["engine"].get_state("pq")
    assert isinstance(st.index, ShardedIVFPQIndex)
    d, ids = _packed_search(query, "pq", x[:8], k=5, nprobe=8, rerank=True)
    assert (ids[:, 0] == np.arange(8)).all()


def test_sharded_streaming_tier(sharded_server):
    """tier=streaming on a mesh activates the slot-striped HBM cache
    (aggregate cache budget scales with the slice) and serves searches."""
    from cuda_acceleratedvectordatabaseengine.parallel import (
        ShardedStreamingIVFFlatIndex,
    )

    rng = np.random.default_rng(13)
    admin, query = sharded_server["admin"], sharded_server["query"]
    admin.CreateIndex(vdb_pb2.CreateIndexRequest(
        name="stream", dimension=DIM, metric="L2", nlist=8,
        tier="streaming",
    ))
    x = rng.standard_normal((400, DIM)).astype(np.float32)
    admin.AddVectors(vdb_pb2.AddVectorsRequest(
        index="stream",
        vectors=[vdb_pb2.Vector(id=i, values=x[i]) for i in range(len(x))],
    ))
    _build_and_activate(admin, "stream")
    st = sharded_server["engine"].get_state("stream")
    assert isinstance(st.index, ShardedStreamingIVFFlatIndex)
    d, ids = _packed_search(query, "stream", x[:8], k=5, nprobe=8)
    assert (ids[:, 0] == np.arange(8)).all()
