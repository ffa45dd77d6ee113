"""CLI tools smoke tests (builder, benchmark, recall, load test vs a live
in-process server)."""

import csv
import io
import json
import os

import grpc
import numpy as np
import pytest


def test_build_index_cli_synthetic_and_load(tmp_path, capsys):
    from cuda_acceleratedvectordatabaseengine.tools.build_index import (
        main,
    )

    out = str(tmp_path / "snap")
    rc = main([
        "--synthetic", "2000", "--dimension", "16", "--nlist", "8",
        "--output", out, "--dtype", "float32",
    ])
    assert rc == 0
    assert os.path.isfile(os.path.join(out, "manifest.json"))
    from cuda_acceleratedvectordatabaseengine import IVFFlatIndex

    idx = IVFFlatIndex.load(out)
    assert idx.ntotal == 2000


def test_build_index_cli_from_arrow_with_epoch(tmp_path, rng):
    from cuda_acceleratedvectordatabaseengine.storage import (
        ArrowStorage,
        EpochManager,
    )
    from cuda_acceleratedvectordatabaseengine.tools.build_index import (
        main,
    )

    src = str(tmp_path / "src.arrow")
    vecs = rng.standard_normal((1000, 8)).astype(np.float32)
    ArrowStorage.write_vectors(src, np.arange(1000, dtype=np.uint64), vecs)
    base = str(tmp_path / "epochs")
    rc = main([
        "--source", src, "--nlist", "4", "--output", "ignored",
        "--epoch-base", base, "--index-name", "foo",
    ])
    assert rc == 0
    em = EpochManager(base)
    eps = em.list_epochs("foo")["epochs"]
    assert len(eps) == 1


def test_benchmark_cli_csv(tmp_path):
    from cuda_acceleratedvectordatabaseengine.tools.benchmark import main

    out = str(tmp_path / "bench.csv")
    rc = main([
        "--vectors", "5000", "--dimension", "16", "--nlist", "16",
        "--queries", "64", "--batch", "32", "--csv", out,
    ])
    assert rc == 0
    with open(out) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["vectors", "dimension", "nlist", "nprobe", "k",
                       "train_time", "add_time", "search_time", "qps",
                       "latency_ms"]
    assert float(rows[1][8]) > 0  # qps


def test_recall_cli(capsys):
    from cuda_acceleratedvectordatabaseengine.tools.recall_test import (
        main,
    )

    rc = main([
        "--vectors", "3000", "--dimension", "16", "--nlist", "8",
        "--queries", "32", "--nprobe", "2", "8",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    rows = json.loads(out.strip().splitlines()[-1])
    # full probe must beat partial probe and be ~1.0 (queries are perturbed
    # corpus points)
    by_probe = {r["nprobe"]: r["recall@10"] for r in rows}
    assert by_probe[8] >= by_probe[2]
    assert by_probe[8] > 0.9


def test_load_test_cli_against_live_server(tmp_path, capsys, rng):
    from cuda_acceleratedvectordatabaseengine.server.config import (
        ServerConfig,
    )
    from cuda_acceleratedvectordatabaseengine.server.main import (
        build_server,
    )
    from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
        AdminServiceClient,
    )
    from cuda_acceleratedvectordatabaseengine.server.proto import vdb_pb2
    from cuda_acceleratedvectordatabaseengine.tools.load_test import main

    config = ServerConfig(
        shard_serving="off",  # single-chip semantics under the 8-dev CPU mesh
        address="127.0.0.1:0", data_path=str(tmp_path / "data"),
        default_nlist=4,
    )
    server, engine, health, port = build_server(config)
    server.start()
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        admin = AdminServiceClient(channel)
        admin.CreateIndex(vdb_pb2.CreateIndexRequest(
            name="lt", dimension=8, nlist=4
        ))
        admin.AddVectors(vdb_pb2.AddVectorsRequest(
            index="lt",
            vectors=[vdb_pb2.Vector(
                id=i, values=rng.standard_normal(8).astype(float))
                for i in range(300)],
        ))
        admin.BuildEpoch(vdb_pb2.BuildEpochRequest(index="lt"))
        import time

        deadline = time.time() + 60
        while True:
            try:
                admin.ActivateEpoch(
                    vdb_pb2.ActivateEpochRequest(index="lt"))
                break
            except grpc.RpcError as e:
                assert time.time() < deadline
                time.sleep(0.2)
        rc = main([
            "--target", f"127.0.0.1:{port}", "--index", "lt",
            "--dimension", "8", "--threads", "2", "--requests", "5",
            "--nprobe", "4",
        ])
        assert rc == 0
        report = json.loads(capsys.readouterr().out)
        assert report["success_rate"] == 1.0
        assert report["qps"] > 0
    finally:
        server.stop(grace=None)


def test_bench_zipf_corpus_chunk_coherent():
    """The zipf-skewed corpus is a pure function of the GLOBAL row index:
    chunked generation must reproduce the one-shot corpus bit-exactly
    (the contract that keeps cross-chunk probing meaningful — see
    bench.clustered_corpus)."""
    import jax
    import jax.numpy as jnp

    from bench import clustered_corpus, zipf_cumulative

    n, dim, modes = 2048, 16, 16
    cum = zipf_cumulative(n, modes, s=1.0)
    assert cum[-1] == n and (np.diff(cum) >= 0).all()
    # head mode strictly larger than tail mode
    sizes = np.diff(np.concatenate([[0], cum]))
    assert sizes[0] > sizes[-1] > 0

    centers = jax.random.normal(
        jax.random.PRNGKey(4), (modes, dim), jnp.float32
    )
    # Emulate the chunked builder: two calls with explicit global base
    # offsets vs one full-range call.
    lo, _ = clustered_corpus(
        jax.random.PRNGKey(9), n // 2, dim, modes, noise=0.0, chunk=n // 2,
        centers=centers, base=0, skew_cum=cum, n_total=n,
    )
    hi, _ = clustered_corpus(
        jax.random.PRNGKey(9), n // 2, dim, modes, noise=0.0, chunk=n // 2,
        centers=centers, base=n // 2, skew_cum=cum, n_total=n,
    )
    full, _ = clustered_corpus(
        jax.random.PRNGKey(9), n, dim, modes, noise=0.0, chunk=n,
        centers=centers, base=0, skew_cum=cum, n_total=n,
    )
    # noise=0 ⇒ rows are exactly their mode center: membership (the part
    # the bijection controls) must agree chunked vs one-shot.
    np.testing.assert_array_equal(
        np.asarray(jnp.concatenate([lo, hi])), np.asarray(full)
    )


def test_autotune_cli_recommends_and_persists(tmp_path, capsys):
    """vdb-tune: measures the coverage curve on a built snapshot, picks
    the smallest nprobe meeting the target, and --persist writes it into
    the manifest so a reloaded index serves SearchParams(nprobe=0) with
    the tuned value (replaces the reference's static tuning table,
    README.md:154-167)."""
    from cuda_acceleratedvectordatabaseengine import (
        IVFFlatIndex,
        SearchParams,
    )
    from cuda_acceleratedvectordatabaseengine.tools.autotune import (
        main as tune_main,
    )
    from cuda_acceleratedvectordatabaseengine.tools.build_index import (
        main as build_main,
    )

    snap = str(tmp_path / "snap")
    rc = build_main([
        "--synthetic", "4000", "--dimension", "16", "--nlist", "16",
        "--output", snap, "--dtype", "float32",
    ])
    assert rc == 0
    capsys.readouterr()

    rc = tune_main([
        "--snapshot", snap, "--target-coverage", "0.9", "--k", "5",
        "--sample", "128", "--measure-qps", "--batch", "32",
        "--qps-batches", "2", "--persist",
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["recommended_nprobe"] >= 1
    assert str(rep["recommended_nprobe"]) in rep["coverage_curve"]
    assert rep["measured_coverage"] >= 0.9 or rep["coverage_limited"]
    assert rep["sequential_qps"] > 0
    assert rep["persisted"] is True
    assert rep["reference_static_nprobe"] == 16  # <1M tier

    idx = IVFFlatIndex.load(snap)
    assert idx.calibrated_nprobe == rep["recommended_nprobe"]
    q = np.zeros((2, 16), np.float32)
    d, ids = idx.search(q, SearchParams(nprobe=0, k=5))  # uses calibration
    assert ids.shape == (2, 5)


def test_autotune_cli_ivf_pq_snapshot(tmp_path, capsys):
    """vdb-tune dispatches on snapshot kind: IVF-PQ snapshots calibrate
    through the shared coverage machinery."""
    from cuda_acceleratedvectordatabaseengine.tools.autotune import (
        main as tune_main,
    )
    from cuda_acceleratedvectordatabaseengine.tools.build_index import (
        main as build_main,
    )

    snap = str(tmp_path / "pqsnap")
    rc = build_main([
        "--synthetic", "3000", "--dimension", "16", "--nlist", "8",
        "--pq-m", "4", "--output", snap,
    ])
    assert rc == 0
    capsys.readouterr()
    rc = tune_main([
        "--snapshot", snap, "--target-coverage", "0.9", "--k", "5",
        "--sample", "64",
    ])
    assert rc == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["kind"] == "ivf_pq"
    assert rep["recommended_nprobe"] >= 1
