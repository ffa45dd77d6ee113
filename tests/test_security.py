"""TLS + bearer-token auth — the reference's last declared-but-dead config
surface (``/root/reference/configs/production.yaml:84-91`` ``enable_tls`` /
``enable_auth``), implemented for real here (server/main.py)."""

import subprocess

import grpc
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


def _start(tmp_path, **cfg_kwargs):
    config = ServerConfig(
        shard_serving="off",
        address="127.0.0.1:0",
        data_path=str(tmp_path / "data"),
        **cfg_kwargs,
    )
    server, engine, health, port = build_server(config)
    server.start()
    return server, port


def test_auth_token_required(tmp_path):
    server, port = _start(tmp_path, auth_token="sekrit-42")
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        grpc.channel_ready_future(channel).result(timeout=10)
        admin = AdminServiceClient(channel)
        query = QueryServiceClient(channel)
        health = HealthClient(channel)

        # no token → UNAUTHENTICATED on vdb.* RPCs
        with pytest.raises(grpc.RpcError) as e:
            admin.GetStats(vdb_pb2.StatsRequest())
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED

        # wrong token → UNAUTHENTICATED
        with pytest.raises(grpc.RpcError) as e:
            admin.GetStats(
                vdb_pb2.StatsRequest(),
                metadata=(("authorization", "Bearer nope"),),
            )
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED

        # streaming RPC without a token aborts with the same code
        with pytest.raises(grpc.RpcError) as e:
            list(query.StreamSearch(iter([vdb_pb2.SearchRequest()])))
        assert e.value.code() == grpc.StatusCode.UNAUTHENTICATED

        # correct token → the interceptor passes the call through to the
        # service (which answers NOT_FOUND for the empty index name —
        # anything but UNAUTHENTICATED proves auth cleared)
        with pytest.raises(grpc.RpcError) as e:
            admin.GetStats(
                vdb_pb2.StatsRequest(),
                metadata=(("authorization", "Bearer sekrit-42"),),
            )
        assert e.value.code() == grpc.StatusCode.NOT_FOUND

        # health stays open for unauthenticated k8s probes
        hc = health.Check(health_pb2.HealthCheckRequest())
        assert hc.status == health_pb2.HealthCheckResponse.SERVING
    finally:
        server.stop(grace=None)


def test_tls_round_trip(tmp_path):
    key = tmp_path / "server.key"
    cert = tmp_path / "server.crt"
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
         "-keyout", str(key), "-out", str(cert), "-days", "1",
         "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True,
    )
    server, port = _start(
        tmp_path, enable_tls=True,
        tls_cert_file=str(cert), tls_key_file=str(key),
    )
    try:
        creds = grpc.ssl_channel_credentials(
            root_certificates=cert.read_bytes()
        )
        channel = grpc.secure_channel(f"localhost:{port}", creds)
        grpc.channel_ready_future(channel).result(timeout=10)
        # over TLS the RPC reaches the service (NOT_FOUND for the empty
        # index name — the transport worked)
        admin = AdminServiceClient(channel)
        with pytest.raises(grpc.RpcError) as e:
            admin.GetStats(vdb_pb2.StatsRequest())
        assert e.value.code() == grpc.StatusCode.NOT_FOUND

        # plaintext client on the TLS port must not get through
        plain = grpc.insecure_channel(f"127.0.0.1:{port}")
        with pytest.raises(grpc.RpcError):
            AdminServiceClient(plain).GetStats(
                vdb_pb2.StatsRequest(), timeout=5
            )
    finally:
        server.stop(grace=None)


def test_enable_tls_without_certs_is_config_error(tmp_path):
    with pytest.raises(ValueError, match="tls_cert_file"):
        _start(tmp_path, enable_tls=True)


def test_enable_auth_without_token_is_config_error(tmp_path):
    yaml_path = tmp_path / "cfg.yaml"
    yaml_path.write_text("security:\n  enable_auth: true\n")
    with pytest.raises(ValueError, match="auth_token"):
        ServerConfig.from_yaml(str(yaml_path))


def test_auth_token_env_indirection(tmp_path, monkeypatch):
    monkeypatch.setenv("VDB_TEST_TOKEN", "from-env")
    cfg = ServerConfig(auth_token="$VDB_TEST_TOKEN")
    assert cfg.resolved_auth_token() == "from-env"
    monkeypatch.delenv("VDB_TEST_TOKEN")
    with pytest.raises(ValueError, match="unset environment"):
        cfg.resolved_auth_token()
