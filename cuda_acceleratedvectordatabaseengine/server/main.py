"""Server bootstrap (S1, ``server/main.cpp:127-214``): CLI + YAML config,
data-dir creation, device banner, gRPC server with health service, metrics
endpoint, graceful SIGINT/SIGTERM shutdown."""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import signal
import threading

import grpc

from cuda_acceleratedvectordatabaseengine.server.config import ServerConfig
from cuda_acceleratedvectordatabaseengine.server.grpc_api import (
    admin_service_handler,
    health_service_handler,
    query_service_handler,
)
from cuda_acceleratedvectordatabaseengine.server.health import (
    HealthServicer,
)
from cuda_acceleratedvectordatabaseengine.server.service import (
    AdminServiceImpl,
    QueryServiceImpl,
    VdbEngine,
)


class BearerAuthInterceptor(grpc.ServerInterceptor):
    """Static bearer-token auth (the reference's `enable_auth` placeholder,
    `/root/reference/configs/production.yaml:89-91`, made real): every
    vdb.* RPC must carry `authorization: Bearer <token>` metadata; the
    gRPC health service stays open so k8s probes and LB health checks
    work unauthenticated (the reference's probes assume that)."""

    _STREAM_STREAM = {"/vdb.QueryService/StreamSearch"}

    def __init__(self, token: str):
        self._expected = f"Bearer {token}"

        def abort_unary(request, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or invalid bearer token")

        def abort_stream(request_iterator, context):
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "missing or invalid bearer token")
            yield  # pragma: no cover — abort raises

        self._abort_unary = grpc.unary_unary_rpc_method_handler(abort_unary)
        self._abort_stream = grpc.stream_stream_rpc_method_handler(
            abort_stream
        )

    def intercept_service(self, continuation, handler_call_details):
        method = handler_call_details.method
        if method.startswith("/grpc.health."):
            return continuation(handler_call_details)
        md = dict(handler_call_details.invocation_metadata or ())
        if md.get("authorization") == self._expected:
            return continuation(handler_call_details)
        if method in self._STREAM_STREAM:
            return self._abort_stream
        return self._abort_unary


def _server_credentials(config: ServerConfig) -> grpc.ServerCredentials:
    """TLS credentials from the configured PEM files (the reference's
    `enable_tls` placeholder, `configs/production.yaml:84-88`, made real).
    A CA file upgrades to mutual TLS."""
    if not (config.tls_cert_file and config.tls_key_file):
        raise ValueError(
            "enable_tls requires tls_cert_file and tls_key_file"
        )
    with open(config.tls_key_file, "rb") as f:
        key = f.read()
    with open(config.tls_cert_file, "rb") as f:
        cert = f.read()
    ca = None
    if config.tls_ca_file:
        with open(config.tls_ca_file, "rb") as f:
            ca = f.read()
    return grpc.ssl_server_credentials(
        [(key, cert)],
        root_certificates=ca,
        require_client_auth=ca is not None,
    )


def build_server(config: ServerConfig):
    """Construct (grpc.Server, VdbEngine, HealthServicer) — separated from
    main() so tests can run an in-process server on an ephemeral port."""
    engine = VdbEngine(config)
    query = QueryServiceImpl(engine)
    admin = AdminServiceImpl(engine)
    health = HealthServicer()
    token = config.resolved_auth_token()
    server = grpc.server(
        concurrent.futures.ThreadPoolExecutor(
            max_workers=config.grpc_workers,
            thread_name_prefix="grpc-worker",
        ),
        options=[
            ("grpc.max_receive_message_length",
             config.max_message_mb * 1024 * 1024),
            ("grpc.max_send_message_length",
             config.max_message_mb * 1024 * 1024),
        ],
        interceptors=(
            (BearerAuthInterceptor(token),) if token else ()
        ),
    )
    server.add_generic_rpc_handlers((
        query_service_handler(query),
        admin_service_handler(admin),
        health_service_handler(health),
    ))
    if config.enable_tls:
        port = server.add_secure_port(
            config.address, _server_credentials(config)
        )
    else:
        port = server.add_insecure_port(config.address)
    return server, engine, health, port


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="GPU vector DB server")
    p.add_argument("--config", help="YAML config file")
    p.add_argument("--address", help="listen address host:port")
    p.add_argument("--data-path", dest="data_path")
    p.add_argument("--batch-size", dest="max_batch_size", type=int)
    p.add_argument("--coalesce-window", dest="coalesce_window_ms",
                   type=float, help="ms")
    p.add_argument("--metrics-port", dest="metrics_port", type=int)
    p.add_argument("--profile-port", dest="profile_port", type=int,
                   help="start a jax.profiler trace server on this port "
                        "(TensorBoard profile plugin / xprof)")
    p.add_argument("--shard-serving", dest="shard_serving",
                   choices=("auto", "on", "off"),
                   help="multi-chip serving over the device mesh")
    args = p.parse_args(argv)

    config = (
        ServerConfig.from_yaml(args.config) if args.config else ServerConfig()
    )
    config = config.apply_overrides(
        address=args.address,
        data_path=args.data_path,
        max_batch_size=args.max_batch_size,
        coalesce_window_ms=args.coalesce_window_ms,
        metrics_port=args.metrics_port,
        profile_port=args.profile_port,
        shard_serving=args.shard_serving,
    )
    os.makedirs(config.data_path, exist_ok=True)

    from cuda_acceleratedvectordatabaseengine.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    # device banner (reference check_cuda_availability, main.cpp:43-66)
    import jax

    devices = jax.devices()
    print(f"[vdb] devices: {[str(d) for d in devices]}")
    print(f"[vdb] listening on {config.address}, data at {config.data_path}")
    if config.enable_tls:
        mode = "mTLS" if config.tls_ca_file else "TLS"
        print(f"[vdb] {mode} enabled ({config.tls_cert_file})")
    if config.auth_token:
        print("[vdb] bearer-token auth required on vdb.* RPCs")

    server, engine, health, port = build_server(config)
    if engine.mesh is not None:
        print(f"[vdb] sharded serving over "
              f"{engine.mesh.devices.size} devices")
    if config.profile_port:
        from cuda_acceleratedvectordatabaseengine.utils.profiling import (
            start_trace_server,
        )

        if start_trace_server(config.profile_port):
            print(f"[vdb] jax profiler serving on :{config.profile_port} "
                  "(TensorBoard profile plugin / xprof)")
        else:
            print("[vdb] jax profiler unavailable")
    if config.metrics_enabled:
        try:
            engine.metrics.start_exposition(
                config.metrics_port, health_fn=health.snapshot
            )
            print(
                f"[vdb] metrics on :{config.metrics_port}/metrics, "
                f"health on :{config.metrics_port}/health"
            )
        except OSError as e:
            print(f"[vdb] metrics endpoint unavailable: {e}")
    server.start()

    stop_event = threading.Event()

    def handle(signum, _frame):
        print(f"[vdb] signal {signum}, shutting down...")
        health.set_status("", False)
        stop_event.set()

    signal.signal(signal.SIGINT, handle)
    signal.signal(signal.SIGTERM, handle)
    stop_event.wait()
    health.stop()
    server.stop(grace=5).wait()
    engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
