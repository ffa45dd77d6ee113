"""grpc.health.v1 health service (S9, ``server/health_service.cpp:8-158``).

System health = device present and usable (a tiny jitted op round-trips) ∧
service marked up — the JAX analog of the reference's CUDA-device +
≥10%-free-VRAM gate (``health_service.cpp:119-157``). ``Watch`` streams
status on a poll loop, as in the reference (5 s poll).
"""

from __future__ import annotations

import threading
import time

from cuda_acceleratedvectordatabaseengine.server.proto import health_pb2

SERVING = health_pb2.HealthCheckResponse.SERVING
NOT_SERVING = health_pb2.HealthCheckResponse.NOT_SERVING
SERVICE_UNKNOWN = health_pb2.HealthCheckResponse.SERVICE_UNKNOWN


def device_usable() -> bool:
    """Probe the accelerator with a real tiny computation."""
    try:
        import jax
        import jax.numpy as jnp

        out = jax.jit(lambda a: a + 1)(jnp.zeros((1,)))
        return bool(out.block_until_ready()[0] == 1)
    except Exception:  # noqa: BLE001
        return False


class HealthServicer:
    """``Check`` never touches the device: a background daemon polls
    ``device_usable`` every ``poll_interval_s`` and ``Check`` reads the
    last-known flag. A probe enqueued behind a long compile or a large
    query batch would otherwise block the liveness RPC past any sane
    probe timeout (observed: cold-start health checks timing out behind
    the engine's warmup compiles) — exactly when orchestrators poll
    hardest. The reference polls on a thread too
    (``health_service.cpp:119-157``)."""

    def __init__(self, poll_interval_s: float = 5.0):
        self._status: dict[str, int] = {"": SERVING}
        self._lock = threading.Lock()
        self.poll_interval_s = poll_interval_s
        self._device_ok = True
        self._stopped = threading.Event()
        self._poller = threading.Thread(
            target=self._poll_loop, name="health-device-probe", daemon=True
        )
        self._poller.start()

    def stop(self) -> None:
        self._stopped.set()

    def set_status(self, service: str, serving: bool) -> None:
        with self._lock:
            self._status[service] = SERVING if serving else NOT_SERVING

    def _poll_loop(self) -> None:
        while not self._stopped.is_set():
            ok = device_usable()
            self._device_ok = ok
            self._stopped.wait(self.poll_interval_s)

    def _system_ok(self) -> bool:
        return self._device_ok

    def _check(self, service: str) -> int:
        with self._lock:
            if service not in self._status:
                return SERVICE_UNKNOWN
            st = self._status[service]
        if st == SERVING and not self._system_ok():
            return NOT_SERVING
        return st

    def snapshot(self) -> dict:
        """Health as a dict for the HTTP ``/health`` endpoint (the
        reference documents ``curl :8080/health``, ``README.md:133-136``,
        but its MetricsServer never implemented it)."""
        return {
            "healthy": self._check("") == SERVING,
            "device_ok": self._device_ok,
        }

    # gRPC handlers ------------------------------------------------------ #

    def Check(self, request, context):
        return health_pb2.HealthCheckResponse(
            status=self._check(request.service)
        )

    def Watch(self, request, context):
        last = None
        while context.is_active():
            st = self._check(request.service)
            if st != last:
                yield health_pb2.HealthCheckResponse(status=st)
                last = st
            time.sleep(self.poll_interval_s)
