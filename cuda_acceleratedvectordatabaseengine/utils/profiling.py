"""Tracing/profiling hooks (SURVEY.md §5: the reference has no tracer —
only nvcc ``-lineinfo`` and ad-hoc chrono timers; its Jaeger flag is dead
config).

Two layers here:
  - ``start_trace_server`` / ``trace`` — the JAX profiler: serves a
    TensorBoard/XProf-compatible endpoint (``jax.profiler``), the JAX
    counterpart of nsight, so device steps can be inspected op by op;
  - ``Timer``/``timed`` — lightweight wall-clock spans feeding the metrics
    layer (the role of the reference's per-request chrono timing,
    ``query_service.cpp:132-139``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable


def start_trace_server(port: int = 9012) -> bool:
    """Start the JAX profiler server; connect with TensorBoard's profile
    plugin or ``jax.profiler.trace``. Returns False if unavailable."""
    try:
        import jax

        jax.profiler.start_server(port)
        return True
    except Exception:  # noqa: BLE001
        return False


@contextlib.contextmanager
def trace(name: str, log_dir: str | None = None):
    """Capture a device trace for the enclosed block (xprof format)."""
    import jax

    if log_dir:
        with jax.profiler.trace(log_dir):
            with jax.profiler.TraceAnnotation(name):
                yield
    else:
        with jax.profiler.TraceAnnotation(name):
            yield


class Timer:
    """Accumulating wall-clock span timer."""

    def __init__(self):
        self.total_s = 0.0
        self.count = 0

    @contextlib.contextmanager
    def span(self):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.total_s += time.monotonic() - t0
            self.count += 1

    @property
    def avg_ms(self) -> float:
        return 1000.0 * self.total_s / self.count if self.count else 0.0


def timed(fn: Callable, *args, **kwargs):
    """Run fn, returning (result, elapsed_ms); blocks on JAX outputs so the
    measurement covers device execution, not just dispatch."""
    import jax

    t0 = time.monotonic()
    out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    return out, (time.monotonic() - t0) * 1000.0
