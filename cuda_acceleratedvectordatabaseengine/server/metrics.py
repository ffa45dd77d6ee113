"""Metrics: per-index latency percentiles, recall, throughput, device memory
— with a REAL Prometheus exposition endpoint.

Reference S6/S10: ``MetricsCollector`` computes p50/p95/p99 from bounded
sample buffers and renders Prometheus text (``query_service.cpp:680-798``),
but the :8080 server is a placeholder loop (``health_service.cpp:161-218``)
and the recording calls in Search are commented out
(``query_service.cpp:158-160``). Here recording is wired in and exposition
uses ``prometheus_client``'s HTTP server. Metric names match the reference
(``README.md:188-191``): vdb_search_duration_milliseconds,
vdb_searches_total, vdb_gpu_memory_bytes, vdb_queries_per_second.
"""

from __future__ import annotations

import collections
import http.server
import json
import threading
import time

import numpy as np
from prometheus_client import (
    CONTENT_TYPE_LATEST,
    CollectorRegistry,
    Counter,
    Gauge,
    Histogram,
    generate_latest,
)


class MetricsCollector:
    MAX_SAMPLES = 10_000   # bounded buffers, query_service.cpp:782-788

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self._lock = threading.Lock()
        self._latencies: dict[str, collections.deque] = {}
        self._stages: dict[str, collections.deque] = {}
        self._recalls: dict[str, collections.deque] = {}
        self._search_counts: dict[str, int] = {}
        self._started = time.monotonic()
        self._total_queries = 0

        self.h_latency = Histogram(
            "vdb_search_duration_milliseconds",
            "Search latency (ms)",
            ["index"],
            buckets=(0.5, 1, 2, 5, 10, 20, 50, 100, 200, 500, 1000),
            registry=self.registry,
        )
        self.c_searches = Counter(
            "vdb_searches_total", "Total searches", ["index"],
            registry=self.registry,
        )
        self.g_device_mem = Gauge(
            "vdb_gpu_memory_bytes", "Device HBM bytes used by indices",
            registry=self.registry,
        )
        self.g_qps = Gauge(
            "vdb_queries_per_second", "Uptime-average QPS",
            registry=self.registry,
        )
        self.g_nvme_bw = Gauge(
            "vdb_nvme_bandwidth_bytes", "Host storage read bandwidth",
            registry=self.registry,
        )
        self.g_recall = Gauge(
            "vdb_search_recall", "Sampled recall@k", ["index"],
            registry=self.registry,
        )

    # ------------------------------------------------------------------ #
    # recording (the calls the reference commented out)
    # ------------------------------------------------------------------ #

    def record_search(self, index: str, latency_ms: float,
                      n_queries: int = 1) -> None:
        with self._lock:
            buf = self._latencies.setdefault(
                index, collections.deque(maxlen=self.MAX_SAMPLES)
            )
            buf.append(latency_ms)
            self._search_counts[index] = (
                self._search_counts.get(index, 0) + 1
            )
            self._total_queries += n_queries
            elapsed = max(time.monotonic() - self._started, 1e-9)
            self.g_qps.set(self._total_queries / elapsed)
        self.h_latency.labels(index=index).observe(latency_ms)
        self.c_searches.labels(index=index).inc()

    def record_stage(self, stage: str, ms: float) -> None:
        """Per-stage serving span (decode / queue_wait / dispatch / fetch /
        encode): the decomposition of server-side request latency the
        wire benchmarks report. The reference's per-request
        chrono timer measured one undifferentiated total
        (``query_service.cpp:132-139``)."""
        with self._lock:
            self._stages.setdefault(
                stage, collections.deque(maxlen=self.MAX_SAMPLES)
            ).append(ms)

    def get_stage_percentiles(self) -> dict:
        """{stage: {p50, p95, p99, max, mean, count}} over the sample
        window. ``max`` is load-bearing for stall forensics: the r4 wire
        runs showed fetch mean ≫ p99 — a handful of multi-second outliers
        beyond the p99 that only the max exposes."""
        with self._lock:
            snap = {k: np.asarray(v) for k, v in self._stages.items() if v}
        return {
            k: {
                "p50": float(np.percentile(a, 50)),
                "p95": float(np.percentile(a, 95)),
                "p99": float(np.percentile(a, 99)),
                "max": float(a.max()),
                "mean": float(a.mean()),
                "count": int(a.size),
            }
            for k, a in snap.items()
        }

    def reset_windows(self, index: str | None = None) -> None:
        """Clear the bounded percentile sample windows (per-index latency
        when ``index`` given, else all) plus the stage spans — so a
        benchmark scenario reads ITS OWN percentiles, not a window
        polluted by earlier traffic (the r4 wire bench's b1 "server p50"
        was really the previous scenario's). Monotonic Prometheus series
        (counters/histograms) are untouched."""
        with self._lock:
            if index is None:
                self._latencies.clear()
            else:
                self._latencies.pop(index, None)
            self._stages.clear()

    def record_recall(self, index: str, recall: float) -> None:
        with self._lock:
            buf = self._recalls.setdefault(
                index, collections.deque(maxlen=self.MAX_SAMPLES)
            )
            buf.append(recall)
        self.g_recall.labels(index=index).set(recall)

    def set_device_memory(self, nbytes: int) -> None:
        self.g_device_mem.set(nbytes)

    def set_storage_bandwidth(self, bytes_per_s: float) -> None:
        self.g_nvme_bw.set(bytes_per_s)

    # ------------------------------------------------------------------ #
    # queries (reference get_percentiles API, query_service.cpp:790-798)
    # ------------------------------------------------------------------ #

    def get_percentiles(self, index: str) -> dict:
        with self._lock:
            buf = self._latencies.get(index)
            if not buf:
                return {"p50": 0.0, "p95": 0.0, "p99": 0.0, "count": 0}
            arr = np.asarray(buf)
        return {
            "p50": float(np.percentile(arr, 50)),
            "p95": float(np.percentile(arr, 95)),
            "p99": float(np.percentile(arr, 99)),
            "count": int(self._search_counts.get(index, 0)),
        }

    def get_avg_recall(self, index: str) -> float:
        with self._lock:
            buf = self._recalls.get(index)
            return float(np.mean(buf)) if buf else 0.0

    def uptime_qps(self) -> float:
        with self._lock:
            elapsed = max(time.monotonic() - self._started, 1e-9)
            return self._total_queries / elapsed

    # ------------------------------------------------------------------ #
    # exposition
    # ------------------------------------------------------------------ #

    def prometheus_text(self) -> bytes:
        base = generate_latest(self.registry)
        stages = self.get_stage_percentiles()
        if not stages:
            return base
        lines = [
            "# TYPE vdb_stage_milliseconds gauge",
            "# HELP vdb_stage_milliseconds Serving stage latency "
            "decomposition",
        ]
        for stage, q in sorted(stages.items()):
            for stat in ("p50", "p95", "p99", "max", "mean"):
                lines.append(
                    f'vdb_stage_milliseconds{{stage="{stage}",'
                    f'stat="{stat}"}} {q[stat]:.4f}'
                )
            lines.append(
                f'vdb_stage_samples{{stage="{stage}"}} {q["count"]}'
            )
        return base + ("\n".join(lines) + "\n").encode()

    def start_exposition(self, port: int, health_fn=None) -> int:
        """Real ``/metrics`` + ``/health`` HTTP endpoints (what S10 stubbed:
        the reference's :8080 ``MetricsServer`` placeholder loop,
        ``server/health_service.cpp:161-218``, and the README's documented
        ``curl :8080/health`` / ``curl :8080/metrics`` surface,
        ``README.md:133-140``).

        ``health_fn`` (optional) returns a dict snapshot — typically
        :meth:`HealthServicer.snapshot` — rendered as JSON with HTTP 200
        when ``healthy`` else 503, so k8s HTTP probes and the healthcheck
        script get a real liveness signal rather than metrics text.
        Returns the bound port (useful with ``port=0`` in tests).
        """
        collector = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                path = self.path.split("?", 1)[0]
                if path == "/metrics":
                    body = collector.prometheus_text()
                    self.send_response(200)
                    self.send_header("Content-Type", CONTENT_TYPE_LATEST)
                elif path == "/health":
                    snap = health_fn() if health_fn else {"healthy": True}
                    snap = dict(snap)
                    snap.setdefault("healthy", True)
                    snap["status"] = (
                        "healthy" if snap["healthy"] else "unhealthy"
                    )
                    snap["uptime_s"] = round(
                        time.monotonic() - collector._started, 3
                    )
                    body = (json.dumps(snap) + "\n").encode()
                    self.send_response(200 if snap["healthy"] else 503)
                    self.send_header("Content-Type", "application/json")
                else:
                    body = b"not found\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet — structured logs only
                pass

        self._http = http.server.ThreadingHTTPServer(("", port), Handler)
        self._http.daemon_threads = True
        threading.Thread(
            target=self._http.serve_forever, name="vdb-metrics-http",
            daemon=True,
        ).start()
        return self._http.server_address[1]

    def stop_exposition(self) -> None:
        srv = getattr(self, "_http", None)
        if srv is not None:
            srv.shutdown()
            srv.server_close()
            self._http = None
