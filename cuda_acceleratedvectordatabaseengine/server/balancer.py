"""Load management: circuit breaker, concurrency caps, adaptive batch/
timeout, priority queue (S7/S8, ``server/load_balancer.cpp``).

Unlike the reference's ``LoadBalancer`` — fully implemented but never
instantiated by ``main()`` (SURVEY.md §2.6) — these are wired into the
Search path by ``service.py``.
"""

from __future__ import annotations

import enum
import heapq
import itertools
import threading
import time


class CircuitState(enum.Enum):
    CLOSED = "closed"
    OPEN = "open"
    HALF_OPEN = "half_open"


class CircuitBreaker:
    """Per-service breaker: opens at error rate > threshold, cools down for
    ``open_seconds``, half-opens to probe, with exponential decay of the
    windowed counts (``load_balancer.cpp:193-268``)."""

    def __init__(
        self,
        error_threshold: float = 0.5,
        open_seconds: float = 30.0,
        decay: float = 0.95,
        min_requests: int = 10,
    ):
        self.error_threshold = error_threshold
        self.open_seconds = open_seconds
        self.decay = decay
        self.min_requests = min_requests
        self._lock = threading.Lock()
        self._state = CircuitState.CLOSED
        self._errors = 0.0
        self._total = 0.0
        self._opened_at = 0.0
        self._last_decay = time.monotonic()

    def _decay_counts(self) -> None:
        now = time.monotonic()
        # one decay step per elapsed 5 s window (reference health loop)
        steps = int((now - self._last_decay) / 5.0)
        if steps:
            factor = self.decay ** steps
            self._errors *= factor
            self._total *= factor
            self._last_decay = now

    def allow(self) -> bool:
        with self._lock:
            self._decay_counts()
            if self._state == CircuitState.OPEN:
                if time.monotonic() - self._opened_at >= self.open_seconds:
                    self._state = CircuitState.HALF_OPEN
                    return True
                return False
            return True

    def record(self, success: bool) -> None:
        with self._lock:
            self._decay_counts()
            self._total += 1
            if not success:
                self._errors += 1
            if self._state == CircuitState.HALF_OPEN:
                if success:
                    self._state = CircuitState.CLOSED
                    self._errors = self._total = 0.0
                else:
                    self._state = CircuitState.OPEN
                    self._opened_at = time.monotonic()
                return
            if (
                self._total >= self.min_requests
                and self._errors / self._total > self.error_threshold
            ):
                self._state = CircuitState.OPEN
                self._opened_at = time.monotonic()

    @property
    def state(self) -> CircuitState:
        with self._lock:
            return self._state


class ConcurrencyLimiter:
    """Overload guard: at the cap, requests are rejected (the caller maps
    this to RESOURCE_EXHAUSTED, ``load_balancer.cpp:47-51``)."""

    def __init__(self, max_concurrent: int = 256):
        self._sem = threading.BoundedSemaphore(max_concurrent)
        self.max_concurrent = max_concurrent
        self._active = 0
        self._lock = threading.Lock()

    def try_enter(self) -> bool:
        ok = self._sem.acquire(blocking=False)
        if ok:
            with self._lock:
                self._active += 1
        return ok

    def exit(self) -> None:
        with self._lock:
            self._active -= 1
        self._sem.release()

    @property
    def active(self) -> int:
        with self._lock:
            return self._active


class AdaptiveController:
    """EMA latency → adaptive timeout (3× avg, clamped) and LATENCY-aware
    batch sizing.

    The reference's heuristic shrinks batches as request concurrency rises
    (``load_balancer.cpp:75-101``) — correct when per-item GPU time
    dominates, but backwards on hardware where each device dispatch pays a
    large fixed cost (dispatch plus the query H2D transfer per batch).
    There, halving the batch roughly halves
    throughput, which *lengthens* queues under exactly the load that
    triggered the shrink (measured: wire bench r4 collapsed to deadline
    cascades at high stream fan-in). Batches therefore stay at full width
    unless the measured batch latency itself blows the budget — the only
    signal that actually says "this batch is too big"."""

    def __init__(self, base_batch: int = 64, latency_budget_ms: float = 500.0):
        self.base_batch = base_batch
        self.latency_budget_ms = latency_budget_ms
        self._ema_ms = 10.0
        self._lock = threading.Lock()

    def record_latency_ms(self, ms: float) -> None:
        with self._lock:
            self._ema_ms = 0.9 * self._ema_ms + 0.1 * ms

    def timeout_s(self) -> float:
        # Floor of 10 s (reference clamps [1 s, 30 s]): a batch that lands
        # on a cold (bucket, k, nprobe) combination pays an XLA compile.
        with self._lock:
            return min(max(3 * self._ema_ms / 1000.0, 10.0), 60.0)

    def batch_size(self, active: int = 0, cap: int = 0) -> int:
        """Device-batch weight cap. Load-invariant; shrinks only when the
        EMA dispatch→fetch wall time exceeds the latency budget (so one
        batch can never monopolize the device for longer than the SLA
        allows), and never below a quarter of base (below that, fixed
        dispatch cost dominates and shrinking is strictly worse)."""
        with self._lock:
            ema = self._ema_ms
        if ema > 2 * self.latency_budget_ms:
            return max(self.base_batch // 4, 1)
        if ema > self.latency_budget_ms:
            return max(self.base_batch // 2, 1)
        return self.base_batch


class Priority(enum.IntEnum):
    LOW = 0
    NORMAL = 1
    HIGH = 2
    URGENT = 3


class PriorityRequestQueue:
    """4-level priority queue, FIFO within level, timed dequeue (S8,
    ``load_balancer.cpp:273-329``)."""

    def __init__(self):
        self._heap: list = []
        self._counter = itertools.count()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)

    def put(self, item, priority: Priority = Priority.NORMAL) -> None:
        with self._cv:
            heapq.heappush(
                self._heap, (-int(priority), next(self._counter), item)
            )
            self._cv.notify()

    def get(self, timeout: float | None = None):
        with self._cv:
            if not self._heap:
                self._cv.wait(timeout=timeout)
            if not self._heap:
                return None
            return heapq.heappop(self._heap)[2]

    def drain(
        self,
        max_n: int,
        window_s: float,
        weight_fn=None,
        max_weight: int | None = None,
    ) -> list:
        """Batch dequeue: block until at least one item arrives, then wait
        out the coalescing window (or until ``max_n`` items are queued) and
        pop up to ``max_n`` items in priority order — the batcher-facing
        surface (used by ``RequestCoalescer``; the reference declared this
        queue and never called it, ``load_balancer.cpp:273-329``).

        ``weight_fn(item) -> int`` + ``max_weight`` bound the drained batch
        by total WEIGHT (for the serving coalescer: queries, not requests —
        a multi-query request counts its true device-batch contribution).
        Without it, 512 drained requests of 16 queries each once built an
        8192-query device tensor, far past every warmed bucket: a cold XLA
        compile mid-SLA, and a deadline cascade under stream fan-in. The
        first item is always taken, whatever its weight."""
        with self._cv:
            while not self._heap:
                self._cv.wait()
            deadline = time.monotonic() + window_s
            while len(self._heap) < max_n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            out = []
            weight = 0
            while self._heap and len(out) < max_n:
                peek = self._heap[0][2]   # None = the coalescer's stop
                if (                      # sentinel (weightless)
                    weight_fn is not None and max_weight is not None
                    and out and peek is not None
                ):
                    w = max(1, int(weight_fn(peek)))
                    if weight + w > max_weight:
                        break
                item = heapq.heappop(self._heap)[2]
                out.append(item)
                if weight_fn is not None and item is not None:
                    weight += max(1, int(weight_fn(item)))
            return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)
