"""Request coalescer: the windowed batcher that feeds the device.

Reference S4 (``server/query_service.h:130-167``, ``query_service.cpp:
587-636``): wait up to ``window`` or until ``max_batch`` requests, drain,
run one batched operation. Crucially, the reference's Search never feeds its
queue (SURVEY.md §2.6) — every RPC runs its own per-query device round trip.
Here coalescing IS the hot path: concurrent Search RPCs for the same index
merge into one fixed-shape device batch (padded to the bucket sizes in
``utils/batching.py``), which is what keeps the device fed and compile caches
warm.

Two reference surfaces that existed as dead code there are live here:
  - the pending queue is the 4-level ``PriorityRequestQueue`` (S8,
    ``load_balancer.cpp:273-329``) — urgent requests jump the batch line;
  - ``max_batch_fn`` lets the owner plug in the load-adaptive batch size
    (``AdaptiveController.batch_size``, ``load_balancer.cpp:75-85``).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import queue as q
import threading
import time
from typing import Any, Callable

from cuda_acceleratedvectordatabaseengine.server.balancer import (
    Priority,
    PriorityRequestQueue,
)


@dataclasses.dataclass
class _Pending:
    payload: Any
    future: concurrent.futures.Future
    enqueued_at: float


class QueueFullError(RuntimeError):
    """Raised by submit() when the pending queue is at ``max_queue`` —
    fail-fast admission instead of queueing work that will outlive its
    deadline (the overload mode VERDICT r2 flagged: timed-out items were
    still burning device time)."""


class RequestCoalescer:
    """Windowed batcher over a priority queue.

    ``batch_fn(payloads) -> results`` is called with the drained batch on a
    worker thread; result i resolves future i. Exceptions fail the whole
    drained batch (callers see the error, as with the reference's promise
    scatter, ``query_service.cpp:380-401``).

    Returned futures support ``cancel()``: a caller whose deadline expires
    while its item is still QUEUED prevents the device from ever running
    it (the drain calls ``set_running_or_notify_cancel`` and drops
    cancelled items before building the batch). Items already inside a
    running device batch are past cancellation — that bound is one batch.
    """

    def __init__(
        self,
        batch_fn: Callable[[list], list] | None = None,
        window_s: float = 0.002,
        max_batch: int = 64,
        name: str = "coalescer",
        max_batch_fn: Callable[[], int] | None = None,
        max_queue: int | None = None,
        dispatch_fn: Callable[[list], Callable[[], list]] | None = None,
        weight_fn: Callable[[Any], int] | None = None,
    ):
        """``dispatch_fn(payloads) -> finalize_thunk`` enables the
        PIPELINED mode: a dedicated finalize thread forces batch N−1's
        thunk (the result fetch) while the drain thread is already
        uploading and dispatching batch N, so the two transfer directions
        overlap. With
        only ``batch_fn`` the loop is synchronous (dispatch+fetch
        back-to-back), the reference's serial batcher shape.

        ``weight_fn(payload) -> int`` makes ``max_batch`` a bound on total
        WEIGHT (the serving path: queries per request) instead of item
        count — a drained batch then never exceeds the device batch width
        the warmed executables cover."""
        if (batch_fn is None) == (dispatch_fn is None):
            raise ValueError("exactly one of batch_fn/dispatch_fn")
        self.batch_fn = batch_fn
        self.dispatch_fn = dispatch_fn
        self.window_s = window_s
        self.max_batch = max_batch
        self.max_batch_fn = max_batch_fn
        self.max_queue = max_queue
        self.weight_fn = weight_fn
        self._shed = 0
        self._queue = PriorityRequestQueue()
        self._lock = threading.Lock()
        self._stop = False
        self._batches = 0
        self._items = 0
        # Pipelined mode: dispatched-but-unfetched batches hand off to the
        # finalize worker through a depth-1 queue. The put blocks while the
        # worker is still fetching the batch before last — bounding
        # in-flight device programs (each holds its device buffers)
        # to ~2 without ever stalling the first dispatch.
        self._inflight: "q.Queue" = q.Queue(maxsize=1)
        self._finalizer = None
        if dispatch_fn is not None:
            self._finalizer = threading.Thread(
                target=self._finalize_loop, name=f"{name}-finalize",
                daemon=True,
            )
            self._finalizer.start()
        self._worker = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._worker.start()

    # ------------------------------------------------------------------ #

    def submit(
        self, payload, priority: Priority = Priority.NORMAL
    ) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        # Enqueue under the same lock stop() takes: checking _stop and
        # releasing before the put() would let a concurrent stop() slip its
        # sentinel in first — the worker could drain it, see an empty queue,
        # and exit before this payload lands (future unresolved forever).
        with self._lock:
            if self._stop:
                raise RuntimeError("coalescer stopped")
            if (
                self.max_queue is not None
                and len(self._queue) >= self.max_queue
            ):
                self._shed += 1
                raise QueueFullError(
                    f"coalescer queue full ({self.max_queue} pending)"
                )
            self._queue.put(
                _Pending(payload, fut, time.monotonic()), priority
            )
        return fut

    def stats(self) -> dict:
        with self._lock:
            return {
                "batches": self._batches,
                "items": self._items,
                "avg_batch": self._items / max(self._batches, 1),
                "queued": len(self._queue),
                "shed": self._shed,
            }

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            # sentinel wakes the drain; URGENT so it can't starve behind a
            # backlog. Enqueued under the lock so it strictly follows every
            # accepted submit() (see submit's ordering comment).
            self._queue.put(None, Priority.URGENT)
        self._worker.join(timeout=5)

    # ------------------------------------------------------------------ #

    def _current_max_batch(self) -> int:
        if self.max_batch_fn is not None:
            try:
                return max(1, min(int(self.max_batch_fn()), self.max_batch))
            except Exception:  # noqa: BLE001 — sizing is advisory only
                pass
        return self.max_batch

    def _resolve(self, batch: list, thunk) -> None:
        """Force a dispatched batch's finalize thunk and scatter results
        (or the failure) onto its futures."""
        try:
            results = thunk()
            for p, r in zip(batch, results):
                p.future.set_result(r)
        except Exception as e:  # noqa: BLE001 — fail the whole batch
            for p in batch:
                if not p.future.done():
                    p.future.set_exception(e)

    def _finalize_loop(self) -> None:
        """Pipelined-mode fetch worker: forces each dispatched batch's
        finalize thunk as soon as it lands — concurrently with the drain
        thread's upload+dispatch of the NEXT batch, so the result fetch
        (D2H) never serializes against the query H2D."""
        while True:
            entry = self._inflight.get()
            if entry is None:
                return
            self._resolve(*entry)

    def _loop(self) -> None:
        while True:
            drained = self._queue.drain(
                self._current_max_batch(), self.window_s,
                weight_fn=(
                    (lambda p: self.weight_fn(p.payload))
                    if self.weight_fn is not None else None
                ),
                max_weight=(
                    self._current_max_batch()
                    if self.weight_fn is not None else None
                ),
            )
            # Transition each live item to RUNNING; cancelled futures
            # (caller deadline expired while queued) drop out here and
            # never cost a device slot.
            batch = [
                p for p in drained
                if p is not None and p.future.set_running_or_notify_cancel()
            ]
            with self._lock:
                stopping = self._stop
                if batch:
                    self._batches += 1
                    self._items += len(batch)
            if batch:
                if self.dispatch_fn is not None:
                    # Pipelined: dispatch NOW (async), hand the fetch to
                    # the finalize worker — batch N's upload+compute
                    # overlaps N−1's result fetch.
                    try:
                        thunk = self.dispatch_fn(
                            [p.payload for p in batch]
                        )
                        self._inflight.put((batch, thunk))
                    except Exception as e:  # noqa: BLE001
                        for p in batch:
                            if not p.future.done():
                                p.future.set_exception(e)
                else:
                    self._resolve(
                        batch,
                        lambda: self.batch_fn(
                            [p.payload for p in batch]
                        ),
                    )
            if stopping and len(self._queue) == 0:
                if self._finalizer is not None:
                    self._inflight.put(None)   # drains in FIFO order —
                    self._finalizer.join()     # after every real batch
                return
