"""Per-lane admission control: bounded queues, fast rejection, drain.

The front-end's backpressure contract: a lane admits a request only if
(a) its queue holds fewer than ``max_queue_depth`` waiting requests and
(b) the response bytes of everything admitted-but-unfinished stay under
``max_inflight_bytes``.  Over either bound the request is rejected
*immediately* with a retry-after hint — a 429 in the transport — instead
of queuing unboundedly until the client times out anyway (the same
fast-fail shape as the engine cache's bounded budget: reject at the
door, never wedge the fleet).

One deliberate exception mirrors the cache's oversized-keep semantics:
a request whose cost alone exceeds the byte bound is still admitted when
the lane is otherwise *empty* — rejecting it then would make it
permanently unservable, and serving it serializes it against nothing.

``close()`` flips the gate into draining: new admissions raise
``DrainingError`` (503) while everything already admitted proceeds —
the graceful-shutdown half of the contract.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Optional


class AdmissionError(Exception):
    """Lane over its queue-depth or in-flight-byte bound (HTTP 429)."""

    status = 429

    def __init__(self, message: str, *, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


class DrainingError(Exception):
    """Gate is draining for shutdown; nothing new admitted (HTTP 503)."""

    status = 503


class LaneGate:
    """Bounded admission for one serving lane.

    ``try_admit`` / ``pop`` / ``complete`` form the request lifecycle:
    admitted requests sit in the FIFO until the dispatcher ``pop``s
    them; their byte cost stays charged against the in-flight budget
    until ``complete`` — so the budget covers queued *and* dispatched
    work (the response buffers both hold alive).
    """

    def __init__(self, *, max_queue_depth: int = 64,
                 max_inflight_bytes: int = 256 << 20):
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth must be >= 1 "
                             f"({max_queue_depth})")
        if max_inflight_bytes < 1:
            raise ValueError(f"max_inflight_bytes must be >= 1 "
                             f"({max_inflight_bytes})")
        self.max_queue_depth = int(max_queue_depth)
        self.max_inflight_bytes = int(max_inflight_bytes)
        self._lock = threading.Lock()
        # guarded-by(_lock): _queue, _inflight_bytes, _inflight_reqs,
        # guarded-by(_lock): _closed, admitted, rejected
        self._queue: deque = deque()
        self._inflight_bytes = 0
        self._inflight_reqs = 0      # admitted and not yet completed
        self._closed = False
        self.admitted = 0
        self.rejected = 0

    # ------------------------------------------------------------ lifecycle
    def try_admit(self, item, cost_bytes: int,
                  retry_after_s: float = 0.1) -> None:
        """Admit ``item`` or raise; never blocks.

        ``retry_after_s`` is the caller's service-time hint (e.g. an
        EWMA of recent end-to-end latency) scaled here by the queue
        depth the retrying client would land behind.
        """
        cost = int(cost_bytes)
        with self._lock:
            if self._closed:
                raise DrainingError(
                    "lane is draining for shutdown; retry against a new "
                    "server instance")
            if len(self._queue) >= self.max_queue_depth:
                self.rejected += 1
                raise AdmissionError(
                    f"lane queue is full ({len(self._queue)}/"
                    f"{self.max_queue_depth} waiting)",
                    retry_after_s=retry_after_s * (len(self._queue) + 1))
            if (self._inflight_bytes + cost > self.max_inflight_bytes
                    and self._inflight_reqs > 0):
                self.rejected += 1
                raise AdmissionError(
                    f"lane in-flight budget is full ({self._inflight_bytes}"
                    f" + {cost} > {self.max_inflight_bytes} bytes)",
                    retry_after_s=retry_after_s * (self._inflight_reqs + 1))
            self._queue.append((item, cost))
            self._inflight_bytes += cost
            self._inflight_reqs += 1
            self.admitted += 1

    def pop(self) -> Optional[tuple]:
        """Next ``(item, cost_bytes)`` in FIFO order, or None.  The cost
        stays charged until ``complete(cost_bytes)``."""
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def complete(self, cost_bytes: int) -> None:
        with self._lock:
            self._inflight_bytes -= int(cost_bytes)
            self._inflight_reqs -= 1

    # -------------------------------------------------------------- queries
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def inflight(self) -> int:
        with self._lock:
            return self._inflight_reqs

    def idle(self) -> bool:
        """No queued and no dispatched-but-unfinished work."""
        with self._lock:
            return not self._queue and self._inflight_reqs == 0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "queued": len(self._queue),
                "inflight_requests": self._inflight_reqs,
                "inflight_bytes": self._inflight_bytes,
                "max_queue_depth": self.max_queue_depth,
                "max_inflight_bytes": self.max_inflight_bytes,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "draining": self._closed,
            }

    # ----------------------------------------------------------------- drain
    def close(self) -> None:
        """Stop admitting (already-admitted work proceeds)."""
        with self._lock:
            self._closed = True

    def reopen(self) -> None:
        with self._lock:
            self._closed = False
