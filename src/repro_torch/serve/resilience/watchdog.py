"""Dispatcher watchdog: bound a device round, abandon it if it wedges.

The frontend dispatcher used to block indefinitely on each lane's
result sync — one wedged device round (or injected stall) froze every
lane behind it.  ``DispatchWatchdog.guard(fn)`` runs ``fn`` on a
watched worker thread and waits at most ``timeout_s``: on time, the
value (or the callee's own exception) propagates exactly as a direct
call would; on timeout the in-flight batch entry is failed with a typed
``StuckDispatchError`` (HTTP 500) and the dispatcher moves on — other
lanes keep serving.

The abandoned worker cannot be killed (Python threads aren't), so it is
*tracked* instead: ``stuck()`` counts rounds still wedged right now,
which is what ``/readyz`` reports and what the chaos harness asserts
back to zero at the end of a soak (no-leak verdict).  Every guarded
call dispatches device work from exactly one thread at a time — the
dispatcher waits on the guard — so the engine-driving discipline the
frontend documents is preserved; only the *waiting* moved off-thread.
"""

from __future__ import annotations

import threading
import time

from repro_torch.serve.resilience.errors import StuckDispatchError


class _Round:
    """One guarded call's shared cell (worker writes, guard reads)."""

    __slots__ = ("value", "error", "done", "abandoned")

    def __init__(self):
        self.value = None
        self.error = None
        self.done = threading.Event()
        self.abandoned = False


class DispatchWatchdog:
    """Timeout + stuck-round accounting for dispatcher device calls."""

    def __init__(self, timeout_s: float, *, name: str = "bfs-watchdog"):
        if not timeout_s > 0:
            raise ValueError(f"timeout_s must be > 0 ({timeout_s})")
        self.timeout_s = float(timeout_s)
        self.name = name
        # guarded-by(_lock): trips, _stuck, _completed_late
        self._lock = threading.Lock()
        self.trips = 0               # total timed-out rounds
        self._stuck = 0              # abandoned rounds still running
        self._completed_late = 0     # abandoned rounds that returned
        self._seq = 0

    def guard(self, fn, *, label: str = ""):
        """Run ``fn()`` with a timeout; raise ``StuckDispatchError`` on
        expiry (the worker keeps running, tracked via ``stuck()``)."""
        cell = _Round()

        def _worker():
            try:
                cell.value = fn()
            except BaseException as exc:   # delivered to the guard side
                cell.error = exc
            finally:
                cell.done.set()
                self._on_worker_done(cell)

        self._seq += 1
        t = threading.Thread(target=_worker, daemon=True,
                             name=f"{self.name}-{self._seq}")
        t.start()
        if not cell.done.wait(self.timeout_s) and \
                self._mark_abandoned(cell):
            raise StuckDispatchError(
                f"dispatch round{' ' + label if label else ''} exceeded "
                f"the {self.timeout_s:.2f}s watchdog timeout; batch "
                "failed, round abandoned to its worker thread")
        if cell.error is not None:
            raise cell.error
        return cell.value

    def _mark_abandoned(self, cell: _Round) -> bool:
        """Abandon a timed-out round unless its worker finished in the
        race window between wait expiry and this call (then the guard
        falls through and delivers the value as on-time)."""
        with self._lock:
            if cell.done.is_set():
                return False
            cell.abandoned = True
            self.trips += 1
            self._stuck += 1
            return True

    def _on_worker_done(self, cell: _Round) -> None:
        with self._lock:
            if cell.abandoned:
                self._stuck -= 1
                self._completed_late += 1

    # ------------------------------------------------------------- queries
    def stuck(self) -> int:
        """Abandoned rounds still running (readiness gate input)."""
        with self._lock:
            return self._stuck

    def wait_idle(self, timeout_s: float = 5.0) -> bool:
        """Block until no round is stuck (chaos no-leak verdict)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.stuck() == 0:
                return True
            time.sleep(0.01)
        return self.stuck() == 0

    def snapshot(self) -> dict:
        with self._lock:
            return {"timeout_s": self.timeout_s, "trips": self.trips,
                    "stuck": self._stuck,
                    "completed_late": self._completed_late}
