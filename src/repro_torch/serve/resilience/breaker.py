"""Per-lane circuit breaker: fail fast while a lane is wedged.

The classic three-state machine, sized for the serving dispatcher:

* **closed** — normal serving; consecutive failures are counted and
  ``failure_threshold`` of them in a row open the circuit.
* **open** — every request is rejected immediately with a typed
  ``CircuitOpenError`` (HTTP 503 + Retry-After = remaining cooldown);
  no compile or device work is attempted, so one poisoned lane cannot
  absorb the fleet's dispatcher time.  After ``reset_timeout_s`` the
  breaker transitions to half-open.
* **half-open** — ``half_open_probes`` trial requests are let through;
  one success closes the circuit, one failure re-opens it (with a fresh
  cooldown).

All transitions are timestamped into a bounded ``transitions`` log so
the chaos harness can compute recovery latencies (open -> closed) and
``/metrics`` can show the trajectory, not just the current state.
Clock injection (``clock=``) keeps the state machine unit-testable
without sleeping.
"""

from __future__ import annotations

import threading
import time

from repro_torch.serve.resilience.errors import CircuitOpenError

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

_MAX_TRANSITIONS = 256


class CircuitBreaker:
    """Thread-safe three-state breaker for one serving lane."""

    def __init__(self, *, failure_threshold: int = 5,
                 reset_timeout_s: float = 30.0, half_open_probes: int = 1,
                 name: str = "", clock=time.monotonic):
        if failure_threshold < 1:
            raise ValueError(f"failure_threshold must be >= 1 "
                             f"({failure_threshold})")
        if reset_timeout_s < 0:
            raise ValueError(f"reset_timeout_s must be >= 0 "
                             f"({reset_timeout_s})")
        if half_open_probes < 1:
            raise ValueError(f"half_open_probes must be >= 1 "
                             f"({half_open_probes})")
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_probes = int(half_open_probes)
        self.name = name
        self._clock = clock
        # guarded-by(_lock): _state, _consecutive, _opened_at,
        # guarded-by(_lock): _probes_left, opened, rejected_fast,
        # guarded-by(_lock): transitions
        self._lock = threading.Lock()
        self._state = CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probes_left = 0
        self.opened = 0              # total open transitions
        self.rejected_fast = 0       # requests shed while open
        self.transitions = [(CLOSED, 0.0)]

    # audit: allow(LK001) -- transition helper; every caller holds _lock
    def _set_state(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self.transitions.append((state, self._clock()))
            del self.transitions[:-_MAX_TRANSITIONS]

    # audit: allow(LK001) -- cooldown check; every caller holds _lock
    def _tick(self) -> None:
        """Open -> half-open once the cooldown has elapsed."""
        if self._state == OPEN and \
                self._clock() - self._opened_at >= self.reset_timeout_s:
            self._set_state(HALF_OPEN)
            self._probes_left = self.half_open_probes

    # ------------------------------------------------------------- gating
    def admits(self) -> bool:
        """Non-consuming check (the admission door's fast 503): False
        only while hard-open.  Half-open admits — the admitted request
        becomes a probe at dispatch time."""
        with self._lock:
            self._tick()
            return self._state != OPEN

    def allow(self) -> bool:
        """Consuming check at dispatch: closed -> True; half-open ->
        True while probe slots remain; open -> False (counted)."""
        with self._lock:
            self._tick()
            if self._state == CLOSED:
                return True
            if self._state == HALF_OPEN and self._probes_left > 0:
                self._probes_left -= 1
                return True
            self.rejected_fast += 1
            return False

    def reject_error(self) -> CircuitOpenError:
        """The typed rejection for the current open period."""
        with self._lock:
            remaining = max(0.0, self.reset_timeout_s
                            - (self._clock() - self._opened_at))
            return CircuitOpenError(
                f"circuit breaker open on lane {self.name!r} after "
                f"{self.failure_threshold} consecutive failures; "
                f"half-open probe in {remaining:.2f}s",
                retry_after_s=max(0.05, remaining))

    # ------------------------------------------------------------ outcomes
    def record_success(self) -> None:
        with self._lock:
            self._consecutive = 0
            if self._state != CLOSED:
                self._set_state(CLOSED)

    def record_failure(self) -> None:
        with self._lock:
            self._tick()
            if self._state == HALF_OPEN:
                # a failed probe re-opens with a fresh cooldown
                self._set_state(OPEN)
                self._opened_at = self._clock()
                self.opened += 1
                return
            self._consecutive += 1
            if self._state == CLOSED and \
                    self._consecutive >= self.failure_threshold:
                self._set_state(OPEN)
                self._opened_at = self._clock()
                self.opened += 1

    # ------------------------------------------------------------- queries
    def state(self) -> str:
        with self._lock:
            self._tick()
            return self._state

    def snapshot(self) -> dict:
        with self._lock:
            self._tick()
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "failure_threshold": self.failure_threshold,
                "reset_timeout_s": self.reset_timeout_s,
                "opened": self.opened,
                "rejected_fast": self.rejected_fast,
                "transitions": [(s, round(t, 4))
                                for s, t in self.transitions[-8:]],
            }

    def recovery_latencies_s(self) -> list:
        """Durations of completed open -> ... -> closed excursions."""
        with self._lock:
            out, t_open = [], None
            for state, t in self.transitions:
                if state == OPEN and t_open is None:
                    t_open = t
                elif state == CLOSED and t_open is not None:
                    out.append(t - t_open)
                    t_open = None
            return out
