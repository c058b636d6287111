"""Request deadlines that propagate admission -> queue -> dispatch.

A ``Deadline`` is an absolute point on the monotonic clock, carried on
the request from the HTTP layer down: the schema accepts a relative
``deadline_ms`` budget, ``submit`` pins it to an absolute instant, the
dispatcher reaps expired queue entries *before* any device work is
spent on them, and ``wait`` stops blocking the handler thread the
moment the deadline lapses — every stage raising the same typed
``DeadlineExceeded`` (HTTP 504) with the stage it expired at.

Monotonic and absolute on purpose: a relative budget re-measured per
stage would silently extend under queueing, which is exactly when the
deadline matters.
"""

from __future__ import annotations

import time
from typing import Optional

from repro_torch.serve.resilience.errors import DeadlineExceeded

__all__ = ["Deadline", "DeadlineExceeded"]


class Deadline:
    """An absolute monotonic-clock deadline (immutable)."""

    __slots__ = ("t", "budget_s", "_clock")

    def __init__(self, t: float, *, budget_s: float = 0.0,
                 clock=time.monotonic):
        self.t = float(t)
        self.budget_s = float(budget_s)
        self._clock = clock

    @classmethod
    def after_ms(cls, budget_ms: float,
                 clock=time.monotonic) -> "Deadline":
        """Deadline ``budget_ms`` from now; the budget must be > 0."""
        ms = float(budget_ms)
        if not ms > 0:
            raise ValueError(f"deadline_ms must be > 0 ({budget_ms})")
        return cls(clock() + ms / 1e3, budget_s=ms / 1e3, clock=clock)

    def remaining_s(self) -> float:
        return self.t - self._clock()

    def expired(self) -> bool:
        return self._clock() >= self.t

    def check(self, stage: str, detail: str = "") -> None:
        """Raise ``DeadlineExceeded`` (504) if the deadline has passed."""
        over = self._clock() - self.t
        if over >= 0:
            raise DeadlineExceeded(
                f"deadline exceeded at {stage} "
                f"({self.budget_s * 1e3:.0f}ms budget, "
                f"{over * 1e3:.0f}ms over){': ' + detail if detail else ''}",
                stage=stage)

    def bound(self, timeout_s: Optional[float]) -> float:
        """The tighter of ``timeout_s`` and the remaining budget (>= 0),
        for handing to ``Event.wait``-style APIs."""
        rem = max(0.0, self.remaining_s())
        return rem if timeout_s is None else min(float(timeout_s), rem)

    def __repr__(self) -> str:
        return (f"Deadline(remaining={self.remaining_s() * 1e3:.1f}ms, "
                f"budget={self.budget_s * 1e3:.0f}ms)")
