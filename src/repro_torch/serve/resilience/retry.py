"""Bounded retry with deterministic exponential backoff + jitter.

The dispatcher's answer to *transient* compile/dispatch failures: retry
up to ``max_attempts`` total attempts, sleeping
``base_s * multiplier**k`` (capped at ``max_s``) with seeded
proportional jitter between attempts.  Only ``TransientError``
subclasses (resilience/errors.py) are retried — deadline, breaker and
watchdog failures are rejections of work, not flaky work, and retrying
them would amplify exactly the overload they shed.

Deterministic by construction (the jitter stream comes from a seeded
``random.Random``), so the chaos regression suite can assert the exact
attempt count and backoff schedule a fault plan produces.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, Optional, Tuple, Type

from repro_torch.serve.resilience.errors import TransientError


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Attempt budget + backoff shape for one call site.

    ``max_attempts=1`` means no retries (first failure propagates) —
    the zero-behavior-change default for callers that opt out.
    """

    max_attempts: int = 3
    base_s: float = 0.05
    max_s: float = 2.0
    multiplier: float = 2.0
    jitter: float = 0.5              # +- fraction of the backoff
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(f"max_attempts must be >= 1 "
                             f"({self.max_attempts})")
        if self.base_s < 0 or self.max_s < 0 or self.multiplier < 1:
            raise ValueError("base_s/max_s must be >= 0 and "
                             f"multiplier >= 1 ({self})")
        if not (0.0 <= self.jitter <= 1.0):
            raise ValueError(f"jitter must be in [0, 1] ({self.jitter})")

    def backoffs(self) -> list:
        """The (deterministic) sleep before each retry, in seconds —
        ``max_attempts - 1`` entries."""
        rng = random.Random(self.seed)
        out = []
        for k in range(self.max_attempts - 1):
            raw = min(self.max_s, self.base_s * self.multiplier ** k)
            out.append(raw * (1.0 + self.jitter * (2 * rng.random() - 1)))
        return out


def call_with_retry(fn: Callable, policy: RetryPolicy, *,
                    retryable: Tuple[Type[BaseException], ...]
                    = (TransientError,),
                    sleep: Callable[[float], None] = time.sleep,
                    on_retry: Optional[Callable] = None):
    """Run ``fn()`` under the policy; returns its value or re-raises.

    ``on_retry(attempt, exc, backoff_s)`` fires before each backoff
    sleep (metrics hook).  Non-retryable exceptions propagate
    immediately; the last retryable failure propagates once the attempt
    budget is spent.
    """
    backoffs = policy.backoffs()
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retryable as exc:
            if attempt >= len(backoffs):
                raise
            delay = backoffs[attempt]
            if on_retry is not None:
                on_retry(attempt + 1, exc, delay)
            if delay > 0:
                sleep(delay)
