"""Fault injection + resilience primitives for the serving stack — the
port of ``repro.serve.resilience``.

Six pieces, one contract — every failure a caller can see is typed with
its HTTP status, every recovery path is deterministic enough to replay:

  * ``errors``   — the typed taxonomy (504 deadline / 503 breaker /
    500 watchdog / transient-vs-permanent retry classifier).
  * ``faults``   — the seeded ``FaultPlan`` registry and the named
    injection points (``faults.fire``) the engine, cache, service and
    frontend consult; a no-op costing one global read when disabled.
  * ``deadline`` — absolute monotonic request deadlines propagating
    admission -> queue -> dispatch (reaped before device work).
  * ``retry``    — bounded deterministic exponential backoff for
    transient compile/dispatch failures.
  * ``breaker``  — the per-lane circuit breaker (open / half-open /
    closed, fast 503s, recovery-latency log).
  * ``watchdog`` — bounded device rounds; a stuck round fails its
    batch with a typed error while other lanes keep serving.
  * ``degrade``  — graceful-degradation arms (other rungs, split over
    a smaller bucket, the uncompressed wire tier).

Every module but ``degrade`` (which re-plans through the port's
``core.engine``) is stdlib-only, a copy of the JAX package's.
"""

from repro_torch.serve.resilience.breaker import CircuitBreaker
from repro_torch.serve.resilience.deadline import Deadline
from repro_torch.serve.resilience.degrade import (StitchedResult,
                                            degradation_arms,
                                            degraded_traverse)
from repro_torch.serve.resilience.errors import (CircuitOpenError,
                                           DeadlineExceeded,
                                           InjectedCompileError,
                                           InjectedDispatchError,
                                           InjectedError, ResilienceError,
                                           StrandedRequestError,
                                           StuckDispatchError,
                                           TransientError)
from repro_torch.serve.resilience.faults import (FaultPlan, FaultSpec,
                                           corrupt_bytes, fire, install)
from repro_torch.serve.resilience.faults import active as faults_active
from repro_torch.serve.resilience.retry import RetryPolicy, call_with_retry
from repro_torch.serve.resilience.watchdog import DispatchWatchdog

__all__ = [
    "CircuitBreaker", "Deadline", "DispatchWatchdog",
    "FaultPlan", "FaultSpec", "RetryPolicy", "StitchedResult",
    "CircuitOpenError", "DeadlineExceeded", "InjectedCompileError",
    "InjectedDispatchError", "InjectedError", "ResilienceError",
    "StrandedRequestError", "StuckDispatchError", "TransientError",
    "call_with_retry", "corrupt_bytes", "degradation_arms",
    "degraded_traverse", "faults_active", "fire", "install",
]
