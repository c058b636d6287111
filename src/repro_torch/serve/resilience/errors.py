"""Typed failure taxonomy of the resilient serving stack.

Every failure the serving layers can surface to a caller is one of
these classes, each carrying the HTTP status the transport maps it to —
so the contract "504 deadline / 503 breaker / 429 admission" is encoded
in the type, not re-derived per call site, and the chaos harness can
assert that every injected fault resolved to exactly one of them.

``TransientError`` is the retry classifier: the dispatcher's bounded
retry-with-backoff (resilience/retry.py) retries *only* subclasses of
it.  Injected faults (resilience/faults.py) raise the ``Injected*``
subclasses, which are transient by construction — a retried compile or
dispatch may succeed on the next attempt once the scheduled fault has
burned its firing budget.  Permanent conditions (deadline passed,
breaker open, watchdog trip, stranded drain) are deliberately *not*
transient: retrying them in-process wastes the very capacity they
protect.

Import-light on purpose (stdlib only): core/engine.py and
serve/engine_cache.py consult the fault layer, so nothing here may pull
in torch or the serving stack.
"""

from __future__ import annotations


class ResilienceError(Exception):
    """Base of the typed serving-failure taxonomy.

    ``status`` is the HTTP code the transport answers with;
    ``retry_after_s`` (when > 0) becomes the ``Retry-After`` hint.
    """

    status = 500
    retry_after_s = 0.0


class TransientError(ResilienceError):
    """A failure worth one more attempt (the retry classifier)."""

    status = 503


class InjectedError(TransientError):
    """Generic fault-injection failure (chaos testing)."""


class InjectedCompileError(InjectedError):
    """Injected at a compile seam: ``plan.compile()`` 'failed'."""


class InjectedDispatchError(InjectedError):
    """Injected at a dispatch seam: the device round 'failed'."""


class DeadlineExceeded(ResilienceError):
    """The request's deadline passed before it was served (HTTP 504).

    Raised at admission (already expired), at queue reap time (expired
    while waiting — before any device work is spent on it), or by
    ``wait`` when the deadline lapses with the request still queued.
    """

    status = 504

    def __init__(self, message: str, *, stage: str = "queue"):
        super().__init__(message)
        self.stage = stage          # admit | queue | wait


class CircuitOpenError(ResilienceError):
    """The lane's circuit breaker is open; fast-fail (HTTP 503)."""

    status = 503

    def __init__(self, message: str, *, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = max(0.0, float(retry_after_s))


class StuckDispatchError(ResilienceError):
    """The dispatcher watchdog timed out a device round (HTTP 500).

    The in-flight batch is failed with this error; the abandoned round
    keeps running on its worker thread until the device returns, and the
    lane's breaker records the failure so repeats open the circuit.
    """

    status = 500


class StrandedRequestError(ResilienceError):
    """``run_until_drained`` hit its bound with this request pending.

    Attached to each stranded request (and the request marked done) so
    in-process callers polling ``req.done`` never hang on work the
    service has given up on.
    """

    status = 503
