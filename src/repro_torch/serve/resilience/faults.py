"""Deterministic fault injection for the serving stack (chaos layer) —
a copy of ``repro.serve.resilience.faults``.

A ``FaultPlan`` is a seeded, schedulable set of ``FaultSpec``s.  Code
under test consults the plan at *named injection points*::

    faults.fire("cache.compile", tag="S=4 wire=auto partition=1d")

``fire`` is a no-op returning ``None`` when no plan is installed — the
fault layer costs one global read on the hot path and changes nothing
with faults disabled (the acceptance bar: bitwise-identical traversals,
unchanged ``plan_key()``).  With a plan installed, the first armed spec
matching ``(site, tag)`` performs its action:

  * ``kind="fail"``  — raise the spec's typed exception (default
    ``InjectedError``): compile failures, device-dispatch exceptions.
  * ``kind="stall"`` — ``time.sleep(delay_s)``: dispatcher stalls and
    slow collectives (the watchdog's and deadline reaper's prey).
  * ``kind="storm"`` — call the site's ``storm=`` callback: the engine
    cache passes its evict-everything thunk (eviction storms).
  * ``kind="corrupt"`` — no side effect here; the caller receives the
    spec and applies ``corrupt_bytes`` to its payload (malformed wire
    bodies are built by the *sender*, so the receiving stack's 400/413
    mapping is what gets exercised).

Determinism: specs fire on exact hit windows (``after`` matches are
skipped, then ``times`` firings happen) and an optional seeded Bernoulli
draw (``p``) from a per-spec ``random.Random`` derived from the plan
seed — same plan + same call sequence -> same faults, which is what lets
the chaos regression suite replay a schedule and assert the exact
breaker/retry/deadline trajectory.

Installation points are harness-controlled (tests, chaos harnesses),
never concurrent with each other; ``fire`` itself is thread-safe across
serving threads.  Sites in the tree today::

    cache.get        engine_cache.get_or_compile entry   (storm)
    cache.compile    before plan.compile() in the cache  (fail)
    engine.compile   BFSEngine.__init__                  (fail)
    engine.dispatch  BFSEngine.run_async pre-dispatch    (fail, stall)
    service.dispatch BFSService.traverse_async, tag=lane (fail, stall)
    frontend.loop    each dispatcher round               (stall)
    frontend.block   inside the watchdog-guarded sync    (stall)
    client.payload   chaos-harness request encoding      (corrupt)

Import-light (stdlib only) by the same contract as errors.py.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time
from typing import Dict, List, Optional, Tuple, Type

from repro_torch.serve.resilience.errors import InjectedError


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault: where it fires, what it does, when.

    ``site`` must match the injection point exactly; ``match`` is a
    substring test against the point's ``tag`` (empty matches every
    tag).  Hit accounting is per-spec: the first ``after`` matching
    hits pass through, the next ``times`` fire (None = unlimited), each
    gated by a seeded Bernoulli draw of probability ``p``.
    """

    site: str
    kind: str = "fail"              # fail | stall | storm | corrupt
    match: str = ""                 # substring of the site's tag
    exc: Optional[Type[BaseException]] = None   # kind="fail" class
    message: str = ""
    delay_s: float = 0.05           # kind="stall" sleep
    p: float = 1.0                  # per-hit firing probability
    after: int = 0                  # matching hits to skip first
    times: Optional[int] = None     # firings before the spec disarms

    _KINDS = ("fail", "stall", "storm", "corrupt")

    def __post_init__(self):
        if self.kind not in self._KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {self._KINDS}")
        if not (0.0 <= self.p <= 1.0):
            raise ValueError(f"p must be in [0, 1] ({self.p})")
        if self.after < 0 or (self.times is not None and self.times < 1):
            raise ValueError(f"after must be >= 0 and times >= 1 "
                             f"(after={self.after}, times={self.times})")


class FaultPlan:
    """A seeded schedule of faults plus the record of what fired.

    ``records`` (one ``(site, tag, spec_index, kind)`` tuple per firing)
    and ``summary()`` are what the chaos harness ships in
    ``BENCH_chaos.json`` — the ground truth against which every
    response's typed status is checked.
    """

    def __init__(self, specs, *, seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = int(seed)
        # guarded-by(_lock): _hits, _fired, records
        self._lock = threading.Lock()
        self._hits: List[int] = [0] * len(self.specs)
        self._fired: List[int] = [0] * len(self.specs)
        self.records: List[tuple] = []
        # per-spec deterministic streams, independent of firing order of
        # *other* specs (each spec draws only on its own matching hits)
        self._rngs = [random.Random(self.seed * 1_000_003 + i)
                      for i in range(len(self.specs))]

    def arm(self, site: str, tag: str) -> Optional[FaultSpec]:
        """First spec firing for this ``(site, tag)`` hit, with hit
        accounting updated; None when nothing fires."""
        with self._lock:
            for i, spec in enumerate(self.specs):
                if spec.site != site or spec.match not in tag:
                    continue
                self._hits[i] += 1
                if self._hits[i] <= spec.after:
                    continue
                if spec.times is not None and self._fired[i] >= spec.times:
                    continue
                if spec.p < 1.0 and self._rngs[i].random() >= spec.p:
                    continue
                self._fired[i] += 1
                self.records.append((site, tag, i, spec.kind))
                return spec
        return None

    def summary(self) -> dict:
        """Per-spec and per-kind firing counts (chaos ledger rows)."""
        with self._lock:
            by_kind: Dict[str, int] = {}
            per_spec = []
            for i, spec in enumerate(self.specs):
                by_kind[spec.kind] = by_kind.get(spec.kind, 0) \
                    + self._fired[i]
                per_spec.append({
                    "site": spec.site, "kind": spec.kind,
                    "match": spec.match, "hits": self._hits[i],
                    "fired": self._fired[i],
                })
            return {"seed": self.seed, "fired_total": len(self.records),
                    "by_kind": by_kind, "specs": per_spec}


# ---------------------------------------------------------------------------
# The process-wide active plan (harness-installed; fire() reads it)
# ---------------------------------------------------------------------------

_active: Optional[FaultPlan] = None
_install_lock = threading.Lock()


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install ``plan`` as the process-wide fault schedule; returns the
    previous one.  ``None`` disables injection entirely."""
    global _active
    with _install_lock:
        prev, _active = _active, plan
        return prev


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped installation (tests / the chaos harness)."""
    prev = install(plan)
    try:
        yield plan
    finally:
        install(prev)


def fire(site: str, tag: str = "", **ctx) -> Optional[FaultSpec]:
    """Consult the active plan at one injection point.

    Raises / sleeps / storms per the matched spec's kind; returns the
    spec (callers of ``corrupt`` sites apply it themselves) or None.
    The no-plan fast path is one global read — serving threads pay
    nothing when chaos is off.
    """
    plan = _active
    if plan is None:
        return None
    spec = plan.arm(site, tag)
    if spec is None:
        return None
    if spec.kind == "fail":
        exc = spec.exc or InjectedError
        raise exc(spec.message
                  or f"injected {exc.__name__} at {site} (tag={tag!r})")
    if spec.kind == "stall":
        time.sleep(spec.delay_s)
    elif spec.kind == "storm":
        storm = ctx.get("storm")
        if storm is not None:
            storm()
    return spec


def plan_tag(plan) -> str:
    """The tag string plan-keyed injection points fire with, so specs
    can target one bucket / wire tier / partition scheme by substring
    (e.g. ``match="S=4"`` poisons only the 4-source rung's compiles)."""
    opts = plan.opts
    return (f"S={plan.num_sources} mode={opts.mode} "
            f"wire={opts.wire_format} partition={plan.partition}")


def corrupt_bytes(payload: bytes, spec: FaultSpec, seed: int = 0) -> bytes:
    """Deterministically mangle a wire payload (kind="corrupt" sites).

    Three corruption shapes, chosen by seed: truncation (framing lies),
    byte flips mid-body (invalid JSON), and a non-JSON prefix — each of
    which the receiving schema layer must answer with a 400-family
    status, never a crash or a hang.
    """
    rng = random.Random(seed)
    shape = rng.randrange(3)
    if shape == 0 and len(payload) > 2:
        return payload[: rng.randrange(1, len(payload))]
    if shape == 1 and payload:
        buf = bytearray(payload)
        for _ in range(1 + rng.randrange(3)):
            buf[rng.randrange(len(buf))] ^= 0xFF
        return bytes(buf)
    return b"\x00not-json\x00" + payload
