"""Graceful-degradation arms: serve on a worse plan instead of failing —
the port of ``repro.serve.resilience.degrade``.

When a lane's preferred engine cannot be produced (its compile keeps
failing — injected or real), the dispatcher walks this module's *arms*
in order of how much they give up, and serves the request on the first
one that works:

1. **bucket:<S>** — another rung of the lane's ladder that still fits
   the request in one run (larger S: padded columns cost device work,
   nothing else).
2. **split:<S>** — a *smaller* rung, the request split into
   ``ceil(k/S)`` sequential runs whose distance columns are stitched
   host-side.  Latency degrades by the split factor; results stay
   bitwise-correct (each chunk is an independent exact traversal).
3. **wire:bytes** — the preferred rung re-planned on the uncompressed
   wire tier (``wire_format="bytes"``), for when the packed/compressed
   twins are what's poisoned.  A distinct ``plan_key()``, so the cache
   compiles it independently of the broken preferred entry.

Every arm resolves through the same shared ``EngineCache`` (budget,
coalescing and counters all apply), and only ``TransientError``s move
the walk to the next arm — a real programming error still propagates.
The arm label is returned so metrics can count degraded serves per
shape (`/metrics` ``degraded``) and the chaos ledger can attribute
recoveries.

A port engine's result lives in the engine's reused buffer, and a split
arm runs one engine several times: every run here is preceded by
``engine.settle()``, so each part is read back before the next one
reuses the buffer.  ``bytes_tier_plan`` re-plans on the base plan's own
mesh, and so on its device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serve.resilience.errors import TransientError


class _HostRunStats:
    """Merged host-side stats of a split traversal (duck-types
    ``BFSRunStats``: ``block()`` no-ops, ``to_host()`` aggregates)."""

    def __init__(self, parts):
        self._merged = None
        self._parts = parts

    def block(self):
        return self

    def to_host(self) -> dict:
        if self._merged is None:
            hosts = [p.run_stats.to_host() for p in self._parts]
            modes = {ph: sum(h["mode_counts"][ph] for h in hosts)
                     for ph in ("dense", "queue", "bottom_up")}
            self._merged = {
                "levels": max(h["levels"] for h in hosts),
                "comm_bytes": float(sum(h["comm_bytes"] for h in hosts)),
                "overflowed": any(h["overflowed"] for h in hosts),
                "mode_counts": modes,
                "sieve_hits": sum(h["sieve_hits"] for h in hosts),
            }
        return self._merged


class StitchedResult:
    """A split-arm traversal: chunk results glued back into one
    (n_logical, k) distance matrix, in request source order.  Duck-types
    the slice of ``BFSResult`` the frontend consumes (``block()``,
    ``dist_host``, ``run_stats``)."""

    def __init__(self, parts, n_sources: int):
        self._parts = list(parts)
        self.n_sources = int(n_sources)
        self.n_logical = parts[0].n_logical
        self.run_stats = _HostRunStats(self._parts)

    def block(self) -> "StitchedResult":
        for p in self._parts:
            p.block()
        return self

    @property
    def dist_host(self) -> np.ndarray:
        return np.concatenate([p.dist_host for p in self._parts], axis=1)


def bytes_tier_plan(lane, bucket: int):
    """The lane rung's uncompressed-wire twin (planned lazily, cached
    on the lane).  None when the rung already serves the bytes tier."""
    from repro_torch.core.engine import plan as plan_fn

    base = lane.plans[bucket]
    if base.opts.wire_format == "bytes":
        return None
    cache = getattr(lane, "_bytes_plans", None)
    if cache is None:
        cache = {}
        lane._bytes_plans = cache
    if bucket not in cache:
        opts = dataclasses.replace(base.opts, wire_format="bytes")
        cache[bucket] = plan_fn(
            lane.graph, opts, mesh=base.mesh, axis=base.axis,
            num_sources=bucket, partition=base.partition)
    return cache[bucket]


def degradation_arms(lane, n_sources: int):
    """Yield ``(label, plan, split_size)`` fallbacks, best first.
    ``split_size`` is None for single-run arms."""
    from repro_torch.core.engine import pick_bucket

    preferred = pick_bucket(n_sources, lane.ladder)
    for s in lane.ladder:                          # other fitting rungs
        if s != preferred and s >= n_sources:
            yield f"bucket:{s}", lane.plans[s], None
    smaller = [s for s in lane.ladder if s < n_sources]
    for s in reversed(smaller):                    # fewest chunks first
        yield f"split:{s}", lane.plans[s], s
    safe = bytes_tier_plan(lane, preferred)
    if safe is not None:
        yield "wire:bytes", safe, None


def _settled_run(engine, srcs):
    engine.settle()                    # the previous result's buffer
    return engine.run_async(srcs)


def degraded_traverse(service, name: str, sources, guard=None):
    """Serve ``sources`` on the first working arm of lane ``name``.

    Returns ``(result, bucket, arm_label)`` — result un-blocked for
    single-run arms (the dispatcher pipelines it like any other), fully
    synced for split arms.  Re-raises the last transient failure when
    every arm is exhausted.  ``guard(fn)``, when given, wraps each
    engine run (the front end's watchdog); an arm's compile runs outside
    it.
    """
    lane = service.lane(name)
    srcs = [int(s) for s in sources]
    run = guard if guard is not None else (lambda fn: fn())
    last_exc = None
    for label, plan_, split in degradation_arms(lane, len(srcs)):
        try:
            engine = service.cache.get_or_compile(plan_)
            if split is None:
                return (run(lambda: _settled_run(engine, srcs)),
                        plan_.num_sources, label)
            parts = [run(lambda chunk=srcs[i:i + split]:
                         _settled_run(engine, chunk).block())
                     for i in range(0, len(srcs), split)]
            return StitchedResult(parts, len(srcs)), split, label
        except TransientError as exc:
            last_exc = exc
    if last_exc is None:
        last_exc = TransientError(
            f"lane {name!r} has no degradation arm for "
            f"{len(srcs)} sources")
    raise last_exc
