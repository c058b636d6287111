"""Multi-tenant traversal service: one router, many graphs, one cache —
the port of ``repro.serve.bfs_service``.

The serving counterpart of the compile-once lifecycle (core/engine.py),
rewritten as a multi-graph router.  Graphs register by name in a
``GraphCatalog``; each registered (graph, plan) pair is a *lane* — its
own ``SlotPool`` (serve/batcher.py) packing concurrent single-source
requests into the engine's source columns (Graph500-style batched
traversal as the serving batch dimension).  Requests carry a graph name
and are routed to their lane's queue.

Engines are never owned by the service: every lane resolves its compiled
engine through a shared ``EngineCache`` (serve/engine_cache.py) keyed by
``BFSPlan.plan_key()``, so

  * two services serving the same graph/options share one compiled
    engine,
  * the cache's device-byte budget bounds total engine memory across all
    tenants — a lane whose engine was evicted transparently recompiles
    on its next step,
  * hit/miss/evict/compile-time counters account the whole fleet.

``step()`` round-robins the lanes, dispatching every lane with live
slots via ``run_async`` *before* reading any result.  A traversal
completes in a single engine run, so every admitted request finishes
within its step; the rotation only decides admission order under
sustained load.  Duplicate sources within a lane share one engine column.

Lanes on one device: each lane's plans carry their ``LocalMesh`` and so
their device (``device=`` or ``mesh=`` per service or per lane; the
default is ``plan()``'s, CUDA or a raise without it).  A result's
distances live in its engine's reused buffer, and lanes whose plans key
equal share one engine, so every run here is preceded by
``engine.settle()``: the engine's previous result, if still unread, is
read back to the host before its buffer is reused.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.bfs import BFSOptions, INF, validate_sources
from repro_torch.core.engine import pick_bucket, plan_ladder
from repro_torch.serve.batcher import SlotPool
from repro_torch.serve.engine_cache import (EngineCache, GraphCatalog,
                                      default_engine_cache)
from repro_torch.serve.resilience import faults as _faults
from repro_torch.serve.resilience.errors import StrandedRequestError

DEFAULT_GRAPH = "default"

_UNSET = object()   # distinguishes "inherit the service default" from an
                    # explicit None (which plan() interprets, e.g. axis)


@dataclasses.dataclass
class TraversalRequest:
    rid: int
    source: int
    graph: Optional[str] = None          # None -> the sole registered graph
    dist: Optional[np.ndarray] = None    # (n_logical,) int32 when done
    levels: int = 0                      # eccentricity of this source's tree
    visited: int = 0
    done: bool = False
    error: Optional[BaseException] = None   # typed rejection (stranded
                                            # drains set StrandedRequestError)


class _Lane:
    """One served graph: routing state, its slot pool, its plan ladder.

    Holds *plans* (cheap metadata), never engines — engines are
    re-resolved through the cache at every step so budget evictions stay
    transparent to the lane.  ``plans`` is the lane's batch-size bucket
    ladder ``{S: BFSPlan}`` ascending: a step (or ``traverse``) with k
    distinct sources routes to the smallest rung with S >= k, so a lane
    under arbitrary fan-out only ever occupies a bounded set of compiled
    executables (the serving front-end's pad-to-bucket contract).
    """

    def __init__(self, name: str, graph, plans: Dict[int, "object"]):
        self.name = name
        self.graph = graph
        self.plans = dict(sorted(plans.items()))
        self.ladder = tuple(self.plans)
        self.pool = SlotPool(self.ladder[-1])
        self.n_logical = self.plan.graph.part.n_logical

    @property
    def plan(self):
        """The largest rung's plan (the lane's full-capacity shape —
        what single-rung call sites held before ladders existed)."""
        return self.plans[self.ladder[-1]]

    def plan_for(self, n_sources: int):
        """The smallest rung fitting ``n_sources`` distinct sources."""
        return self.plans[pick_bucket(n_sources, self.ladder)]

    def pending(self) -> int:
        return len(self.pool.queue) + int(self.pool.live().sum())

    def drained(self) -> bool:
        return self.pool.drained()


class BFSService:
    """Route traversal requests across many registered graphs.

    ``graphs`` may be a single sharded graph (registered under
    ``"default"`` — the single-tenant form older call sites use), a
    ``{name: graph}`` dict, or None (register lanes later via
    ``add_graph``).  Constructor keywords are per-service defaults;
    ``add_graph`` can override any of them per lane, so one service can
    mix 1-D and 2-D partitions, meshes and option sets.
    """

    def __init__(self, graphs=None, opts: BFSOptions = BFSOptions(), *,
                 mesh=None, axis=None, batch_slots: int = 4,
                 batch_buckets=None, partition=None, device=None,
                 cache: Optional[EngineCache] = None,
                 catalog: Optional[GraphCatalog] = None):
        self.catalog = catalog if catalog is not None else GraphCatalog()
        self.cache = cache if cache is not None else default_engine_cache()
        self._defaults = dict(opts=opts, mesh=mesh, axis=axis,
                              batch_slots=batch_slots,
                              batch_buckets=batch_buckets,
                              partition=partition, device=device)
        self._lanes: Dict[str, _Lane] = {}
        self._order: List[str] = []      # registration order, for rotation
        self._rr = 0
        if graphs is None:
            pass
        elif isinstance(graphs, dict):
            for name, g in graphs.items():
                self.add_graph(name, g)
        else:
            self.add_graph(DEFAULT_GRAPH, graphs)

    # ------------------------------------------------------------ registry
    def add_graph(self, name: str, graph=None, *, opts=_UNSET, mesh=_UNSET,
                  axis=_UNSET, batch_slots=_UNSET, batch_buckets=_UNSET,
                  partition=_UNSET, device=_UNSET) -> str:
        """Register a graph (or adopt one already in the catalog) and
        open its serving lane.  Planning happens now — invalid options
        fail at registration; compiling waits for the first step that
        serves the lane (through the shared cache).  Passing any keyword
        (including an explicit None, e.g. ``mesh=None`` for a p=1 2-D
        lane) overrides the service default for this lane only.

        ``batch_buckets`` opens the lane with a batch-size bucket ladder
        (e.g. ``(1, 8, 64)``): one plan per rung, slot pool sized to the
        largest rung, every dispatch routed to the smallest rung fitting
        its distinct-source count.  Without it the lane is a one-rung
        ladder at ``batch_slots`` — the pre-bucket behavior exactly.
        ``device`` is ``plan()``'s: the lane's device when it names no
        mesh (a mesh carries its own)."""
        if name in self._lanes:
            raise ValueError(f"graph {name!r} already has a serving lane")
        if graph is None:
            graph = self.catalog.get(name)
        else:
            self.catalog.register(name, graph)
        d = self._defaults

        def pick(val, key):
            return d[key] if val is _UNSET else val

        opts = pick(opts, "opts")
        if opts.mode == "queue":
            raise ValueError("BFSService batches sources; queue mode is "
                             "single-source — use dense or auto")
        buckets = pick(batch_buckets, "batch_buckets")
        ladder = tuple(buckets) if buckets else (pick(batch_slots,
                                                      "batch_slots"),)
        lane_mesh = pick(mesh, "mesh")
        lane_axis = axis if axis is not _UNSET else (
            d["axis"] if lane_mesh is d["mesh"] else None)
        lane_plans = plan_ladder(
            graph, opts, mesh=lane_mesh, axis=lane_axis, ladder=ladder,
            partition=pick(partition, "partition"),
            device=pick(device, "device"))
        self._lanes[name] = _Lane(name, graph, lane_plans)
        self._order.append(name)
        return name

    def graph_names(self) -> List[str]:
        return list(self._order)

    def lane(self, name: str) -> _Lane:
        try:
            return self._lanes[name]
        except KeyError:
            raise KeyError(f"no serving lane for graph {name!r}; lanes: "
                           f"{sorted(self._lanes)}") from None

    def _sole_lane(self) -> _Lane:
        if len(self._lanes) != 1:
            raise ValueError(
                f"service has {len(self._lanes)} lanes "
                f"({sorted(self._lanes)}); requests must name their graph")
        return self._lanes[self._order[0]]

    # single-tenant conveniences (the pre-router surface)
    @property
    def engine(self):
        """The sole lane's compiled engine (single-graph services)."""
        return self.cache.get_or_compile(self._sole_lane().plan)

    @property
    def pool(self) -> SlotPool:
        return self._sole_lane().pool

    @property
    def graph(self):
        return self._sole_lane().graph

    def cache_stats(self) -> dict:
        return self.cache.stats()

    # ------------------------------------------------------------- serving
    def submit(self, req: TraversalRequest) -> None:
        lane = (self.lane(req.graph) if req.graph is not None
                else self._sole_lane())
        req.graph = lane.name
        # Fail fast at the door instead of poisoning a whole batch.
        validate_sources([req.source], lane.n_logical)
        lane.pool.submit(req)

    def step(self) -> List[TraversalRequest]:
        """Serve one round: admit queued requests on every lane (rotating
        the start lane for fairness), dispatch all live lanes through
        ``run_async``, then collect.  Returns the finished requests."""
        if not self._order:
            return []
        k = len(self._order)
        rotation = [self._order[(self._rr + i) % k] for i in range(k)]
        self._rr = (self._rr + 1) % k

        inflight = []
        for name in rotation:
            lane = self._lanes[name]
            lane.pool.admit()
            live = lane.pool.live()
            if not live.any():
                continue
            # Requests for the same vertex share a source column.
            col_of = {}
            for i in np.where(live)[0]:
                src = lane.pool.slots[i].source
                if src not in col_of:
                    col_of[src] = len(col_of)
            uniq = sorted(col_of, key=col_of.get)
            # bucket routing: a round with few distinct sources runs on
            # the smallest fitting rung's engine, not the full-width plan
            engine = self.cache.get_or_compile(lane.plan_for(len(uniq)))
            # an earlier lane of this round may share the engine: read its
            # result back before the buffer is reused
            engine.settle()
            inflight.append((lane, live, col_of, engine.run_async(uniq)))

        finished = []
        for lane, live, col_of, res in inflight:
            dist = res.block().dist_host       # (n_logical, len(uniq))
            for i in np.where(live)[0]:
                r = lane.pool.slots[i]
                # copy: columns are views into one shared result buffer,
                # and requests for the same source share a column
                col = dist[:, col_of[r.source]].copy()
                reached = col < int(INF)
                r.dist = col
                r.levels = int(col[reached].max()) if reached.any() else 0
                r.visited = int(reached.sum())
                r.done = True
                finished.append(r)
        return finished

    def traverse_async(self, name: Optional[str], sources):
        """Dispatch one multi-source traversal on a lane's smallest
        fitting bucket; returns the un-blocked ``BFSResult`` (the remote
        front-end's dispatch path — lanes overlap via these handles).

        Sources are validated *here*, at the door: range against the
        lane's logical vertex count, duplicate detection, and the lane's
        largest-rung capacity all raise ``ValueError`` before any device
        work, so bad remote input maps to a 400-style rejection instead
        of surfacing as a device-side error mid-``step()``.
        """
        lane, engine, srcs, bucket = self.resolve(name, sources)
        return self.dispatch(lane.name, engine, srcs), bucket

    def resolve(self, name: Optional[str], sources):
        """The first half of ``traverse_async``: validate ``sources`` and
        compile (or fetch) the engine of the lane's smallest fitting
        bucket, running nothing.  Returns ``(lane, engine, sources,
        bucket)``.  The front end calls it outside its watchdog, so a slow
        compile serves as it does in the JAX package."""
        lane = self.lane(name) if name is not None else self._sole_lane()
        srcs = validate_sources(sources, lane.n_logical,
                                max_sources=lane.ladder[-1])
        plan_ = lane.plan_for(len(srcs))
        return (lane, self.cache.get_or_compile(plan_),
                [int(s) for s in srcs], plan_.num_sources)

    def dispatch(self, name: str, engine, sources):
        """The second half: the ``service.dispatch`` fault seam, then one
        run of a resolved engine (the level loop, which reads the device
        every level) after its previous result is read back."""
        _faults.fire("service.dispatch", name)
        engine.settle()
        return engine.run_async(sources)

    def traverse(self, name: Optional[str], sources):
        """Blocking ``traverse_async``: returns ``(BFSResult, bucket)``
        with the result synced (``dist_host`` is the padding-stripped
        (n_logical, len(sources)) distance matrix)."""
        res, bucket = self.traverse_async(name, sources)
        return res.block(), bucket

    def drained(self) -> bool:
        return all(lane.drained() for lane in self._lanes.values())

    def pending_by_lane(self) -> Dict[str, int]:
        """Per-lane queued + in-slot request counts (nonzero lanes only)."""
        return {name: lane.pending() for name, lane in self._lanes.items()
                if lane.pending()}

    def reject_stranded(self, reason: str) -> List[TraversalRequest]:
        """Fail every queued / in-slot request with a typed
        ``StrandedRequestError`` and empty the pools.

        This is the shutdown path's leak stopper: a request object whose
        holder is still waiting observes ``done=True`` with ``error``
        set, instead of sitting in a dead pool forever.  Returns the
        rejected requests (callers fold them into their ledger)."""
        rejected: List[TraversalRequest] = []
        for name in self._order:
            pool = self._lanes[name].pool
            stranded = pool.queue + [
                r for r in pool.slots if r is not None and not r.done]
            pool.queue.clear()
            pool.slots[:] = [None] * len(pool.slots)
            for r in stranded:
                r.error = StrandedRequestError(
                    f"request {r.rid} on lane {name!r} stranded: {reason}")
                r.done = True
                rejected.append(r)
        return rejected

    def run_until_drained(self, max_steps: int = 10_000,
                          timeout_s: Optional[float] = None):
        """Step until every submitted request on every lane has finished.

        Raises ``RuntimeError`` if the queues are not drained within
        ``max_steps`` service steps — previously this returned the partial
        result list silently, so a caller could mistake a truncated drain
        for completion and never see the still-queued requests.
        ``timeout_s`` bounds the drain by wall clock as well (checked
        between steps; a single stuck engine run is not interrupted): a
        deep-traversal tenant can exhaust hours before it exhausts
        ``max_steps``, and serving shutdown paths need a time bound, not
        a step bound.  The error names each lane's pending count so a
        stuck lane is identifiable instead of one opaque total.

        On that timeout every still-pending request is *rejected*, not
        leaked: each gets ``done=True`` and a typed
        ``StrandedRequestError`` in ``.error`` (see ``reject_stranded``),
        so callers holding request objects always observe an outcome.
        """
        done = []
        deadline = (time.monotonic() + timeout_s
                    if timeout_s is not None else None)
        for _ in range(max_steps):
            if self.drained():
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            done += self.step()
        if not self.drained():
            per_lane = ", ".join(f"{name}: {cnt}" for name, cnt
                                 in self.pending_by_lane().items())
            pending = sum(self.pending_by_lane().values())
            limit = (f"timeout_s={timeout_s}" if deadline is not None
                     and time.monotonic() >= deadline
                     else f"max_steps={max_steps}")
            self.reject_stranded(f"drain gave up at {limit}")
            raise RuntimeError(
                f"run_until_drained: {pending} request(s) still pending "
                f"after {limit} ({len(done)} finished, each rejected with "
                f"StrandedRequestError; per-lane pending: {per_lane}); "
                f"raise the bound or submit fewer requests")
        return done
