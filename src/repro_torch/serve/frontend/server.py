"""The HTTP transport + dispatcher over ``BFSService`` — the port of
``repro.serve.frontend.server``; the same request body gets the same JSON
response, timing fields aside.

Threading model: ``ThreadingHTTPServer`` handler threads do the cheap
host-side work — parse/validate the JSON body, admit against the lane's
gate, then block on the request's completion event and serialize the
response.  A single *dispatcher* thread owns all device interaction: it
round-robins the lanes, pops at most one admitted request per lane per
round, dispatches every popped request through
``BFSService.traverse_async`` (bucket routing happens there) *before*
blocking on any result — the same cross-lane device/host overlap
``BFSService.step`` pipelines — then completes the events.  One
dispatcher means the service and engines are only ever driven from one
thread, while N handler threads provide concurrent admission and
serialization.

Endpoints::

    POST /v1/traverse    {"graph": name, "sources": [ids...],
                          "include_parents": false, "deadline_ms": 500}
    GET  /v1/graphs      lanes, ladders, admission config, graph specs
    GET  /healthz        liveness + draining flag
    GET  /readyz         readiness: 503 while draining, every lane's
                         breaker open, or a watchdog round is stuck
    GET  /metrics        per-lane histograms/counters + engine-cache
                         stats + breaker/deadline/retry/degrade counters
    POST /admin/shutdown graceful drain, then server stop

Error mapping: schema violations and source validation -> 400 (413 for
oversized bodies), unknown lane -> 404, admission bound -> 429 with a
``Retry-After`` header, draining or open circuit -> 503 (+Retry-After),
expired request deadline -> 504, stuck dispatch round -> 500.

Resilience (serve/resilience/): per-lane circuit breakers shed load at
the admission door and at dispatch; transient compile/dispatch failures
are retried with bounded exponential backoff, then served on a
degradation arm (another bucket, a split over a smaller bucket, the
uncompressed wire tier); request deadlines propagate admission ->
queue -> dispatch so expired entries are reaped before device work; a
watchdog bounds each device round so one wedged lane cannot freeze the
dispatcher.  All of it is driven by typed errors and is inert by
default (no deadline, no watchdog, retries only on ``TransientError``).

Two things differ from the JAX dispatcher, both from the port's engine.
Its ``run_async`` returns only after the level loop, which reads the
device every level, so a wedged device hangs in the *run*: the watchdog
guards each engine run as well as its result read, the two together
being the counterpart of JAX's sync.  The engine is resolved and
compiled first, outside the guard (``BFSService.resolve``), and so are
the retries' backoff sleeps and each degradation arm's compile: a slow
compile serves, as in the JAX package.  And a result's distances live in
its engine's reused buffer: the service settles an engine before each
run (``BFSEngine.settle``), and the sync reads ``dist_host`` on the
dispatching side, before the waiting handler thread is woken, so no
later round can reuse the buffer under it.  Parents, when a request asks
for them, are derived there too, on the lane's device
(``schema.derive_parents_on_device``, the host rule's values), over an
int64 edge list uploaded once per graph and device, shown in
``/metrics`` as ``engine_cache.parents_device_bytes`` and freed when the
front end drains.  The HTTP handler sends the encoded response bytes
as they are.
"""

from __future__ import annotations

import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import torch

from repro_torch.serve.frontend import schema
from repro_torch.serve.frontend.admission import (AdmissionError, DrainingError,
                                            LaneGate)
from repro_torch.serve.frontend.metrics import FrontendMetrics
from repro_torch.serve.resilience import faults as _faults
from repro_torch.serve.resilience.breaker import CircuitBreaker
from repro_torch.serve.resilience.deadline import Deadline
from repro_torch.serve.resilience.degrade import degraded_traverse
from repro_torch.serve.resilience.errors import (DeadlineExceeded,
                                           ResilienceError, TransientError)
from repro_torch.serve.resilience.retry import RetryPolicy, call_with_retry
from repro_torch.serve.resilience.watchdog import DispatchWatchdog


class _Pending:
    """One admitted request riding the dispatcher: timestamps + result."""

    __slots__ = ("graph", "sources", "include_parents", "cost_bytes",
                 "event", "result", "bucket", "error", "deadline", "arm",
                 "parents", "t_admit", "t_dispatch", "t_done")

    def __init__(self, graph: str, sources, include_parents: bool,
                 cost_bytes: int, deadline: Optional[Deadline] = None):
        self.graph = graph
        self.sources = sources
        self.include_parents = include_parents
        self.cost_bytes = cost_bytes
        self.event = threading.Event()
        self.result = None           # BFSResult once served
        self.bucket = None
        self.error: Optional[Exception] = None
        self.deadline = deadline     # None = no time bound
        self.arm = None              # degradation arm label, if degraded
        self.parents = None          # (n, S) host parents, if requested
        self.t_admit = time.monotonic()
        self.t_dispatch = None
        self.t_done = None


class BFSFrontend:
    """Admission + dispatch + metrics over a configured ``BFSService``.

    Transport-agnostic: ``submit``/``wait`` drive it from the HTTP
    handler, tests, and the in-process serving benchmark alike.  Lanes
    must be registered on the service before construction (gates and
    metrics are built per existing lane).
    """

    def __init__(self, service, *, max_queue_depth: int = 64,
                 max_inflight_mb: float = 256.0,
                 stats_interval_s: float = 0.0,
                 graph_specs: Optional[dict] = None,
                 start_dispatcher: bool = True,
                 breaker_threshold: int = 5,
                 breaker_reset_s: float = 5.0,
                 retry_policy: Optional[RetryPolicy] = None,
                 watchdog_timeout_s: Optional[float] = None,
                 degrade: bool = True,
                 default_deadline_ms: Optional[float] = None,
                 log=print):
        self.service = service
        self.graph_specs = dict(graph_specs or {})
        self._log = log
        names = service.graph_names()
        if not names:
            raise ValueError("service has no lanes; add_graph before "
                             "building a frontend")
        max_bytes = max(1, int(max_inflight_mb * 2**20))
        self.gates: Dict[str, LaneGate] = {
            name: LaneGate(max_queue_depth=max_queue_depth,
                           max_inflight_bytes=max_bytes)
            for name in names}
        self.metrics = FrontendMetrics(names)
        # resilience: per-lane breakers, one shared retry policy, an
        # optional watchdog (None = unbounded device rounds, the
        # pre-resilience behavior), degradation arms on/off, and a
        # server-side default deadline for requests that carry none
        self.breakers: Dict[str, CircuitBreaker] = {
            name: CircuitBreaker(failure_threshold=breaker_threshold,
                                 reset_timeout_s=breaker_reset_s,
                                 name=name)
            for name in names}
        self.retry_policy = (retry_policy if retry_policy is not None
                             else RetryPolicy())
        self.watchdog = (DispatchWatchdog(watchdog_timeout_s)
                         if watchdog_timeout_s else None)
        self.degrade_enabled = bool(degrade)
        self.default_deadline_ms = default_deadline_ms
        self._level_bytes: Dict[str, dict] = {}   # lane -> phase pricing
        # (graph id, device) -> (graph, src, dst): the graph's int64 edge
        # list on that device, for the parents (filled by the dispatching
        # side, emptied by a drain and by shutdown; the graph is held so
        # its id stays)
        self._edges: Dict[tuple, tuple] = {}
        # guarded-by(_cv): _running, _draining
        self._cv = threading.Condition()
        self._running = True
        self._draining = False
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="bfs-dispatch", daemon=True)
        self._stats_interval_s = float(stats_interval_s)
        self._stats_thread = None
        if start_dispatcher:
            self.start()

    # -------------------------------------------------------------- control
    def start(self) -> None:
        if not self._dispatcher.is_alive():
            self._dispatcher.start()
            if self._stats_interval_s > 0:
                self._stats_thread = threading.Thread(
                    target=self._stats_loop, name="bfs-stats", daemon=True)
                self._stats_thread.start()

    @property
    def draining(self) -> bool:
        with self._cv:
            return self._draining

    def drain(self, timeout_s: float = 60.0) -> bool:
        """Stop admitting; wait for admitted work to finish.  Returns
        True when every gate went idle within the timeout."""
        for gate in self.gates.values():
            gate.close()
        with self._cv:
            self._draining = True
            self._cv.notify_all()
        deadline = time.monotonic() + timeout_s
        while not all(g.idle() for g in self.gates.values()):
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.01)
        # no request is left to derive parents for
        self._edges.clear()
        return True

    def shutdown(self, timeout_s: float = 60.0) -> bool:
        """Graceful drain, then stop the dispatcher and free the parents'
        edge lists, whether or not the drain finished in time."""
        drained = self.drain(timeout_s)
        with self._cv:
            self._running = False
            self._cv.notify_all()
        if self._dispatcher.is_alive():
            self._dispatcher.join(timeout=5.0)
        self._edges.clear()
        return drained

    def parents_device_bytes(self) -> int:
        """Device bytes of the edge lists held for the parents (16 bytes
        an edge a graph and device); the engine cache's budget does not
        hold them, since evicting an engine would not free them."""
        return sum(src.nbytes + dst.nbytes
                   for _, src, dst in list(self._edges.values()))

    # ------------------------------------------------------------ admission
    def _resolve_lane(self, graph: Optional[str]):
        if graph is None:
            lane = self.service._sole_lane()   # raises ValueError if many
            return lane.name, lane
        return graph, self.service.lane(graph)  # raises KeyError if unknown

    def submit(self, graph: Optional[str], sources,
               include_parents: bool = False,
               deadline_ms: Optional[float] = None) -> _Pending:
        """Validate + admit one request; returns its pending handle.

        Raises ``KeyError`` (unknown lane), ``ValueError`` (bad
        sources), ``AdmissionError`` (bounds), ``DrainingError`` or
        ``CircuitOpenError`` (lane breaker open) — the transport maps
        each to its status code.  ``deadline_ms`` pins an absolute
        deadline the request carries through queue and dispatch.
        """
        from repro_torch.core.bfs import validate_sources

        name, lane = self._resolve_lane(graph)
        lane_metrics = self.metrics.lane(name)
        try:
            srcs = validate_sources(sources, lane.n_logical,
                                    max_sources=lane.ladder[-1])
        except ValueError:
            lane_metrics.record_rejected(invalid=True)
            raise
        # the breaker's fast 503: an open circuit sheds at the door,
        # before the gate books queue/byte capacity for doomed work
        breaker = self.breakers[name]
        if not breaker.admits():
            lane_metrics.record_breaker_rejected()
            raise breaker.reject_error()
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        deadline = (Deadline.after_ms(deadline_ms)
                    if deadline_ms is not None else None)
        # admission cost ~= response payload: one int32 depth row per
        # source (doubled when parents ride along), plus framing slack
        cost = (1 + bool(include_parents)) * lane.n_logical * 4 * len(srcs)
        cost += 1024
        pending = _Pending(name, [int(s) for s in srcs], include_parents,
                           cost, deadline)
        try:
            self.gates[name].try_admit(
                pending, cost, retry_after_s=lane_metrics.ewma_e2e_s())
        except AdmissionError:
            lane_metrics.record_rejected()
            raise
        with self._cv:
            self._cv.notify_all()
        return pending

    def wait(self, pending: _Pending,
             timeout_s: Optional[float] = None) -> "object":
        """Block until a pending request is served; returns its
        ``BFSResult`` or re-raises the dispatch error.

        A request deadline tightens the wait: the handler thread stops
        blocking the moment the deadline lapses and raises the typed
        ``DeadlineExceeded`` (504) — the still-queued entry is reaped by
        the dispatcher before it can waste device work.
        """
        wait_s = (pending.deadline.bound(timeout_s)
                  if pending.deadline is not None else timeout_s)
        if not pending.event.wait(wait_s):
            if pending.deadline is not None and pending.deadline.expired():
                self.metrics.lane(pending.graph).record_deadline_expired()
                pending.deadline.check("wait",
                                       f"lane {pending.graph!r}")
            raise TimeoutError(
                f"request on lane {pending.graph!r} not served within "
                f"{timeout_s}s (queue depth "
                f"{self.gates[pending.graph].depth()})")
        if pending.error is not None:
            raise pending.error
        return pending.result

    def traverse(self, graph: Optional[str], sources, *,
                 include_parents: bool = False,
                 timeout_s: Optional[float] = 120.0,
                 deadline_ms: Optional[float] = None) -> dict:
        """Submit + wait + shape the response payload (the in-process
        mirror of ``POST /v1/traverse``; benchmarks drive this)."""
        pending = self.submit(graph, sources, include_parents, deadline_ms)
        result = self.wait(pending, timeout_s)
        return self._payload(pending, result)

    def _payload(self, pending: _Pending, result) -> dict:
        return json.loads(self._payload_bytes(pending, result))

    def _payload_bytes(self, pending: _Pending, result) -> bytes:
        """The ``/v1/traverse`` response body (the HTTP handler sends
        these bytes as they are: no decode and re-encode)."""
        return schema.encode_traverse_response(
            graph=pending.graph, sources=pending.sources,
            bucket=pending.bucket, depths=result.dist_host,
            parents=pending.parents,
            run_stats=result.run_stats.to_host(),
            timing_ms={
                "queue_wait": (pending.t_dispatch - pending.t_admit) * 1e3,
                "device": (pending.t_done - pending.t_dispatch) * 1e3,
                "total": (pending.t_done - pending.t_admit) * 1e3,
            })

    def _parents(self, name: str, depths):
        """``schema.derive_parents`` of a served result, computed on the
        lane's device (``derive_parents_on_device``) over the lane
        graph's edge list, uploaded once per graph."""
        lane = self.service.lane(name)
        dev = lane.plan.device
        key = (id(lane.graph), str(dev))
        entry = self._edges.get(key)
        if entry is None:
            src, dst = lane.graph.edge_list()
            entry = self._edges[key] = (
                lane.graph, torch.as_tensor(src).to(dev),
                torch.as_tensor(dst).to(dev))
        parents = schema.derive_parents_on_device(
            entry[1], entry[2], torch.as_tensor(depths).to(dev))
        return parents.cpu().numpy()

    # ------------------------------------------------------------- dispatch
    def _dispatch_loop(self) -> None:
        while True:
            if self._dispatch_round():
                continue          # keep draining queues while work exists
            with self._cv:
                if not self._running:
                    return
                if all(g.depth() == 0 for g in self.gates.values()):
                    self._cv.wait(timeout=0.1)

    def _fail(self, name: str, pending: _Pending, cost: int, exc,
              *, count_failed: bool = True) -> None:
        """Complete one pending request with an error (gate released,
        waiter woken)."""
        pending.error = exc
        pending.t_done = time.monotonic()
        if count_failed:
            self.metrics.lane(name).record_failed()
        self.gates[name].complete(cost)
        pending.event.set()

    def _pop_live(self, name: str):
        """Next queued request whose deadline has not lapsed; expired
        entries are reaped here — completed with ``DeadlineExceeded``
        (504) — so no device work is ever spent on dead requests."""
        while True:
            popped = self.gates[name].pop()
            if popped is None:
                return None
            pending, cost = popped
            if pending.deadline is None or not pending.deadline.expired():
                return pending, cost
            self.metrics.lane(name).record_deadline_expired()
            try:
                pending.deadline.check("queue", f"lane {name!r}")
            except DeadlineExceeded as exc:
                self._fail(name, pending, cost, exc, count_failed=False)

    def _dispatch_one(self, name: str, pending: _Pending):
        """Resolve + dispatch one request: bounded retry on transient
        failures, then the degradation arms.  Returns the un-blocked
        result handle + bucket; raises when every avenue is spent.  Only
        the engine runs are watchdog-guarded: the compiles, the backoff
        sleeps and the arms' compiles are not."""
        lane_metrics = self.metrics.lane(name)

        def on_retry(attempt, exc, backoff_s):
            lane_metrics.record_retry()

        def attempt():
            _, engine, srcs, bucket = self.service.resolve(name,
                                                           pending.sources)
            return self._guarded(name, lambda: self.service.dispatch(
                name, engine, srcs)), bucket

        try:
            return call_with_retry(attempt, self.retry_policy,
                                   on_retry=on_retry)
        except TransientError:
            if not self.degrade_enabled:
                raise
        res, bucket, arm = degraded_traverse(
            self.service, name, pending.sources,
            guard=lambda fn: self._guarded(name, fn))
        pending.arm = arm
        lane_metrics.record_degraded(arm)
        return res, bucket

    def _guarded(self, name: str, fn):
        """``fn()``, watchdog-bounded when enabled (a wedged device round
        fails its batch with a typed 500 and the dispatcher moves on; the
        round is tracked, not leaked).  The dispatcher waits on the
        guard, so one thread at a time drives the engines; an abandoned
        round keeps its engine's lock until it ends."""
        if self.watchdog is None:
            return fn()
        return self.watchdog.guard(fn, label=f"lane {name!r}")

    def _block_result(self, name: str, pending: _Pending, res):
        """Sync one dispatched result and read its distances (and, when
        requested, its parents) back."""
        def sync():
            _faults.fire("frontend.block", name)
            depths = res.block().dist_host
            if pending.include_parents:
                pending.parents = self._parents(name, depths)
            return res

        return self._guarded(name, sync)

    def _dispatch_round(self) -> int:
        """One rotation: pop at most one live request per lane, dispatch
        them all, then sync them all (the cross-lane overlap window).
        Returns the number of requests taken off the queues."""
        _faults.fire("frontend.loop")
        taken = 0
        batch = []
        for name in self.service.graph_names():
            popped = self._pop_live(name)
            if popped is None:
                continue
            pending, cost = popped
            taken += 1
            breaker = self.breakers[name]
            if not breaker.allow():
                self.metrics.lane(name).record_breaker_rejected()
                self._fail(name, pending, cost, breaker.reject_error(),
                           count_failed=False)
                continue
            pending.t_dispatch = time.monotonic()
            try:
                if pending.deadline is not None:
                    pending.deadline.check("queue", f"lane {name!r}")
                res, bucket = self._dispatch_one(name, pending)
                pending.bucket = bucket
                batch.append((name, pending, cost, res))
            except DeadlineExceeded as exc:
                # expired mid-retry/backoff: a reap, not a lane failure
                self.metrics.lane(name).record_deadline_expired()
                self._fail(name, pending, cost, exc, count_failed=False)
            except Exception as exc:   # compile/device failure
                breaker.record_failure()
                self._fail(name, pending, cost, exc)
        for name, pending, cost, res in batch:
            breaker = self.breakers[name]
            try:
                self._block_result(name, pending, res)
                pending.result = res
            except Exception as exc:
                breaker.record_failure()
                pending.error = exc
                self.metrics.lane(name).record_failed()
            else:
                breaker.record_success()
                pending.t_done = time.monotonic()
                self.metrics.lane(name).record_completed(
                    queue_wait_s=pending.t_dispatch - pending.t_admit,
                    device_s=pending.t_done - pending.t_dispatch,
                    e2e_s=pending.t_done - pending.t_admit,
                    bucket=pending.bucket,
                    n_sources=len(pending.sources),
                    wire_bytes=self._run_wire_bytes(name, res),
                    levels=res.run_stats.to_host()["levels"])
            if pending.t_done is None:
                pending.t_done = time.monotonic()
            self.gates[name].complete(cost)
            pending.event.set()
        return taken

    def _run_wire_bytes(self, name: str, res) -> dict:
        """Modeled per-chip wire bytes one run moved, split by phase:
        the lane plan's resolved per-level pricing times the number of
        levels the run spent in each mode (already synced by block())."""
        pricing = self._level_bytes.get(name)
        if pricing is None:
            meta = self.service.lane(name).plan.describe()
            pricing = {ph: float(meta[f"{ph}_level_bytes"])
                       for ph in ("dense", "queue", "bottom_up")}
            self._level_bytes[name] = pricing
        counts = res.run_stats.to_host()["mode_counts"]
        return {ph: pricing[ph] * counts[ph]
                for ph in pricing if counts[ph]}

    def _stats_loop(self) -> None:
        while True:
            time.sleep(self._stats_interval_s)
            with self._cv:
                if not self._running:
                    return
            self._log(self.metrics.stats_line(
                cache_stats=self.service.cache_stats()))

    # -------------------------------------------------------------- queries
    def graphs_payload(self) -> dict:
        lanes = []
        for name in self.service.graph_names():
            lane = self.service.lane(name)
            plan_ = lane.plan
            meta = plan_.describe()
            info = {
                "name": name,
                "n": lane.n_logical,
                "partition": plan_.partition,
                "buckets": list(lane.ladder),
                "slots": len(lane.pool),
                "wire_formats": dict(meta["wire_formats"]),
                "sieve": meta["sieve"],
                "admission": self.gates[name].snapshot(),
            }
            if plan_.partition == "2d":
                info["grid"] = list(meta["grid"])
            if name in self.graph_specs:
                info["spec"] = self.graph_specs[name]
            lanes.append(info)
        return {"graphs": lanes}

    def metrics_payload(self) -> dict:
        out = self.metrics.snapshot(
            cache_stats=self.service.cache_stats(), gates=self.gates,
            draining=self.draining)
        for name, breaker in self.breakers.items():
            out["lanes"][name]["breaker"] = breaker.snapshot()
        if self.watchdog is not None:
            out["watchdog"] = self.watchdog.snapshot()
        out["engine_cache"]["parents_device_bytes"] = \
            self.parents_device_bytes()
        return out

    def ready(self) -> "tuple[bool, list]":
        """Readiness verdict + the reasons it fails (``/readyz``).

        Not ready while draining, while *every* lane's breaker is open
        (one open lane degrades, all open means nothing can be served),
        or while a watchdog-abandoned device round is still stuck.
        Liveness (``/healthz``) stays green through all of these — the
        process is up; a load balancer should just stop routing here.
        """
        reasons = []
        if self.draining:
            reasons.append("draining")
        states = {name: b.state() for name, b in self.breakers.items()}
        if states and all(s == "open" for s in states.values()):
            reasons.append("all lane breakers open")
        if self.watchdog is not None and self.watchdog.stuck() > 0:
            reasons.append(f"{self.watchdog.stuck()} stuck dispatch "
                           f"round(s)")
        return not reasons, reasons

    def readiness_payload(self) -> "tuple[int, dict]":
        ok, reasons = self.ready()
        body = {
            "ready": ok,
            "draining": self.draining,
            "breakers": {name: b.state()
                         for name, b in self.breakers.items()},
            "watchdog_stuck": (self.watchdog.stuck()
                               if self.watchdog is not None else 0),
        }
        if reasons:
            body["reasons"] = reasons
        return (200 if ok else 503), body


# ---------------------------------------------------------------------------
# HTTP layer
# ---------------------------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    # one response per connection keeps the stdlib server simple and
    # avoids keep-alive bookkeeping in handler threads
    protocol_version = "HTTP/1.0"
    server_version = "repro-bfs-frontend/1"
    quiet = True

    @property
    def frontend(self) -> BFSFrontend:
        return self.server.frontend

    def log_message(self, fmt, *args):   # noqa: N802 (stdlib name)
        if not self.quiet:
            BaseHTTPRequestHandler.log_message(self, fmt, *args)

    # ------------------------------------------------------------- plumbing
    def _send_json(self, status: int, obj, extra_headers=()) -> None:
        body = obj if isinstance(obj, bytes) else json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in extra_headers:
            self.send_header(k, v)
        self.end_headers()
        try:
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass                       # client gave up; nothing to unwind

    def _send_error_json(self, status: int, message: str,
                         extra_headers=(), **fields) -> None:
        self._send_json(status, {"error": message, **fields}, extra_headers)

    # ------------------------------------------------------------- routes
    def do_GET(self) -> None:          # noqa: N802 (stdlib name)
        fe = self.frontend
        if self.path == "/healthz":
            self._send_json(200, {"status": "draining" if fe.draining
                                  else "ok", "lanes": len(fe.gates)})
        elif self.path == "/readyz":
            status, body = fe.readiness_payload()
            self._send_json(status, body)
        elif self.path == "/v1/graphs":
            self._send_json(200, fe.graphs_payload())
        elif self.path == "/metrics":
            self._send_json(200, fe.metrics_payload())
        else:
            self._send_error_json(404, f"no route for GET {self.path}")

    def do_POST(self) -> None:         # noqa: N802 (stdlib name)
        if self.path == "/v1/traverse":
            self._traverse()
        elif self.path == "/admin/shutdown":
            self._shutdown()
        else:
            self._send_error_json(404, f"no route for POST {self.path}")

    def _read_body(self) -> bytes:
        length = int(self.headers.get("Content-Length") or 0)
        if length > schema.MAX_BODY_BYTES:
            raise schema.RequestError(
                f"request body of {length} bytes exceeds the "
                f"{schema.MAX_BODY_BYTES}-byte limit", status=413)
        return self.rfile.read(length)

    def _send_resilience_error(self, exc: ResilienceError) -> None:
        """Map a typed serving failure to its status (+Retry-After)."""
        headers = ()
        fields = {}
        if exc.retry_after_s > 0:
            headers = (("Retry-After",
                        str(max(1, math.ceil(exc.retry_after_s)))),)
            fields["retry_after_s"] = round(exc.retry_after_s, 3)
        self._send_error_json(exc.status, str(exc), extra_headers=headers,
                              error_type=type(exc).__name__, **fields)

    def _traverse(self) -> None:
        fe = self.frontend
        try:
            req = schema.parse_traverse_request(self._read_body())
            pending = fe.submit(req["graph"], req["sources"],
                                req["include_parents"],
                                req["deadline_ms"])
        except schema.RequestError as exc:
            self._send_error_json(exc.status, str(exc))
            return
        except KeyError as exc:
            self._send_error_json(404, str(exc.args[0]) if exc.args
                                  else "unknown graph")
            return
        except ValueError as exc:
            self._send_error_json(400, str(exc))
            return
        except AdmissionError as exc:
            retry = max(1, math.ceil(exc.retry_after_s))
            self._send_error_json(
                429, str(exc), extra_headers=(("Retry-After", str(retry)),),
                retry_after_s=round(exc.retry_after_s, 3))
            return
        except DrainingError as exc:
            self._send_error_json(
                503, str(exc), extra_headers=(("Retry-After", "5"),))
            return
        except ResilienceError as exc:   # breaker open at the door
            self._send_resilience_error(exc)
            return
        try:
            result = fe.wait(pending, timeout_s=300.0)
        except ResilienceError as exc:   # 504 deadline / 503 breaker /
            self._send_resilience_error(exc)   # 500 watchdog, all typed
            return
        except TimeoutError as exc:
            self._send_error_json(504, str(exc))
            return
        except Exception as exc:       # dispatch-side failure
            self._send_error_json(500, f"{type(exc).__name__}: {exc}")
            return
        self._send_json(200, fe._payload_bytes(pending, result))

    def _shutdown(self) -> None:
        fe = self.frontend
        self._send_json(200, {"status": "draining"})
        # drain + stop from a side thread: shutdown() must not run on a
        # handler thread the server is about to join
        threading.Thread(target=self.server.drain_and_stop,
                         name="bfs-stop", daemon=True).start()


class _FrontendHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's 5 is less than one burst of
    # clients (eight at once on chip_smoke.py's path 6), and a network
    # stack that resets an overflowed connection fails the request
    request_queue_size = 128
    frontend: BFSFrontend = None
    _stopper: Optional[threading.Thread] = None   # runs drain_and_stop

    def drain_and_stop(self, timeout_s: float = 60.0) -> None:
        self._stopper = threading.current_thread()
        self.frontend.shutdown(timeout_s)
        self.shutdown()

    def server_close(self) -> None:
        """Close the socket, then wait for the side thread that stopped
        the server to end: a daemon thread that drops the last reference
        to the front end's tensors while the interpreter finalizes
        aborts the process."""
        super().server_close()
        stopper = self._stopper
        if stopper is not None and stopper is not threading.current_thread():
            stopper.join(timeout=30.0)


def serve_http(service, host: str = "127.0.0.1", port: int = 0, *,
               max_queue_depth: int = 64, max_inflight_mb: float = 256.0,
               stats_interval_s: float = 0.0, graph_specs=None,
               start_dispatcher: bool = True,
               breaker_threshold: int = 5, breaker_reset_s: float = 5.0,
               retry_policy: Optional[RetryPolicy] = None,
               watchdog_timeout_s: Optional[float] = None,
               degrade: bool = True,
               default_deadline_ms: Optional[float] = None, log=print):
    """Bind the front-end: returns ``(httpd, frontend)``.

    ``port=0`` binds an ephemeral port (``httpd.server_address[1]``
    holds the real one).  The caller owns the accept loop — call
    ``httpd.serve_forever()`` (blocking) or run it in a thread; stop
    via ``httpd.drain_and_stop()`` or ``POST /admin/shutdown``.
    """
    frontend = BFSFrontend(
        service, max_queue_depth=max_queue_depth,
        max_inflight_mb=max_inflight_mb,
        stats_interval_s=stats_interval_s, graph_specs=graph_specs,
        start_dispatcher=start_dispatcher,
        breaker_threshold=breaker_threshold,
        breaker_reset_s=breaker_reset_s, retry_policy=retry_policy,
        watchdog_timeout_s=watchdog_timeout_s, degrade=degrade,
        default_deadline_ms=default_deadline_ms, log=log)
    httpd = _FrontendHTTPServer((host, port), _Handler)
    httpd.frontend = frontend
    return httpd, frontend
