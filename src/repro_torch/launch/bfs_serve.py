"""Multi-tenant BFS serving launcher: many graphs, one engine cache — the
port of ``repro.launch.bfs_serve``.

    PYTHONPATH=src python -m repro_torch.launch.bfs_serve --n 50000 \
        --requests 32
    PYTHONPATH=src python -m repro_torch.launch.bfs_serve --device cpu \
        --devices 4 --graph er=erdos_renyi:40000 --graph hub=star:20000 \
        --graph ring=chain:5000:2x2 --requests 24 --cache-budget-mb 64

Registers every ``--graph`` spec in a ``GraphCatalog`` and serves them
through one multi-graph ``BFSService``: each graph gets a serving lane
(its own slot pool, sized to ``--slots``), requests are routed by graph
name, and every compiled engine lives in a shared byte-budgeted
``EngineCache`` (under ``--cache-budget-mb`` pressure LRU engines evict
and recompile on their lane's next turn).  Every lane's shards live on
the one device of ``--device`` (default ``cuda``), ``--devices N`` of
them in a ``LocalMesh``.

Graph specs are ``[name=]kind[:n][:RxC]``; a trailing grid selects the
2-D edge partition for that lane (an ``RxC`` ``LocalMesh.grid``, R*C =
N), so one service mixes schemes.  With no ``--graph`` the launcher
serves the single-graph workload flags.  ``--verify`` checks every
finished traversal against the numpy reference; ``--expect-eviction``
exits nonzero unless the budget actually forced at least one eviction.

``--http HOST:PORT`` binds the remote front-end instead of running the
self-driven request loop::

    PYTHONPATH=src python -m repro_torch.launch.bfs_serve --devices 4 \
        --graph er=erdos_renyi:40000 --graph ring=chain:5000:2x2 \
        --http 127.0.0.1:8642 --buckets 1,8,64 --queue-depth 32 \
        --cache-budget-mb 64 --stats-interval 10

Each lane then compiles a ladder of batch-size buckets (``--buckets``)
through the shared engine cache; remote requests
(``repro_torch.launch.bfs_client``) are padded to the smallest fitting
bucket, admission is bounded by ``--queue-depth`` / ``--max-inflight-mb``
(429 + Retry-After when full), and ``/metrics`` serves per-lane latency
histograms next to the cache counters.  ``HOST:0`` binds an ephemeral
port; ``--port-file`` writes the bound port for scripted callers.  The
server runs until ``POST /admin/shutdown`` (graceful drain), SIGINT, or
``--serve-secs``.  Each lane advertises its ``spec`` in ``/v1/graphs``,
which ``bfs_client --verify`` regenerates the graph from.

Resilience knobs (HTTP mode): ``--breaker-threshold`` /
``--breaker-reset-secs`` size the per-lane circuit breakers,
``--watchdog-secs`` bounds each engine run and result read,
``--no-degrade`` turns off the degradation arms, and
``--default-deadline-ms`` stamps a deadline on requests that carry none;
``/readyz`` reports readiness separately from ``/healthz`` liveness.
``--profile DIR`` captures a ``torch.profiler`` trace of the serving
window and prints ``analysis.trace_model``'s phase split.
"""

from __future__ import annotations

import argparse
import contextlib
import sys
import threading
import time

import numpy as np

from repro_torch.analysis import trace_model
from repro_torch.configs.base import BFS_WORKLOADS
from repro_torch.core import BFSOptions, LocalMesh
from repro_torch.graphs import generate, shard_graph
from repro_torch.launch import parse_graph_spec, resolve_cli_device
from repro_torch.serve.bfs_service import BFSService, TraversalRequest
from repro_torch.serve.engine_cache import EngineCache, GraphCatalog

_GEN_DEFAULTS = {
    "erdos_renyi": {"avg_degree": 8.0},
    "small_world": {"k": 8, "beta": 0.1},
    "rmat": {"edge_factor": 8},
}


def _print_profile(logdir: str) -> None:
    """Parse + print the phase summary of a captured serving trace (the
    ``bfs.level`` ranges of every lane's runs, in time order)."""
    try:
        print(trace_model.format_summary(trace_model.parse_trace(logdir)))
    except FileNotFoundError as exc:
        print(f"profile: {exc}", file=sys.stderr)


def _serve_http(args, svc, graph_specs) -> int:
    """Bind the remote front-end and run the accept loop to completion."""
    from repro_torch.serve.frontend.server import serve_http

    try:
        host, _, port_s = args.http.rpartition(":")
        host = host or "127.0.0.1"
        port = int(port_s)
    except ValueError:
        raise SystemExit(f"--http expects HOST:PORT, got {args.http!r}")

    httpd, frontend = serve_http(
        svc, host, port, max_queue_depth=args.queue_depth,
        max_inflight_mb=args.max_inflight_mb,
        stats_interval_s=args.stats_interval, graph_specs=graph_specs,
        breaker_threshold=args.breaker_threshold,
        breaker_reset_s=args.breaker_reset_s,
        watchdog_timeout_s=(args.watchdog_secs
                            if args.watchdog_secs > 0 else None),
        degrade=not args.no_degrade,
        default_deadline_ms=(args.default_deadline_ms
                             if args.default_deadline_ms > 0 else None))
    bound = httpd.server_address[1]
    print(f"serving on http://{host}:{bound} "
          f"(queue_depth={args.queue_depth}, "
          f"max_inflight_mb={args.max_inflight_mb:g}); "
          "POST /admin/shutdown to drain and stop", flush=True)
    if args.port_file:
        with open(args.port_file, "w") as f:
            f.write(str(bound))

    if args.serve_secs > 0:
        def _timer():
            time.sleep(args.serve_secs)
            httpd.drain_and_stop()

        threading.Thread(target=_timer, daemon=True).start()
    profile_cm = (trace_model.capture(args.profile) if args.profile
                  else contextlib.nullcontext())
    try:
        with profile_cm:
            httpd.serve_forever()
    except KeyboardInterrupt:
        print("interrupt: draining", flush=True)
        frontend.shutdown()
    finally:
        httpd.server_close()
    if args.profile:
        _print_profile(args.profile)

    st = svc.cache_stats()
    done = sum(m.completed for m in frontend.metrics.lanes.values())
    rejected = sum(m.rejected for m in frontend.metrics.lanes.values())
    print(f"served {done} traversals ({rejected} rejected 429); "
          f"cache: hits={st['hits']} misses={st['misses']} "
          f"evictions={st['evictions']} hit_rate={st['hit_rate']:.2f} "
          f"compile_s={st['compile_s_total']:.2f}")
    if args.expect_eviction and st["evictions"] == 0:
        print("EXPECTED at least one cache eviction under "
              f"--cache-budget-mb {args.cache_budget_mb}; none happened")
        return 1
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default=None,
                    choices=[w.name for w in BFS_WORKLOADS])
    ap.add_argument("--graph", action="append", default=None,
                    metavar="[NAME=]KIND[:N][:RxC]",
                    help="graph spec; repeatable — each spec opens one "
                         "serving lane (a trailing RxC grid selects the "
                         "2-D edge partition for that lane)")
    ap.add_argument("--n", type=int, default=50_000,
                    help="default vertex count for specs without :N")
    ap.add_argument("--mode", default="dense", choices=["dense", "auto"])
    ap.add_argument("--exchange", default="alltoall_direct")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16,
                    help="total requests, dealt round-robin across graphs")
    ap.add_argument("--cache-budget-mb", type=float, default=0.0,
                    help="engine-cache device-byte budget (0 = unbounded)")
    ap.add_argument("--verify", action="store_true",
                    help="check every traversal against the numpy reference")
    ap.add_argument("--expect-eviction", action="store_true",
                    help="exit nonzero unless the cache evicted >= 1 engine")
    ap.add_argument("--http", default=None, metavar="HOST:PORT",
                    help="bind the remote front-end instead of running the "
                         "self-driven request loop (PORT 0 = ephemeral)")
    ap.add_argument("--buckets", default=None, metavar="S1,S2,...",
                    help="batch-size bucket ladder per lane, e.g. 1,8,64 "
                         "(default: one bucket of --slots)")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="per-lane admission queue bound (HTTP mode)")
    ap.add_argument("--max-inflight-mb", type=float, default=256.0,
                    help="per-lane in-flight response-byte bound (HTTP)")
    ap.add_argument("--stats-interval", type=float, default=0.0,
                    help="seconds between serving stats log lines (0=off)")
    ap.add_argument("--port-file", default=None,
                    help="write the bound HTTP port to this file")
    ap.add_argument("--breaker-threshold", type=int, default=5,
                    help="consecutive lane failures that open its circuit "
                         "breaker (HTTP mode)")
    ap.add_argument("--breaker-reset-secs", type=float, default=5.0,
                    dest="breaker_reset_s",
                    help="open-circuit cooldown before half-open probes")
    ap.add_argument("--watchdog-secs", type=float, default=0.0,
                    help="fail an engine run exceeding this bound with a "
                         "typed 500; other lanes keep serving (0 = off)")
    ap.add_argument("--no-degrade", action="store_true",
                    help="disable degradation arms (other buckets, split "
                         "runs, the uncompressed wire tier) on persistent "
                         "transient failures")
    ap.add_argument("--default-deadline-ms", type=float, default=0.0,
                    help="server-side deadline for requests that carry no "
                         "deadline_ms of their own (0 = none)")
    ap.add_argument("--serve-secs", type=float, default=0.0,
                    help="auto-shutdown the HTTP server after this many "
                         "seconds (0 = run until /admin/shutdown or ^C)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the serving "
                         "window (self-driven loop, or HTTP accept loop "
                         "until drain) into DIR and print the per-phase "
                         "time summary parsed from it")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device every lane lives on (default cuda)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards of each lane's LocalMesh (default 1)")
    args = ap.parse_args(argv)

    buckets = None
    if args.buckets:
        try:
            buckets = tuple(int(tok) for tok in args.buckets.split(","))
        except ValueError:
            ap.error(f"--buckets expects comma-separated ints, got "
                     f"{args.buckets!r}")

    # spec rows: (name, kind, n, grid, generator kwargs) — a named
    # workload keeps its configured gen_kwargs; ad-hoc specs use the
    # per-kind defaults
    if args.graph and args.workload:
        ap.error("--graph and --workload are mutually exclusive; pass the "
                 "workload's graph as a --graph spec instead")
    if args.graph:
        specs = []
        for s in args.graph:
            name, kind, n, grid = parse_graph_spec(s, args.n)
            specs.append((name, kind, n, grid,
                          dict(_GEN_DEFAULTS.get(kind, {}))))
        names = [s[0] for s in specs]
        dupes = sorted({x for x in names if names.count(x) > 1})
        if dupes:
            ap.error(f"duplicate graph name(s) {dupes}: lane names must "
                     "be unique — disambiguate with a name= prefix, e.g. "
                     f"--graph small={dupes[0]}:10000")
    elif args.workload:
        wl = next(w for w in BFS_WORKLOADS if w.name == args.workload)
        specs = [(wl.name, wl.graph, wl.n_vertices, None,
                  dict(wl.gen_kwargs))]
    else:
        specs = [("default", "erdos_renyi", args.n, None,
                  dict(_GEN_DEFAULTS["erdos_renyi"]))]

    dev = resolve_cli_device(args.device)
    p = max(1, args.devices)
    for name, _, _, grid, _ in specs:
        if grid and grid[0] * grid[1] != p:
            ap.error(f"lane {name}: a {grid[0]}x{grid[1]} grid needs "
                     f"--devices {grid[0] * grid[1]}, not {p}")

    cache = EngineCache(
        max_device_bytes=(int(args.cache_budget_mb * 2**20)
                          if args.cache_budget_mb > 0 else None))
    catalog = GraphCatalog()
    svc = BFSService(opts=BFSOptions(mode=args.mode,
                                     dense_exchange=args.exchange,
                                     queue_cap=1 << 15),
                     mesh=LocalMesh.flat(p, dev), batch_slots=args.slots,
                     batch_buckets=buckets, cache=cache, catalog=catalog)

    edge_lists = {}
    graph_specs = {}
    t0 = time.time()
    for name, kind, n, grid, kw in specs:
        src, dst = generate(kind, n, seed=0, **kw)
        edge_lists[name] = (src, dst, n)
        # advertised via /v1/graphs so a remote --verify client can
        # regenerate the identical graph and check depths bitwise
        graph_specs[name] = {"kind": kind, "n": n, "seed": 0,
                             "gen_kwargs": kw}
        g = shard_graph(src, dst, n, p)
        if grid:
            svc.add_graph(name, g, mesh=LocalMesh.grid(*grid, dev),
                          axis=None, partition="2d")
        else:
            svc.add_graph(name, g)
        part_lbl = f"2d:{grid[0]}x{grid[1]}" if grid else "1d"
        print(f"lane {name}: kind={kind} n={n} edges={src.shape[0]} "
              f"partition={part_lbl}")
    print(f"{len(specs)} lane(s) registered in {time.time()-t0:.2f}s "
          f"(shards={p}, buckets={list(buckets) if buckets else [args.slots]},"
          f" budget={args.cache_budget_mb or 'unbounded'} MB)", flush=True)

    if args.http is not None:
        return _serve_http(args, svc, graph_specs)

    rng = np.random.default_rng(0)
    names = svc.graph_names()
    for i in range(args.requests):
        name = names[i % len(names)]
        n = edge_lists[name][2]
        svc.submit(TraversalRequest(rid=i, source=int(rng.integers(0, n)),
                                    graph=name))
    profile_cm = (trace_model.capture(args.profile) if args.profile
                  else contextlib.nullcontext())
    t0 = time.time()
    with profile_cm:
        done = svc.run_until_drained()
    dt = time.time() - t0
    if args.profile:
        _print_profile(args.profile)
    print(f"{len(done)} traversals over {len(names)} graph(s) in {dt:.2f}s "
          f"({len(done)/max(dt, 1e-9):.1f} req/s, "
          f"{dt/max(len(done), 1)*1e3:.1f} ms/req)")
    for r in done[:4]:
        print(f"  rid={r.rid} graph={r.graph} source={r.source} "
              f"levels={r.levels} visited={r.visited}")

    st = svc.cache_stats()
    print(f"cache: hits={st['hits']} misses={st['misses']} "
          f"evictions={st['evictions']} entries={st['entries']} "
          f"bytes={st['device_bytes']}/{st['max_device_bytes'] or 'inf'} "
          f"hit_rate={st['hit_rate']:.2f} "
          f"compile_s={st['compile_s_total']:.2f}")

    if args.verify:
        from repro_torch.core.ref import bfs_reference
        for r in done:
            src, dst, n = edge_lists[r.graph]
            want = bfs_reference(src, dst, n, [r.source])[:, 0]
            if not np.array_equal(r.dist, want):
                print(f"VERIFY FAILED: rid={r.rid} graph={r.graph} "
                      f"source={r.source}")
                return 1
        print(f"verify: {len(done)} traversals match the numpy reference")

    if args.expect_eviction and st["evictions"] == 0:
        print("EXPECTED at least one cache eviction under "
              f"--cache-budget-mb {args.cache_budget_mb}; none happened")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
