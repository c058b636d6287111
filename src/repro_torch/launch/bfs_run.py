"""BFS launcher: run any BFS workload on a local ``LocalMesh``, or one
shard a process on a ``DistMesh`` — the port of ``repro.launch.bfs_run``.

    PYTHONPATH=src python -m repro_torch.launch.bfs_run --workload rmat_1m \
        --devices 4 --mode dense --sources 64 --repeats 2
    PYTHONPATH=src python -m repro_torch.launch.bfs_run --device cpu \
        --graph erdos_renyi:100000 --graph star:50000 --repeats 2
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.bfs_run --dist --backend nccl \
        --workload rmat_1m --mode dense --sources 64

``--devices N`` stacks N shards on the one device of ``--device`` (default
``cuda``; ``--device cpu`` runs on the CPU) as one 1-D shard row, or —
with ``--partition 2d`` — as an ``r x c`` grid (``--grid 2x2``; defaults
to the most-square factorization of N) running the two-phase
edge-partitioned engine.  ``--dist`` runs under ``torch.distributed.run``
instead: each of its N processes holds one shard (``--backend nccl``, a
card a process, or ``gloo``, on the CPU or ranks sharing a card; the
counterpart of JAX's ``--devices N`` over N devices), and rank 0 prints
the lines the in-process run prints at the same p.

The launcher drives the compile-once lifecycle: one ``plan().compile()``
per (graph, options, mesh), then ``--repeats`` traversals from rotating
source sets against the same engine — compile wall time and per-traversal
wall time are reported separately.  ``--graph`` is repeatable
(``KIND[:N]``): every engine resolves through the process-wide shared
``EngineCache``, and the final stats line shows the cross-graph compile
amortization (hits / misses / evictions / compile seconds).  The printed
``run[i]`` lines are the JAX launcher's, field for field.  ``--profile
DIR`` captures a ``torch.profiler`` trace of the timed traversals and
prints ``analysis.trace_model``'s phase split, one row a level.
``--audit`` runs the plan auditor (``analysis.collective_audit``) on each
engine: one traversal from the first run's sources on a recording mesh,
its census printed beside the modeled bytes; the launcher exits 1 if any
engine fails the audit.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

import numpy as np

from repro_torch.analysis import collective_audit, trace_model
from repro_torch.configs.base import BFS_WORKLOADS
from repro_torch.core import (FOLD_COL_STRATEGIES, BFSOptions, DistMesh,
                              LocalMesh, default_grid, plan)
from repro_torch.graphs import generate, shard_graph, shard_graph_2d
from repro_torch.launch import (init_distributed, parse_graph_spec,
                                resolve_cli_device)
from repro_torch.serve.engine_cache import default_engine_cache


def main(argv=None, *, on_run=None) -> int:
    """Run the launcher on ``argv``; returns the exit code.

    ``on_run(rep, sources, result)`` exists for in-process checks (the
    command line has no counterpart): when given, it is called after each
    timed run, while the result's distances are still the engine's, and
    with ``rep="audit"`` after the audited traversal of ``--audit``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default=None,
                    choices=[w.name for w in BFS_WORKLOADS])
    ap.add_argument("--graph", action="append", default=None,
                    metavar="KIND[:N]",
                    help="graph to traverse; repeatable — each runs "
                         "against its own cached engine (default: one "
                         "erdos_renyi of --n vertices)")
    ap.add_argument("--n", type=int, default=100_000,
                    help="default vertex count for --graph without :N")
    ap.add_argument("--mode", default="auto",
                    choices=["dense", "queue", "auto"])
    ap.add_argument("--exchange", default="alltoall_direct")
    ap.add_argument("--wire-format", default="auto",
                    choices=["packed", "bytes", "compressed", "auto"],
                    help="wire layout: packed bitset words (dense, 8x "
                         "smaller), uint8 mask bytes / raw int32 ids, "
                         "delta+varint compressed ids (sparse phases), or "
                         "byte-model auto-selection per phase")
    ap.add_argument("--sieve", default="auto",
                    choices=["auto", "on", "off"],
                    help="visited-sieve: filter candidate ids against a "
                         "replicated coarse visited-summary bitmap before "
                         "the sparse exchange (auto: on when p>1 and the "
                         "plan has a sparse phase)")
    ap.add_argument("--describe", action="store_true",
                    help="print the compiled plan's full describe() "
                         "metadata — per-phase strategies, the wire "
                         "format 'auto' chose for each, and per-level "
                         "byte pricing")
    ap.add_argument("--audit", action="store_true",
                    help="run the plan auditor on each compiled engine "
                         "(a traversal's collective census vs the resolved "
                         "strategies and modeled bytes, host reads a "
                         "level, dist buffer reuse) and print the census "
                         "next to the modeled bytes; exits 1 if any "
                         "engine fails the audit")
    ap.add_argument("--sources", type=int, default=1)
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler trace of the timed "
                         "traversals into DIR and print the per-phase, "
                         "per-level time summary (expand / collective / "
                         "fold / owner_update) parsed from it")
    ap.add_argument("--repeats", type=int, default=3,
                    help="traversals to run against each compiled engine")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device every shard lives on (default cuda)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards of the in-process LocalMesh (default 1)")
    ap.add_argument("--partition", default="1d", choices=["1d", "2d"],
                    help="vertex blocks over all p shards (1d) or edge "
                         "blocks over an r x c grid (2d)")
    ap.add_argument("--grid", default=None, metavar="RxC",
                    help="2-D grid shape, e.g. 2x2 (default: most-square "
                         "factorization of the shard count)")
    ap.add_argument("--dist", action="store_true",
                    help="one shard a process on a DistMesh, under python "
                         "-m torch.distributed.run --nproc-per-node N -m "
                         "repro_torch.launch.bfs_run --dist ...; rank 0 "
                         "prints")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the --dist process group's backend: nccl (a "
                         "card a rank) or gloo (the CPU, or ranks that "
                         "share a card)")
    args = ap.parse_args(argv)
    if not args.dist:
        return _run(ap, args, resolve_cli_device(args.device),
                    max(1, args.devices), on_run)
    import torch.distributed as dist

    rank, world, dev = init_distributed(args.backend, args.device)
    try:
        if args.devices and args.devices != world:
            ap.error(f"--devices {args.devices} differs from the "
                     f"{world} processes of --dist")
        if rank == 0:
            return _run(ap, args, dev, world, on_run, rank)
        with open(os.devnull, "w") as sink, \
                contextlib.redirect_stdout(sink):
            return _run(ap, args, dev, world, on_run, rank)
    finally:
        dist.destroy_process_group()


def _run(ap, args, dev, p: int, on_run, rank: int = 0) -> int:
    """The launcher's body on ``p`` shards on ``dev``: a ``LocalMesh``, or
    under ``--dist`` this rank's ``DistMesh``."""
    if args.workload and args.graph:
        ap.error("--graph and --workload are mutually exclusive; pass the "
                 "workload's graph as a --graph spec instead")
    if args.workload:
        wl = next(w for w in BFS_WORKLOADS if w.name == args.workload)
        graphs = [(wl.graph, wl.n_vertices, dict(wl.gen_kwargs))]
    elif args.graph:
        graphs = []
        for spec in args.graph:
            _, kind, n, grid = parse_graph_spec(spec, args.n)
            if grid is not None:
                ap.error(f"--graph {spec}: per-spec grids are a bfs_serve "
                         "feature; here use --partition 2d --grid "
                         f"{grid[0]}x{grid[1]} (applies to every graph)")
            graphs.append((kind, n, {}))
    else:
        graphs = [("erdos_renyi", args.n, {})]

    sieve = {"auto": "auto", "on": True, "off": False}[args.sieve]
    if args.partition == "2d":
        if args.grid:
            r, c = (int(x) for x in args.grid.lower().split("x"))
            if (args.devices or args.dist) and r * c != p:
                ap.error(f"--grid {args.grid} needs {r * c} shards, "
                         f"not --devices {p}")
        else:
            r, c = default_grid(p)
        mesh = (DistMesh.grid(r, c, dev) if args.dist
                else LocalMesh.grid(r, c, dev))
        # --exchange names a *dense* (1-D) strategy; the 2-D phases use
        # expand/fold strategies.  Honor it when it is also a registered
        # fold strategy, otherwise say so instead of silently dropping it.
        fold = "alltoall_reduce"
        if args.exchange in FOLD_COL_STRATEGIES:
            fold = args.exchange
        elif args.exchange != ap.get_default("exchange"):
            print(f"partition=2d ignores --exchange={args.exchange} "
                  f"(uses expand/fold strategies; fold options: "
                  f"{tuple(FOLD_COL_STRATEGIES)})")
        opts = BFSOptions(mode=args.mode, fold_exchange=fold,
                          wire_format=args.wire_format, sieve=sieve,
                          queue_cap=1 << 15)
        print(f"grid={r}x{c} (p={r*c}) mode={args.mode} "
              f"wire={args.wire_format} sieve={args.sieve}")
    else:
        mesh = DistMesh.flat(dev) if args.dist else LocalMesh.flat(p, dev)
        opts = BFSOptions(mode=args.mode, dense_exchange=args.exchange,
                          wire_format=args.wire_format, sieve=sieve,
                          queue_cap=1 << 15)
        print(f"shards={p} mode={args.mode} wire={args.wire_format} "
              f"sieve={args.sieve}")
    if args.dist:
        print(f"dist: {p} ranks, {mesh.transport}, one shard a rank")

    cache = default_engine_cache()
    audit_failed = False
    for kind, n, kw in graphs:
        t0 = time.time()
        src, dst = generate(kind, n, seed=0, **kw)
        if args.partition == "2d":
            # bucket straight into the r x c edge blocks; the bottom-up
            # in-edge blocks build lazily iff mode=auto compiles them
            g = shard_graph_2d(src, dst, n, r, c)
        else:
            g = shard_graph(src, dst, n, mesh.p)
        print(f"graph={kind} n={n}: generated {src.shape[0]} edges "
              f"in {time.time()-t0:.1f}s")

        t0 = time.time()
        engine = cache.get_or_compile(
            plan(g, opts, mesh=mesh, num_sources=args.sources,
                 partition=args.partition))
        compile_s = time.time() - t0
        meta = engine.plan.describe()
        exchanges = (f"{meta['expand_exchange']}+{meta['fold_exchange']}"
                     if args.partition == "2d" else meta["dense_exchange"])
        wires = meta["wire_formats"]
        print(f"plan+get_or_compile: {compile_s:.2f}s (S={args.sources}, "
              f"{exchanges}, "
              f"level_bytes/chip={meta['dense_level_bytes']:.2e})")
        # per-level-variant pricing with the wire format each phase
        # resolved to; a 2-D dense level has two phases which may resolve
        # differently (a degenerate grid's peerless phase keeps bytes)
        dense_wire = (wires["dense"] if args.partition != "2d"
                      else f"{wires['expand']}+{wires['fold']}")
        queue_wire = wires["queue" if args.partition != "2d"
                           else "fold_sparse"]
        print("  level variants: "
              f"dense={meta['dense_level_bytes']:.2e}B[{dense_wire}]  "
              f"queue={meta['queue_level_bytes']:.2e}B[{queue_wire}]  "
              f"bottom_up={meta['bottom_up_level_bytes']:.2e}B"
              f"[{wires['bottom_up']}]")
        if args.describe:
            for k in sorted(meta):
                print(f"  describe.{k} = {meta[k]}")
        if args.audit:
            audit_srcs = collective_audit.default_sources(engine.plan)
            rep = collective_audit.audit_engine(
                engine, sources=audit_srcs,
                on_result=None if on_run is None else
                (lambda res: on_run("audit", audit_srcs, res)))
            print(f"  {rep.summary()}")
            print(collective_audit.census_table(rep))
            for v in rep.violations:
                print(f"  {v}")
            audit_failed |= not rep.ok()

        rng = np.random.default_rng(0)
        # under --dist each rank traces into its own directory
        trace_dir = (os.path.join(args.profile, f"rank{rank}")
                     if args.profile and args.dist else args.profile)
        profile_cm = (trace_model.capture(trace_dir) if args.profile
                      else contextlib.nullcontext())
        total_levels = 0
        with profile_cm:
            for rep in range(max(1, args.repeats)):
                sources = (list(range(args.sources)) if rep == 0 else
                           sorted(rng.choice(n, size=args.sources,
                                             replace=False).tolist()))
                t0 = time.time()
                res = engine.run(sources)
                run_s = time.time() - t0
                stats = res.stats()
                if on_run is not None:
                    on_run(rep, sources, res)
                total_levels += stats.levels
                hits = int(stats.sieve_hits)
                # hit-rate: share of would-be enqueued candidates the
                # sieve dropped before they reached the wire
                rate = hits / max(1, hits + stats.visited)
                sieve_str = (f" sieve_hits={hits} ({rate:.0%})"
                             if meta["sieve"] else "")
                print(f"run[{rep}] sources={sources[:4]}"
                      f"{'...' if len(sources) > 4 else ''}: "
                      f"levels={stats.levels} visited={stats.visited} "
                      f"modes={stats.mode_counts} "
                      f"comm_bytes/chip={stats.comm_bytes:.2e} "
                      f"wall={run_s:.3f}s{sieve_str}")
        if args.profile:
            timings = trace_model.parse_trace(trace_dir,
                                              n_levels=total_levels)
            print(trace_model.format_summary(timings))
        assert engine.trace_count == engine.compile_traces, \
            "engine retraced after compile — amortization broken"

    st = cache.stats()
    print(f"engine cache: hits={st['hits']} misses={st['misses']} "
          f"evictions={st['evictions']} entries={st['entries']} "
          f"bytes={st['device_bytes']} "
          f"compile_s={st['compile_s_total']:.2f}")
    return 1 if audit_failed else 0


if __name__ == "__main__":
    sys.exit(main())
