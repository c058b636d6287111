"""Audit gate: check the plans' collectives and the port's conventions —
the port of ``repro.launch.bfs_audit``.

    PYTHONPATH=src python -m repro_torch.launch.bfs_audit \
        --graph er:4096 --all-variants --devices 4 [--device cpu]

For each partition x wire-format x mode x fused-tail variant, plan and
compile the engine (through an ``EngineCache``, so twins that resolve to
the same plan key cost one compile) and run the plan auditor
(``analysis.collective_audit``): one traversal on a recording mesh must
make every collective the resolved strategies price, each receiving the
modeled bytes within the documented tolerance, in groups that span the
plan's axes; each level must read the device within its budget and at a
listed site; the engine must reuse its dist buffer, and two
distinct-source runs must not retrace.  The registry / level-loop lint
(``analysis.lint``) and the serve/ lock-discipline pass
(``analysis.locks``) run once alongside.

``--devices N`` stacks N shards on the one device of ``--device``
(default ``cuda``; without a card, pass ``--device cpu``).  Exit code 0
iff every report is clean (suppressed violations and ``info`` rows carry
their reasons in the report but do not gate).  ``--out`` writes the full
machine-readable ledger.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.analysis import collective_audit
from repro_torch.analysis.lint import lint_tree
from repro_torch.analysis.locks import analyze_serve
from repro_torch.core import BFSOptions, LocalMesh, default_grid, plan
from repro_torch.graphs import generate, shard_graph, shard_graph_2d
from repro_torch.launch import parse_graph_spec, resolve_cli_device
from repro_torch.serve.engine_cache import EngineCache

MODES = ("dense", "queue", "auto")
WIRES = ("bytes", "packed", "compressed", "auto")
# the fused-tail axis doubles the gate: every wire x mode plans its
# unfused twin and its "auto"-resolved twin (which turns the fused tail
# on exactly where it can exist — packed dense/fold wire + a dense-path
# mode; elsewhere both resolve to the same plan_key, the EngineCache
# dedups the compile and the duplicate report is skipped)
FUSED = (False, "auto")


def _variants(p: int, all_variants: bool, args):
    if not all_variants:
        yield (args.partition, args.mode, args.wire_format,
               {"on": True, "off": False, "auto": "auto"}[args.fused_tail])
        return
    partitions = ("1d", "2d") if p > 1 else ("1d",)
    for part in partitions:
        for wire in WIRES:
            for mode in MODES:
                for fused in FUSED:
                    yield part, mode, wire, fused


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="audit of the BFS plans' collectives (census against "
                    "the byte models, host reads, buffer reuse, retrace) "
                    "+ registry lint + lock pass")
    ap.add_argument("--graph", default="er:4096", metavar="KIND[:N]",
                    help="graph spec to audit plans against")
    ap.add_argument("--all-variants", action="store_true",
                    help="audit every partition x wire-format x mode x "
                         "fused-tail variant (the gate); default audits "
                         "the single variant named by --partition/--mode/"
                         "--wire-format")
    ap.add_argument("--partition", default="1d", choices=["1d", "2d"])
    ap.add_argument("--mode", default="auto", choices=list(MODES))
    ap.add_argument("--wire-format", default="auto", choices=list(WIRES))
    ap.add_argument("--fused-tail", default="auto",
                    choices=["auto", "on", "off"],
                    help="fused fold/owner-update tail for the single-"
                         "variant audit (--all-variants always audits "
                         "both twins)")
    ap.add_argument("--grid", default=None, metavar="RxC",
                    help="2-D grid (default: most-square factorization)")
    ap.add_argument("--sources", type=int, default=1,
                    help="compiled source-batch capacity S")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device every shard lives on (default cuda)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards of the in-process LocalMesh (default 1)")
    ap.add_argument("--tolerance", default=None, metavar="LO,HI",
                    help="recorded-vs-model byte ratio band "
                         f"(default {collective_audit.DEFAULT_TOLERANCE})")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the full audit ledger json")
    ap.add_argument("--census", action="store_true",
                    help="print the per-variant census table")
    ap.add_argument("--skip-lint", action="store_true")
    ap.add_argument("--skip-locks", action="store_true")
    ap.add_argument("--skip-run-check", action="store_true",
                    help="skip the two-run retrace check (HA006)")
    args = ap.parse_args(argv)

    tol = collective_audit.DEFAULT_TOLERANCE
    if args.tolerance:
        lo, hi = (float(x) for x in args.tolerance.split(","))
        tol = (lo, hi)

    _, kind, n, spec_grid = parse_graph_spec(args.graph, 4096)
    dev = resolve_cli_device(args.device)
    p = max(1, args.devices)
    grid = spec_grid
    if grid is None:
        grid = (tuple(int(x) for x in args.grid.lower().split("x"))
                if args.grid else default_grid(p))
    r, c = grid
    if args.all_variants or args.partition == "2d":
        if r * c != p:
            ap.error(f"grid {r}x{c} needs {r * c} shards, not --devices {p}")
    print(f"audit: graph={kind}:{n} p={p} grid={r}x{c} device={dev} "
          f"tolerance={list(tol)}")

    src, dst = generate(kind, n, seed=0)
    mesh_1d = LocalMesh.flat(p, dev)
    g1 = shard_graph(src, dst, n, p)
    g2 = shard_graph_2d(src, dst, n, r, c) if p > 1 else None
    mesh_2d = LocalMesh.grid(r, c, dev) if p > 1 else None

    cache = EngineCache()
    reports = []
    failed = False
    planned = 0
    worst = {}
    for part, mode, wire, fused in _variants(p, args.all_variants, args):
        planned += 1
        opts = BFSOptions(mode=mode, wire_format=wire,
                          use_fused_tail=fused)
        t0 = time.time()
        if part == "2d":
            pl = plan(g2 if g2 is not None else g1, opts,
                      mesh=mesh_2d or LocalMesh.grid(1, 1, dev),
                      num_sources=args.sources, partition="2d")
        else:
            pl = plan(g1, opts, mesh=mesh_1d, num_sources=args.sources)
        if (args.all_variants and fused == "auto"
                and not pl.use_fused_tail):
            # "auto" resolved the fused tail off — this plan_key is the
            # fused=False twin already audited; skip the duplicate report
            continue
        engine = cache.get_or_compile(pl)
        fused_tag = ":fused" if pl.use_fused_tail else ""
        rep = collective_audit.audit_engine(
            engine, tolerance=tol, run_check=not args.skip_run_check,
            name=f"census:{part}:{mode}:{wire}:S{args.sources}{fused_tag}")
        coll = rep.info["collectives"]
        per_level = ", ".join(f"{k} {v:g}" for k, v in
                              sorted(coll["per_level"].items()))
        print(f"{rep.summary()}  "
              f"[{coll['loop_data']} data + {coll['loop_control']} control "
              f"collectives in {sum(rep.info['levels'].values())} levels "
              f"(a level: {per_level}); "
              f"{rep.info['host_reads']['max_per_level']} host reads at "
              f"most a level; {time.time() - t0:.1f}s]")
        if args.census:
            print(collective_audit.census_table(rep))
        for v in rep.violations:
            print(f"  {v}")
        for role, rr in rep.info["ratios"].items():
            w = worst.setdefault(role, [rr["min"], rr["max"]])
            w[0], w[1] = min(w[0], rr["min"]), max(w[1], rr["max"])
        failed |= not rep.ok()
        reports.append(rep)

    print(f"variants: {planned} planned, {len(reports)} audited")
    print("recorded/modeled bytes by role (least, most over the variants): "
          + ", ".join(f"{role} {lo:.3f}..{hi:.3f}"
                      for role, (lo, hi) in sorted(worst.items())))
    if not args.skip_lint:
        rep = lint_tree()
        print(rep.summary() + f"  [{len(rep.info['registrations'])} "
              "registrations checked]")
        for v in rep.violations:
            print(f"  {v}")
        failed |= not rep.ok()
        reports.append(rep)
    if not args.skip_locks:
        rep = analyze_serve()
        print(rep.summary() + f"  [{len(rep.info['lock_edges'])} lock "
              "edges]")
        for v in rep.violations:
            print(f"  {v}")
        failed |= not rep.ok()
        reports.append(rep)

    st = cache.stats()
    print(f"engine cache: hits={st['hits']} misses={st['misses']} "
          f"compile_s={st['compile_s_total']:.1f}")
    if args.out:
        ledger = {
            "audit": {
                "graph": {"kind": kind, "n": n}, "p": p,
                "grid": [r, c], "device": str(dev),
                "tolerance": list(tol), "ok": not failed,
                "variants": {"planned": planned,
                             "audited": sum(1 for rep in reports
                                            if rep.name.startswith(
                                                "census:"))},
                "byte_ratios": worst,
                "reports": [rep.to_dict() for rep in reports],
            },
        }
        with open(args.out, "w") as f:
            json.dump(ledger, f, indent=2, sort_keys=True, default=str)
        print(f"wrote {args.out}")
    print("audit: " + ("FAIL" if failed else "PASS"))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
