"""Quickstart on the PyTorch port: distributed BFS on all three paper graph
families — the twin of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Runs the port's 1-D-partitioned engine in every frontier mode on a
small-world, an Erdős-Rényi and a star graph through the compile-once
lifecycle (``plan(...).compile()`` then ``engine.run(source)``),
validates against the port's serial oracle, and prints the per-mode
communication volumes.  Each engine is reused for a second traversal
from a different source (no new compile).  ``--device`` picks where the
shards live (default ``cuda``; without a card, pass ``--device cpu``).
"""

import argparse

import numpy as np

from repro_torch.core import BFSOptions, plan
from repro_torch.core.ref import INF, bfs_reference
from repro_torch.graphs import generate, shard_graph
from repro_torch.launch import resolve_cli_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--n", type=int, default=20_000)
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)
    n = args.n
    bad = 0
    for kind, kw in (("small_world", {"k": 8, "beta": 0.1}),
                     ("erdos_renyi", {"avg_degree": 8.0}),
                     ("star", {})):
        src, dst = generate(kind, n, seed=0, **kw)
        g = shard_graph(src, dst, n, p=1)
        want = bfs_reference(src, dst, n, [0])
        want2 = bfs_reference(src, dst, n, [n // 2])
        print(f"\n== {kind}: n={n} directed_edges={src.shape[0]} ==")
        for mode in ("dense", "queue", "auto"):
            for strat in (("allgather_merge", "baseline [2]"),
                          ("alltoall_direct", "paper-optimized")):
                opts = BFSOptions(mode=mode, dense_exchange=strat[0],
                                  queue_exchange=strat[0],
                                  queue_cap=1 << 14)
                engine = plan(g, opts, device=dev).compile()
                res = engine.run([0])
                stats = res.stats()
                ok = np.array_equal(res.dist_host, want)
                # reuse: new source, same engine, no new compile
                ok &= np.array_equal(engine.run([n // 2]).dist_host, want2)
                ok &= engine.trace_count == engine.compile_traces
                bad += not ok
                print(f"  mode={mode:6s} exchange={strat[1]:16s} "
                      f"levels={stats.levels:3d} "
                      f"visited={stats.visited:6d} "
                      f"comm_bytes/chip={stats.comm_bytes:12.0f} "
                      f"{'OK' if ok else 'MISMATCH'}")
        reach = int((want < INF).sum())
        print(f"  reachable from source: {reach}/{n}")
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
