"""End-to-end driver for the paper's experiment grid (paper §3-4) on the
PyTorch port — the twin of ``examples/bfs_scaling.py``.

    PYTHONPATH=src python examples/bfs_scaling_torch.py [--full]
    PYTHONPATH=src python examples/bfs_scaling_torch.py --device cpu

Default runs reduced vertex counts; --full uses the paper's exact sizes
(4M-vertex star, 100k ER/small-world).  For every workload it runs one
traversal on one shard of ``--device`` (default ``cuda``; without a card,
pass ``--device cpu``) and prints the strong-scaling table: the measured
traversal time split over p shards, plus each level's exchange bytes
(the registry's byte models) priced over the link of a p-card H100 host,
``launch.roofline.NVLINK_BW`` (NVLink 4 of the SXM part, one direction;
NVIDIA's data sheet, at the card's 700 W limit), for the baseline
(``allgather_merge``) and the optimized (``alltoall_direct``) exchange,
reproducing the shapes of paper figs. 4, 6 and 8.  The times are the
model's, not a run on p cards.
"""

import argparse
import time

from repro_torch.configs.base import BFS_WORKLOADS
from repro_torch.core import BFSOptions, plan
from repro_torch.core import exchange as ex
from repro_torch.graphs import generate, shard_graph
from repro_torch.launch import resolve_cli_device
from repro_torch.launch.roofline import NVLINK_BW

REDUCED = {"star_4m": 400_000, "erdos_renyi_100k": 100_000,
           "small_world_100k": 100_000, "rmat_1m": 131_072}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper-exact sizes (4M star etc.)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_cli_device(args.device)
    print(f"device={dev}; exchange priced over NVLink at "
          f"{NVLINK_BW / 1e9:.0f} GB/s a direction (H100 SXM, 700 W)")

    for wl in BFS_WORKLOADS:
        n = wl.n_vertices if args.full else REDUCED[wl.name]
        kw = dict(wl.gen_kwargs)
        t0 = time.time()
        src, dst = generate(wl.graph, n, seed=0, **kw)
        g = shard_graph(src, dst, n, p=1)
        gen_s = time.time() - t0
        print(f"\n== {wl.name}: n={n} edges={src.shape[0]} "
              f"(generated in {gen_s:.1f}s, chunked per paper §3.1) ==")
        opts = BFSOptions(mode="auto", queue_cap=1 << 15)
        t0 = time.time()
        engine = plan(g, opts, device=dev).compile()
        compile_s = time.time() - t0
        engine.run([0])                       # first dispatch (warm)
        t0 = time.time()
        res = engine.run([0])                 # run() ends in a device sync
        step_s = time.time() - t0
        stats = res.stats()
        print(f"  BFS: levels={stats.levels} visited={stats.visited} "
              f"modes={stats.mode_counts} compile={compile_s:.2f}s "
              f"run={step_s:.2f}s (compile paid once per graph/options)")
        print(f"  {'p':>4s} {'baseline_total':>15s} {'optimized_total':>16s} "
              f"{'ratio':>6s}")
        for p in (1, 2, 4, 8, 16, 32, 64):
            comp = step_s / p
            base = comp + stats.levels * ex.dense_level_bytes(
                "allgather_merge", g.part.n, p) / NVLINK_BW
            opt = comp + stats.levels * ex.dense_level_bytes(
                "alltoall_direct", g.part.n, p) / NVLINK_BW
            print(f"  {p:>4d} {base:>14.4f}s {opt:>15.4f}s "
                  f"{base/opt:>6.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
