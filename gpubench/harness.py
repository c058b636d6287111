"""One run of one cell: load the graph, build the engine, warm it up, run
the closed loop for the window, check the distances against the plain
reference, and compute the cell's metrics.

Everything that belongs to one configuration, traffic mix or metric is a
file found by its name in ``BENCHMARK.json``:
``gpubench/configs/<config>.json``, ``gpubench/traffic/<traffic>.json``
and ``gpubench/metrics/<metric>.py`` (a ``read(run)`` that returns the
number, or None where the run has nothing for it to read).  ``run_cell``
takes the root that holds ``BENCHMARK.json`` and those folders, so a
configuration, a mix or a metric is added by adding files.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from gpubench import graph500, tracing
from gpubench.reference import bfs as reference

HERE = Path(__file__).resolve().parent
ROOT_RULES = ("uniform_nonisolated",)


@dataclass
class Batch:
    seconds: float
    levels: int
    edges: int                 # Graph500's traversed edges, summed over roots


@dataclass
class Run:
    """What a run leaves for the metric readers."""

    config: dict
    traffic: dict
    graph: graph500.Graph
    setup_s: float = 0.0
    spans: dict = field(default_factory=dict)      # host seconds by name
    batches: list = field(default_factory=list)    # the window's Batch list
    window_s: float = 0.0
    peak_bytes: int = 0
    device: object = "cpu"     # where the run's tensors live
    traced: list = field(default_factory=list)     # per traced batch: the
    # OR over the roots of each level's frontier, bool (n,) on the device
    traced_roots: list = field(default_factory=list)   # each traced batch's
    # roots, as the pool holds them
    trace: tracing.Trace | None = None
    first_untraced: int = 0    # index of the first batch outside the trace

    @property
    def sources(self) -> int:
        return int(self.traffic["sources"])

    @property
    def p(self) -> int:
        return int(self.config["partition"]["p"])


def load_spec(root: Path, workload: str):
    """The cell's entry of ``root/BENCHMARK.json`` with its configuration
    and traffic files, and the metrics it reports at ``--trace 0`` and
    ``--trace 1``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[cell["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / HERE.name / "traffic" / f"{cell['traffic']}.json").read_text())

    def mine(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return cell, config, traffic, e2e, layer


def reader(root: Path, name: str):
    """``gpubench/metrics/<name>.py``'s ``read``."""
    path = root / HERE.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gpubench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def default_engine(sharded, run: Run, device):
    """The engine every cell drives: the port's compile-once lifecycle over
    a flat ``LocalMesh`` of the configuration's ``p`` shards on the one
    device, with the traffic's ``BFSOptions``."""
    from repro_torch.core import BFSOptions, LocalMesh, plan

    opts = BFSOptions(**run.traffic.get("options", {}))
    return plan(sharded, opts, mesh=LocalMesh.flat(run.p, device),
                num_sources=run.sources).compile()


def root_batches(traffic: dict, graph: graph500.Graph) -> list:
    """The traffic's pool of root batches: ``pool_batches`` batches of
    ``sources`` roots each, drawn from the mix's own fixed ``pool_seed``,
    uniformly and without repeats within a batch, among the vertices of
    degree >= 1 (Graph500's rule for its search keys)."""
    rule = traffic["roots"]
    if rule not in ROOT_RULES:
        raise ValueError(f"unknown root rule {rule!r}; have {ROOT_RULES}")
    rng = np.random.default_rng(int(traffic["pool_seed"]))
    return [rng.choice(graph.root_pool, int(traffic["sources"]),
                       replace=False)
            for _ in range(int(traffic["pool_batches"]))]


def batch_order(n: int, rng):
    """Indices into a pool of ``n`` batches: whole passes, each a fresh
    permutation drawn from ``rng``, so every seed runs the same batches in
    another order."""
    while True:
        yield from rng.permutation(n).tolist()


def _level_frontiers(eng, roots, n: int) -> list:
    """Each level's frontier of one batch, OR-ed over its roots: a bool
    ``(n,)`` a level, from the distances of the batch run again."""
    res = eng.run(roots)
    dist = res.dist[:n, :len(roots)]
    return [(dist == lv).any(dim=1) for lv in range(int(res.run_stats.levels))]


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, *, t_start: float | None = None,
             cache_dir: Path | None = None, make_engine=default_engine,
             log=print) -> dict:
    """One run of ``workload``; returns the result object the benchmark
    prints.  ``t_start`` is the process's start on ``time.monotonic``'s
    clock (set-up is measured from it); ``make_engine(sharded, run,
    device)`` builds what the window drives."""
    import torch

    from repro_torch.graphs.formats import shard_graph

    t_start = time.monotonic() if t_start is None else t_start
    root = Path(root)
    cell, config, traffic, e2e, layer = load_spec(root, workload)
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise ValueError("only a closed loop with one client is built: "
                         f"{traffic['loop']!r}, {traffic['clients']} clients")
    cuda = torch.device(device).type == "cuda"
    streams = np.random.SeedSequence(int(seed)).spawn(3)
    warm_rng, order_rng, sample_rng = (np.random.default_rng(s)
                                       for s in streams)

    graph, generated = graph500.load(
        config, cache_dir or root / HERE.name / ".cache", device)
    run = Run(config=config, traffic=traffic, graph=graph, device=device)
    if cuda:
        torch.zeros(1, device=device)      # the allocator exists from here
        torch.cuda.reset_peak_memory_stats(device)
    p = run.p

    t0 = time.monotonic()
    sharded = shard_graph(graph.src, graph.dst, graph.n, p)
    run.spans["shard_graph"] = time.monotonic() - t0
    t0 = time.monotonic()
    eng = make_engine(sharded, run, device)
    if cuda:
        torch.cuda.synchronize(device)
    run.spans["plan_compile"] = time.monotonic() - t0

    pool = root_batches(traffic, graph)
    warm_order, order = (batch_order(len(pool), r)
                         for r in (warm_rng, order_rng))
    warm = []
    for _ in range(int(traffic["warmup_batches"])):
        roots = pool[next(warm_order)]
        t0 = time.perf_counter()
        eng.run(roots)
        warm.append(time.perf_counter() - t0)

    # the batches whose distances the reference checks: the window's last
    # and, drawn from the seed, others among the first half of the batches
    # the warm-up says the window will hold (none of them traced); each
    # gets a pinned host buffer, so its copy inside the window is short
    n_traced = int(traffic["trace_batches"]) if trace else 0
    expect = max(1, int(seconds / max(min(warm, default=1.0), 1e-6)))
    among = range(n_traced, max(n_traced + 1, expect // 2))
    n_draw = min(int(traffic["check_batches"]) - 1, len(among))
    sampled = {int(among[k]): torch.empty((graph.n, run.sources),
                                          dtype=torch.int32, pin_memory=cuda)
               for k in sample_rng.choice(len(among), n_draw, replace=False)}
    run.setup_s = time.monotonic() - t_start

    checked = {}                  # batch index -> (roots, host distances)
    prof, traced_roots = None, []
    if n_traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        window_range = record_function(tracing.WINDOW_RANGE)
        window_range.__enter__()

    t_window = time.perf_counter()
    res, i = None, 0
    while True:
        roots = pool[next(order)]
        t0 = time.perf_counter()
        res = eng.run(roots)
        t1 = time.perf_counter()
        run.batches.append(Batch(t1 - t0, int(res.run_stats.levels),
                                 int(graph.comp_edges[roots].sum())))
        if i in sampled:
            held = sampled[i].copy_(res.dist[:graph.n, :len(roots)])
            checked[i] = (roots, held.numpy())
        if i < n_traced:
            traced_roots.append(roots)
            if i == n_traced - 1:
                window_range.__exit__(None, None, None)
                prof.__exit__(None, None, None)
        i += 1
        if t1 - t_window >= seconds and i >= n_traced:
            break
    run.window_s = t1 - t_window
    run.first_untraced = n_traced
    checked[i - 1] = (roots, res.dist_host)
    if cuda:
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    ms = np.array([b.seconds for b in run.batches]) * 1e3
    levels = np.bincount([b.levels for b in run.batches]).tolist()
    log(f"window: {len(run.batches)} batches in {run.window_s:.3f} s; batch "
        f"ms min {ms.min():.3f} median {np.median(ms):.3f} max "
        f"{ms.max():.3f}; batches by level count {levels}; spans "
        f"{run.spans}; set-up {run.setup_s:.3f} s (graph "
        f"{'generated' if generated else 'from the cache'}); warm-up "
        f"{[round(w, 4) for w in warm]} s", file=sys.stderr)

    if n_traced:
        # the traced batches again, after the window: each level's
        # frontier, OR-ed over the roots, for the byte counts
        run.traced = [_level_frontiers(eng, roots, graph.n)
                      for roots in traced_roots]
        run.traced_roots = traced_roots
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            run.trace = tracing.load(path)

    # the check, once the window has closed and the program's state is
    # freed: every checked batch's distances against the plain reference
    del eng, res, sharded
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    mismatches, failed = 0, 0
    for idx in sorted(checked):
        roots, got = checked[idx]
        want = reference.bfs(graph.src, graph.dst, graph.n, roots,
                             device=device)
        bad = (int((got != want).sum()) if got.shape == want.shape
               else int(want.size))
        mismatches += bad
        failed += bad > 0

    metrics = {}
    for m in (layer if trace else e2e):
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": run.peak_bytes}
    out = {"correct": mismatches == 0, "attempted": len(run.batches),
           "failed": failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.top_ops(),
                            "idle_gaps": run.trace.top_idle()}
    log(f"checked {len(checked)} batches: {sorted(checked)}",
        file=sys.stderr)
    out["checks"] = {"dist_mismatches": {"value": mismatches, "limit": 0}}
    return out
