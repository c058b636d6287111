#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (BFS on the 1-D and 2-D partitions in the
dense, queue and auto modes, BFS serving over HTTP, LM prefill, DeepFM
serving and the EmbeddingBag op) on one card.

    python3 chip_smoke.py            # full size, as the acceptance run
    python3 chip_smoke.py --profile  # also profile one run of each path

Phases (any failed check raises and the script exits non-zero):

1. build — compiles every ``src/repro_torch/csrc/*.cu`` (the BFS kernels,
   the attention kernels and the EmbeddingBag kernel, one nvcc each, in
   parallel) for sm_90a into
   one library under ``build/kernels/`` and prints the compiler's
   register report (and ``bsr_expand_bits``' lines of it on their own)
   and the card's name and power limit; counts the
   ``HGMMA`` and ``UTMALDG`` instructions in the SASS of the bf16 A4
   kernel (``cuobjdump -sass``) and fails if either is 0; prints the
   register report of A5's ``bag_gather_kernel`` (each dtype and
   granule), failing on a spill, and counts its ``LDGSTS`` (``cp.async``)
   and ``UBLKCP`` (bulk copy) instructions, failing if it has no
   asynchronous copy.
2. path 1 — ``rmat_1m`` (Graph500 Kronecker, scale 20, edge factor 16)
   with the default dense expansion, S = 64 roots: once on a 4-shard
   ``LocalMesh`` with default options (packed wire, fused tail = kernel
   A1) and once on one shard with ``wire_format="packed"``.
3. path 3 — the same graph and roots with ``use_kernel=True`` on 4
   shards, default options: the one-bit tile expansion
   (``bsr_expand_bits``) and A1; distances bitwise equal to path 1's.
4. path 2 — ``small_world_100k`` (Watts-Strogatz k = 16, beta = 0.1)
   with ``use_kernel=True`` (``bsr_expand_bits`` and A1), one shard,
   packed wire, S = 64, against the same plan without ``use_kernel``.
   Every path resets the kernels' launch counts just before it runs and
   reads them just after; every kernel of the path must have launched,
   and under ``use_kernel`` the f32 A2 and A3 never.
   Distances are checked with ``validate_bfs`` (Graph500 rules) on every
   column and against scipy's BFS on four columns, bitwise.  Then the
   cost of the level loop's profiler ranges on this host-bound engine:
   its run time with the ranges as shipped (idle: nothing records with
   no profiler), replaced by a no-op, and forced (a ``record_function`` a
   range), in alternating rounds in this one process (printed, not
   checked: host times vary by more than the ranges cost).
5. path 4 — ``rmat_1m`` with path 1's roots, p = 4, default options, in the
   modes that mix level kinds: (a) ``mode="auto"``, S = 64 (dense and
   packed bottom-up levels, the fused tail A1 on the dense ones); (b)
   ``mode="auto"`` and (c) ``mode="queue"``, S = 1 (the visited sieve and
   the compressed queue wire), on the first 8 roots, the first three times.
   Distances bitwise path 1's (columns); (a)'s and (b)'s ``mode_counts``
   equal a numpy replay of the auto rule from the distances; A1 launches
   once per dense level of (a) and no other kernel does.
6. path 5 — the same graph and roots on the 2-D edge partition:
   ``to_2d(g, 2, 2)`` on a 2 x 2 ``LocalMesh.grid``, default options
   (packed expand and fold wires, A1 on the fused fold tail): (a)
   ``mode="dense"``, S = 64, three runs, A1 exactly once a level and no
   other kernel, ``comm_bytes`` the float32 sum of ``dense_level_bytes``
   a level; (b) ``mode="auto"``, S = 64; (c) ``mode="auto"`` and (d)
   ``mode="queue"``, S = 1, on the first 8 roots.  Distances bitwise path
   1's (columns); the auto ``mode_counts`` equal the numpy replay (the
   2-D auto rule is the 1-D rule on the same statistics).  Logs each
   cell's edges, ``e_cap`` and the host seconds of ``to_2d`` and of the
   bottom-up blocks.
7. path 6 — serving: path 1's ``rmat_1m`` and path 2's
   ``small_world_100k`` behind ``BFSService`` and ``serve_http``, with one
   ``GraphCatalog`` and one ``EngineCache``, ladder (1, 8, 64) on four
   lanes: ``rmat`` (p = 4, default options: A1 on the fused tail),
   ``rmat2d`` (the catalog's 2 x 2 view, path 5's cached ``to_2d``),
   ``sw`` (``use_kernel``, packed wire: ``bsr_expand_bits`` and A1) and
   ``rmat_alias`` (rmat's graph under a second name: its plans key equal,
   so it compiles nothing).  Every rung is compiled through the cache and
   run once at full S first: its ``estimated_device_bytes()`` must cover
   the measured ``max_memory_allocated`` rise, and a lane's later rungs
   hold the first rung's block uploads (memory grows by their working
   buffers).  Then 8 client threads (stdlib ``urllib``, 60 s a call) send
   48 ``POST /v1/traverse``, lanes in rotation, fan-outs drawn from
   {1, 3, 8, 17, 64}, sources from the paths' 64 roots, a quarter with
   parents: depths bitwise the paths' columns, parents by the JAX
   client's rule, the cache's compiles equal the 9 distinct plan keys, A1
   launched once a level of the 48 runs and ``bsr_expand_bits`` once a
   level of the ``sw`` runs, no other kernel; a ``BFSService.step`` of
   one request a lane against the lanes one at a time (the round's
   overlap); ``/admin/shutdown`` drains and stops.  Then a second cache
   with a byte budget between two and three ``rmat`` rung estimates:
   serving S = 1, 8, 64 evicts S = 1, freeing at least its working
   buffers, and S = 1 then recompiles bitwise.  Last, a ``FaultPlan``
   failing ``cache.compile`` for ``rmat``'s S = 64 rung: a 40-source
   request is served by the ``split:8`` arm, five runs of one engine,
   bitwise, and ``/metrics`` shows the arm.
8. path 7 — the launchers, each ``main(argv)`` called in process so the
   kernel counts see its launches: (a) ``bfs_run --workload rmat_1m
   --devices 4 --mode dense --sources 64 --repeats 2 --profile DIR`` (not
   cut): run 0 (sources 0..63) prints the levels, visited, modes and
   ``comm_bytes/chip`` of path 1's p = 4 engine on those sources, its
   distances pass ``validate_bfs`` and scipy, A1 launches once a level of
   the two runs and no other kernel, and ``analysis.trace_model``'s
   summary has a row a level, the device events it places at their
   launch cover all but 1% of the device time in the trace file,
   ``other`` is under 2% of the time inside the levels, and ``expand``
   is the largest phase; (b) the same on the
   2 x 2 grid in ``auto`` (``--repeats 1``): levels, visited and modes of
   path 5 (b)'s engine on 0..63; (c) after path 6's service is released,
   ``bfs_serve --devices 4 --http`` on ``rmat:1048576``, its 2 x 2 twin
   and ``small_world:100000`` (``bfs_serve``'s generator defaults, as the
   JAX launcher's: rmat edge factor 8, small-world k = 8), ladder
   (1, 8, 64), a 5 s watchdog, in a thread; ``bfs_client --requests 12
   --max-retries 2 --verify`` on each lane in subprocesses (the last with
   ``--shutdown``) exits 0, the server drains and returns 0, A1 launched;
   (d) ``bfs_chaos --devices 4 --secs 20 --n 100000`` exits 0 with at
   least one ``cache.get`` storm and a bitwise 200 requested after it.
9. path 8 — the plan audits (``analysis.collective_audit``, ``lint``,
   ``locks``), each entry point called in process: (a) ``bfs_audit
   --graph er:4096 --all-variants --devices 4 --census --out
   build/chip_smoke_path8/BENCH_audit_torch.json`` exits 0: 48 variants
   planned, each distinct one audited clean, with the host reads of
   every level counted by ``torch.cuda.set_sync_debug_mode`` within the
   budget; it prints the data collectives a level by level kind and the
   least and most recorded-to-modeled byte ratio by role; (b) ``bfs_run
   --workload rmat_1m --devices 4 --mode dense --sources 64 --repeats 2
   --audit`` (not cut): the audit passes, each ``dense`` row receives
   ``describe()["dense_level_bytes"]`` within the tolerance, the audited
   run's distances are bitwise path 1's p = 4 engine on sources 0..63,
   run 0 prints that engine's line, and A1 launches once a level of the
   audited run, the audit's two buffer-check runs and the two timed
   runs; then a ``use_kernel`` engine on ``small_world_100k`` at p = 4,
   audited from path 2's roots: clean, distances bitwise path 2's,
   ``bsr_expand_bits`` and A1 once a level.  Paths 1, 3, 4 (a) and 5 (a)
   print each level kind's ``describe()["roofline"]`` ``t_level_s``
   beside the measured ms a level, and the share.
10. path 9 — ``DistMesh``, one shard a process (``core.dist_mesh``): the
   parent writes the graphs and expected distances it already holds to
   ``build/chip_smoke_path9/`` once (no rank regenerates R-MAT), then
   starts the processes with ``spawn`` (the kernels were built before;
   a process group's collectives time out after 120 s, and every process
   is killed and failed at 420 s).  (a) ``nccl`` at world size 1:
   ``rmat_1m`` at p = 1, packed wire, S = 64, path 1's roots: bitwise
   path 1's p = 1 run, A1 once a level.  Then four ``gloo`` processes
   sharing ``cuda:0`` (NCCL refuses two ranks on one GPU; a ``gloo``
   collective that refuses CUDA tensors is staged through the host, and
   the transport is printed): (b) ``rmat_1m`` p = 4, default options,
   S = 64: distances, ``levels`` and ``comm_bytes`` bitwise path 1's
   p = 4 run, A1 once a level on each rank, each rank's
   ``estimated_device_bytes`` and ``memory_allocated`` after compile, and
   the ranks' ``resident`` terms summing to the stacked engine's; (f)
   every rank audits (b)'s engine and rank 0's census is printed: clean,
   every role at ratio 1.000, the host reads within the budget; (c)
   ``auto`` S = 1 on path 4's first 8 roots: bitwise, ``mode_counts``
   equal to ``replay_modes``; (d) ``DistMesh.grid(2, 2)`` dense S = 64:
   bitwise path 5 (a), its levels and ``comm_bytes``; (e)
   ``small_world_100k`` with ``use_kernel`` at p = 4: bitwise path 2,
   ``bsr_expand_bits`` once a level on each rank; and a planted fault,
   rank 1 reporting the next shard's index, whose distances must fail
   the check.  (b)'s and (d)'s ms a level print beside paths 1's and 5
   (a)'s: ``gloo`` through the host on one card, not a multi-card figure.
11. prefill — gemma3-12b at full width (d_model 3840, 16 q / 8 kv heads of
   256, d_ff 15360, vocab 262144, bf16) through ``build_bundle(...,
   "prefill_32k")``, cut to 12 layers (two 5 local + 1 global groups) and
   batch 2 x seq 8192, with random weights from a seeded generator on the
   card.  Three runs, each with kernel A4's bf16 route launched once per
   layer; runs 2
   and 3 bitwise equal; then the same prefill with the plain attention,
   held to a stated tolerance (the first layer's cache bitwise), which
   two planted faults (every local window one key off) must fail.
12. recsys — DeepFM at its full configuration (39 fields x 1,000,000 rows
   x 10, a 1.56 GB f32 table, MLP 403-400-400-400-1), not cut, through
   ``build_bundle(get_arch("deepfm"), ...)`` for ``serve_p99``,
   ``serve_bulk`` and ``retrieval_cand``, with random weights from a
   seeded generator on the card.  Three runs of each step (runs 2 and 3
   bitwise equal), held to the port's own steps on the CPU in float64
   from the same weights: gathered rows bitwise, the FM term, logits and
   scores at a stated relative L2 limit.  Two planted faults must fail
   that hold: every field offset one row off, and (serve) TF32 products.  DeepFM looks its fields up
   with a row gather, as the JAX package does, so no kernel launches.
13. embedding bag — the lookup op ``kernels.embedding_bag.ops.embedding_bag``
   (kernel A5) on (a) the ``serve_bulk`` batch's own flat ids as bags
   over DeepFM's table (the op's main path, three calls; also held to the
   serve path's ``emb.sum(1)``), (b) the same bags cut to seeded ragged
   lengths, sum and mean, both on the gather route (``bag_gather_kernel``),
   (c) ``bench_kernels``' shape, (256, 8) over (10,000, 128), in f32 and
   bf16, and (d) bf16 over (10,000, 127), these three tables in L2 and so
   on the plain-load route (``bag_sum_kernel``); bitwise to its plain
   version each time, by the route the shape takes and by the other one.
   Timed on (a) and (b): the wrapper, its index check, the launch alone
   and each route's launch (each held bitwise), beside the bound of the
   useful bytes and that of the 32-byte sectors the rows span; and on
   (a)'s ids over a (V, 8) f32 table (one sector a row) and over the
   table's first 100,000 rows (a 4 MB table, the plain-load route).
14. kernels — each kernel against its plain torch version on the card at
   the shapes of the paths (A4 also each (batch, head) slice, with the
   window one key off failing; ``bsr_expand_bits`` on path 2's densest
   level and on a random 5% frontier, and the f32 A2 + A3 chain of
   ``ops.frontier_expand_packed``, driven on its own, held bitwise to
   it), then timed beside its bound (and, for A2,
   beside ``torch.sparse_bsr_tensor @ x``; for A4, beside
   ``F.scaled_dot_product_attention`` on the global layer's shape and, with
   the window as a boolean ``attn_mask``, on the local layer's; for A5,
   beside ``F.embedding_bag`` with per-slot weights on (a)).

The last line is ``{"ok": true, "device": {...}}``; before it come one
``{"kernels": [...]}`` JSON line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import multiprocessing
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
S = 64
MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
F32_FLOPS = 67e12         # H100 SXM f32 FLOP/s outside the tensor cores
BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
# the prefill phase: gemma3-12b's prefill_32k cell, cut in depth and size
PREFILL_LAYERS, PREFILL_BATCH, PREFILL_SEQ = 12, 2, 8192
# A4 against its plain version, bf16: the largest relative L2 error of one
# (batch, head) slice.  The kernel rounds each p to bf16 before PV (a
# relative error of at most 2^-8, RMS 2^-8/sqrt(3)) and both round the
# output to bf16 once.  On an H100 the correct kernel reads at most
# 0.0023 (2^-8.8) a head and a window one key off at least 0.020
# (2^-5.6), at the prefill's shapes; 2^-7 sits a factor of about 3 from
# each, and the script checks that the planted fault fails.
A4_HEAD_TOL = 2.0 ** -7
# the prefill with A4 against the same prefill with the plain attention:
# relative L2 of the logits and of each layer's cache.  The bf16 drift
# grows with depth: 0.0078 in layer 1's cache to 0.0184 in the logits at
# 12 layers (seed 0, H100); 2^-5 leaves a factor of 1.7.
PREFILL_TOL = 2.0 ** -5
# the recsys phase: DeepFM's steps, not cut, and the rows of each held to
# the f64 CPU twin (the first rows of the batch, or of the candidates)
RECSYS_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_HOLD = {"serve_p99": 512, "serve_bulk": 4096,
               "retrieval_cand": 65_536}
# f32 on the card (matrix products in full f32: allow_tf32 is False)
# against f64 on the CPU: relative L2 of the logits and scores (serve) and
# of the scores (retrieval); the FM term (about 1e-2 of the logits) is held
# on its own.  On an H100 the correct steps read at most 2.6e-7 (serve_bulk
# logits) and the FM term 2.2e-7; field offsets one row off read at least
# 0.043 (serve scores) and FM 1.4.  2^-20 sits 3.7 times above the worst
# correct reading; the serve steps with TF32 products (10-bit mantissa),
# a second planted fault, must fail it too.
RECSYS_TOL = 2.0 ** -20
FM_TOL = 2.0 ** -20


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float = 0.0, peak: float = F32_FLOPS):
    """Least time (ms) for the work on the card, and what bounds it."""
    t_mem, t_ops = nbytes / MEM_BW, flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# the highest device memory of the phases before the last peak reset
_EARLIER_PEAK = 0


def reset_peak() -> None:
    """Start a phase's peak memory reading; the script's own peak keeps
    the highest reading of every phase."""
    global _EARLIER_PEAK
    torch.cuda.synchronize()
    _EARLIER_PEAK = max(_EARLIER_PEAK, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    """Peak device memory since the script started, in GiB."""
    return max(_EARLIER_PEAK, torch.cuda.max_memory_allocated()) / 2**30


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def scipy_check(src, dst, n, roots, dist_host, inf):
    """Bitwise agreement of four columns with scipy's unweighted BFS."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    adj = csr_matrix((np.ones(src.shape[0], np.int8), (src, dst)),
                     shape=(n, n))
    sp = shortest_path(adj, method="D", directed=True, unweighted=True,
                       indices=roots[:4])
    want = np.where(np.isinf(sp), inf, sp).astype(np.int32).T
    check(np.array_equal(dist_host[:, :4], want),
          "dist differs from scipy's BFS on the first four roots")


def reset_counts(kernels) -> None:
    """Set every kernel's launch counts (A4's per-route ones too) to 0."""
    for k in kernels.values():
        for attr in ("launches", "launches_bf16", "launches_f32",
                     "launches_gather", "launches_loads"):
            if hasattr(k, attr):
                setattr(k, attr, 0)


def library_sass(lib: Path) -> str:
    """The SASS of the built library (``cuobjdump -sass``)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_counts(sass: str, pattern: str, ops) -> dict:
    """For each kernel whose mangled name matches ``pattern`` (keyed by
    its groups joined with "/"), the count of each instruction of ``ops``
    and the highest register named in its SASS."""
    import re

    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*" + pattern, line)
        if m or "Function : " in line:
            fn = "/".join(m.groups()) if m else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0) | {"max_reg": 0}
        elif fn:
            for op in ops:
                counts[fn][op] += op in line
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            counts[fn]["max_reg"] = max([counts[fn]["max_reg"], *regs])
    return counts


def drive(kernels, eng, roots, runs: int = 3):
    """Reset the launch counts, run the engine ``runs`` times and read the
    counts; returns (host dist of the last run, per-run ms of runs 2..,
    last result, counts)."""
    reset_counts(kernels)
    run_ms, last_host, res = [], None, None
    for i in range(runs):
        t0 = time.perf_counter()
        res = eng.run(roots)
        run_ms.append((time.perf_counter() - t0) * 1e3)
        host = res.dist_host
        if last_host is not None:
            check(np.array_equal(host, last_host),
                  "two runs of one engine disagree")
        last_host = host
    counts = {name: k.launches for name, k in kernels.items()}
    return last_host, run_ms[1:], res, counts


def span_cost(eng, roots, rounds: int = 20, per_round: int = 10,
              calls: int = 100_000) -> dict:
    """The level loop's profiler ranges priced on ``eng`` (path 2): the
    host ms of a run ending in its result read, with ``core.spans.span``
    as shipped (``idle``), swapped for a no-op (``no-op``: the call sites
    still enter a ``with``) and for a bare ``record_function``
    (``forced``), the settings alternating in rounds; the ranges a run
    enters (one run under a CPU profiler); and the us of one range in
    each setting over ``calls`` calls."""
    import contextlib
    import importlib
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans

    users = [importlib.import_module(f"repro_torch.core.{m}")
             for m in ("bfs", "mesh")]
    check(all(u.span is spans.span for u in users),
          "span_cost: a level-loop module does not use core.spans.span")
    idle = contextlib.nullcontext()
    settings = {"idle": spans.span, "no-op": lambda name: idle,
                "forced": torch.profiler.record_function}
    times = {name: [] for name in settings}
    per_range_us = {}
    try:
        for _ in range(rounds):
            for name, fn in settings.items():
                for u in users:
                    u.span = fn
                for _ in range(per_round):
                    t0 = time.perf_counter()
                    eng.run(roots).dist_host
                    times[name].append((time.perf_counter() - t0) * 1e3)
        for name, fn in settings.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                with fn(spans.EXPAND):
                    pass
            per_range_us[name] = (time.perf_counter() - t0) / calls * 1e6
    finally:
        for u in users:
            u.span = spans.span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(roots).dist_host
    ranges = sum(e.count for e in prof.key_averages()
                 if e.key.startswith("bfs."))
    med = {name: statistics.median(t) for name, t in times.items()}
    return {"runs_per_setting": rounds * per_round,
            "ms_per_run_median": med,
            "ms_per_run_mean": {name: statistics.fmean(t)
                                for name, t in times.items()},
            "ranges_per_run": ranges, "us_per_range": per_range_us,
            "idle_over_noop": med["idle"] / med["no-op"] - 1,
            "forced_over_noop": med["forced"] / med["no-op"] - 1}


def report_run(name, compile_ms, run_ms, res, counts) -> None:
    st = res.run_stats
    log(f"{name}: compile {compile_ms:.1f} ms; runs {[round(t, 3) for t in run_ms]} ms; "
        f"levels {st.levels}; per-level ms "
        f"{[round(t * 1e3, 3) for t in st.level_seconds]}; "
        f"comm_bytes {st.comm_bytes}; launches {counts}")


def ptxas_reports(log_text: str, name: str) -> dict:
    """The ``-Xptxas -v`` report of each kernel whose mangled name holds
    ``name``, keyed by that name: stack, spills, registers and barriers."""
    lines, out = log_text.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            fn = line.split("'")[1] if "'" in line else line
            out[fn] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
    return out


def ptxas_lines(log_text: str, name: str) -> str:
    """The report of the first kernel whose mangled name holds ``name``."""
    return next(iter(ptxas_reports(log_text, name).values()), "")


def densest_frontier(host: np.ndarray, n: int, inf: int, dev):
    """The largest frontier of a run: the ``(n, S)`` uint8 mask of the
    depth that holds the most (vertex, source) pairs; with the depth and
    the pair count."""
    counts = np.bincount(host[host < inf].ravel())
    depth = int(np.argmax(counts))
    mask = np.zeros((n, host.shape[1]), np.uint8)
    mask[:host.shape[0]] = host == depth
    return torch.from_numpy(mask).to(dev), depth, int(counts[depth])


def frontier_words(mask: torch.Tensor, p: int, col_pad: int):
    """An ``(n, S)`` uint8 frontier of ``p`` shards as ``bsr_expand_bits``
    takes it: each shard's rows zero-padded to ``col_pad``, packed along
    the vertex axis."""
    from repro_torch.core.frontier import pack_bits

    n, s = mask.shape
    x = torch.zeros((p, col_pad, s), dtype=torch.uint8, device=mask.device)
    x[:, : n // p] = mask.reshape(p, n // p, s)
    return pack_bits(x).reshape(-1, s)


def expand_bound(tiles, cmask, rows, cols, fwords, out) -> dict:
    """``bsr_expand_bits``' byte bound: the column masks, block indices,
    frontier words and output, and the tiles this frontier makes it read
    (those whose column mask meets some source's frontier word); beside
    it the bound with every tile read, which no skip can pass."""
    any_src = fwords[:, 0].clone()
    for j in range(1, fwords.shape[1]):
        any_src |= fwords[:, j]
    words = cols.long()[:, None] * 4 + torch.arange(4, device=cols.device)
    read = int(((any_src[words] & cmask) != 0).any(dim=1).sum())
    fixed = nbytes(cmask, rows, cols, fwords, out)
    b_ms, b_by = bound(fixed + read * tiles[0].numel() * tiles.element_size())
    all_ms, _ = bound(fixed + nbytes(tiles))
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_all_tiles_ms": all_ms,
            "tiles_read": read, "tiles": tiles.shape[0]}


def path3_phase(kernels, g, src, dst, roots, want, dev, profile: bool):
    """``rmat_1m`` with ``use_kernel`` on 4 shards (module docstring, phase
    3); returns ``bsr_expand_bits``' reading at these shapes."""
    from repro_torch.core import BFSOptions, plan
    from repro_torch.core import frontier as fr
    from repro_torch.core.ref import validate_bfs
    from repro_torch.kernels.bsr_spmm.kernel import bsr_expand_bits

    part = g.part
    p, shard, n = part.p, part.shard_size, part.n
    reset_peak()
    t0 = time.perf_counter()
    pl = plan(g, BFSOptions(use_kernel=True), num_sources=S)
    eng = pl.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    tiles, cmask, row_ptr, rows, cols = eng.kernel_arrays
    d = pl.describe()
    log(f"path 3: p={p} dense_exchange={d['dense_exchange']} fused="
        f"{d['use_fused_tail']}; {tiles.shape[0]} tiles in "
        f"{nbytes(tiles) / 1e9:.3f} GB of bit tiles (compile, the bit-tile "
        f"build included: {compile_ms:.1f} ms)")
    host, run_ms, res, counts = drive(kernels, eng, roots)
    levels = res.run_stats.levels
    check(counts["bsr_expand_bits"] == 3 * levels,
          f"path 3: bsr_expand_bits launched {counts['bsr_expand_bits']} "
          f"times in 3 runs of {levels} levels")
    check(counts["bsr_spmm"] == 0 and counts["bitpack_words"] == 0,
          "path 3: the f32 A2 or A3 launched under use_kernel")
    check(counts["fold_update"] > 0, "path 3: kernel A1 never launched")
    validate_bfs(src, dst, roots, res.dist[:part.n_logical, :S])
    check(np.array_equal(host, want),
          "path 3: distances differ from path 1's p4_default")
    report_run("path 3 use_kernel p4", compile_ms, run_ms, res, counts)
    roofline_line("path 3 use_kernel p4", d, res.run_stats,
                  ["dense"] * levels)
    log(f"path 3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run("path 3 use_kernel", lambda: eng.run(roots))

    # the kernel at these shapes on the run's densest frontier, held to
    # the plain scatter-max expansion over the edge list (the plain
    # version's f32 tiles would be 695 GB), then timed beside its bound
    mask, depth, pairs = densest_frontier(host, n, fr.INF, dev)
    fwords = frontier_words(mask, p, -(-shard // 128) * 128)
    layout = dict(n_valid=n, n_blocks=p, rows_per_group=-(-n // 128) * 128)
    out = bsr_expand_bits(*eng.kernel_arrays, fwords, **layout)
    # shard j's group holds the candidates of shard j's own edges, packed
    # per owner, as the engine ships them
    src_d, dst_d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    owner = src_d // shard
    for j in range(p):
        sel = owner == j
        want_j = fr.pack_bits(fr.expand_dense_edges(mask, src_d[sel],
                                                    dst_d[sel], n), p)
        check(torch.equal(out.reshape(p, -1, S)[j], want_j),
              f"path 3: shard {j}'s candidate words differ from the "
              f"scatter-max expansion over its edges")
        del sel, want_j
    del src_d, dst_d, owner
    ms = timed_ms(lambda: bsr_expand_bits(*eng.kernel_arrays, fwords,
                                          **layout), 10)
    pack_ms = timed_ms(lambda: fr.pack_bits(mask.view(p, shard, S)), 10)
    b = expand_bound(tiles, cmask, rows, cols, fwords, out)
    log(f"bsr_expand_bits at path 3 (depth {depth}, {pairs} frontier "
        f"pairs, the densest level): {ms} ms; bound {b['bound_ms']} ms "
        f"({b['bound_by']}; {b['tiles_read']} of {b['tiles']} tiles read), "
        f"every tile {b['bound_all_tiles_ms']} ms; each shard's words "
        f"agree bitwise with the scatter-max expansion over its edges; "
        f"pack_bits of the frontier (a run's "
        f"first level) {pack_ms} ms")
    del eng, res, tiles, cmask, row_ptr, cols, rows, out
    torch.cuda.empty_cache()
    return {"ms": ms, **b, "depth": depth, "frontier_pairs": pairs,
            "pack_ms": pack_ms, "compile_ms": compile_ms,
            "shape": f"{b['tiles']} tiles over 4 shards, frontier words "
                     f"{tuple(fwords.shape)}"}


def replay_modes(host: np.ndarray, deg: np.ndarray, n_edges: int, s: int,
                 inf: int):
    """numpy replay of the ``auto`` rule (JAX ``bfs.py:244-245, 379-413``)
    from a run's distances, independent of the port's loop: level ``L``'s
    frontier is ``dist == L-1``; ``f_verts`` counts its pairs over every
    column, ``f_edges`` the out-edges of column 0's frontier.  Returns the
    level count (the largest finite distance + 1) and each level's mode."""
    from repro_torch.core import BFSOptions

    opts = BFSOptions()
    queue_cut = max(1, int(opts.queue_threshold * n_edges))
    bottom_up_cut = max(1, int(opts.bottom_up_threshold * host.shape[0]))
    levels = int(host[host < inf].max()) + 1
    modes = []
    for level in range(1, levels + 1):
        front = host == level - 1
        f_verts, f_edges = int(front.sum()), int(deg[front[:, 0]].sum())
        if f_verts > bottom_up_cut:
            modes.append("bottom_up")
        elif s == 1 and f_edges < queue_cut:
            modes.append("queue")
        else:
            modes.append("dense")
    return levels, modes


def mode_counts(modes) -> dict:
    return {m: modes.count(m) for m in ("dense", "queue", "bottom_up")}


def build_engine(label: str, g, opts, s: int, **plan_kw):
    """Plan and compile one engine of a BFS path; logs its resolved wires
    and compile time.  Returns (plan, engine, describe())."""
    from repro_torch.core import plan

    reset_peak()
    t0 = time.perf_counter()
    pl = plan(g, opts, num_sources=s, **plan_kw)
    eng = pl.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    d = pl.describe()
    keys = ("dense_exchange", "queue_exchange", "expand_exchange",
            "fold_exchange", "expand_sparse_exchange",
            "fold_sparse_exchange")
    log(f"{label}: wires {d['wire_formats']}, "
        f"{', '.join(f'{k} {d[k]}' for k in keys if k in d)}, sieve "
        f"{d['sieve']}, fused {d['use_fused_tail']}; compile "
        f"{compile_ms:.1f} ms")
    return pl, eng, d


def report_modes(label: str, run_ms, st: dict, modes, res) -> None:
    log(f"{label}: runs {[round(t, 3) for t in run_ms]} ms; "
        f"levels {st['levels']}; per-level ms (mode) "
        f"{[f'{t * 1e3:.3f} ({m})' for t, m in zip(res.run_stats.level_seconds, modes)]}; "
        f"comm_bytes {st['comm_bytes']}; sieve_hits {st['sieve_hits']}; "
        f"overflowed {st['overflowed']}; mode_counts {st['mode_counts']}")


def single_source_roots(kernels, label: str, eng, mode: str, roots, want,
                        deg, n_edges: int, profile: bool) -> None:
    """One S = 1 engine over the first 8 roots (the first three times):
    each root's distances bitwise ``want``'s column, ``auto``'s
    ``mode_counts`` equal to the numpy replay, ``queue`` a queue level a
    level."""
    from repro_torch.core.frontier import INF

    totals = dict.fromkeys(("dense", "queue", "bottom_up"), 0)
    for i, root in enumerate(roots[:8]):
        if i == 0:
            host, run_ms, res, _ = drive(kernels, eng, [root])
        else:
            t0 = time.perf_counter()
            res = eng.run([root])
            run_ms = [(time.perf_counter() - t0) * 1e3]
            host = res.dist_host
        st = res.run_stats.to_host()
        check(np.array_equal(host, want[:, i:i + 1]),
              f"{label}: root {i}'s distances differ from path 1's column "
              f"{i}")
        levels, modes = replay_modes(host, deg, n_edges, 1, INF)
        if mode == "auto":
            check(levels == st["levels"]
                  and mode_counts(modes) == st["mode_counts"],
                  f"{label}: root {i}'s mode_counts {st['mode_counts']}, "
                  f"the replay {mode_counts(modes)}")
        else:
            modes = ["queue"] * st["levels"]
            check(st["levels"] == levels
                  and st["mode_counts"]["queue"] == levels,
                  f"{label}: root {i} ran {st}")
        for k in totals:
            totals[k] += st["mode_counts"][k]
        report_modes(f"{label} root {i}", run_ms, st, modes, res)
        if profile and i == 0:
            profile_run(f"{label} root 0", lambda: eng.run([root]))
    log(f"{label}: 8 roots bitwise path 1's columns; mode totals {totals}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def path4_phase(kernels, g, src, roots, want, profile: bool) -> None:
    """``rmat_1m`` on the queue and ``auto`` modes (module docstring, phase
    5): (a) auto, S = 64; (b) auto and (c) queue, S = 1, on the first 8
    roots; distances bitwise path 1's p4_default columns."""
    from repro_torch.core import BFSOptions
    from repro_torch.core.frontier import INF

    deg = np.bincount(src, minlength=g.part.n_logical)
    others = [k for k in kernels if k != "fold_update"]

    # (a) auto, S = 64: dense and bottom-up levels only
    pl, eng, d = build_engine("path 4 (a) auto S=64", g,
                              BFSOptions(mode="auto"), S)
    check(d["wire_formats"]["bottom_up"] == "packed" and d["use_fused_tail"],
          "path 4 (a): the plan does not resolve a packed bottom-up wire "
          "and the fused tail")
    host, run_ms, res, counts = drive(kernels, eng, roots)
    st = res.run_stats.to_host()
    check(np.array_equal(host, want),
          "path 4 (a): distances differ from path 1's p4_default")
    levels, modes = replay_modes(host, deg, g.n_edges, S, INF)
    check(levels == st["levels"] and mode_counts(modes) == st["mode_counts"],
          f"path 4 (a): mode_counts {st['mode_counts']} over {st['levels']} "
          f"levels, the replay {mode_counts(modes)} over {levels}")
    check(counts["fold_update"] == 3 * st["mode_counts"]["dense"],
          f"path 4 (a): A1 launched {counts['fold_update']} times in 3 runs "
          f"of {st['mode_counts']['dense']} dense levels")
    check(not any(counts[k] for k in others),
          f"path 4 (a): a kernel off the path launched: {counts}")
    report_modes("path 4 (a) auto S=64", run_ms, st, modes, res)
    roofline_line("path 4 (a) auto S=64", d, res.run_stats, modes)
    log(f"path 4 (a): launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run("path 4 (a) auto S=64", lambda: eng.run(roots))
    del eng, res

    # (b) auto and (c) queue, S = 1: the first root three times, the next
    # seven once each
    for label, mode in (("(b) auto S=1", "auto"), ("(c) queue S=1", "queue")):
        pl, eng, d = build_engine(f"path 4 {label}", g,
                                  BFSOptions(mode=mode), 1)
        check(d["sieve"], f"path 4 {label}: the sieve is off")
        single_source_roots(kernels, f"path 4 {label}", eng, mode, roots,
                            want, deg, g.n_edges, profile)
        del eng
    torch.cuda.empty_cache()


def path5_phase(kernels, g, src, roots, want, profile: bool) -> int:
    """``rmat_1m`` on the 2-D partition, a 2 x 2 ``LocalMesh`` grid with
    default options (module docstring, phase 6): (a) dense, S = 64; (b)
    auto, S = 64; (c) auto and (d) queue, S = 1, on the first 8 roots;
    distances bitwise path 1's p4_default (columns).  Returns A1's
    launches in (a) and (a)'s last run stats."""
    from repro_torch.core import BFSOptions, LocalMesh
    from repro_torch.core.frontier import INF
    from repro_torch.graphs import to_2d

    t0 = time.perf_counter()
    g2 = to_2d(g, 2, 2)
    to2d_s = time.perf_counter() - t0
    per_cell = (g2.dst_fold >= 0).sum(1).tolist()
    log(f"path 5: to_2d(2, 2) in {to2d_s:.3f} s (host); e_cap "
        f"{g2.e_cap}, edges per cell {per_cell} (mean "
        f"{g2.n_edges / 4:.0f})")
    mesh = LocalMesh.grid(2, 2, torch.device("cuda", 0))
    deg = np.bincount(src, minlength=g.part.n_logical)
    others = [k for k in kernels if k != "fold_update"]

    # (a) dense, S = 64: packed expand and fold, A1 on the fused fold tail
    label = "path 5 (a) dense S=64"
    pl, eng, d = build_engine(label, g2, BFSOptions(), S, mesh=mesh)
    check(d["grid"] == (2, 2) and d["wire_formats"]["expand"] == "packed"
          and d["wire_formats"]["fold"] == "packed" and d["use_fused_tail"],
          f"{label}: the plan does not resolve packed expand and fold "
          f"wires and the fused tail: {d['wire_formats']}")
    host, run_ms, res, counts = drive(kernels, eng, roots)
    st = res.run_stats.to_host()
    check(np.array_equal(host, want),
          f"{label}: distances differ from path 1's p4_default")
    levels = st["levels"]
    check(st["mode_counts"] == {"dense": levels, "queue": 0,
                                "bottom_up": 0},
          f"{label}: mode_counts {st['mode_counts']}")
    check(counts["fold_update"] == 3 * levels,
          f"{label}: A1 launched {counts['fold_update']} times in 3 runs of "
          f"{levels} levels")
    check(not any(counts[k] for k in others),
          f"{label}: a kernel off the path launched: {counts}")
    want_bytes = np.float32(0)
    for _ in range(levels):
        want_bytes = np.float32(want_bytes
                                + np.float32(d["dense_level_bytes"]))
    check(st["comm_bytes"] == float(want_bytes),
          f"{label}: comm_bytes {st['comm_bytes']}, not {levels} x "
          f"{d['dense_level_bytes']} as float32")
    report_modes(label, run_ms, st, ["dense"] * levels, res)
    roofline_line(label, d, res.run_stats, ["dense"] * levels)
    log(f"{label}: launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run(label, lambda: eng.run(roots))
    a1_launches, stats_a = counts["fold_update"], res.run_stats
    del eng, res

    # (b) auto, S = 64: the bottom-up blocks are built here, on first use
    t0 = time.perf_counter()
    g2.bottom_up_blocks()
    log(f"path 5: bottom_up_blocks in {time.perf_counter() - t0:.3f} s "
        f"(host); in_e_cap {g2.in_e_cap}")
    label = "path 5 (b) auto S=64"
    pl, eng, d = build_engine(label, g2, BFSOptions(mode="auto"), S,
                              mesh=mesh)
    host, run_ms, res, counts = drive(kernels, eng, roots)
    st = res.run_stats.to_host()
    check(np.array_equal(host, want),
          f"{label}: distances differ from path 1's p4_default")
    levels, modes = replay_modes(host, deg, g2.n_edges, S, INF)
    check(levels == st["levels"] and mode_counts(modes) == st["mode_counts"],
          f"{label}: mode_counts {st['mode_counts']} over {st['levels']} "
          f"levels, the replay {mode_counts(modes)} over {levels}")
    check(counts["fold_update"] == 3 * st["mode_counts"]["dense"]
          and not any(counts[k] for k in others),
          f"{label}: launches {counts} in 3 runs of {st['mode_counts']}")
    report_modes(label, run_ms, st, modes, res)
    log(f"{label}: launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run(label, lambda: eng.run(roots))
    del eng, res

    # (c) auto and (d) queue, S = 1, the first 8 roots
    for label, mode in (("(c) auto S=1", "auto"), ("(d) queue S=1", "queue")):
        pl, eng, d = build_engine(f"path 5 {label}", g2,
                                  BFSOptions(mode=mode), 1, mesh=mesh)
        check(d["sieve"], f"path 5 {label}: the sieve is off")
        single_source_roots(kernels, f"path 5 {label}", eng, mode, roots,
                            want, deg, g2.n_edges, profile)
        del eng
    torch.cuda.empty_cache()
    return a1_launches, stats_a


# ---------------------------------------------------------------------------
# path 6: BFS serving over HTTP
# ---------------------------------------------------------------------------

LADDER = (1, 8, 64)
FANOUTS = (1, 3, 8, 17, 64)
N_REQUESTS, N_CLIENTS, CLIENT_TIMEOUT_S = 48, 8, 60.0


def http_call(url: str, path: str, body=None) -> bytes:
    """One stdlib HTTP call with the client timeout; returns the body."""
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url + path, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=CLIENT_TIMEOUT_S) as rsp:
        return rsp.read()


def depth_rows(want: np.ndarray, roots) -> dict:
    """Each root's row of depths as the server writes it inside a
    response (``schema.json_int_rows``: fixed-width numbers), keyed by
    root: a response's depths are checked by comparing bytes, not by
    parsing a million ints a source."""
    from repro_torch.serve.frontend.schema import json_int_rows

    n = want.shape[0]
    text = memoryview(json_int_rows(np.ascontiguousarray(want.T)))
    width = len(text[1:]) // len(roots)
    check(width * len(roots) + 1 == len(text) and width % n == 0,
          "path 6: the depth rows are not fixed-width")
    return {int(r): bytes(text[1 + i * width: (i + 1) * width])
            for i, r in enumerate(roots)}


def read_traverse(body: bytes, sources, rows: dict, n: int) -> dict:
    """A ``/v1/traverse`` response whose depths must equal ``rows``'
    (bytes, each row but its closing byte, then the closings); returns
    its other fields (json), with the parents parsed by numpy."""
    tag = b'"depths": '
    start = body.index(tag) + len(tag)
    width = len(rows[sources[0]]) + 1
    end = start + 1 + len(sources) * width
    view = memoryview(body)
    check(view[start] == ord("[") and bytes(view[end - 2:end]) == b"]]"
          and body.startswith(b', "stats": ', end),
          "path 6: a response's depths are not the expected layout")
    for q, s in enumerate(sources):
        a = start + 1 + q * width
        check(view[a:a + width - 1] == rows[s]
              and view[a + width - 1] in b",]",
              f"path 6: the depths of source {s} differ from the path's")
    parents = None
    tag = b', "parents": '
    k = body.find(tag, end)
    if k >= 0:
        text = body[k + len(tag):-1]
        parents = np.fromstring(text.translate(None, b"[]"), dtype=np.int64,
                                sep=",")
        check(parents.size == len(sources) * n,
              f"path 6: {parents.size} parents for {len(sources)} x {n}")
        tail = body[end:k] + b"}"
    else:
        tail = body[end:]
    out = json.loads(body[:start] + b"null" + tail)
    out["parents"] = (None if parents is None
                      else parents.reshape(len(sources), n))
    return out


def check_parents(depths, parents, sources, unreached) -> None:
    """The JAX client's rule (``bfs_client._verify_depths``): each root
    is its own parent, an unreached vertex has -1, and every other
    reached vertex's parent is one level up."""
    for d, par, s in zip(depths, parents, sources):
        reached = d < unreached
        inner = reached & (d > 0)
        ok = (par[s] == s and np.all(par[reached] >= 0)
              and np.all(par[~reached] == -1)
              and np.all(d[par[inner]] == d[inner] - 1))
        check(bool(ok), f"path 6: the parents of source {s} break the rule")


def run_clients(url, requests, want, roots):
    """The requests from ``N_CLIENTS`` threads, each response checked:
    depths by bytes against the paths' distances (each lane's smallest
    response also parsed whole by json), parents by the JAX client's rule.
    Returns ``(results, errors)``: a request's client seconds, stats and
    bucket."""
    lanes = list(want)
    col = {name: {int(r): j for j, r in enumerate(roots[name])}
           for name in lanes}
    rows, by_array = {}, {}
    for name in lanes:                  # rmat's rows serve its 3 lanes
        if id(want[name]) not in by_array:
            by_array[id(want[name])] = depth_rows(want[name], roots[name])
        rows[name] = by_array[id(want[name])]
    smallest = {name: min((i for i, q in enumerate(requests)
                           if q[0] == name),
                          key=lambda i: len(requests[i][1]))
                for name in lanes}
    results, errors = [None] * len(requests), []

    def client(c):
        for i in range(c, len(requests), N_CLIENTS):
            name, srcs, parents = requests[i]
            n = want[name].shape[0]
            t0 = time.perf_counter()
            try:
                body = http_call(url, "/v1/traverse", {
                    "graph": name, "sources": srcs,
                    "include_parents": parents})
                dt = time.perf_counter() - t0
                out = read_traverse(body, srcs, rows[name], n)
                cols = [col[name][s] for s in srcs]
                if i == smallest[name]:
                    whole = json.loads(body)
                    check(np.array_equal(np.asarray(whole["depths"]),
                                         want[name][:, cols].T),
                          f"path 6: request {i}'s json depths differ")
                if parents:
                    check_parents(want[name][:, cols].T, out["parents"],
                                  srcs, out["unreached"])
                results[i] = (dt, out["stats"], out["bucket"])
            except Exception as exc:          # reported by the caller
                errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    return client, results, errors


def client_process(conn, url, requests, want, roots) -> None:
    """The body of path 6's client process: build the expected rows, say
    "ready", wait for "go", send the 48 requests from ``N_CLIENTS``
    threads, send back ``(results, errors)``."""
    import threading

    sys.path.insert(0, str(ROOT / "src"))
    try:
        client, results, errors = run_clients(url, requests, want, roots)
        conn.send("ready")
        conn.recv()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conn.send((results, errors))
    except Exception as exc:
        conn.send(([], [f"client process: {type(exc).__name__}: {exc}"]))


def rung_memory(label, cache, plan_, roots, want):
    """Compile one rung through ``cache`` and run it once at full S,
    reading the device memory it takes: the ``max_memory_allocated``
    rise over both, against ``estimated_device_bytes``, and what stays
    allocated after."""
    reset_peak()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = cache.get_or_compile(plan_)
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    s = plan_.num_sources
    res = eng.run(roots[:s])
    check(np.array_equal(res.dist_host, want[:, :s]),
          f"{label}: distances differ from the path's own")
    del res
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - m0
    kept = torch.cuda.memory_allocated() - m0
    est = plan_.estimated_device_bytes()
    terms = plan_.device_byte_terms()
    t0 = time.perf_counter()
    eng.run(roots[:s]).dist_host
    run_ms = (time.perf_counter() - t0) * 1e3
    log(f"{label}: compile {compile_ms:.1f} ms; a second run {run_ms:.3f} "
        f"ms; device bytes: estimate {est} ({terms}), measured peak rise "
        f"{rise} (estimate / measured {est / max(rise, 1):.3f}), kept {kept}")
    check(est >= rise, f"{label}: estimated_device_bytes {est} is below the "
                       f"measured rise {rise}")
    return {"compile_ms": compile_ms, "run_ms": run_ms, "estimate": est,
            "measured": rise, "kept": kept, "work": terms["work"]}


def serving_phase(kernels, g1, want1, roots1, g2, want2, roots2, dev,
                  card: str) -> dict:
    """``BFSService`` behind ``serve_http`` (module docstring, phase 7):
    four lanes, 48 requests from 8 client threads, the cache's counters,
    the shared blocks, the memory estimate, a byte budget's eviction and
    a split arm under an injected compile fault.  Returns A1's and
    ``bsr_expand_bits``' launches in the traffic."""
    import gc
    import threading

    from repro_torch.core import BFSOptions, LocalMesh
    from repro_torch.core.frontier import INF
    from repro_torch.graphs import device_block_cache, to_2d
    from repro_torch.serve.bfs_service import BFSService, TraversalRequest
    from repro_torch.serve.engine_cache import EngineCache, GraphCatalog
    from repro_torch.serve.frontend import serve_http
    from repro_torch.serve.resilience import faults
    from repro_torch.serve.resilience.faults import FaultPlan, FaultSpec

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    catalog = GraphCatalog()
    catalog.register("rmat", g1)
    catalog.register("rmat_alias", g1)
    catalog.register("sw", g2)
    g1_2d = catalog.get_2d("rmat", 2, 2)
    check(g1_2d is to_2d(g1, 2, 2) and "_graph2d" in g1.__dict__,
          "path 6: the catalog's 2 x 2 view is not path 5's cached to_2d")
    cache = EngineCache()
    svc = BFSService(opts=BFSOptions(), batch_buckets=LADDER, cache=cache,
                     catalog=catalog, device=dev)
    svc.add_graph("rmat")
    svc.add_graph("rmat2d", g1_2d, mesh=LocalMesh.grid(2, 2, dev))
    svc.add_graph("sw", opts=BFSOptions(use_kernel=True,
                                        wire_format="packed"))
    svc.add_graph("rmat_alias")
    lanes = svc.graph_names()
    want = {"rmat": want1, "rmat2d": want1, "rmat_alias": want1,
            "sw": want2}
    roots = {"rmat": roots1, "rmat2d": roots1, "rmat_alias": roots1,
             "sw": roots2}
    keys = {name: [pl.plan_key() for pl in svc.lane(name).plans.values()]
            for name in lanes}
    check(keys["rmat_alias"] == keys["rmat"],
          "path 6: rmat_alias's plans key apart from rmat's")
    distinct = {k for ks in keys.values() for k in ks}
    check(len(distinct) == 9, f"path 6: {len(distinct)} distinct plan keys")
    for name in lanes:
        d = svc.lane(name).plan.describe()
        log(f"path 6 lane {name}: p={d['p']} partition={d['partition']} "
            f"wires {d['wire_formats']} fused={d['use_fused_tail']} "
            f"use_kernel={d['use_kernel']} ladder {svc.lane(name).ladder}")

    # every rung compiled through the cache and run once at full S, with
    # its device memory read; a graph's rungs share one upload a group
    rungs = {}
    for name in ("rmat", "rmat2d", "sw"):
        lane = svc.lane(name)
        owner = lane.plan.graph2d if name == "rmat2d" else lane.graph
        blocks = device_block_cache(owner)
        groups = None
        for s in LADDER:
            label = f"path 6 {name} S={s}"
            rungs[label] = row = rung_memory(label, cache, lane.plans[s],
                                             roots[name], want[name])
            held = dict(blocks.map.items())
            if groups is not None:
                check(held == groups, f"{label}: the block map changed: "
                      f"{sorted(k[2] for k in groups)} -> "
                      f"{sorted(k[2] for k in held)}")
                # dist and frontier: each block may round up to 2 MiB
                check(row["kept"] <= 1.05 * row["work"] + 2 * 2**21,
                      f"{label}: memory grew by {row['kept']} bytes, past "
                      f"its working buffers {row['work']} plus 5% and "
                      "the allocator's rounding")
            groups = held
        log(f"path 6 {name}: block groups {sorted(k[2] for k in groups)}, "
            "one upload each across the rungs")
    st = cache.stats()
    check(st["misses"] == 9 and st["entries"] == 9,
          f"path 6: {st['misses']} compiles for 9 plan keys")

    # the traffic: 48 requests from 8 client threads over HTTP
    spec = {"rmat": {"kind": "rmat", "n": g1.part.n_logical, "seed": SEED},
            "sw": {"kind": "small_world", "n": g2.part.n_logical,
                   "seed": SEED}}
    httpd, fe = serve_http(svc, "127.0.0.1", 0, max_queue_depth=64,
                           max_inflight_mb=65536.0, graph_specs=spec,
                           log=lambda *a: None)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(SEED)
    with_parents = set(rng.choice(N_REQUESTS, N_REQUESTS // 4,
                                  replace=False).tolist())
    requests = []
    for i in range(N_REQUESTS):
        name = lanes[i % len(lanes)]
        k = int(rng.choice(FANOUTS))
        srcs = rng.choice(roots[name], k, replace=False).tolist()
        requests.append((name, srcs, i in with_parents))
    # the clients run in a process of their own, so that their reading
    # and checking of the responses does not hold the server's GIL
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=client_process, daemon=True,
                       args=(child, url, requests, want, roots))
    proc.start()
    def receive(what):
        while not conn.poll(1.0):
            check(proc.is_alive(), f"path 6: the client process died {what}")
        return conn.recv()

    try:
        check(receive("starting") == "ready",
              "path 6: the client process did not start")
        reset_counts(kernels)
        t0 = time.perf_counter()
        conn.send("go")
        results, errors = receive("sending")
        wall = time.perf_counter() - t0
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    counts = {name: k.launches for name, k in kernels.items()}
    check(not errors, f"path 6: {len(errors)} requests failed: {errors[:3]}")
    levels = sum(r[1]["levels"] for r in results)
    sw_levels = sum(r[1]["levels"] for r, q in zip(results, requests)
                    if q[0] == "sw")
    check(counts["fold_update"] == levels,
          f"path 6: A1 launched {counts['fold_update']} times in "
          f"{levels} levels of the 48 runs")
    check(counts["bsr_expand_bits"] == sw_levels,
          f"path 6: bsr_expand_bits launched {counts['bsr_expand_bits']} "
          f"times in {sw_levels} levels of the sw runs")
    check(not any(v for k, v in counts.items()
                  if k not in ("fold_update", "bsr_expand_bits")),
          f"path 6: a kernel off the path launched: {counts}")
    metrics = json.loads(http_call(url, "/metrics"))
    st = metrics["engine_cache"]
    check(st["misses"] == 9 and st["evictions"] == 0,
          f"path 6: the traffic compiled or evicted: {st}")
    # the engines' own time for the 48 requests, each at its rung's
    # solo run time: what the card was busy with at most
    engine_s = sum(rungs[f"path 6 {'rmat' if q[0] == 'rmat_alias' else q[0]}"
                         f" S={r[2]}"]["run_ms"] for r, q in
                   zip(results, requests)) / 1e3
    log(f"path 6: {card}; 48 requests from {N_CLIENTS} clients in "
        f"{wall:.3f} s ({N_REQUESTS / wall:.3f} requests/s); the runs "
        f"alone take {engine_s:.3f} s (card busy at most "
        f"{engine_s / wall:.3f} of the traffic); launches {counts}; cache "
        f"{st}")
    per_lane = {}
    for name in lanes:
        m = metrics["lanes"][name]
        dts = sorted(r[0] for r, q in zip(results, requests)
                     if q[0] == name)
        per_lane[name] = {
            "requests": m["completed"], "buckets": m["buckets"],
            "e2e_p50_ms": m["e2e"]["p50_ms"], "e2e_p99_ms": m["e2e"]["p99_ms"],
            "queue_wait_s": m["queue_wait"]["sum_ms"] / 1e3,
            "device_s": m["device"]["sum_ms"] / 1e3,
            "client_p50_s": dts[len(dts) // 2], "client_max_s": dts[-1]}
        log(f"path 6 lane {name}: {per_lane[name]}")

    col = {name: {int(r): j for j, r in enumerate(roots[name])}
           for name in lanes}
    # the overlap of one round: a request a lane through BFSService.step
    # against the same requests one lane at a time
    alone = 0.0
    for name in ("rmat", "rmat2d", "sw"):
        t0 = time.perf_counter()
        svc.traverse(name, [int(roots[name][0])])
        alone += time.perf_counter() - t0
    for i, name in enumerate(("rmat", "rmat2d", "sw")):
        svc.submit(TraversalRequest(rid=i, source=int(roots[name][0]),
                                    graph=name))
    t0 = time.perf_counter()
    done = svc.step()
    step_s = time.perf_counter() - t0
    check(len(done) == 3 and all(np.array_equal(
        r.dist, want[r.graph][:, col[r.graph][r.source]]) for r in done),
        "path 6: a step's results differ from the path's distances")
    log(f"path 6: one step of a request a lane {step_s:.4f} s, the lanes "
        f"one at a time {alone:.4f} s (overlap {1 - step_s / alone:.3f})")

    http_call(url, "/admin/shutdown", {})
    server.join(timeout=60.0)
    check(not server.is_alive() and fe.draining,
          "path 6: the server did not drain and stop")
    httpd.server_close()

    # a byte budget between two and three rmat rungs: the LRU rung goes
    ests = [svc.lane("rmat").plans[s].estimated_device_bytes()
            for s in LADDER]
    budget = (sum(ests) + ests[1] + ests[2]) // 2
    cache2 = EngineCache(max_device_bytes=budget)
    svc2 = BFSService(opts=BFSOptions(), batch_buckets=LADDER, cache=cache2,
                      catalog=catalog, device=dev)
    svc2.add_graph("rmat")
    for s in LADDER[:2]:
        res, _ = svc2.traverse("rmat", roots1[:s])
        check(np.array_equal(res.dist_host, want1[:, :s]),
              f"path 6 budget: S={s} differs")
        del res
    torch.cuda.synchronize()
    m_before = torch.cuda.memory_allocated()
    res, _ = svc2.traverse("rmat", roots1[:S])
    check(np.array_equal(res.dist_host, want1), "path 6 budget: S=64 differs")
    del res
    torch.cuda.synchronize()
    m_after = torch.cuda.memory_allocated()
    plans2 = svc2.lane("rmat").plans
    work = {s: plans2[s].device_byte_terms()["work"] for s in LADDER}
    freed = m_before + work[S] - m_after
    st2 = cache2.stats()
    check(st2["evictions"] == 1 and plans2[1] not in cache2
          and plans2[8] in cache2 and plans2[64] in cache2,
          f"path 6 budget: not the LRU rung evicted: {st2}")
    check(freed >= work[1], f"path 6 budget: the eviction freed {freed} "
                            f"bytes, below the rung's {work[1]}")
    res, _ = svc2.traverse("rmat", roots1[:1])
    check(np.array_equal(res.dist_host, want1[:, :1])
          and cache2.stats()["misses"] == 4,
          "path 6 budget: the evicted rung did not recompile bitwise")
    del res
    log(f"path 6 budget: {budget} bytes; the S=1 rung evicted for S=64, "
        f"{freed} bytes freed (its work {work[1]}), recompiled bitwise; "
        f"cache {cache2.stats()}")
    del svc2, cache2

    # a compile fault on rmat's S=64 rung: 40 sources on the split:8 arm,
    # five runs of one engine, each read back before the next
    svc3 = BFSService(opts=BFSOptions(), batch_buckets=LADDER,
                      cache=EngineCache(), catalog=catalog, device=dev)
    svc3.add_graph("rmat")
    tag = faults.plan_tag(svc3.lane("rmat").plans[S])
    httpd, fe = serve_http(svc3, "127.0.0.1", 0, max_inflight_mb=65536.0,
                           log=lambda *a: None)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    srcs = roots1[:40].tolist()
    reset_counts(kernels)
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match=tag)])):
        out = read_traverse(http_call(url, "/v1/traverse",
                                      {"graph": "rmat", "sources": srcs}),
                            srcs, depth_rows(want1, roots1), want1.shape[0])
    lane_m = json.loads(http_call(url, "/metrics"))["lanes"]["rmat"]
    check(lane_m["degraded"] == {"split:8": 1} and out["bucket"] == 8,
          f"path 6 degraded: /metrics shows {lane_m['degraded']}, bucket "
          f"{out['bucket']}")
    check(kernels["fold_update"].launches == out["stats"]["mode_counts"][
        "dense"], "path 6 degraded: A1 not once a level of the five runs")
    log(f"path 6 degraded: {tag!r} failing, 40 sources served on "
        f"{lane_m['degraded']} (retries {lane_m['retries']}), bitwise path "
        f"1's; cache {svc3.cache.stats()}")
    http_call(url, "/admin/shutdown", {})
    server.join(timeout=60.0)
    check(not server.is_alive(), "path 6 degraded: the server did not stop")
    httpd.server_close()
    wall6 = time.perf_counter() - t_phase
    log(f"path 6: wall {wall6:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"fold_update": counts["fold_update"],
            "bsr_expand_bits": counts["bsr_expand_bits"], "rungs": rungs,
            "lanes": per_lane, "requests_per_s": N_REQUESTS / wall,
            "engine_s": engine_s,
            "wall_s": wall6}



# ---------------------------------------------------------------------------
# path 7: the launchers, called in process
# ---------------------------------------------------------------------------

class _Tee:
    """Standard output that is printed and kept (a launcher's lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s: str) -> int:
        self.out.write(s)
        self.lines.append(s)
        return len(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def run_launcher(label: str, main, argv, **kw):
    """``main(argv)`` with its standard output printed and kept; returns
    (exit code, output, wall seconds)."""
    import contextlib

    log(f"{label}: {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = main(argv, **kw)
    wall = time.perf_counter() - t0
    log(f"{label}: exit {rc}, wall {wall:.1f} s")
    check(rc == 0, f"{label}: exit {rc}")
    return rc, tee.text(), wall


_RUN_LINE = (r"^run\[(\d+)\] sources=.*?: levels=(\d+) visited=(\d+) "
             r"modes=(\{.*?\}) comm_bytes/chip=(\S+) wall=(\S+)s")


def run_lines(text: str) -> list:
    """The ``run[i]`` lines of ``bfs_run``: (levels, visited, modes,
    comm_bytes/chip) each, as printed."""
    return [m.groups()[1:5] for m in (re.match(_RUN_LINE, line)
                                      for line in text.splitlines()) if m]


def engine_line(res) -> tuple:
    """A result's fields as ``bfs_run`` prints them on its run line."""
    st = res.stats()
    return (str(st.levels), str(st.visited), str(st.mode_counts),
            f"{st.comm_bytes:.2e}")


def trace_device_ms(logdir: str) -> float:
    """Device time of a captured trace, read straight from the file: the
    kernels, copies and sets, each once."""
    from repro_torch.analysis import trace_model

    with open(trace_model.find_trace_file(logdir)) as f:
        events = json.load(f)["traceEvents"]
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3


def launchers_phase(kernels, g1, src1, dst1, dev, tmp: Path) -> dict:
    """The launchers' ``main(argv)`` in process (module docstring, path
    7): (a) ``bfs_run`` dense at p = 4 with ``--profile``, (b) ``bfs_run``
    on the 2 x 2 grid in auto, (c) ``bfs_serve --http`` on three lanes
    with the port's ``bfs_client --verify``, (d) ``bfs_chaos``.  Returns
    A1's launches in each."""
    import gc
    import threading

    from repro_torch.analysis import trace_model
    from repro_torch.core import BFSOptions, LocalMesh, plan
    from repro_torch.core.frontier import INF
    from repro_torch.core.ref import validate_bfs
    from repro_torch.graphs import to_2d
    from repro_torch.launch import bfs_chaos, bfs_run, bfs_serve
    from repro_torch.serve.engine_cache import default_engine_cache

    t_phase = time.perf_counter()
    n1 = g1.part.n_logical
    sources = list(range(S))
    others = [k for k in kernels if k != "fold_update"]
    a1 = {}

    def release():
        default_engine_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the 1-D dense launcher against path 1's p = 4 engine on the
    # launcher's run 0 sources, 0..63
    eng = plan(g1, BFSOptions(), num_sources=S).compile()
    ref = engine_line(eng.run(sources))
    del eng
    release()
    run0 = []

    def hold_run0(rep, srcs, res):
        # the host copy the run line's stats read; checked after the
        # launcher returns, so no check's device work enters the profile
        if rep == 0:
            run0.append((srcs, res.dist_host))

    prof = tmp / "profile_a"
    reset_counts(kernels)
    _, out, wall_a = run_launcher(
        "path 7 (a) bfs_run", bfs_run.main,
        ["--workload", "rmat_1m", "--devices", "4", "--mode", "dense",
         "--sources", str(S), "--repeats", "2", "--profile", str(prof)],
        on_run=hold_run0)
    counts = {name: k.launches for name, k in kernels.items()}
    runs = run_lines(out)
    check(len(runs) == 2 and len(run0) == 1 and run0[0][0] == sources,
          f"path 7 (a): {len(runs)} run lines, run 0 {run0[:1]}")
    validate_bfs(src1, dst1, np.asarray(sources),
                 torch.from_numpy(run0[0][1]).to(dev))
    scipy_check(src1, dst1, n1, np.asarray(sources), run0[0][1], INF)
    del run0
    check(runs[0] == ref, f"path 7 (a): run 0 {runs[0]}, path 1's p = 4 "
          f"engine on sources 0..63 {ref}")
    levels = sum(int(r[0]) for r in runs)
    check(counts["fold_update"] == levels
          and not any(counts[k] for k in others),
          f"path 7 (a): launches {counts}, not A1 once a level of "
          f"{levels}")
    a1["a"] = counts["fold_update"]
    t = trace_model.parse_trace(str(prof), n_levels=levels)
    rows = sum(line.startswith("  level[") for line in out.splitlines())
    dev_ms = trace_device_ms(str(prof))
    phase_ms = {ph: s * 1e3 for ph, s in t.total_s.items()}
    # the device time the join placed at a launch, against the file's
    placed = sum(phase_ms.values()) - t.unanchored_s * 1e3
    level_ms = sum(sum(lv.values()) for lv in t.levels) * 1e3
    level_other = sum(lv["other"] for lv in t.levels) * 1e3
    log(f"path 7 (a): trace {t.n_ops} device events, phases "
        f"{ {ph: round(v, 3) for ph, v in phase_ms.items()} } ms; "
        f"{placed:.3f} ms placed at a launch of {dev_ms:.3f} ms of device "
        f"time in the file ({t.unanchored} events, "
        f"{t.unanchored_s * 1e3:.3f} ms, with no launch found); "
        f"{level_ms:.3f} ms inside the levels, {level_other:.3f} ms of it "
        f"other; {len(t.levels)} level segments, {rows} level rows, "
        f"{levels} levels")
    check(len(t.levels) == levels and rows == levels,
          f"path 7 (a): {len(t.levels)} segments and {rows} rows for "
          f"{levels} levels")
    check(dev_ms > 0 and dev_ms - placed <= 0.01 * dev_ms,
          f"path 7 (a): {placed:.3f} ms of {dev_ms:.3f} ms of device time "
          "placed at a launch")
    check(level_other < 0.02 * level_ms,
          f"path 7 (a): other is {level_other:.3f} ms of the "
          f"{level_ms:.3f} ms inside the levels")
    check(max(phase_ms, key=phase_ms.get) == "expand",
          f"path 7 (a): expand is not the largest phase: {phase_ms}")
    release()

    # (b) the 2-D launcher against path 5 (b)'s engine on 0..63
    g2 = to_2d(g1, 2, 2)
    eng = plan(g2, BFSOptions(mode="auto"), num_sources=S,
               mesh=LocalMesh.grid(2, 2, dev)).compile()
    ref = engine_line(eng.run(sources))
    del eng
    release()
    reset_counts(kernels)
    _, out, wall_b = run_launcher(
        "path 7 (b) bfs_run", bfs_run.main,
        ["--workload", "rmat_1m", "--devices", "4", "--partition", "2d",
         "--grid", "2x2", "--mode", "auto", "--sources", str(S),
         "--repeats", "1"])
    runs = run_lines(out)
    check(len(runs) == 1 and runs[0][:3] == ref[:3],
          f"path 7 (b): run 0 {runs}, path 5 (b)'s engine {ref}")
    a1["b"] = kernels["fold_update"].launches
    release()

    # (c) bfs_serve --http on three lanes, the port's client verifying
    log(f"path 7 (c): device memory in use at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    port_file = tmp / "port"
    reset_counts(kernels)
    served = []
    argv = ["--devices", "4", "--graph", "rmat=rmat:1048576", "--graph",
            "rmat2d=rmat:1048576:2x2", "--graph", "sw=small_world:100000",
            "--http", "127.0.0.1:0", "--buckets", "1,8,64",
            "--watchdog-secs", "5", "--port-file", str(port_file)]
    log(f"path 7 (c) bfs_serve: {' '.join(argv)}")
    t0 = time.perf_counter()
    server = threading.Thread(target=lambda: served.append(
        bfs_serve.main(argv)), daemon=True)
    server.start()
    while not (port_file.exists() and port_file.read_text()):
        check(server.is_alive(), "path 7 (c): the server exited early")
        check(time.perf_counter() - t0 < 120, "path 7 (c): no port")
        time.sleep(0.2)
    url = f"http://127.0.0.1:{int(port_file.read_text())}"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def client(lane, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.bfs_client", "--url",
             url, "--graph", lane, "--requests", "12", "--max-retries", "2",
             "--verify", *extra], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    outs = {}
    for group in (("rmat", "rmat2d"), ("sw",)):
        procs = {lane: client(lane, *(("--shutdown",) if lane == "sw"
                                      else ())) for lane in group}
        for lane, proc in procs.items():
            text, _ = proc.communicate(timeout=300)
            outs[lane] = text
            log(f"path 7 (c) bfs_client --graph {lane}: exit "
                f"{proc.returncode}\n{text.strip()}")
            check(proc.returncode == 0 and "match the numpy reference "
                  "bitwise" in text, f"path 7 (c): the {lane} client failed")
    server.join(timeout=120)
    wall_c = time.perf_counter() - t0
    check(not server.is_alive() and served == [0],
          f"path 7 (c): the server did not drain and stop ({served})")
    a1["c"] = kernels["fold_update"].launches
    check(a1["c"] > 0, "path 7 (c): A1 never launched")
    log(f"path 7 (c): wall {wall_c:.1f} s")
    release()

    # (d) the chaos soak at the size of erdos_renyi_100k
    reset_counts(kernels)
    _, out, wall_d = run_launcher(
        "path 7 (d) bfs_chaos", bfs_chaos.main,
        ["--devices", "4", "--secs", "20", "--n", "100000", "--seed", "0",
         "--out", str(tmp / "chaos.json")])
    ledger = json.loads((tmp / "chaos.json").read_text())
    after = re.search(r"; (\d+) bitwise 200\(s\) requested after the first",
                      out)
    storms = ledger["faults"]["by_kind"].get("storm", 0)
    log(f"path 7 (d): faults {ledger['faults']['by_kind']}, outcomes "
        f"{ledger['outcomes']}, watchdog {ledger['watchdog']}")
    check(ledger["ok"] and storms >= 1 and after and int(after.group(1)) >= 1,
          f"path 7 (d): {storms} storms, 200s after one: "
          f"{after.group(1) if after else None}")
    a1["d"] = kernels["fold_update"].launches
    release()
    log(f"path 7: walls (a) {wall_a:.1f} s, (b) {wall_b:.1f} s, (c) "
        f"{wall_c:.1f} s, (d) {wall_d:.1f} s; A1 launches {a1}; path 7 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return a1


# ---------------------------------------------------------------------------
# path 8: the plan audits
# ---------------------------------------------------------------------------

def roofline_line(label: str, d: dict, stats, modes) -> dict:
    """Each level kind's ``describe()["roofline"]`` ``t_level_s`` beside
    the run's measured mean ms a level of that kind (``level_seconds``,
    the host clock to the level's read) and the share, model over
    measured; logged with the card's name and power limit."""
    rows = {}
    for kind, row in d["roofline"].items():
        ms = [t * 1e3 for t, m in zip(stats.level_seconds, modes)
              if m == kind]
        if ms:
            model = row["t_level_s"] * 1e3
            rows[kind] = {"model_ms": model, "measured_ms": sum(ms) / len(ms),
                          "levels": len(ms),
                          "share": model / (sum(ms) / len(ms)),
                          "bottleneck": row["bottleneck"]}
    log(f"{label} roofline ({card_line()}): " + "; ".join(
        f"{k} t_level_s {v['model_ms']:.6f} ms ({v['bottleneck']}) beside "
        f"{v['measured_ms']:.3f} ms measured a level over {v['levels']}, "
        f"share {v['share']:.6f}" for k, v in rows.items()))
    return rows


def census_rows(text: str, role: str) -> list:
    """``(recv B, model B)`` of the ``role`` rows of a printed census
    table."""
    out = []
    for line in text.splitlines():
        f = line.split()
        if len(f) >= 7 and f[0] == role and f[4].isdigit():
            out.append((float(f[4]), float(f[5])))
    return out


def audit_phase(kernels, g1, src1, dst1, g_sw, host_sw, roots_sw, dev,
                tmp: Path) -> dict:
    """The plan audits on the card (module docstring, path 8): (a)
    ``bfs_audit --all-variants``, (b) ``bfs_run --audit`` on ``rmat_1m``
    and the audit of a ``use_kernel`` engine on ``small_world_100k``.
    Returns the kernels' launches in (b)."""
    import gc

    from repro_torch.analysis import collective_audit
    from repro_torch.core import BFSOptions, plan
    from repro_torch.core.ref import validate_bfs
    from repro_torch.graphs import shard_graph
    from repro_torch.launch import bfs_audit, bfs_run
    from repro_torch.serve.engine_cache import default_engine_cache

    t_phase = time.perf_counter()
    card = card_line()
    lo, hi = collective_audit.DEFAULT_TOLERANCE
    launches = {}

    def release():
        default_engine_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the gate: every variant of er:4096 at p = 4 on the card
    ledger_path = tmp / "BENCH_audit_torch.json"
    _, out, wall_a = run_launcher(
        "path 8 (a) bfs_audit", bfs_audit.main,
        ["--graph", "er:4096", "--all-variants", "--devices", "4",
         "--census", "--out", str(ledger_path)])
    ledger = json.loads(ledger_path.read_text())["audit"]
    reports = [r for r in ledger["reports"] if r["name"].startswith("census")]
    check(ledger["ok"] and ledger["device"].startswith("cuda")
          and ledger["variants"]["planned"] == 48
          and len(reports) == ledger["variants"]["audited"],
          f"path 8 (a): ledger {ledger['ok']}, variants "
          f"{ledger['variants']}, {len(reports)} reports")
    check(all(r["info"]["host_reads"]["counted_by"] == "sync"
              for r in reports),
          "path 8 (a): the host reads were not counted by sync debug mode")
    per_level, reads = {}, {}
    for r in reports:
        for k, v in r["info"]["collectives"]["per_level"].items():
            per_level.setdefault(k, set()).add(v)
        for k, v in r["info"]["host_reads"]["max_per_level"].items():
            reads[k] = max(reads.get(k, 0), v)
    check(reads and all(reads[k] <= collective_audit.HOST_READ_BUDGET[k]
                        for k in reads),
          f"path 8 (a): host reads a level {reads}")
    check(ledger["byte_ratios"] and per_level
          and all(lo <= a and b <= hi
                  for a, b in ledger["byte_ratios"].values()),
          f"path 8 (a): byte ratios {ledger['byte_ratios']}, collectives a "
          f"level {per_level}")
    log(f"path 8 (a): {ledger['variants']['planned']} variants planned, "
        f"{ledger['variants']['audited']} audited, all clean ({card}); data "
        f"collectives a level by kind "
        f"{ {k: sorted(v) for k, v in per_level.items()} }; synchronizing "
        f"calls a level at most (sync debug mode) {reads}; recorded/modeled "
        f"bytes by role (least, most) {ledger['byte_ratios']}; wall "
        f"{wall_a:.1f} s")

    # (b) bfs_run --audit on rmat_1m at p = 4, dense, S = 64 (not cut),
    # against path 1's p = 4 engine on the audited sources 0..63, and on
    # the two single sources the audit's buffer check runs
    sources = list(range(S))
    eng = plan(g1, BFSOptions(), num_sources=S).compile()
    d = eng.plan.describe()
    res = eng.run(sources)
    want, ref = res.dist_host, engine_line(res)
    check_levels = [eng.run([k]).run_stats.levels for k in (0, 1)]
    del eng, res
    release()
    held = {}

    def hold(rep, srcs, res):
        if rep in ("audit", 0):
            held[rep] = (list(srcs), res.dist_host, res.run_stats.levels)

    reset_counts(kernels)
    _, out, wall_b = run_launcher(
        "path 8 (b) bfs_run --audit", bfs_run.main,
        ["--workload", "rmat_1m", "--devices", "4", "--mode", "dense",
         "--sources", str(S), "--repeats", "2", "--audit"], on_run=hold)
    counts = {name: k.launches for name, k in kernels.items()}
    runs = run_lines(out)
    check(f"[census:1d:dense:auto:S{S}:fused] ok" in out,
          "path 8 (b): the audit did not pass")
    check(held["audit"][0] == sources
          and np.array_equal(held["audit"][1], want),
          "path 8 (b): the audited run's distances differ from path 1's "
          "p = 4 engine on sources 0..63")
    validate_bfs(src1, dst1, np.asarray(sources),
                 torch.from_numpy(held["audit"][1]).to(dev))
    check(len(runs) == 2 and runs[0] == ref,
          f"path 8 (b): run 0 {runs[:1]}, path 1's engine {ref}")
    levels = (held["audit"][2] + sum(check_levels)
              + sum(int(r[0]) for r in runs))
    check(counts["fold_update"] == levels
          and not any(v for k, v in counts.items() if k != "fold_update"),
          f"path 8 (b): launches {counts}, not A1 once a level of {levels}")
    dense = census_rows(out, "dense")
    check(dense and all(m == d["dense_level_bytes"] and lo <= r / m <= hi
                        for r, m in dense),
          f"path 8 (b): dense rows {dense}, model "
          f"{d['dense_level_bytes']}")
    launches["rmat"] = counts["fold_update"]
    log(f"path 8 (b): the audited run bitwise path 1's engine on 0..63 "
        f"({held['audit'][2]} levels), A1 {counts['fold_update']} launches "
        f"= once a level of the audit, its two buffer-check runs "
        f"{check_levels} and the two timed runs; dense received / modeled "
        f"{[r / m for r, m in dense]}; wall {wall_b:.1f} s")
    del held
    release()

    # (b) with use_kernel: small_world_100k at p = 4, bsr_expand_bits and
    # A1 under the audit, from path 2's roots, bitwise path 2's distances
    t0 = time.perf_counter()
    eng = plan(shard_graph(g_sw[0], g_sw[1], g_sw[2], 4),
               BFSOptions(use_kernel=True), num_sources=S).compile()
    check_levels = [eng.run([k]).run_stats.levels for k in (0, 1)]
    got = []
    reset_counts(kernels)
    rep = collective_audit.audit_engine(
        eng, sources=roots_sw, on_result=lambda r: got.append(
            (r.dist_host, r.run_stats.levels)))
    counts = {name: k.launches for name, k in kernels.items()}
    log(f"path 8 (b) use_kernel: {rep.summary()}\n"
        + collective_audit.census_table(rep))
    for v in rep.violations:
        log(f"  {v}")
    check(rep.ok() and rep.info["host_reads"]["counted_by"] == "sync",
          "path 8 (b) use_kernel: the audit failed")
    check(np.array_equal(got[0][0], host_sw),
          "path 8 (b) use_kernel: distances differ from path 2's")
    levels = got[0][1] + sum(check_levels)
    check(counts["bsr_expand_bits"] == levels
          and counts["fold_update"] == levels
          and counts["bsr_spmm"] == counts["bitpack_words"] == 0,
          f"path 8 (b) use_kernel: launches {counts}, not "
          f"bsr_expand_bits and A1 once a level of {levels}")
    launches["sw"] = counts
    log(f"path 8 (b) use_kernel: small_world_100k p=4 from path 2's roots "
        f"bitwise path 2's distances ({got[0][1]} levels); launches "
        f"{counts}; host reads {rep.info['host_reads']}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    del eng, got
    release()
    log(f"path 8: walls (a) {wall_a:.1f} s, (b) {wall_b:.1f} s; path 8 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# path 9: the torch.distributed mesh, one shard a process
# ---------------------------------------------------------------------------

#: every process of path 9 is gone by then, or killed and failed
PATH9_DEADLINE_S = 420
#: the process groups' timeout: a collective that waits longer raises
PATH9_PG_TIMEOUT_S = 120


def save_blocks(d: Path, graph, names) -> None:
    """Write a sharded graph's host blocks (one ``.npy`` each) and its
    sizes, for path 9's processes to map."""
    d.mkdir(parents=True, exist_ok=True)
    for name in names:
        np.save(d / f"{name}.npy", getattr(graph, name))
    part = graph.part
    (d / "meta.json").write_text(json.dumps({
        "n": part.n_logical, "p": part.p, "n_edges": int(graph.n_edges),
        "grid": [part.r, part.c] if hasattr(part, "r") else None}))


def load_blocks(d: Path):
    """The graph ``save_blocks`` wrote, its blocks mapped from the files
    (copy on write: a rank reads the rows it uploads)."""
    from repro_torch.core import Partition1D, Partition2D
    from repro_torch.graphs import ShardedGraph, ShardedGraph2D

    meta = json.loads((d / "meta.json").read_text())
    arrays = {f.stem: np.load(f, mmap_mode="c") for f in d.glob("*.npy")}
    if meta["grid"]:
        return ShardedGraph2D(part=Partition2D(meta["n"], *meta["grid"]),
                              n_edges=meta["n_edges"], **arrays)
    return ShardedGraph(part=Partition1D(meta["n"], meta["p"]),
                        n_edges=meta["n_edges"], **arrays)


def path9_kernels() -> dict:
    from repro_torch.kernels.bsr_spmm.kernel import bsr_expand_bits
    from repro_torch.kernels.fold_update import fold_update

    return {"fold_update": fold_update, "bsr_expand_bits": bsr_expand_bits}


def path9_drive(kernels, eng, roots, runs: int = 2):
    """``runs`` runs of ``eng`` (all ranks at once) with the launch counts
    reset before: (last result, its host dist, counts, run ms)."""
    reset_counts(kernels)
    run_ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(roots)
        run_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {name: k.launches for name, k in kernels.items()}
    return res, res.dist_host, counts, run_ms


def run_summary(res, counts, run_ms) -> dict:
    st = res.run_stats
    return {"stats": st.to_host(), "counts": counts, "run_ms": run_ms,
            "level_ms": [t * 1e3 for t in st.level_seconds]}


def path9_rank(rank: int, world: int, backend: str, tmp: str) -> None:
    """One process of path 9: join the group (``file://`` rendezvous in
    ``tmp``, no port), run its phases on ``cuda:0``, write its results
    (``result_<backend>_<rank>.json``) and leave the group."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    tmp = Path(tmp)
    dist.init_process_group(
        backend, init_method=f"file://{tmp / f'rendezvous_{backend}'}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PATH9_PG_TIMEOUT_S))
    try:
        body = path9_nccl if backend == "nccl" else path9_gloo
        out = body(rank, dev, tmp)
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def path9_nccl(rank: int, dev, tmp: Path) -> dict:
    """(a): ``nccl`` at world size 1: ``rmat_1m`` at p = 1 with the packed
    wire, S = 64, on path 1's roots."""
    import torch.distributed as dist

    from repro_torch.core import BFSOptions, DistMesh, plan
    from repro_torch.graphs import shard_graph

    kernels = path9_kernels()
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)                  # the communicator forms
    want = np.load(tmp / "want1.npy", mmap_mode="r")
    roots = np.load(tmp / "roots1.npy").tolist()
    src = np.load(tmp / "src1.npy", mmap_mode="r")
    dst = np.load(tmp / "dst1.npy", mmap_mode="r")
    g = shard_graph(src, dst, want.shape[0], 1)
    mesh = DistMesh.flat(dev)
    pl = plan(g, BFSOptions(wire_format="packed"), mesh=mesh, num_sources=S)
    eng = pl.compile()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots)
    return {"a": run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want)),
        "all_reduce": float(one.item()), "mesh": pl.describe()["mesh"],
        "nccl": str(torch.cuda.nccl.version())}}


def path9_gloo(rank: int, dev, tmp: Path) -> dict:
    """(b)-(f) and the planted fault: ``gloo``, 4 ranks on ``cuda:0``."""
    import gc

    from repro_torch.analysis import collective_audit
    from repro_torch.core import BFSOptions, DistMesh, plan
    from repro_torch.core.frontier import INF

    kernels = path9_kernels()
    out = {}
    want1 = np.load(tmp / "want1.npy", mmap_mode="r")
    roots1 = np.load(tmp / "roots1.npy").tolist()
    deg1 = np.load(tmp / "deg1.npy")
    g1 = load_blocks(tmp / "rmat4")

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # (b) dense, default options (packed wire, A1 on the fused tail)
    mesh = DistMesh.flat(dev)
    pl = plan(g1, BFSOptions(), mesh=mesh, num_sources=S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = pl.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    allocated = torch.cuda.memory_allocated()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots1)
    out["b"] = run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want1)),
        "compile_ms": compile_ms, "memory_allocated": allocated,
        "estimated_device_bytes": pl.estimated_device_bytes(),
        "terms": pl.device_byte_terms(), "mesh": pl.describe()["mesh"],
        "rows": list(eng._dist.shape),
        "roofline_dense": pl.describe()["roofline"]["dense"]}

    # (f) every rank audits (b)'s engine; rank 0's census is the one read
    rep = collective_audit.audit_engine(eng, sources=roots1)
    out["f"] = {"ok": rep.ok(), "summary": rep.summary(),
                "violations": [str(v) for v in rep.violations],
                "ratios": rep.info["ratios"],
                "host_reads": rep.info["host_reads"],
                "collectives": rep.info["collectives"],
                "table": collective_audit.census_table(rep)}
    del eng, res, rep
    release()

    # (c) auto, S = 1, path 4's first roots: bitwise, schedules replayed
    pl = plan(g1, BFSOptions(mode="auto"), mesh=mesh, num_sources=1)
    eng = pl.compile()
    rows = []
    for i, root in enumerate(roots1[:8]):
        res, host, counts, run_ms = path9_drive(kernels, eng, [root], runs=1)
        st = res.run_stats.to_host()
        levels, modes = replay_modes(host, deg1, g1.n_edges, 1, INF)
        rows.append(run_summary(res, counts, run_ms) | {
            "bitwise": bool(np.array_equal(host, want1[:, i:i + 1])),
            "replayed": levels == st["levels"]
            and mode_counts(modes) == st["mode_counts"], "modes": modes})
    out["c"] = rows
    del eng, res
    release()

    # (d) the 2 x 2 grid, dense, S = 64 (path 5 (a))
    g2d = load_blocks(tmp / "rmat2d")
    pl = plan(g2d, BFSOptions(), mesh=DistMesh.grid(2, 2, dev),
              num_sources=S)
    eng = pl.compile()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots1)
    out["d"] = run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want1)),
        "rows": list(eng._dist.shape)}
    del eng, res, g2d
    release()

    # (e) small_world_100k, use_kernel, p = 4 (path 2's roots)
    want2 = np.load(tmp / "want2.npy")
    roots2 = np.load(tmp / "roots2.npy").tolist()
    g_sw = load_blocks(tmp / "sw4")
    pl = plan(g_sw, BFSOptions(use_kernel=True), mesh=mesh, num_sources=S)
    eng = pl.compile()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots2)
    out["e"] = run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want2)),
        "tiles": int(eng.kernel_arrays[0].shape[0])}
    del eng, res
    release()

    # the planted fault: rank 1 reports the next shard's index
    class WrongIndex(DistMesh):
        @property
        def local_shards(self):
            k = (self.rank + 1) % self.p if self.rank == 1 else self.rank
            return range(k, k + 1)

    pl = plan(g_sw, BFSOptions(), mesh=WrongIndex((4,), ("bfs_p",), dev),
              num_sources=S)
    host = pl.compile().run(roots2).dist_host
    out["fault"] = {"rejected": not np.array_equal(host, want2)}
    return out


def path9_group(ctx, world: int, backend: str, tmp: Path, deadline: float):
    """Start ``world`` processes of ``path9_rank`` and wait for them until
    ``deadline`` (``time.monotonic``), then kill the rest; returns their
    results, or fails."""
    procs = [ctx.Process(target=path9_rank, args=(k, world, backend,
                                                  str(tmp)))
             for k in range(world)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [proc.exitcode for proc in procs]
    check(codes == [0] * world,
          f"path 9 ({backend}): the processes exited {codes}")
    return [json.loads((tmp / f"result_{backend}_{k}.json").read_text())
            for k in range(world)]


def path9_phase(g1, src1, dst1, roots1, want1, path1, path5_stats, g_sw_src,
                host2, roots2, card: str, tmp: Path) -> dict:
    """``DistMesh`` on the card (module docstring, path 9).  Writes the
    graphs and expected distances once, then runs (a) in one ``nccl``
    process and (b)-(f) and the planted fault in four ``gloo`` processes
    on ``cuda:0``, all started with ``spawn`` after the parent built the
    kernels.  Returns each rank's launches."""
    import gc

    from repro_torch.core import BFSOptions, plan
    from repro_torch.graphs import shard_graph, to_2d
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.build()                        # built before any rank starts
    t0 = time.perf_counter()
    names1 = ("src_local", "dst_global", "in_src_global", "in_dst_local")
    save_blocks(tmp / "rmat4", g1, names1)
    save_blocks(tmp / "rmat2d", to_2d(g1, 2, 2), ("src_rowlocal",
                                                  "dst_fold"))
    save_blocks(tmp / "sw4", shard_graph(*g_sw_src, 4), names1)
    np.save(tmp / "src1.npy", src1.astype(np.int32))
    np.save(tmp / "dst1.npy", dst1.astype(np.int32))
    np.save(tmp / "deg1.npy", np.bincount(src1, minlength=g1.part.n_logical))
    np.save(tmp / "roots1.npy", np.asarray(roots1))
    np.save(tmp / "want1.npy", want1)
    np.save(tmp / "roots2.npy", np.asarray(roots2))
    np.save(tmp / "want2.npy", host2)
    write_s = time.perf_counter() - t0
    stacked = plan(g1, BFSOptions(), num_sources=S).device_byte_terms()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + PATH9_DEADLINE_S

    # (a) nccl at world size 1
    t0 = time.perf_counter()
    a = path9_group(ctx, 1, "nccl", tmp, deadline)[0]["a"]
    wall_a = time.perf_counter() - t0
    p1 = path1["p1_packed"][3]
    check(a["bitwise"] and a["mesh"]["backend"] == "nccl"
          and a["all_reduce"] == 1.0,
          f"path 9 (a): distances or the nccl group wrong: {a['mesh']}")
    check(a["stats"]["levels"] == p1.levels
          and a["stats"]["comm_bytes"] == p1.comm_bytes,
          f"path 9 (a): {a['stats']}, path 1 p1_packed {p1.levels} levels")
    check(a["counts"]["fold_update"] == 2 * a["stats"]["levels"]
          and a["counts"]["bsr_expand_bits"] == 0,
          f"path 9 (a): launches {a['counts']} in 2 runs")
    log(f"path 9 (a) nccl {a['nccl']}, world size 1, rmat_1m p=1 packed "
        f"S=64: bitwise path 1 p1_packed, levels {a['stats']['levels']}, "
        f"comm_bytes {a['stats']['comm_bytes']}, runs {a['run_ms']} ms, "
        f"per-level ms {a['level_ms']}, launches {a['counts']}; wall "
        f"{wall_a:.1f} s ({card})")

    # (b)-(f): gloo, four ranks sharing cuda:0
    t0 = time.perf_counter()
    ranks = path9_group(ctx, 4, "gloo", tmp, deadline)
    wall_g = time.perf_counter() - t0
    p4 = path1["p4_default"][3]
    for k, r in enumerate(ranks):
        b = r["b"]
        check(b["bitwise"] and b["stats"]["levels"] == p4.levels
              and b["stats"]["comm_bytes"] == p4.comm_bytes,
              f"path 9 (b) rank {k}: bitwise {b['bitwise']}, {b['stats']}; "
              f"path 1 p4_default {p4.levels} levels, {p4.comm_bytes}")
        check(b["counts"]["fold_update"] == 2 * b["stats"]["levels"]
              and b["counts"]["bsr_expand_bits"] == 0,
              f"path 9 (b) rank {k}: launches {b['counts']} in 2 runs")
        check(b["rows"] == [g1.part.shard_size, S]
              and b["memory_allocated"] <= b["estimated_device_bytes"],
              f"path 9 (b) rank {k}: dist {b['rows']}, allocated "
              f"{b['memory_allocated']} over the estimate "
              f"{b['estimated_device_bytes']}")
    resident = [r["b"]["terms"]["resident"] for r in ranks]
    check(sum(resident) == stacked["resident"],
          f"path 9 (b): the ranks' resident bytes {resident} do not sum to "
          f"the stacked engine's {stacked['resident']}")
    transport = ranks[0]["b"]["mesh"]["transport"]
    for k, r in enumerate(ranks):
        log(f"path 9 (b) rank {k}: estimated_device_bytes "
            f"{r['b']['estimated_device_bytes']} (resident "
            f"{r['b']['terms']['resident']}), memory_allocated after compile "
            f"{r['b']['memory_allocated']}, compile {r['b']['compile_ms']:.1f}"
            f" ms, runs {r['b']['run_ms']} ms, launches {r['b']['counts']}")
    b0 = ranks[0]["b"]
    log(f"path 9 (b) {transport}, 4 ranks on one "
        f"card ({card}), not a multi-card figure: rmat_1m p=4 dense S=64 "
        f"bitwise path 1 p4_default, levels {b0['stats']['levels']}, "
        f"comm_bytes {b0['stats']['comm_bytes']}; per-level ms (rank 0) "
        f"{[round(t, 3) for t in b0['level_ms']]} beside path 1 p4_default "
        f"{[round(t * 1e3, 3) for t in p4.level_seconds]}; the ranks' "
        f"resident bytes {resident} sum to the stacked engine's "
        f"{stacked['resident']}; roofline dense link "
        f"{b0['roofline_dense']['link']} t_level_s "
        f"{b0['roofline_dense']['t_level_s']}")

    f = ranks[0]["f"]
    log(f"path 9 (f) rank 0's census of (b): {f['summary']}\n{f['table']}")
    check(all(r["f"]["ok"] for r in ranks),
          f"path 9 (f): an audit failed: {f['violations']}")
    check(f["ratios"] and all(v["min"] == v["max"] == 1.0
                              for v in f["ratios"].values()),
          f"path 9 (f): recorded/modeled ratios {f['ratios']}")
    from repro_torch.analysis.collective_audit import HOST_READ_BUDGET
    check(all(n <= HOST_READ_BUDGET[k]
              for k, n in f["host_reads"]["max_per_level"].items()),
          f"path 9 (f): host reads {f['host_reads']}")
    log(f"path 9 (f): ratios {f['ratios']}; host reads a level "
        f"{f['host_reads']['max_per_level']} (counted by "
        f"{f['host_reads']['counted_by']}); collectives "
        f"{f['collectives']}")

    for k, r in enumerate(ranks):
        for i, row in enumerate(r["c"]):
            check(row["bitwise"] and row["replayed"],
                  f"path 9 (c) rank {k} root {i}: bitwise {row['bitwise']},"
                  f" {row['stats']['mode_counts']} against the replay")
    c0 = ranks[0]["c"]
    # A1 runs on the dense levels and on the queue levels that escalate
    log(f"path 9 (c) auto S=1, {len(c0)} roots: bitwise path 4's columns, "
        f"mode_counts == the replay: "
        f"{[row['stats']['mode_counts'] for row in c0]}; overflowed "
        f"{[row['stats']['overflowed'] for row in c0]}; A1 "
        f"{[row['counts']['fold_update'] for row in c0]}; runs "
        f"{[round(row['run_ms'][0], 3) for row in c0]} ms")

    s5 = path5_stats
    for k, r in enumerate(ranks):
        d = r["d"]
        check(d["bitwise"] and d["stats"]["levels"] == s5.levels
              and d["stats"]["comm_bytes"] == s5.comm_bytes
              and d["stats"]["mode_counts"]["dense"] == s5.levels,
              f"path 9 (d) rank {k}: bitwise {d['bitwise']}, {d['stats']}")
        check(d["counts"]["fold_update"] == 2 * d["stats"]["levels"],
              f"path 9 (d) rank {k}: launches {d['counts']} in 2 runs")
    d0 = ranks[0]["d"]
    log(f"path 9 (d) 2 x 2 DistMesh.grid dense S=64, gloo through the host "
        f"on one card ({card}): bitwise path 5 (a), levels "
        f"{d0['stats']['levels']}, comm_bytes {d0['stats']['comm_bytes']}; "
        f"per-level ms (rank 0) {[round(t, 3) for t in d0['level_ms']]} "
        f"beside path 5 (a) {[round(t * 1e3, 3) for t in s5.level_seconds]}")

    for k, r in enumerate(ranks):
        e = r["e"]
        check(e["bitwise"], f"path 9 (e) rank {k}: distances differ from "
                            "path 2's")
        check(e["counts"]["bsr_expand_bits"] == 2 * e["stats"]["levels"]
              and e["counts"]["fold_update"] == 2 * e["stats"]["levels"],
              f"path 9 (e) rank {k}: launches {e['counts']} in 2 runs of "
              f"{e['stats']['levels']} levels")
        check(r["fault"]["rejected"],
              f"path 9 fault: rank {k}'s distances passed with a wrong "
              "shard index")
    e0 = ranks[0]["e"]
    log(f"path 9 (e) small_world_100k use_kernel p=4: bitwise path 2, "
        f"bsr_expand_bits {[r['e']['counts']['bsr_expand_bits'] for r in ranks]}"
        f" a rank in 2 runs of {e0['stats']['levels']} levels; tiles a rank "
        f"{[r['e']['tiles'] for r in ranks]}; the planted wrong shard index "
        f"rejected on every rank")
    log(f"path 9: writes {write_s:.1f} s, (a) {wall_a:.1f} s, (b)-(f) "
        f"{wall_g:.1f} s; path 9 {time.perf_counter() - t_phase:.1f} s")
    return {"fold_update": [a["counts"]["fold_update"]]
            + [r["b"]["counts"]["fold_update"] for r in ranks],
            "bsr_expand_bits": [r["e"]["counts"]["bsr_expand_bits"]
                                for r in ranks]}


def profile_run(name, run) -> None:
    """One more call of ``run`` under ``torch.profiler``: device time by
    op, and the share of the call's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device-side entries only: a host op's device time repeats its kernels'
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    log(f"{name} profile: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    log(events.table(sort_by="self_device_time_total", row_limit=12))


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the causal / window mask keeps (A4's work)."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q + 1, skv) if causal else np.full(sq, skv, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against ``want``, in f32."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def head_rel_errs(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of each (batch, head) slice of an attention
    output ``(B, H, S, Dh)``."""
    want = want.float()
    diff = (got.float() - want).flatten(2).norm(dim=-1)
    return diff / want.flatten(2).norm(dim=-1).clamp_min(1e-30)


def hold_a4(q, k, v, causal: bool, window: int, what: str):
    """A4 against its plain version: elementwise with the bound of
    tests/test_torch_cuda.py (f32 2e-5; bf16 atol 2^-9 max|v|, rtol
    2^-6), and each (batch, head) slice within A4_HEAD_TOL relative L2
    (bf16; 2e-5 for f32).  Returns the max abs error and the plain
    output."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype == torch.float32:
        atol = rtol = head_tol = 2e-5
    else:
        atol, rtol = 2.0 ** -9 * float(v.abs().max()), 2.0 ** -6
        head_tol = A4_HEAD_TOL
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    heads = head_rel_errs(got, want)
    log(f"A4 {what}: max abs err {err} (atol {atol}, rtol {rtol}); rel L2 "
        f"a head: mean {float(heads.mean())}, max {float(heads.max())} "
        f"(limit {head_tol})")
    check(ok and float(heads.max()) <= head_tol,
          f"A4 differs from attention_ref at {what}")
    return err, want


def planted_a4(q, k, v, window: int, want, what: str) -> torch.Tensor:
    """A planted fault: A4 with the causal window one key wider and one
    narrower, read against the plain output ``want`` at ``window``;
    returns the smallest relative L2 error a head."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    worst = float("inf")
    for delta in (-1, 1):
        heads = head_rel_errs(flash_attention(
            q, k, v, causal=True, window=window + delta), want)
        log(f"A4 planted fault at {what} (window {window + delta} against "
            f"{window}): rel L2 a head: min {float(heads.min())}, max "
            f"{float(heads.max())} (limit {A4_HEAD_TOL})")
        worst = min(worst, float(heads.min()))
    return worst


def shifted_windows(cfg, delta: int):
    """``cfg`` with every local layer's window moved by ``delta``: a
    planted fault, for reading what the prefill check catches."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(sp, window=sp.window + delta) if sp.window
        else sp for sp in cfg.pattern))


def prefill_phase(kernels, dev, profile: bool) -> dict:
    """gemma3-12b prefill at full width, cut in depth and size (module
    docstring, phase 8); returns A4's launches and what the kernel phase
    needs of the run."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models import transformer as tf

    spec = get_arch("gemma3_12b")
    full, full_shape = spec.config, get_shape(spec, "prefill_32k")
    cfg = dataclasses.replace(full, n_layers=PREFILL_LAYERS)
    shape = dataclasses.replace(full_shape, seq_len=PREFILL_SEQ,
                                global_batch=PREFILL_BATCH)
    log(f"prefill: {full.name} prefill_32k, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} q / {cfg.n_kv_heads} kv x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, random weights "
        f"(seed {SEED})")
    log(f"prefill cut: layers {full.n_layers} -> {cfg.n_layers} "
        f"({cfg.n_groups} groups of {len(cfg.pattern)}: 5 local, window "
        f"{cfg.pattern[0].window}, + 1 global)")
    log(f"prefill cut: batch {full_shape.global_batch} -> "
        f"{shape.global_batch}")
    log(f"prefill cut: seq_len (prompt = max_len) {full_shape.seq_len} -> "
        f"{shape.seq_len}")
    bundle = build_bundle(dataclasses.replace(spec, config=cfg), shape,
                          device=dev)
    t0 = time.perf_counter()
    params = bundle.make_state(bundle.init_params(
        torch.Generator(device=dev).manual_seed(SEED)))
    batch = bundle.make_batch(SEED)
    torch.cuda.synchronize()
    log(f"prefill: {sum(p.numel() for p in params.parameters())} weights "
        f"({sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9:.3f} GB) "
        f"drawn in {time.perf_counter() - t0:.3f} s; tokens "
        f"{tuple(batch['tokens'].shape)}")

    run_ms, outs, launches = [], [], 0
    a4 = kernels["flash_attention"]
    for i in range(3):
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.fn(params, batch)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {name: k.launches for name, k in kernels.items()}
        check(counts["flash_attention"] == cfg.n_layers
              and a4.launches_bf16 == cfg.n_layers and a4.launches_f32 == 0,
              f"prefill run {i + 1}: A4 launched "
              f"{counts['flash_attention']} times ({a4.launches_bf16} bf16, "
              f"{a4.launches_f32} f32), not {cfg.n_layers} bf16")
        launches += counts["flash_attention"]
        outs.append((logits, cache))
    logits, cache = outs[-1]
    b, s = batch["tokens"].shape
    check(logits.shape == (b, cfg.vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(torch.equal(outs[1][0], logits)
          and all(torch.equal(x[n], y[n]) for x, y in zip(outs[1][1], cache)
                  for n in "kv"), "prefill runs 2 and 3 differ")
    log(f"prefill: first run {run_ms[0]:.1f} ms; runs 2, 3 "
        f"{[round(t, 3) for t in run_ms[1:]]} ms = "
        f"{[round(b * s / (t / 1e3), 1) for t in run_ms[1:]]} prompt "
        f"tokens/s; A4 launches {cfg.n_layers} a run")
    del outs
    if profile:
        profile_run("prefill", lambda: bundle.fn(params, batch))

    # the same prefill with the plain attention (attention_ref)
    plain_logits, plain_cache = bundle.fn(params, batch, use_kernel=False)
    torch.cuda.synchronize()
    # Tolerance: each layer's attention output may differ from the plain
    # one by the kernel phase's limit (2^-7 relative L2 a head); the
    # residual stream carries 12 such differences to the logits and to
    # the later layers' k, v, which are held to PREFILL_TOL relative L2.
    # The first layer's k, v are computed before any attention, so its
    # cache is bitwise equal.
    err = rel_err(logits, plain_logits)
    layer_errs = [max(rel_err(c[n][g], pc[n][g]) for n in "kv")
                  for g in range(cfg.n_groups)
                  for c, pc in zip(cache, plain_cache)]
    max_abs = float((logits.float() - plain_logits.float()).abs().max())
    log(f"prefill vs plain attention: logits rel L2 {err} (max abs "
        f"{max_abs}); cache rel L2 by layer {layer_errs}; tolerance "
        f"{PREFILL_TOL}")
    check(err <= PREFILL_TOL and max(layer_errs) <= PREFILL_TOL,
          "prefill with A4 differs from the plain-attention prefill")
    check(torch.equal(cache[0]["k"][0], plain_cache[0]["k"][0])
          and torch.equal(cache[0]["v"][0], plain_cache[0]["v"][0]),
          "the first layer's cache differs from the plain prefill's")
    del plain_cache
    # planted faults, read only: every local window one key off moves the
    # logits by 0.036 and 0.044 (H100), too close to the correct kernel's
    # 0.018 for the logits to be the gate; the per-layer hold below is.
    for delta in (-1, 1):
        bad, _, _ = tf.prefill(shifted_windows(cfg, delta), params,
                               batch["tokens"], shape.seq_len)
        log(f"prefill planted fault (local windows {delta:+d}): logits rel "
            f"L2 {rel_err(bad, plain_logits)} against the plain prefill")
    del plain_logits

    # A4 on each layer's own q, k, v (the kernel's contiguous operands),
    # recorded from one more prefill
    recorded, attention = [], tf.attention

    def record(q, k, v, *, causal, window, use_kernel):
        recorded.append((q.contiguous(), k.contiguous(), v.contiguous(),
                         window))
        return attention(q, k, v, causal=causal, window=window,
                         use_kernel=use_kernel)

    tf.attention = record
    try:
        bundle.fn(params, batch)
    finally:
        tf.attention = attention
    check(len(recorded) == cfg.n_layers, "a layer's attention not recorded")
    for i, (q, k, v, window) in enumerate(recorded):
        _, want = hold_a4(q, k, v, True, window,
                          f"prefill layer {i} (window {window})")
        if i == 0:      # every head must fail with the window one key off
            check(planted_a4(q, k, v, window, want, "prefill layer 0")
                  > A4_HEAD_TOL, "the A4 check passes a window one key off "
                                 "at prefill layer 0")
    del recorded, q, k, v, want
    return {"launches": launches, "cfg": cfg, "batch": b, "seq": s}


def attention_rows(lay: dict, dev, sass: dict) -> dict:
    """A4 against its plain version at the prefill's shapes (local and
    global layer) and at Dh = 128 on an unaligned length; timed beside its
    bound, the plain version and SDPA (both layers)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         attention_ref)

    cfg, b, s = lay["cfg"], lay["batch"], lay["seq"]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(dtype, sq, skv, d):
        return (torch.randn((b, hq, sq, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, hkv, skv, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, hkv, skv, d), generator=gen, device=dev
                            ).to(dtype))

    errs = []
    for dtype in (torch.float32, torch.bfloat16):   # unaligned, non-causal
        q, k, v = qkv(dtype, 1000, 1500, 128)
        errs.append(hold_a4(q, k, v, False, 0, f"{dtype} Dh 128 Sq 1000 "
                            f"Skv 1500 non-causal")[0])
    # the prefill's widths with a ragged last q and kv tile
    q, k, v = qkv(torch.bfloat16, s - 1, s - 1, dh)
    errs.append(hold_a4(q, k, v, True, cfg.pattern[0].window,
                        f"bf16 Dh {dh} Sq = Skv = {s - 1} window "
                        f"{cfg.pattern[0].window}")[0])
    q, k, v = qkv(torch.bfloat16, s, s, dh)
    row = {}
    for window in (cfg.pattern[0].window, 0):       # local, then global
        what = f"bf16 {tuple(q.shape)} kv {tuple(k.shape)} window {window}"
        err, want = hold_a4(q, k, v, True, window, what)
        errs.append(err)
        if window:      # every head must fail with the window one key off
            check(planted_a4(q, k, v, window, want, what) > A4_HEAD_TOL,
                  f"the A4 check passes a window one key off at {what}")
        del want
        pairs = visible_pairs(s, s, True, window)
        flops = 4.0 * b * hq * dh * pairs
        b_ms, b_by = bound(nbytes(q, k, v, q), flops, BF16_FLOPS)
        ms = timed_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window), 5)
        plain_ms = timed_ms(lambda: attention_ref(q, k, v, causal=True,
                                                  window=window), 3)
        tflops = flops / ms / 1e9
        log(f"A4 {what}: {ms} ms = {tflops} TFLOP/s, {b_ms / ms:.4f} of the "
            f"bound {b_ms} ms ({b_by}; {pairs} visible pairs a head); plain "
            f"{plain_ms} ms")
        row[window] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "tflops": tflops,
                       "bound_share": b_ms / ms}
    # the one-call yardsticks (timed only; the port never calls SDPA): the
    # global layer causal with GQA, the local layer with its window as a
    # boolean mask over kv heads expanded to q heads beforehand
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    sdpa_err = float((sdpa().float()
                      - attention_ref(q, k, v, causal=True).float()
                      ).abs().max())
    library_ms = timed_ms(sdpa, 10)
    log(f"SDPA (global layer): {library_ms} ms, max abs err vs plain "
        f"{sdpa_err}")
    w_loc = cfg.pattern[0].window
    k_rep, v_rep = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    mask = attention_mask(s, s, causal=True, window=w_loc, device=dev)
    sdpa_local = lambda: F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                        attn_mask=mask)
    local_err = float((sdpa_local().float()
                       - attention_ref(q, k, v, causal=True,
                                       window=w_loc).float()).abs().max())
    library_local_ms = timed_ms(sdpa_local, 5)
    log(f"SDPA (local layer, boolean attn_mask): {library_local_ms} ms, max "
        f"abs err vs plain {local_err}")
    del k_rep, v_rep, mask
    local, glob = row[w_loc], row[0]
    return {
        "name": "flash_attention", "route": "cuda",
        "design": "bf16: wgmma + TMA, warp-specialised; f32: CUDA cores",
        "source": "src/repro_torch/csrc/attention_kernels.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "launches": lay["launches"], "max_abs_err": max(errs),
        "ms": glob["ms"], "plain_ms": glob["plain_ms"],
        "bound_ms": glob["bound_ms"], "bound_by": glob["bound_by"],
        "library_ms": library_ms,
        "tflops": glob["tflops"], "bound_share": glob["bound_share"],
        "shape": f"global layer: q {tuple(q.shape)} bf16, kv "
                 f"{tuple(k.shape)}, causal",
        "local_window": w_loc,
        "local_ms": local["ms"], "local_plain_ms": local["plain_ms"],
        "local_bound_ms": local["bound_ms"],
        "local_tflops": local["tflops"],
        "local_bound_share": local["bound_share"],
        "library_local_ms": library_local_ms, "sass": sass}


def to_host64(tree):
    """A float64 copy on the host of a DeepFM weight tree."""
    if isinstance(tree, dict):
        return {k: to_host64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_host64(v) for v in tree]
    return tree.detach().cpu().double()


def rel_err64(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against the f64 host ``want``."""
    return float((got.cpu().double() - want).norm() / want.norm())


def serve_twin(cfg, host, batch, n: int) -> dict:
    """The port's serve step on the CPU in float64 (weights ``host``) for
    the first ``n`` rows of ``batch``: gathered rows, FM term, logits."""
    from repro_torch.models.recsys import deepfm

    hb = {"sparse": batch["sparse"][:n].cpu(),
          "dense": batch["dense"][:n].cpu().double()}
    emb, _ = deepfm._embed(cfg, host, hb["sparse"])
    return {"emb": emb, "fm": deepfm.fm_term(emb),
            "logits": deepfm.forward(cfg, host, hb)}


def retrieval_twin(cfg, host, batch, n: int) -> dict:
    """The port's retrieval step on the CPU in float64 for the first ``n``
    candidates: the query's rows, the candidates' rows and the scores."""
    from repro_torch.models.recsys import deepfm

    hb = {"sparse": batch["sparse"].cpu(),
          "cand_ids": batch["cand_ids"][:n].cpu()}
    emb, _ = deepfm._embed(cfg, host, hb["sparse"])
    return {"emb": emb, "cand": host["table"][hb["cand_ids"]],
            "scores": deepfm.retrieval_step(cfg, host, hb)}


def hold_serve(cfg, params, batch, scores, twin: dict) -> dict:
    """A serve step's ``scores`` on the card against its f64 ``twin`` on
    the twin's rows: the gathered rows bitwise (f32 -> f64 is exact), the
    FM term, logits and scores at relative L2.  Returns the readings, with
    ``ok``."""
    from repro_torch.models.recsys import deepfm

    n = twin["logits"].shape[0]
    emb, _ = deepfm._embed(cfg, params, batch["sparse"])
    fm = deepfm.fm_term(emb)[:n]
    r = {"emb_bitwise": torch.equal(emb[:n].cpu().double(), twin["emb"]),
         "fm": rel_err64(fm, twin["fm"]),
         "logits": rel_err64(deepfm.forward(cfg, params, batch)[:n],
                             twin["logits"]),
         "scores": rel_err64(scores[:n], torch.sigmoid(twin["logits"])),
         "fm_abs_mean": float(twin["fm"].abs().mean()),
         "logits_abs_mean": float(twin["logits"].abs().mean())}
    r["ok"] = (r["emb_bitwise"] and r["fm"] <= FM_TOL
               and max(r["logits"], r["scores"]) <= RECSYS_TOL)
    return r


def hold_retrieval(cfg, params, batch, scores, twin: dict) -> dict:
    """A retrieval step's ``scores`` on the card against its f64 ``twin``
    on the twin's candidates: the query's rows and the candidates' rows
    bitwise, the scores at relative L2."""
    from repro_torch.models.recsys import deepfm

    n = twin["scores"].shape[0]
    emb, _ = deepfm._embed(cfg, params, batch["sparse"])
    cand = params["table"][batch["cand_ids"][:n]]
    r = {"emb_bitwise": (torch.equal(emb.cpu().double(), twin["emb"])
                         and torch.equal(cand.cpu().double(), twin["cand"])),
         "scores": rel_err64(scores[:n], twin["scores"]),
         "scores_abs_mean": float(twin["scores"].abs().mean())}
    r["ok"] = r["emb_bitwise"] and r["scores"] <= RECSYS_TOL
    return r


def recsys_phase(kernels, dev, profile: bool) -> dict:
    """DeepFM's serve and retrieval steps at the full configuration (module
    docstring, phase 9); returns the table and the serve_bulk batch for the
    EmbeddingBag phase."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models.recsys import deepfm

    spec = get_arch("deepfm")
    cfg = spec.config
    bundles = {name: build_bundle(spec, name) for name in RECSYS_CELLS}
    log(f"recsys: {cfg.name} ({spec.source}): {cfg.n_sparse} fields x "
        f"{cfg.vocab_per_field} rows x {cfg.embed_dim}, {cfg.n_dense} dense, "
        f"MLP {cfg.n_sparse * cfg.embed_dim + cfg.n_dense}-"
        f"{'-'.join(map(str, cfg.mlp_dims))}-1, not cut; random weights "
        f"(seed {SEED})")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = bundles["serve_p99"].init_params(gen)
    # At init the first-order weights are zero, and the 0.01-scale table
    # makes the FM term about a tenth of the logits (0.0065 beside 0.07 in
    # mean magnitude, H100): the hold draws the first-order weights (and
    # the bias) at the table's scale, so that the lookups of lin_table are
    # read, and holds the FM term on its own.
    for name in ("lin_table", "lin_dense", "bias"):
        params[name].normal_(0.0, 0.01, generator=gen)
    torch.cuda.synchronize()
    leaves = [params[k] for k in ("table", "lin_table", "lin_dense", "bias")]
    leaves += [t for layer in params["mlp"] for t in layer.values()]
    log(f"recsys: table {tuple(params['table'].shape)} "
        f"({nbytes(params['table']) / 1e9:.3f} GB), lin_table "
        f"{nbytes(params['lin_table']) / 1e6:.1f} MB, "
        f"{sum(t.numel() for t in leaves)} weights drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    host = to_host64(params)
    log(f"recsys: f64 host twin of the weights in "
        f"{time.perf_counter() - t0:.1f} s")

    bulk = None
    for name, bundle in bundles.items():
        batch = bundle.make_batch(SEED)
        n_items = (bundle.shape.n_candidates if bundle.step_kind == "retrieval"
                   else bundle.shape.batch)
        unit = "candidates" if bundle.step_kind == "retrieval" else "examples"
        reset_counts(kernels)
        run_ms, outs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(bundle.fn(params, batch))
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {n: k.launches for n, k in kernels.items()}
        check(not any(counts.values()),
              f"recsys {name}: a kernel launched {counts}; DeepFM looks its "
              f"fields up with a row gather")
        out = outs[-1]
        check(out.shape == (n_items,), f"recsys {name}: {tuple(out.shape)}")
        check(torch.equal(outs[1], out), f"recsys {name}: runs 2 and 3 differ")
        check(bool(torch.isfinite(out).all()),
              f"recsys {name}: scores not finite")
        if bundle.step_kind == "serve":
            check(bool(((out >= 0) & (out <= 1)).all()),
                  f"recsys {name}: a score outside [0, 1]")
        log(f"recsys {name}: first run {run_ms[0]:.3f} ms; runs 2, 3 "
            f"{[round(t, 4) for t in run_ms[1:]]} ms = "
            f"{[round(n_items / (t / 1e3), 1) for t in run_ms[1:]]} "
            f"{unit}/s; launches {counts}")
        if profile:
            profile_run(f"recsys {name}", lambda: bundle.fn(params, batch))

        # run 3's own scores against the f64 twin
        n = RECSYS_HOLD[name]
        t0 = time.perf_counter()
        if bundle.step_kind == "serve":
            hold, twin = hold_serve, serve_twin(cfg, host, batch, n)
        else:
            hold, twin = hold_retrieval, retrieval_twin(cfg, host, batch, n)
        twin_s = time.perf_counter() - t0
        r = hold(cfg, params, batch, out, twin)
        del outs, out
        log(f"recsys {name} against the f64 CPU twin ({n} rows, "
            f"{twin_s:.1f} s): {r}; limits rel L2 {RECSYS_TOL}, FM {FM_TOL}")
        check(r["ok"], f"recsys {name} differs from its f64 CPU twin")
        # planted fault on the card: every field offset one row down (field
        # 0's id 0 reads row -1, the table's last, as torch indexing wraps it)
        offsets = deepfm.field_offsets
        deepfm.field_offsets = lambda c, device=None: offsets(c, device) - 1
        try:
            bad = hold(cfg, params, batch, bundle.fn(params, batch), twin)
        finally:
            deepfm.field_offsets = offsets
        log(f"recsys {name} planted fault (field offsets - 1): {bad}")
        check(not bad["ok"], f"recsys {name}: the hold passes field offsets "
                             f"one row off")
        if bundle.step_kind == "serve":     # planted: a lower precision
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                bad = hold(cfg, params, batch, bundle.fn(params, batch), twin)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            log(f"recsys {name} planted fault (TF32 products): {bad}")
            check(not bad["ok"], f"recsys {name}: the hold passes TF32 "
                                 f"products")
        if name == "serve_bulk":
            bulk = batch
    del host
    return {"cfg": cfg, "table": params["table"], "bulk": bulk}


def sector_bytes(idx: torch.Tensor, table: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors the valid slots' rows span, each row
    counted once a slot, from the table's own address."""
    row = table.shape[1] * table.element_size()
    start = table.data_ptr() + idx[idx >= 0].long() * row
    return 32 * int(((start + row - 1) // 32 - start // 32 + 1).sum())


def bag_phase(rec: dict, kernels, dev) -> dict:
    """Kernel A5 through the lookup op on DeepFM's table (module docstring,
    phase 10); returns A5's row of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag.kernel import (
        _launch, embedding_bag_sum, embedding_bag_sum_plain)
    from repro_torch.kernels.embedding_bag.ref import bag_mean
    from repro_torch.models.recsys import deepfm

    cfg, table = rec["cfg"], rec["table"]

    def drive(what: str, calls: int, fn, route: str):
        """Reset the counts, run ``fn``, check that A5 and nothing else
        launched ``calls`` times, each on ``route``; returns fn's result
        and the counts."""
        reset_counts(kernels)
        out = fn()
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        want = dict.fromkeys(kernels, 0) | {"embedding_bag_sum": calls}
        check(counts == want, f"A5 {what}: launches {counts}, not {want}")
        on_route = getattr(embedding_bag_sum, f"launches_{route}")
        check(on_route == calls, f"A5 {what}: {on_route} of {calls} launches "
                                 f"on the {route} route")
        return out, counts

    def max_err(got, want) -> float:
        return float((got.float() - want.float()).abs().max())

    def other_route(idx, tab, want, what: str) -> float:
        """The route the shape does not take, launched on ``idx`` over
        ``tab`` (gather where it takes the rows), held bitwise to the
        plain version's ``want``; returns its max abs error."""
        out = torch.empty_like(want)
        other = "gather" if _launch(idx, tab, out).route == "loads" else \
            "loads"
        out.zero_()
        _launch(idx, tab, out, other)
        check(torch.equal(out, want), f"A5 {what}: the {other} route differs "
                                      f"from the plain version")
        return max_err(out, want)

    def timings(idx, what: str, tab=table) -> dict:
        """The wrapper, its index check, the launch alone by the shape's
        route and by each route on ``idx`` over ``tab`` (each route's
        output held bitwise to the plain version), beside the useful-byte
        and the sector bounds."""
        want = embedding_bag_sum_plain(idx, tab)
        out = torch.empty_like(want)
        valid = int((idx >= 0).sum())
        useful = valid * tab.shape[1] * tab.element_size()
        b_ms, b_by = bound(useful + nbytes(idx, out))
        sector_ms, _ = bound(sector_bytes(idx, tab) + nbytes(idx, out))
        route = _launch(idx, tab, out).route
        t = {"route": route,
             "ms": timed_ms(lambda: embedding_bag_sum(idx, tab), 20),
             "check_ms": timed_ms(lambda: int(idx.max()), 20),
             "kernel_ms": timed_ms(lambda: _launch(idx, tab, out), 20)}
        for r in ("gather", "loads"):
            out.zero_()
            t[f"{r}_kernel_ms"] = timed_ms(lambda: _launch(idx, tab, out, r),
                                           20)
            check(torch.equal(out, want), f"A5 {what}: the {r} route differs "
                                          f"from the plain version")
        t |= {"bound_ms": b_ms, "bound_by": b_by,
              "sector_bound_ms": sector_ms, "valid_rows": valid}
        log(f"A5 {what}: wrapper {t['ms']} ms, index check {t['check_ms']} "
            f"ms, launch alone {t['kernel_ms']} ms ({route} route; gather "
            f"{t['gather_kernel_ms']} ms, plain loads {t['loads_kernel_ms']} "
            f"ms, each bitwise); bound {b_ms} ms ({b_by}, {valid} valid "
            f"rows), sector bound {sector_ms} ms")
        return t

    # (a) the serve_bulk batch's flat ids as bags: the op's main path
    emb, bags = deepfm._embed(cfg, {"table": table}, rec["bulk"]["sparse"])
    b, l = bags.shape
    calls = 3
    outs, counts = drive("(a) serve_bulk bags", calls,
                         lambda: [bag_ops.embedding_bag(bags, table)
                                  for _ in range(calls)], "gather")
    got = outs[-1]
    check(torch.equal(outs[1], got), "A5 (a): calls 2 and 3 differ")
    del outs
    want = embedding_bag_sum_plain(bags, table)
    errs = [max_err(got, want), other_route(bags, table, want, "(a)")]
    check(torch.equal(got, want), "A5 (a) differs from its plain version")
    # against the serve path's emb.sum(1), summed in another order: two
    # f32 sums of L terms differ by at most 2 (L - 1) eps sum |x|
    eps = float(torch.finfo(torch.float32).eps)
    gap = (got - emb.sum(dim=1)).abs()
    tol = 2 * (l - 1) * eps * emb.abs().sum(dim=1)
    log(f"A5 (a) bags {tuple(bags.shape)} over {tuple(table.shape)}: "
        f"bitwise to the plain version by both routes; against emb.sum(1): "
        f"max abs {float(gap.max())}, max share of the order bound "
        f"{float((gap / tol.clamp_min(1e-30)).max())}")
    check(bool((gap <= tol).all()), "A5 (a) differs from emb.sum(1) by more "
                                    "than the summation-order bound")
    del emb, gap, tol

    # (b) the same bags cut to ragged lengths 0..L (about 1 in L + 1 empty)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lengths = torch.randint(0, l + 1, (b, 1), generator=gen, device=dev)
    slot = torch.arange(l, device=dev)[None, :]
    rag = torch.where(slot < lengths, bags, -1).to(torch.int32)
    (s_k, m_k), _ = drive("(b) ragged", 2, lambda: (
        bag_ops.embedding_bag(rag, table),
        bag_ops.embedding_bag(rag, table, mode="mean")), "gather")
    s_p = embedding_bag_sum_plain(rag, table)
    m_p = bag_mean(s_p, rag)
    empty = (lengths[:, 0] == 0)
    errs += [max_err(s_k, s_p), max_err(m_k, m_p),
             other_route(rag, table, s_p, "(b)")]
    check(torch.equal(s_k, s_p) and torch.equal(m_k, m_p),
          "A5 (b) differs from its plain version")
    check(not s_k[empty].any() and not m_k[empty].any(),
          "A5 (b): an all-padded bag is not zero")
    log(f"A5 (b) ragged: {int(empty.sum())} of {b} bags all padded "
        f"({100 * float(empty.float().mean()):.2f}%), "
        f"{int((rag >= 0).sum())} valid slots; sum and mean bitwise")
    del s_k, m_k, s_p, m_p

    # (c) bench_kernels' shape, f32 and bf16, and (d) bf16 with odd D: tables
    # the L2 holds, so the plain-load route (the gather held beside it)
    for what, dtype, d in (("(c)", torch.float32, 128),
                           ("(c)", torch.bfloat16, 128),
                           ("(d)", torch.bfloat16, 127)):
        t = torch.randn((10_000, d), generator=gen, device=dev).to(dtype)
        i = torch.randint(-1, 10_000, (256, 8), generator=gen, device=dev,
                          dtype=torch.int32)
        out, _ = drive(f"{what} {dtype}", 1, lambda: embedding_bag_sum(i, t),
                       "loads")
        plain = embedding_bag_sum_plain(i, t)
        errs.append(max_err(out, plain))
        check(torch.equal(out, plain),
              f"A5 {what} {dtype} differs from its plain version")
        if d % 2 == 0:
            errs.append(other_route(i, t, plain, f"{what} {dtype}"))
        log(f"A5 {what} {dtype} (256, 8) over (10000, {d}): plain loads "
            f"bitwise{', the gather too' if d % 2 == 0 else ''}")

    # timing on (a) and (b)
    geo = _launch(bags, table, torch.empty_like(got))
    log(f"A5 (a) geometry: {dataclasses.asdict(geo)}")
    t_a = timings(bags, "(a)")
    t_b = timings(rag, "(b) ragged")
    # two references on the same ids: one 32-byte sector a row, and the
    # table's first 100,000 rows, a 4 MB table the 50 MB L2 holds (the
    # plain-load route by the rule)
    sector_table = torch.randn((table.shape[0], 8), generator=gen,
                               device=dev)
    t_sector = timings(bags, "(a) over a (V, 8) f32 table", sector_table)
    del sector_table
    t_l2 = timings(torch.where(bags >= 0, bags % 100_000, bags),
                   "(a) ids mod 100,000 over the first 100,000 rows (a 4 MB "
                   "table)", table[:100_000])
    plain_ms = timed_ms(lambda: embedding_bag_sum_plain(bags, table), 3)
    # the one-call yardstick (timed here only; the port never calls it)
    idx64, weights = bags.clamp(min=0).long(), (bags >= 0).to(table.dtype)
    lib = lambda: F.embedding_bag(idx64, table, mode="sum",
                                  per_sample_weights=weights)
    lib_err = float((lib() - got).abs().max())
    library_ms = timed_ms(lib, 20)
    log(f"A5 (a): plain {plain_ms} ms, F.embedding_bag {library_ms} ms (max "
        f"abs err vs A5 {lib_err})")
    rest = lambda t: {k: v for k, v in t.items() if k != "bound_by"}
    return {
        "name": "embedding_bag_sum", "route": "cuda",
        "design": "persistent grid, indices and rows by cp.async into a "
                  "3-stage mbarrier ring, sum in slot order from shared "
                  "memory; plain loads for rows over 40 bytes and for 20- "
                  "to 40-byte rows of a table of at most 48 MiB",
        "source": "src/repro_torch/csrc/embedding_bag_kernels.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:28",
        "launches": counts["embedding_bag_sum"], "max_abs_err": max(errs),
        "ms": t_a["ms"], "plain_ms": plain_ms, "bound_ms": t_a["bound_ms"],
        "bound_by": t_a["bound_by"], "library_ms": library_ms,
        "shape": f"bags {tuple(bags.shape)} int32 (serve_bulk flat ids) over "
                 f"the table {tuple(table.shape)} f32",
        "check_ms": t_a["check_ms"], "kernel_ms": t_a["kernel_ms"],
        "sector_bound_ms": t_a["sector_bound_ms"],
        "gather_kernel_ms": t_a["gather_kernel_ms"],
        "loads_kernel_ms": t_a["loads_kernel_ms"],
        "geometry": dataclasses.asdict(geo), "ragged": rest(t_b),
        "one_sector_rows": rest(t_sector), "l2_table": rest(t_l2)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more run of each path")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import bfs_workload
    from repro_torch.core import BFSOptions, plan
    from repro_torch.core.frontier import INF, pack_bits
    from repro_torch.core.ref import validate_bfs
    from repro_torch.graphs import generate, shard_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmm import ops as spmm_ops
    from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                     bitpack_words_plain,
                                                     block_row_ptr,
                                                     bsr_expand_bits,
                                                     bsr_expand_bits_plain,
                                                     bsr_spmm)
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_sum
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.fold_update import fold_update, fold_update_plain

    # the plain A2 is an f32 bmm, DeepFM's MLP f32 matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"fold_update": fold_update, "bsr_spmm": bsr_spmm,
               "bitpack_words": bitpack_words,
               "bsr_expand_bits": bsr_expand_bits,
               "flash_attention": flash_attention,
               "embedding_bag_sum": embedding_bag_sum}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    build_log = lib.with_suffix(".log").read_text().strip()
    log(build_log)
    xptxas = ptxas_lines(build_log, "bsr_expand_bits_kernel")
    log(f"build: bsr_expand_bits_kernel (-Xptxas -v): {xptxas}; dynamic "
        f"shared memory {_build.library().bfs_expand_bits_smem()} bytes")
    check(bool(xptxas), "build: no ptxas report for bsr_expand_bits_kernel")
    sass_text = library_sass(lib)
    sass = {int(k): v for k, v in sass_counts(
        sass_text, r"flash_fwd_wgmmaILi(\d+)E", ("HGMMA", "UTMALDG")).items()}
    log(f"build: bf16 A4 SASS (cuobjdump -sass): {sass}")
    check(len(sass) == 4 and all(c["HGMMA"] and c["UTMALDG"]
                                 for c in sass.values()),
          "build: a bf16 A4 kernel has no HGMMA or no UTMALDG in its SASS")
    gather_ptxas = ptxas_reports(build_log, "bag_gather_kernel")
    for fn, line in gather_ptxas.items():
        log(f"build: A5 {fn} (-Xptxas -v): {line}")
    check(len(gather_ptxas) == 6 and all(
        "0 bytes spill stores, 0 bytes spill loads" in line
        for line in gather_ptxas.values()),
        "build: a bag_gather_kernel has no ptxas report or spills")
    gather_sass = sass_counts(sass_text, r"bag_gather_kernelI(\w+?)Li(\d+)E",
                              ("LDGSTS", "UBLKCP"))
    log(f"build: A5 bag_gather_kernel SASS (cuobjdump -sass; dtype/granule): "
        f"{gather_sass}")
    check(len(gather_sass) == 6 and all(c["LDGSTS"] + c["UBLKCP"]
                                        for c in gather_sass.values()),
          "build: a bag_gather_kernel has no asynchronous copy in its SASS")
    card = card_line()
    log(f"card: {card}")

    # --------------------------------------------------------------- path 1
    w1 = bfs_workload("rmat_1m")
    n1 = w1.n_vertices
    t0 = time.perf_counter()
    src1, dst1 = generate(w1.graph, n1, seed=SEED, **dict(w1.gen_kwargs))
    deg = np.bincount(src1, minlength=n1)
    roots1 = np.random.default_rng(SEED).choice(np.flatnonzero(deg > 0), S,
                                                replace=False)
    log(f"path 1: {w1.name} n={n1} directed edges={src1.size} "
        f"(generated in {time.perf_counter() - t0:.1f} s), S={S}")
    path1, g1_p4 = {}, None
    for label, p, opts in (("p4_default", 4, BFSOptions()),
                           ("p1_packed", 1, BFSOptions(wire_format="packed"))):
        g = shard_graph(src1, dst1, n1, p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = plan(g, opts, num_sources=S)
        eng = pl.compile()
        torch.cuda.synchronize()
        compile_ms = (time.perf_counter() - t0) * 1e3
        d = pl.describe()
        log(f"path 1 {label}: dense_exchange={d['dense_exchange']} "
            f"fused={d['use_fused_tail']} dense_level_bytes="
            f"{d['dense_level_bytes']}")
        host, run_ms, res, counts = drive(kernels, eng, roots1)
        check(counts["fold_update"] > 0,
              f"path 1 {label}: kernel A1 never launched")
        validate_bfs(src1, dst1, roots1, res.dist[:n1, :S])
        report_run(f"path 1 {label}", compile_ms, run_ms, res, counts)
        roofline_line(f"path 1 {label}", d, res.run_stats,
                      ["dense"] * res.run_stats.levels)
        if args.profile:
            profile_run(f"path 1 {label}", lambda: eng.run(roots1))
        path1[label] = (host, counts, d, res.run_stats)
        if p == 4:
            g1_p4 = g
        del eng, res
    check(np.array_equal(path1["p4_default"][0], path1["p1_packed"][0]),
          "path 1: p=4 and p=1 distances differ")
    scipy_check(src1, dst1, n1, roots1, path1["p4_default"][0], INF)
    log("path 1: validate_bfs on all columns, scipy on 4 columns, p=4 == p=1: ok")

    # --------------------------------------------------------------- path 3
    path3 = path3_phase(kernels, g1_p4, src1, dst1, roots1,
                        path1["p4_default"][0], dev, args.profile)
    log("path 3: validate_bfs on all columns, distances == path 1 "
        "p4_default, bsr_expand_bits once a level: ok")

    # --------------------------------------------------------------- path 2
    w2 = bfs_workload("small_world_100k")
    n2 = w2.n_vertices
    src2, dst2 = generate(w2.graph, n2, seed=SEED, **dict(w2.gen_kwargs))
    roots2 = np.random.default_rng(SEED).choice(n2, S, replace=False)
    g2 = shard_graph(src2, dst2, n2, 1)
    log(f"path 2: {w2.name} n={n2} directed edges={src2.size}, S={S}")
    reset_peak()
    t0 = time.perf_counter()
    pl2 = plan(g2, BFSOptions(use_kernel=True, wire_format="packed"),
               num_sources=S)
    eng2 = pl2.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    host2, run_ms, res2, counts2 = drive(kernels, eng2, roots2)
    check(counts2["fold_update"] > 0, "path 2: kernel A1 never launched")
    check(counts2["bsr_expand_bits"] == 3 * res2.run_stats.levels,
          f"path 2: bsr_expand_bits launched {counts2['bsr_expand_bits']} "
          f"times in 3 runs of {res2.run_stats.levels} levels")
    check(counts2["bsr_spmm"] == 0 and counts2["bitpack_words"] == 0,
          "path 2: the f32 A2 or A3 launched under use_kernel")
    validate_bfs(src2, dst2, roots2, res2.dist[:n2, :S])
    report_run("path 2 use_kernel", compile_ms, run_ms, res2, counts2)
    log(f"path 2: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the engine's "
        f"bit tiles {nbytes(eng2.kernel_arrays[0]) / 1e9:.3f} GB")
    if args.profile:
        profile_run("path 2 use_kernel", lambda: eng2.run(roots2))
    eng2b = plan(g2, BFSOptions(wire_format="packed"), num_sources=S).compile()
    host2b = eng2b.run(roots2).dist_host
    del eng2b
    check(np.array_equal(host2, host2b),
          "path 2: use_kernel distances differ from the plain expansion")
    scipy_check(src2, dst2, n2, roots2, host2, INF)
    log("path 2: validate_bfs on all columns, scipy on 4 columns, "
        "use_kernel == plain expansion: ok")
    log(f"path 2: span cost {json.dumps(span_cost(eng2, roots2))}")

    # --------------------------------------------------------------- path 4
    # (after path 2, so that path 2 runs where it ran before path 4 came)
    path4_phase(kernels, g1_p4, src1, roots1, path1["p4_default"][0],
                args.profile)
    log("path 4: auto (S = 64 and 1) and queue (S = 1) distances == path 1, "
        "auto mode_counts == the numpy replay, A1 once a dense level: ok")

    # --------------------------------------------------------------- path 5
    a1_path5, path5_a = path5_phase(kernels, g1_p4, src1, roots1,
                                    path1["p4_default"][0], args.profile)
    log("path 5: the 2 x 2 grid in dense (S = 64), auto (S = 64 and 1) and "
        "queue (S = 1): distances == path 1, auto mode_counts == the numpy "
        "replay, A1 once a dense level: ok")

    # --------------------------------------------------------------- path 6
    path6 = serving_phase(kernels, g1_p4, path1["p4_default"][0], roots1,
                          g2, host2, roots2, dev, card)
    log("path 6: 48 HTTP requests on four lanes bitwise the paths' "
        "distances, parents valid, 9 compiles for 9 plan keys, one block "
        "upload a group, estimates above the measured peaks, the LRU rung "
        "evicted and freed, the split:8 arm bitwise: ok")

    # --------------------------------------------------------------- path 7
    tmp7 = ROOT / "build" / "chip_smoke_path7"
    if tmp7.exists():
        import shutil
        shutil.rmtree(tmp7)
    tmp7.mkdir(parents=True)
    path7 = launchers_phase(kernels, g1_p4, src1, dst1, dev, tmp7)
    log("path 7: bfs_run (1-D dense with its phase split, 2-D auto) equal "
        "to the engines, A1 once a level, bfs_serve --http verified by "
        "bfs_client on three lanes and drained, the chaos soak's verdict "
        "with a storm served: ok")

    # --------------------------------------------------------------- path 8
    tmp8 = ROOT / "build" / "chip_smoke_path8"
    if tmp8.exists():
        import shutil
        shutil.rmtree(tmp8)
    tmp8.mkdir(parents=True)
    path8 = audit_phase(kernels, g1_p4, src1, dst1, (src2, dst2, n2), host2,
                        roots2, dev, tmp8)
    log("path 8: bfs_audit --all-variants clean with the host reads counted "
        "by sync debug mode, bfs_run --audit on rmat_1m bitwise path 1's "
        "engine with A1 once a level, bsr_expand_bits audited on "
        "small_world_100k bitwise path 2: ok")

    # --------------------------------------------------------------- path 9
    import shutil
    tmp9 = ROOT / "build" / "chip_smoke_path9"
    shutil.rmtree(tmp9, ignore_errors=True)
    tmp9.mkdir(parents=True)
    path9 = path9_phase(g1_p4, src1, dst1, roots1, path1["p4_default"][0],
                        path1, path5_a, (src2, dst2, n2), host2, roots2,
                        card, tmp9)
    shutil.rmtree(tmp9)            # the graphs' files, gigabytes of them
    del g1_p4
    log("path 9: DistMesh, nccl at world size 1 bitwise path 1 p=1; gloo, "
        "4 ranks on the card: dense, auto S = 1, the 2 x 2 grid and "
        "use_kernel bitwise paths 1, 4, 5 (a) and 2, A1 and "
        "bsr_expand_bits once a level on every rank, the census at ratio "
        "1.000 within the read budget, a wrong shard index rejected: ok")

    # -------------------------------------------------------------- prefill
    lay = prefill_phase(kernels, dev, args.profile)
    log("prefill: logits finite, runs 2 == 3, A4 12 a run, within "
        "tolerance of the plain attention: ok")

    # --------------------------------------------------------------- recsys
    rec = recsys_phase(kernels, dev, args.profile)
    log("recsys: serve and retrieval runs 2 == 3, held to the f64 CPU twin, "
        "the planted offset fault fails: ok")

    # -------------------------------------------------------- embedding bag
    bag_row = bag_phase(rec, kernels, dev)
    del rec
    log("embedding bag: A5 bitwise to its plain version on (a)-(d), "
        "by both routes: ok")

    # -------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # A1 at path 1's p=4 shapes: (4, W, S) words against (4, m, S) dist
    part = shard_graph(src1[:1], dst1[:1], n1, 4).part
    m, w = part.shard_size, (part.shard_size + 31) // 32
    words = torch.randint(-2 ** 31, 2 ** 31, (4, w, S), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    if m % 32:                             # pad bits of the last word zero
        words[:, -1] &= (1 << (m % 32)) - 1
    dist = torch.where(torch.rand((4, m, S), generator=gen, device=dev) < 0.5,
                       INF, torch.randint(0, 12, (4, m, S), generator=gen,
                                          device=dev)).to(torch.int32)
    got = fold_update(words, dist, 7)
    want = fold_update_plain(words, dist, 7)
    err1 = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(err1 == 0, f"A1 differs from its plain version by {err1}")
    b_ms, b_by = bound(nbytes(words, dist, *got))
    rows.append({
        "name": "fold_update", "route": "cuda",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/fold_update.py:57",
        "launches": path1["p4_default"][1]["fold_update"],
        "launches_path5": a1_path5,
        "launches_path6": path6["fold_update"],
        "launches_path7": sum(path7.values()),
        "launches_path8": path8["rmat"] + path8["sw"]["fold_update"],
        "launches_path9": path9["fold_update"],
        "max_abs_err": err1,
        "ms": timed_ms(lambda: fold_update(words, dist, 7), 50),
        "plain_ms": timed_ms(lambda: fold_update_plain(words, dist, 7),
                             10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"words {tuple(words.shape)}, dist {tuple(dist.shape)}"})
    del words, dist, got, want

    # bsr_expand_bits at path 2's shapes: the engine's own operands, on the
    # run's densest level and on a random 5% frontier
    xops_in = eng2.kernel_arrays
    xtiles, xmask, _, xrows, xcols = xops_in
    part2 = g2.part
    pad2 = -(-part2.n // 128) * 128        # p = 1: rows and columns alike
    layout = dict(n_valid=part2.n, n_blocks=1, rows_per_group=pad2)
    dense, depth, pairs = densest_frontier(host2, part2.n, INF, dev)
    fronts = {f"the densest level (depth {depth}, {pairs} pairs)": dense,
              "a random 5% frontier": (torch.rand(
                  (part2.n, S), generator=gen, device=dev) < 0.05).to(
                      torch.uint8)}
    xops, errx = {}, 0
    for what, mask in fronts.items():
        fw = frontier_words(mask, 1, pad2)
        got = bsr_expand_bits(*xops_in, fw, **layout)
        want = bsr_expand_bits_plain(*xops_in, fw, **layout)
        errx = max(errx, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want),
              f"bsr_expand_bits differs from its plain version on {what}")
        log(f"bsr_expand_bits on {what}: bitwise to its plain version")
        xops[what] = (mask, fw, got)
        del want
    dense_what = next(iter(xops))
    _, fw, got = xops[dense_what]
    xb = expand_bound(xtiles, xmask, xrows, xcols, fw, got)
    x_ms = timed_ms(lambda: bsr_expand_bits(*xops_in, fw, **layout), 20)
    x_plain_ms = timed_ms(lambda: bsr_expand_bits_plain(*xops_in, fw,
                                                        **layout), 2)
    log(f"bsr_expand_bits at path 2 on {dense_what}: {x_ms} ms; bound "
        f"{xb['bound_ms']} ms ({xb['bound_by']}; {xb['tiles_read']} of "
        f"{xb['tiles']} tiles read), every tile {xb['bound_all_tiles_ms']} "
        f"ms; plain {x_plain_ms} ms")
    xrow = {
        "name": "bsr_expand_bits", "route": "cuda",
        "design": "one-bit tiles, skip by column mask, cp.async + mbarrier "
                  "ring, atomicOr merge of split rows",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:38",
        "fuses": "src/repro/kernels/bsr_spmm/kernel.py:100",
        "launches": counts2["bsr_expand_bits"],
        "launches_path6": path6["bsr_expand_bits"],
        "launches_path8": path8["sw"]["bsr_expand_bits"],
        "launches_path9": path9["bsr_expand_bits"], "max_abs_err": errx,
        "ms": x_ms, "plain_ms": x_plain_ms, "bound_ms": xb["bound_ms"],
        "bound_by": xb["bound_by"], "library_ms": None,
        "bound_all_tiles_ms": xb["bound_all_tiles_ms"],
        "tiles_read": xb["tiles_read"], "tiles": xb["tiles"],
        "shape": f"path 2: {xtiles.shape[0]} bit tiles, frontier words "
                 f"{tuple(fw.shape)} ({dense_what})",
        "path3": path3}

    # the f32 A2 + A3 chain, driven through its entry point
    # ops.frontier_expand_packed on path 2's f32 tiles and both frontiers,
    # held bitwise to bsr_expand_bits
    blocks, brs, bcs, row_pad2, col_pad2 = g2.bsr_shards(device=dev)
    tiles, trows, tcols = blocks[0], brs[0], bcs[0]
    del blocks
    row_ptr = block_row_ptr(trows, tcols, row_pad2 // 128, col_pad2 // 128)
    reset_counts(kernels)
    for what, (mask, _, got) in xops.items():
        x = torch.zeros((col_pad2, S), dtype=torch.uint8, device=dev)
        x[:part2.n] = mask
        words = spmm_ops.frontier_expand_packed(
            tiles, trows, tcols, x, n_rows_pad=row_pad2, n_valid=part2.n,
            n_blocks=1, row_ptr=row_ptr)
        check(torch.equal(words, got), f"the f32 A2 + A3 chain differs from "
                                       f"bsr_expand_bits on {what}")
    torch.cuda.synchronize()
    counts_ops = {name: k.launches for name, k in kernels.items()}
    check(counts_ops == dict.fromkeys(kernels, 0) | {
        "bsr_spmm": len(xops), "bitpack_words": len(xops)},
        f"ops.frontier_expand_packed: launches {counts_ops}")
    log(f"ops.frontier_expand_packed (f32 A2 + A3) on both frontiers: "
        f"bitwise to bsr_expand_bits; launches {counts_ops}")
    del xops, fronts, dense

    # A2 at path 2's shapes: the f32 tiles against an (n_cols_pad, S) x
    n_rows_pad = row_pad2
    n_x = col_pad2                         # p = 1: one shard, square tiles
    x01 = (torch.rand((n_x, S), generator=gen, device=dev) < 0.05).float()
    xf = torch.rand((n_x, S), generator=gen, device=dev) * 2 - 1
    y01 = bsr_spmm(tiles, row_ptr, tcols, x01, n_rows_pad=n_rows_pad)
    check(torch.equal(y01, bsr_spmm_ref(tiles, trows, tcols, x01,
                                        n_rows_pad=n_rows_pad)),
          "A2 differs from bsr_spmm_ref on 0/1 operands")
    yf = bsr_spmm(tiles, row_ptr, tcols, xf, n_rows_pad=n_rows_pad)
    yf_ref = bsr_spmm_ref(tiles, trows, tcols, xf, n_rows_pad=n_rows_pad)
    err2 = float((yf - yf_ref).abs().max())
    # f32 sums in another order: each output sums at most `deg_max` terms
    # of magnitude <= 1, so the two orders differ by at most
    # 2 * deg_max * eps * deg_max
    deg_max = int(np.bincount(dst2, minlength=n2).max())
    tol2 = 2.0 * deg_max * deg_max * float(torch.finfo(torch.float32).eps)
    check(err2 <= tol2, f"A2 differs from bsr_spmm_ref by {err2} > {tol2}")
    flops = 2.0 * tiles.shape[0] * 128 * 128 * S
    b_ms, b_by = bound(nbytes(tiles, row_ptr, tcols, x01, y01), flops)
    # the one-call yardstick (timed here only; the port never calls it)
    bsr = torch.sparse_bsr_tensor(row_ptr, tcols, tiles,
                                  size=(n_rows_pad, n_x),
                                  check_invariants=False)
    check(torch.equal(bsr @ x01, y01), "torch BSR @ x disagrees on 0/1")
    library_ms = timed_ms(lambda: bsr @ x01, 5)
    rows.append({
        "name": "bsr_spmm", "route": "cuda",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:38",
        "path": "ops.frontier_expand_packed / ops.spmm (not the engine's)",
        "launches": counts_ops["bsr_spmm"], "max_abs_err": err2,
        "ms": timed_ms(lambda: bsr_spmm(tiles, row_ptr, tcols, x01,
                                               n_rows_pad=n_rows_pad), 5),
        "plain_ms": timed_ms(lambda: bsr_spmm_ref(
            tiles, trows, tcols, x01, n_rows_pad=n_rows_pad), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "shape": f"{tiles.shape[0]} tiles, x {tuple(x01.shape)}",
        "tolerance_f32": tol2})
    del xf, yf, yf_ref, bsr

    # A3 at path 2's shapes: pack the (n, S) expansion sums
    mask = y01[:n2] if n2 % 32 == 0 else y01[: n2 - n2 % 32]
    packed = bitpack_words(mask)
    want3 = bitpack_words_plain(mask)
    err3 = int((packed.long() - want3.long()).abs().max())
    check(err3 == 0 and torch.equal(want3, pack_bits(mask > 0)),
          f"A3 differs from its plain version by {err3}")
    b_ms, b_by = bound(nbytes(mask, packed))
    rows.append({
        "name": "bitpack_words", "route": "cuda",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:100",
        "path": "ops.frontier_expand_packed (not the engine's)",
        "launches": counts_ops["bitpack_words"], "max_abs_err": err3,
        "ms": timed_ms(lambda: bitpack_words(mask), 50),
        "plain_ms": timed_ms(lambda: bitpack_words_plain(mask), 10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"mask {tuple(mask.shape)}"})
    rows.append(xrow)
    del tiles, y01, x01

    rows.append(attention_rows(lay, dev, sass))
    rows.append(bag_row)

    log(f"peak device memory over the whole script {peak_gib():.2f} GiB")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
