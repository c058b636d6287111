#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (BFS on the 1-D and 2-D partitions in the
dense, queue and auto modes, LM prefill, DeepFM serving and the
EmbeddingBag op) on one card.

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
   column and against scipy's BFS on four columns, bitwise.
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
7. prefill — gemma3-12b at full width (d_model 3840, 16 q / 8 kv heads of
   256, d_ff 15360, vocab 262144, bf16) through ``build_bundle(...,
   "prefill_32k")``, cut to 12 layers (two 5 local + 1 global groups) and
   batch 2 x seq 8192, with random weights from a seeded generator on the
   card.  Three runs, each with kernel A4's bf16 route launched once per
   layer; runs 2
   and 3 bitwise equal; then the same prefill with the plain attention,
   held to a stated tolerance (the first layer's cache bitwise), which
   two planted faults (every local window one key off) must fail.
8. recsys — DeepFM at its full configuration (39 fields x 1,000,000 rows
   x 10, a 1.56 GB f32 table, MLP 403-400-400-400-1), not cut, through
   ``build_bundle(get_arch("deepfm"), ...)`` for ``serve_p99``,
   ``serve_bulk`` and ``retrieval_cand``, with random weights from a
   seeded generator on the card.  Three runs of each step (runs 2 and 3
   bitwise equal), held to the port's own steps on the CPU in float64
   from the same weights: gathered rows bitwise, the FM term, logits and
   scores at a stated relative L2 limit.  Two planted faults must fail
   that hold: every field offset one row off, and (serve) TF32 products.  DeepFM looks its fields up
   with a row gather, as the JAX package does, so no kernel launches.
9. embedding bag — the lookup op ``kernels.embedding_bag.ops.embedding_bag``
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
10. kernels — each kernel against its plain torch version on the card at
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
    launches in (a)."""
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
    log(f"{label}: launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run(label, lambda: eng.run(roots))
    a1_launches = counts["fold_update"]
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
    return a1_launches


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
    docstring, phase 4); returns A4's launches and what the kernel phase
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
    docstring, phase 5); returns the table and the serve_bulk batch for the
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
    phase 7); returns A5's row of the kernels line."""
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

    # --------------------------------------------------------------- path 4
    # (after path 2, so that path 2 runs where it ran before path 4 came)
    path4_phase(kernels, g1_p4, src1, roots1, path1["p4_default"][0],
                args.profile)
    log("path 4: auto (S = 64 and 1) and queue (S = 1) distances == path 1, "
        "auto mode_counts == the numpy replay, A1 once a dense level: ok")

    # --------------------------------------------------------------- path 5
    a1_path5 = path5_phase(kernels, g1_p4, src1, roots1,
                           path1["p4_default"][0], args.profile)
    del g1_p4
    log("path 5: the 2 x 2 grid in dense (S = 64), auto (S = 64 and 1) and "
        "queue (S = 1): distances == path 1, auto mode_counts == the numpy "
        "replay, A1 once a dense level: ok")

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
        "launches": counts2["bsr_expand_bits"], "max_abs_err": errx,
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
