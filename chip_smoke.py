#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of the dense 1-D BFS engine on one card.

    python3 chip_smoke.py            # full size, as the acceptance run
    python3 chip_smoke.py --profile  # also profile one run of each path

Phases (any failed check raises and the script exits non-zero):

1. build — compiles ``src/repro_torch/csrc/bfs_kernels.cu`` with nvcc for
   sm_90a into ``build/kernels/`` and prints the compiler's register
   report and the card's name and power limit.
2. path 1 — ``rmat_1m`` (Graph500 Kronecker, scale 20, edge factor 16)
   with the default dense expansion, S = 64 roots: once on a 4-shard
   ``LocalMesh`` with default options (packed wire, fused tail = kernel
   A1) and once on one shard with ``wire_format="packed"``.
3. path 2 — ``small_world_100k`` (Watts-Strogatz k = 16, beta = 0.1)
   with ``use_kernel=True`` (kernels A2, A3 and A1), one shard, packed
   wire, S = 64, against the same plan without ``use_kernel``.
   Every path resets the kernels' launch counts just before it runs and
   reads them just after; every kernel of the path must have launched.
   Distances are checked with ``validate_bfs`` (Graph500 rules) on every
   column and against scipy's BFS on four columns, bitwise.
4. kernels — each kernel against its plain torch version on the card at
   the shapes of the paths, then timed beside its bound (and, for A2,
   beside ``torch.sparse_bsr_tensor @ x``).

The last line is ``{"ok": true, "device": {...}}``; before it come one
``{"kernels": [...]}`` JSON line and the card's name and power limit.
"""

from __future__ import annotations

import argparse
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


def bound(nbytes: float, flops: float = 0.0):
    """Least time (ms) for the work on the card, and what bounds it."""
    t_mem, t_ops = nbytes / MEM_BW, flops / F32_FLOPS
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def drive(kernels, eng, roots, runs: int = 3):
    """Reset the launch counts, run the engine ``runs`` times and read the
    counts; returns (host dist of the last run, per-run ms of runs 2..,
    last result, counts)."""
    for k in kernels.values():
        k.launches = 0
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


def profile_run(name, eng, roots) -> None:
    """One more run under ``torch.profiler``: device time by op, and the
    share of the run's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(roots)
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device-side entries only: a host op's device time repeats its kernels'
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    log(f"{name} profile: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    log(events.table(sort_by="self_device_time_total", row_limit=12))


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
    from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                     bitpack_words_plain,
                                                     bsr_spmm)
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    from repro_torch.kernels.fold_update import fold_update, fold_update_plain

    torch.backends.cuda.matmul.allow_tf32 = False   # the plain A2 is f32 bmm
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"fold_update": fold_update, "bsr_spmm": bsr_spmm,
               "bitpack_words": bitpack_words}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    log(lib.with_suffix(".log").read_text().strip())
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
    path1 = {}
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
            profile_run(f"path 1 {label}", eng, roots1)
        path1[label] = (host, counts, d, res.run_stats)
        del eng, res
    check(np.array_equal(path1["p4_default"][0], path1["p1_packed"][0]),
          "path 1: p=4 and p=1 distances differ")
    scipy_check(src1, dst1, n1, roots1, path1["p4_default"][0], INF)
    log("path 1: validate_bfs on all columns, scipy on 4 columns, p=4 == p=1: ok")

    # --------------------------------------------------------------- path 2
    w2 = bfs_workload("small_world_100k")
    n2 = w2.n_vertices
    src2, dst2 = generate(w2.graph, n2, seed=SEED, **dict(w2.gen_kwargs))
    roots2 = np.random.default_rng(SEED).choice(n2, S, replace=False)
    g2 = shard_graph(src2, dst2, n2, 1)
    log(f"path 2: {w2.name} n={n2} directed edges={src2.size}, S={S}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pl2 = plan(g2, BFSOptions(use_kernel=True, wire_format="packed"),
               num_sources=S)
    eng2 = pl2.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    host2, run_ms, res2, counts2 = drive(kernels, eng2, roots2)
    for name in kernels:
        check(counts2[name] > 0, f"path 2: kernel {name} never launched")
    validate_bfs(src2, dst2, roots2, res2.dist[:n2, :S])
    report_run("path 2 use_kernel", compile_ms, run_ms, res2, counts2)
    if args.profile:
        profile_run("path 2 use_kernel", eng2, roots2)
    eng2b = plan(g2, BFSOptions(wire_format="packed"), num_sources=S).compile()
    host2b = eng2b.run(roots2).dist_host
    del eng2b
    check(np.array_equal(host2, host2b),
          "path 2: use_kernel distances differ from the plain expansion")
    scipy_check(src2, dst2, n2, roots2, host2, INF)
    log("path 2: validate_bfs on all columns, scipy on 4 columns, "
        "use_kernel == plain expansion: ok")

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
        "max_abs_err": err1,
        "ms": timed_ms(lambda: fold_update(words, dist, 7), 50),
        "plain_ms": timed_ms(lambda: fold_update_plain(words, dist, 7),
                             10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"words {tuple(words.shape)}, dist {tuple(dist.shape)}"})
    del words, dist, got, want

    # A2 at path 2's shapes: the engine's tiles against an (n_cols_pad, S) x
    tiles, trows, tcols, row_ptr = eng2.kernel_arrays
    n_rows_pad = (row_ptr.numel() - 1) * 128
    n_x = n_rows_pad                       # p = 1: one shard, square tiles
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
        "launches": counts2["bsr_spmm"], "max_abs_err": err2,
        "ms": timed_ms(lambda: bsr_spmm(tiles, row_ptr, tcols, x01,
                                               n_rows_pad=n_rows_pad), 5),
        "plain_ms": timed_ms(lambda: bsr_spmm_ref(
            tiles, trows, tcols, x01, n_rows_pad=n_rows_pad), 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": library_ms,
        "shape": f"{tiles.shape[0]} tiles, x {tuple(x01.shape)}",
        "tolerance_f32": tol2})
    del xf, yf, yf_ref

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
        "launches": counts2["bitpack_words"], "max_abs_err": err3,
        "ms": timed_ms(lambda: bitpack_words(mask), 50),
        "plain_ms": timed_ms(lambda: bitpack_words_plain(mask), 10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"mask {tuple(mask.shape)}"})

    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
