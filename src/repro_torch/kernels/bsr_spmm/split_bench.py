"""A2's two builds timed against each other on the card: ``bsr_spmm_kernel``
without and with ``tf32``'s 2^-136 hi (the rule for values below 2^-136),
at ``chip_smoke.py`` path 2's size (142,452 tiles of 128 x 128 f32 over
782 block rows, x of 100,096 x 64).  These are the readings behind the
wrapper's choice of build by ``tf32.needs_least_hi(x)``.

    PYTHONPATH=src python -m repro_torch.kernels.bsr_spmm.split_bench \\
        [--iters N]

The tiles are random (1% ones, sorted by block row); x is uniform in
[-1, 1) with one 0, which takes the build without the rule, and the same
x with that 0 set to 2^-140, which takes the build with it.  Each build
is timed with CUDA events in the order without, with, with, without
(``--iters`` calls each, the wrapper's device flag included) and the two
readings of a build averaged; the flag alone is timed too.  The two
outputs must agree within 2^-100 (they differ only in products of the
planted value).  Prints the card's name and power limit, then one JSON
line; exits 1 without a card or if the builds disagree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.kernels.bsr_spmm.kernel import block_row_ptr, bsr_spmm
from repro_torch.kernels.tf32 import needs_least_hi

TILES, BLOCK_ROWS, D = 142_452, 782, 64


def timed_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("split_bench: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=False).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.sort(torch.randint(0, BLOCK_ROWS, (TILES,), generator=gen,
                                    device=dev)).values.to(torch.int32)
    cols = torch.randint(0, BLOCK_ROWS, (TILES,), generator=gen,
                         device=dev).to(torch.int32)
    tiles = torch.empty((TILES, 128, 128), device=dev)
    for i in range(0, TILES, 8192):            # 9.3 GB, in slices
        m = min(8192, TILES - i)
        tiles[i:i + m] = (torch.rand((m, 128, 128), generator=gen,
                                     device=dev) < 0.01).float()
    row_ptr = block_row_ptr(rows, cols, BLOCK_ROWS, BLOCK_ROWS)
    n = BLOCK_ROWS * 128
    x = torch.rand((n, D), generator=gen, device=dev) * 2 - 1
    x[int(cols[0]) * 128, 0] = 0.0                 # meets tile 0's column 0
    x_least = x.clone()
    x_least[int(cols[0]) * 128, 0] = 2.0 ** -140
    flags = (int(needs_least_hi(x)), int(needs_least_hi(x_least)))

    def run(xs):
        return bsr_spmm(tiles, row_ptr, cols, xs, n_rows_pad=n)

    diff = float((run(x) - run(x_least)).abs().max())
    ms = {"without": [], "with": []}
    for build, xs in (("without", x), ("with", x_least), ("with", x_least),
                      ("without", x)):
        ms[build].append(timed_ms(lambda: run(xs), args.iters))
    out = {"tiles": TILES, "x": [n, D], "flags": flags,
           "max_abs_diff": diff,
           "flag_ms": timed_ms(lambda: needs_least_hi(x), args.iters),
           **{f"{k}_ms": sum(v) / 2 for k, v in ms.items()},
           **{f"{k}_readings_ms": v for k, v in ms.items()}}
    print(json.dumps(out), flush=True)
    return 0 if flags == (0, 1) and diff <= 2.0 ** -100 else 1


if __name__ == "__main__":
    raise SystemExit(main())
