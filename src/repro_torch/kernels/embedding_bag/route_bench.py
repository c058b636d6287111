"""A5's two routes timed against each other on the card, by table size and
row width: the gather (``bag_gather_kernel``) and the plain loads
(``bag_sum_kernel``), on 262,144 bags of 39 uniform ids each (DeepFM's
``serve_bulk`` bags).  These are the readings behind ``bag_geometry``'s
route rule.

    PYTHONPATH=src python -m repro_torch.kernels.embedding_bag.route_bench \\
        [--out FILE] [--iters N]

Each case holds the two routes bitwise to each other, then times the
launch alone with CUDA events in the order gather, loads, loads, gather
(``--iters`` launches each) and averages the two readings of a route.
Prints the card's name and power limit, then one JSON line a case (also
written to ``--out``); exits 1 without a card or if the routes disagree.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from repro_torch.kernels.embedding_bag.kernel import (_launch, bag_geometry,
                                                      embedding_bag_sum)

B, L = 262_144, 39
# (dtype, D): every granule, DeepFM's D = 10, and rows up to 2 KB
WIDTHS = [(torch.float32, d) for d in (1, 2, 4, 8, 10, 16, 32, 64, 128, 512)
          ] + [(torch.bfloat16, d) for d in (2, 8, 10, 16, 64, 128)]
TABLE_MIB = (8, 24, 40, 48, 56, 64, 96, 128, 512, 1536)


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


def case(dtype, d: int, mib: int, iters: int, gen) -> dict:
    """Both routes on one (V, D) table of about ``mib`` MiB."""
    dev = torch.device("cuda")
    row = d * torch.finfo(dtype).bits // 8
    v = max(1, mib * 2 ** 20 // row)
    table = torch.randn((v, d), generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, v, (B, L), generator=gen, device=dev,
                        dtype=torch.int32)
    outs = {r: torch.empty((B, d), dtype=dtype, device=dev)
            for r in ("gather", "loads")}
    for r, out in outs.items():
        _launch(idx, table, out, r)
    same = torch.equal(outs["gather"], outs["loads"])
    ms = dict.fromkeys(outs, 0.0)
    for r in ("gather", "loads", "loads", "gather"):
        ms[r] += timed_ms(lambda: _launch(idx, table, outs[r], r), iters) / 2
    ptr = table.data_ptr()
    rule = bag_geometry(B, L, v, d, table.element_size(),
                        align=ptr & -ptr).route
    return {"dtype": str(dtype).split(".")[-1], "d": d, "row_bytes": row,
            "v": v, "table_bytes": v * row, "gather_ms": ms["gather"],
            "loads_ms": ms["loads"], "gather_over_loads":
            ms["gather"] / ms["loads"], "faster": min(ms, key=ms.get),
            "rule": rule, "bitwise": same}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON lines here")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("route_bench needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows, ok = [], True
    for dtype, d in WIDTHS:
        for mib in TABLE_MIB:
            r = case(dtype, d, mib, args.iters, gen)
            ok &= r["bitwise"]
            rows.append(r)
            print(json.dumps(r), flush=True)
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rows)
    print(f"launches {embedding_bag_sum.launches}; routes bitwise: {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
