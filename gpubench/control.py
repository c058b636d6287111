"""The control and the planted faults that the check of ``correct`` has to
catch.  The benchmark's own runs never use this module.

* ``control``: the plain reference in the program's place, with one of
  the configuration's guarantees broken: it stops one level before its
  last, so the deepest vertices of a batch stay unreached (an early exit
  that a later change could be tempted by).
* faults planted in the program's engine, under the harness's window:
  ``unchanged`` (the level loop returns the state as the roots left it),
  ``half_batch`` (only the first half of the batch's roots are searched),
  ``no_exchange`` (each shard keeps only its own block of every
  collective, so candidates never cross shards) and ``altered`` (one
  distance written one too high where the engine produces it).

    python3 gpubench/control.py --workload <cell> --seeds 11 12 13 \\
        --seconds 5 [--fault control|unchanged|half_batch|no_exchange|altered|none]

runs the harness once a seed in one process (``none``: the program
unbroken) and prints each run's ``dist_mismatches`` reading, then one JSON
line of every reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

if __package__ in (None, ""):
    _root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(_root), str(_root / "src")]

from gpubench import harness  # noqa: E402
from gpubench.reference import bfs as reference  # noqa: E402


class ControlEngine:
    """The reference in the program's place, one level short."""

    def __init__(self, run, device):
        self.graph, self.device = run.graph, device

    def run(self, roots):
        import torch

        dist = reference.bfs(self.graph.src, self.graph.dst, self.graph.n,
                             roots, device=self.device)
        deepest = int(dist[dist < reference.INF].max())
        dist[dist == deepest] = reference.INF
        return SimpleNamespace(dist=torch.from_numpy(dist), dist_host=dist,
                               run_stats=SimpleNamespace(levels=deepest))


def control_engine(sharded, run, device):
    return ControlEngine(run, device)


def _unchanged(eng):
    eng._run_levels = lambda dist, frontier, max_levels: (
        1, 0.0, False, (1, 0, 0), 0, (0.0,))


def _half_batch(eng):
    inner = eng._run_levels

    def run_levels(dist, frontier, max_levels):
        frontier[:, frontier.shape[1] // 2:] = 0
        return inner(dist, frontier, max_levels)

    eng._run_levels = run_levels


def _altered(eng):
    inner = eng._run_levels

    def run_levels(dist, frontier, max_levels):
        out = inner(dist, frontier, max_levels)
        row = int((dist[:, 0] == 1).nonzero()[0, 0])
        dist[row, 0] = 2
        return out

    eng._run_levels = run_levels


def _no_exchange(eng):
    """Each shard of the flat mesh keeps only what it sent itself."""
    import torch

    mesh = eng.plan.mesh
    p = mesh.p
    eye = torch.eye(p, dtype=torch.bool, device=mesh.device)
    all_to_all, all_gather = mesh.all_to_all, mesh.all_gather

    def own(y):                      # (p receivers, p senders, ...)
        keep = eye.reshape(p, p, *([1] * (y.dim() - 2)))
        return torch.where(keep, y, torch.zeros_like(y))

    def a2a(x, axis):
        y = all_to_all(x, axis)
        return own(y.reshape(p, p, -1, *y.shape[2:])).reshape(y.shape)

    def gather(x, axis):
        return own(all_gather(x, axis))

    object.__setattr__(mesh, "all_to_all", a2a)
    object.__setattr__(mesh, "all_gather", gather)


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "altered": _altered, "no_exchange": _no_exchange}


def make_engine(fault: str):
    """The ``make_engine`` of the harness for ``fault``: ``control``, a
    name of ``FAULTS``, or ``none``."""
    if fault == "control":
        return control_engine
    if fault == "none":
        return harness.default_engine

    def make(sharded, run, device):
        eng = harness.default_engine(sharded, run, device)
        FAULTS[fault](eng)
        return eng

    return make


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--fault", default="control",
                    choices=("control", "none", *FAULTS))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    readings = []
    for seed in args.seeds:
        t0 = time.monotonic()
        out = harness.run_cell(root, args.workload, seed, args.seconds, False,
                               torch.device("cuda", 0),
                               make_engine=make_engine(args.fault),
                               log=lambda *a, **k: print(*a, **k, flush=True))
        value = out["checks"]["dist_mismatches"]["value"]
        readings.append({"seed": seed, "dist_mismatches": value,
                         "correct": out["correct"],
                         "attempted": out["attempted"],
                         "seconds": time.monotonic() - t0})
        print(f"{args.fault} {args.workload} seed {seed}: dist_mismatches "
              f"{value}, correct {out['correct']}, {out['attempted']} "
              f"batches", flush=True)
    print(json.dumps({"workload": args.workload, "fault": args.fault,
                      "readings": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
