"""Parse ``torch.profiler`` traces into per-level BFS phase timings — the
port of ``repro.analysis.trace_model``, with its public surface and
``PHASES``.

``capture(logdir)`` writes a chrome trace (``<logdir>/*.pt.trace.json``)
of CPU activity, plus CUDA activity on a card.  ``load_events`` keeps the
device events on the card (kernels, copies and sets) and, on a CPU run,
the outermost ``cpu_op`` events of each thread (an op's inner ops are
part of its time).  Each kept event goes to the phase of the innermost
``bfs.*`` profiler range around it (``core.spans``) and to the level of
the ``bfs.level`` range around it.  A device event does not sit inside
the CPU ranges: it runs later, on a stream's timeline, so it is placed by
its launch, the CUDA runtime call that shares its ``correlation`` id
(the trace's ``ac2g`` flow ties the two as well).  A device event whose
launch is not in the trace goes to ``other`` with no level, and is
counted as ``unanchored``: its time says how much of the device time the
join failed to place.

Where JAX classifies XLA op names, the port classifies range names:

  * ``collective``   — ``bfs.collective``, every ``LocalMesh``
    collective (copies and index ops on one device, not NCCL kernels);
  * ``expand``       — ``bfs.expand``: the edge walk (the dense
    scatter-max, ``bsr_expand_bits``, the bottom-up word gather, a
    queue level's active edges, sieve and buckets);
  * ``fold``         — ``bfs.fold``: the candidate pack and the owner
    exchange's merge (and an unfused plan's unpack);
  * ``owner_update`` — ``bfs.owner_update``: the dist update.  A fused
    plan's kernel A1 unpacks, updates and re-packs in one pass and is
    reported here, so, as in JAX, fold + owner_update together is what
    fused and unfused plans compare;
  * ``other``        — the rest: a level's termination read (inside
    ``bfs.host_read``) and pad masking, and work outside any level (the
    sources' upload inside ``bfs.init``, the rest of ``bfs.run``, and
    set-up: ``graph.shard`` and ``engine.compile``).

No range but the phases opens inside a phase range (``core.spans``), so
the innermost ``bfs.*`` range around a launch names its phase.

Levels are the ``bfs.level`` ranges themselves, not clusters of
collectives.  The launchers' ``--profile`` prints ``format_summary``.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

PHASES = ("expand", "collective", "fold", "owner_update", "other")

RANGE_PREFIX = "bfs."
LEVEL_RANGE = "bfs.level"
_RANGE_CATS = ("user_annotation",)
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def classify(name: str) -> str:
    """Map one profiler range name (e.g. ``bfs.expand``) to a phase."""
    if name.startswith(RANGE_PREFIX):
        phase = name[len(RANGE_PREFIX):]
        if phase in PHASES[:-1]:
            return phase
    return "other"


@dataclass
class TraceOp:
    """One kept event: name, phase, start + duration (s), the index of
    its ``bfs.level`` range (None outside every level), its source
    (``"device"`` events or ``"cpu"`` ops) and whether its launch was
    found (a CPU op is its own launch)."""

    name: str
    phase: str
    ts: float
    dur: float
    level: Optional[int] = None
    source: str = "device"
    anchored: bool = True


@dataclass
class PhaseTimings:
    """Per-phase time totals, split per level."""

    total_s: dict                      # phase -> summed seconds
    counts: dict                       # phase -> event count
    levels: List[dict] = field(default_factory=list)  # per-level totals
    span_s: float = 0.0                # first event start to last end
    n_ops: int = 0
    source: str = "device"             # "device" events or "cpu" ops
    unanchored: int = 0                # device events with no launch found
    unanchored_s: float = 0.0          # ... and their summed seconds

    def to_dict(self) -> dict:
        return {"total_s": self.total_s, "counts": self.counts,
                "levels": self.levels, "span_s": self.span_s,
                "n_ops": self.n_ops, "source": self.source,
                "unanchored": self.unanchored,
                "unanchored_s": self.unanchored_s}


def find_trace_file(path: str) -> str:
    """Resolve a profiler log dir (or a direct file) to one chrome trace,
    the newest ``*.trace.json`` or ``*.trace.json.gz`` in it or one
    directory down."""
    if os.path.isfile(path):
        return path
    hits = [h for ext in ("*.trace.json", "*.trace.json.gz")
            for pat in (os.path.join(path, ext),
                        os.path.join(path, "*", ext))
            for h in glob.glob(pat)]
    if not hits:
        raise FileNotFoundError(
            f"no *.trace.json under {path!r} — was the run launched "
            "with --profile (analysis.trace_model.capture)?")
    return max(hits, key=os.path.getmtime)


def _innermost(ranges, times) -> list:
    """For each time of ``times`` (one thread), the value of the
    innermost of the properly nested ``(start, end, value)`` ``ranges``
    holding it (None where none does), by one sweep."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out = [None] * len(times)
    stack, k = [], 0
    for i in sorted(range(len(times)), key=times.__getitem__):
        t = times[i]
        while k < len(ranges) and ranges[k][0] <= t:
            while stack and stack[-1][1] < ranges[k][0]:
                stack.pop()
            stack.append(ranges[k])
            k += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        if stack:
            out[i] = stack[-1][2]
    return out


def load_events(path: str) -> List[TraceOp]:
    """Load one trace file into classified events (see the module doc)."""
    path = find_trace_file(path)
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    spans = [ev for ev in raw.get("traceEvents", ()) if ev.get("ph") == "X"]
    phase_ranges: Dict[object, list] = {}
    level_ranges: Dict[object, list] = {}
    for ev in spans:
        name = ev.get("name", "")
        if ev.get("cat") in _RANGE_CATS and name.startswith(RANGE_PREFIX):
            start = float(ev["ts"])
            end = start + float(ev.get("dur", 0))
            if name == LEVEL_RANGE:
                level_ranges.setdefault(ev.get("tid"), []).append(
                    (start, end))
            else:
                phase_ranges.setdefault(ev.get("tid"), []).append(
                    (start, end, classify(name)))

    device = [ev for ev in spans if ev.get("cat") in _DEVICE_CATS]
    # each kept event's anchor: where on the CPU (thread, time) it began
    anchors = []
    if device:
        launch = {}
        for ev in spans:
            corr = (ev.get("args") or {}).get("correlation")
            if ev.get("cat") in _LAUNCH_CATS and corr is not None:
                launch[corr] = (ev.get("tid"), float(ev["ts"]))
        for ev in raw.get("traceEvents", ()):   # the ac2g flow starts
            if (ev.get("ph") == "s" and ev.get("cat") == "ac2g"
                    and ev.get("id") not in launch):
                launch[ev.get("id")] = (ev.get("tid"), float(ev["ts"]))
        kept = device
        for ev in kept:
            anchors.append(launch.get((ev.get("args") or {}).get(
                "correlation")))
        source = "device"
    else:
        ops: Dict[object, list] = {}
        for ev in spans:
            if ev.get("cat") == "cpu_op":
                ops.setdefault(ev.get("tid"), []).append(ev)
        kept = []
        for tid, evs in ops.items():
            evs.sort(key=lambda e: (float(e["ts"]), -float(e.get("dur", 0))))
            end = float("-inf")
            for ev in evs:              # outermost ops only
                if float(ev["ts"]) >= end:
                    kept.append(ev)
                    anchors.append((tid, float(ev["ts"])))
                    end = float(ev["ts"]) + float(ev.get("dur", 0))
        source = "cpu"

    # levels are numbered in time order over every thread
    order = sorted((r[0], tid) for tid, rs in level_ranges.items()
                   for r in rs)
    index = {key: i for i, key in enumerate(order)}
    for tid, rs in level_ranges.items():
        level_ranges[tid] = [(a, b, index[(a, tid)]) for a, b in rs]
    by_tid: Dict[object, list] = {}
    for i, a in enumerate(anchors):
        if a is not None:
            by_tid.setdefault(a[0], []).append((a[1], i))
    phases = ["other"] * len(kept)
    levels: List[Optional[int]] = [None] * len(kept)
    for tid, points in by_tid.items():
        times = [t for t, _ in points]
        for (_, i), ph, lv in zip(
                points, _innermost(phase_ranges.get(tid, []), times),
                _innermost(level_ranges.get(tid, []), times)):
            phases[i] = ph or "other"
            levels[i] = lv
    out = [TraceOp(name=ev.get("name", ""), phase=phases[i],
                   ts=float(ev["ts"]) * 1e-6,
                   dur=float(ev.get("dur", 0)) * 1e-6, level=levels[i],
                   source=source, anchored=anchors[i] is not None)
           for i, ev in enumerate(kept)]
    out.sort(key=lambda o: o.ts)
    return out


def split_levels(ops: List[TraceOp],
                 n_levels: Optional[int] = None) -> List[List[TraceOp]]:
    """Group a run's events by their ``bfs.level`` range, in order (one
    segment a level range that holds an event).  ``n_levels`` is taken
    for JAX's signature: here the ranges mark the levels, so nothing is
    inferred from it."""
    del n_levels
    groups: Dict[int, List[TraceOp]] = {}
    for op in ops:
        if op.level is not None:
            groups.setdefault(op.level, []).append(op)
    return [groups[k] for k in sorted(groups)]


def phase_timings(ops: List[TraceOp],
                  n_levels: Optional[int] = None) -> PhaseTimings:
    """Aggregate classified events into per-phase (and per-level)
    seconds."""
    total = {ph: 0.0 for ph in PHASES}
    counts = {ph: 0 for ph in PHASES}
    unanchored = [op.dur for op in ops if not op.anchored]
    for op in ops:
        total[op.phase] += op.dur
        counts[op.phase] += 1
    levels = []
    for seg in split_levels(ops, n_levels):
        lv = {ph: 0.0 for ph in PHASES}
        for op in seg:
            lv[op.phase] += op.dur
        levels.append(lv)
    span = (max(op.ts + op.dur for op in ops) - min(op.ts for op in ops)
            if ops else 0.0)
    return PhaseTimings(total_s=total, counts=counts, levels=levels,
                        span_s=span, n_ops=len(ops),
                        source=ops[0].source if ops else "device",
                        unanchored=len(unanchored),
                        unanchored_s=sum(unanchored))


def parse_trace(path: str, n_levels: Optional[int] = None) -> PhaseTimings:
    """One-call helper: resolve, load, classify, aggregate."""
    return phase_timings(load_events(path), n_levels=n_levels)


@contextlib.contextmanager
def capture(logdir: str):
    """Profile the enclosed block into ``logdir`` (the ``--profile``
    flag): CPU activity, and CUDA activity when a card is present; the
    chrome trace lands where ``find_trace_file(logdir)`` picks it up."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f"bfs.{time.time_ns()}.pt.trace.json"))


def format_summary(t: PhaseTimings) -> str:
    """Render one PhaseTimings as the launchers' post-run report: the
    phase totals, then one row a level."""
    tot = sum(t.total_s.values()) or 1.0
    kind = "device" if t.source == "device" else "cpu_op"
    rows = [f"trace: {t.n_ops} {kind} events ({t.unanchored} with no "
            f"launch found, {t.unanchored_s * 1e3:.3f}ms) over "
            f"{t.span_s * 1e3:.1f}ms wall, {len(t.levels)} level segment(s)"]
    for ph in PHASES:
        s = t.total_s[ph]
        rows.append(f"  {ph:<13} {s * 1e3:9.3f}ms  {s / tot:6.1%}  "
                    f"({t.counts[ph]} ops)")
    for i, lv in enumerate(t.levels):
        lt = sum(lv.values()) or 1.0
        share = "  ".join(f"{ph}={lv[ph] / lt:.0%}" for ph in PHASES
                          if lv[ph] > 0)
        rows.append(f"  level[{i}] {lt * 1e3:8.3f}ms  {share}")
    return "\n".join(rows)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="summarize a torch.profiler chrome trace into BFS "
                    "phase timings (expand / collective / fold / "
                    "owner_update)")
    ap.add_argument("path", help="profiler logdir or *.trace.json file")
    ap.add_argument("--levels", type=int, default=None,
                    help="the run's level count (JAX's flag; the "
                         "bfs.level ranges mark the levels here)")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable timing dict")
    args = ap.parse_args(argv)
    t = parse_trace(args.path, n_levels=args.levels)
    if args.json:
        print(json.dumps(t.to_dict(), indent=2, sort_keys=True))
    else:
        print(format_summary(t))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
