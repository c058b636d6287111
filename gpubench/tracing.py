"""Reading a ``torch.profiler`` chrome trace of the traced batches.

A copy of the port's ``analysis/trace_model.py`` phase split, cut to what
the readers need: each device event (kernel, copy, set) is placed by its
launch, the CUDA runtime call that shares its ``correlation`` id, into the
innermost ``bfs.*`` profiler range around that launch (``core/spans.py``:
``bfs.expand``, ``bfs.collective``, ``bfs.fold``, ``bfs.owner_update``;
anything else is ``other``).  Beside the phases it gives what the copy
adds: the device's busy time (the union of device intervals) inside the
benchmark's own ``gpubench.window`` range, the device operations that took
most time, and the idle gaps named by what the host was doing then.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field

PHASES = ("expand", "collective", "fold", "owner_update", "other")
RANGE_PREFIX = "bfs."
WINDOW_RANGE = "gpubench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


def classify(name: str) -> str:
    """A profiler range name (``bfs.expand``) to its phase."""
    if name.startswith(RANGE_PREFIX):
        phase = name[len(RANGE_PREFIX):]
        if phase in PHASES[:-1]:
            return phase
    return "other"


def innermost(ranges, times) -> list:
    """For each time of ``times``, the value of the innermost of the
    properly nested ``(start, end, value)`` ``ranges`` holding it (None
    where none does), by one sweep."""
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


def union(intervals) -> list:
    """Merge ``(start, end)`` intervals into disjoint ones, in order."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def short_name(name: str) -> str:
    """A device operation's name without a kernel's argument list: the
    text before the ``(`` that closes its templates, cut to 160 letters."""
    depth = 0
    for i, ch in enumerate(name):
        depth += (ch == "<") - (ch == ">")
        if ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:160]


@dataclass
class DeviceOp:
    name: str
    phase: str
    dur: float                # seconds


@dataclass
class Trace:
    """The traced window: its device events and how long they kept the
    device busy.  Times are seconds."""

    ops: list = field(default_factory=list)
    window_s: float = 0.0
    busy_s: float = 0.0
    phase_s: dict = field(default_factory=dict)
    idle_by_host: dict = field(default_factory=dict)

    def kernel(self, fragment: str) -> tuple[int, float]:
        """Launches and summed seconds of the device ops whose name holds
        ``fragment``."""
        hits = [op.dur for op in self.ops if fragment in op.name]
        return len(hits), sum(hits)

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations that took most time, by name (a
        kernel's name without its argument list, at most 160 letters)."""
        total = defaultdict(float)
        for op in self.ops:
            total[short_name(op.name)] += op.dur
        return sorted(([n, s] for n, s in total.items()),
                      key=lambda x: -x[1])[:k]

    def top_idle(self, k: int = 10) -> list:
        return sorted(([n, s] for n, s in self.idle_by_host.items()),
                      key=lambda x: -x[1])[:k]


def load(path) -> Trace:
    """Read one chrome trace written by ``export_chrome_trace`` (see the
    module doc).  Without a ``gpubench.window`` range the trace is empty."""
    with open(path) as f:
        raw = json.load(f)
    spans = [ev for ev in raw.get("traceEvents", ()) if ev.get("ph") == "X"]
    win = [ev for ev in spans if ev.get("name") == WINDOW_RANGE]
    if not win:
        return Trace()
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0].get("dur", 0))
    main_tid = win[0].get("tid")

    phase_ranges, host = defaultdict(list), defaultdict(list)
    launch = {}
    for ev in spans:
        cat, name = ev.get("cat"), ev.get("name", "")
        start = float(ev["ts"])
        end = start + float(ev.get("dur", 0))
        if cat == "user_annotation" and name.startswith(RANGE_PREFIX):
            phase_ranges[ev.get("tid")].append((start, end, name))
        if cat in _HOST_CATS:
            host[ev.get("tid")].append((start, end, name))
        corr = (ev.get("args") or {}).get("correlation")
        if cat in _LAUNCH_CATS and corr is not None:
            launch[corr] = (ev.get("tid"), start)

    device = [ev for ev in spans if ev.get("cat") in _DEVICE_CATS
              and w0 <= float(ev["ts"]) < w1]
    anchors = [launch.get((ev.get("args") or {}).get("correlation"))
               for ev in device]
    phases = ["other"] * len(device)
    by_tid = defaultdict(list)
    for i, a in enumerate(anchors):
        if a is not None:
            by_tid[a[0]].append((a[1], i))
    for tid, points in by_tid.items():
        found = innermost(phase_ranges.get(tid, []), [t for t, _ in points])
        for (_, i), rng in zip(points, found):
            phases[i] = classify(rng or "")

    ops = [DeviceOp(ev.get("name", ""), phases[i],
                    float(ev.get("dur", 0)) * 1e-6)
           for i, ev in enumerate(device)]
    phase_s = dict.fromkeys(PHASES, 0.0)
    for op in ops:
        phase_s[op.phase] += op.dur
    busy = union((float(ev["ts"]), min(w1, float(ev["ts"])
                                      + float(ev.get("dur", 0))))
                 for ev in device)
    busy_s = sum(b - a for a, b in busy) * 1e-6

    # the device's idle gaps inside the window, each named by the
    # innermost host event on the window's thread at the gap's middle
    # (under the innermost bfs.* range there, where one is open)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = [(a + b) / 2 for a, b in gaps]
    what = innermost(host.get(main_tid, []), mids)
    where = innermost(phase_ranges.get(main_tid, []), mids)
    idle = defaultdict(float)
    for (a, b), op, rng in zip(gaps, what, where):
        name = op or "host (no event)"
        if rng is not None and rng != name:
            name = f"{rng} / {name}"
        idle[name] += (b - a) * 1e-6
    return Trace(ops=ops, window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                 phase_s=phase_s, idle_by_host=dict(idle))
