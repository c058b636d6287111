"""The program's own spans and counters (``repro_torch.core.spans``), as
the per-layer metrics that rest on them read them.

The recorder is on while a profiler records, so a ``--trace 1`` run's
recorder holds the set-up spans (recorded always) and the traced batches:
one ``bfs.run`` span a batch, one ``bfs.level`` span a level.  A program
without the recorder gives nothing to read, and so does a run that put
nothing on a device, or whose recorder holds another count of traversals
or levels than the benchmark traced, or dropped spans.
"""

from __future__ import annotations

RUN, LEVEL, HOST_READ = "bfs.run", "bfs.level", "bfs.host_read"


def snapshot(run):
    """The recorder's snapshot, or None where the program has none or the
    traced batches put nothing on a device (a run on the CPU has no wait
    for a device and no kernel to count)."""
    if run.trace is None or not run.trace.ops:
        return None
    from repro_torch.core import spans

    take = getattr(spans, "snapshot", None)
    return take() if take is not None else None


def traced_levels(run):
    """``(snapshot, indices of the traced levels' bfs.level spans)``, or
    None where the recorder's traversals and levels are not the traced
    batches'."""
    if not run.traced:
        return None
    snap = snapshot(run)
    if snap is None or snap.dropped:
        return None
    runs = {s.run for s in snap.spans if s.name == RUN}
    levels = [i for i, s in enumerate(snap.spans)
              if s.name == LEVEL and s.run in runs and s.end is not None]
    if (len(runs) != len(run.traced)
            or len(levels) != sum(len(batch) for batch in run.traced)):
        return None
    return snap, levels


def level_split_ms(run):
    """``(wait, enqueue)``: ms a traced level in ``bfs.host_read`` spans
    directly under its ``bfs.level``, and in the rest of the level; None
    where ``traced_levels`` is."""
    got = traced_levels(run)
    if got is None:
        return None
    snap, levels = got
    under = set(levels)
    wait = sum(s.end - s.start for s in snap.spans
               if s.name == HOST_READ and s.parent in under)
    total = sum(snap.spans[i].end - snap.spans[i].start for i in levels)
    return wait / len(levels) / 1e6, (total - wait) / len(levels) / 1e6


def setup_seconds(run, name: str):
    """Seconds in the set-up spans named ``name``, or None where there are
    none."""
    snap = snapshot(run)
    if snap is None:
        return None
    found = [s.end - s.start for s in snap.spans
             if s.name == name and s.end is not None]
    return sum(found) / 1e9 if found else None
