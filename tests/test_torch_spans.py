"""The port's span recorder (``core.spans``) on the CPU.

With the recorder off a span is the shared no-op; under a profiler or a
``recording()`` block the level loop's spans are recorded with their
parents and one run id a traversal; set-up spans are recorded always; the
bounded buffer drops and counts; a span maps onto an exported trace's
clock next to its ``record_function`` twin; no new profiler range opens
inside a phase range; and ``bsr_expand_bits`` counts the tiles it reads
by the kernel's rule.
"""

import json
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import BFSOptions, plan, spans
from repro_torch.core.frontier import pack_bits
from repro_torch.graphs import generate, shard_graph
from repro_torch.kernels.bsr_spmm.kernel import (block_row_ptr,
                                                 bsr_expand_bits,
                                                 expand_tiles_read)

torch.set_num_threads(1)

N = 600
LOOP = {spans.LEVEL, spans.EXPAND, spans.FOLD, spans.OWNER_UPDATE,
        spans.COLLECTIVE}


@pytest.fixture
def rec():
    """The process's recorder, emptied before and after the test."""
    spans.reset()
    yield spans.RECORDER
    spans.reset()


@pytest.fixture(scope="module")
def graph():
    src, dst = generate("erdos_renyi", N, seed=1)
    return src, dst


def engine(graph, p=2, s=4, **opts):
    return plan(shard_graph(*graph, N, p), BFSOptions(**opts),
                num_sources=s, device="cpu").compile()


def by_name(snap, name):
    return [i for i, sp in enumerate(snap.spans) if sp.name == name]


def test_the_off_path_is_the_shared_no_op(rec):
    for name in (spans.LEVEL, spans.EXPAND, spans.RUN, spans.HOST_READ):
        assert spans.span(name) is spans._IDLE
    assert not spans.on()
    spans.count("x", 3)
    with spans.span(spans.LEVEL):
        pass
    snap = spans.snapshot()
    assert snap.spans == [] and snap.dropped == 0
    assert not any(snap.counters.values())
    with spans.recording():
        assert spans.on() and spans.span(spans.LEVEL) is not spans._IDLE
    assert spans.span(spans.LEVEL) is spans._IDLE


@pytest.mark.parametrize("how", ["recording", "profiler"])
def test_a_run_records_its_spans_with_parents_and_one_run_id(rec, graph,
                                                             how):
    eng = engine(graph)
    spans.reset()
    on = (spans.recording() if how == "recording"
          else profile(activities=[ProfilerActivity.CPU]))
    with on:
        levels = [eng.run([0, 1, 2, 3]).run_stats.levels for _ in range(2)]
    snap = spans.snapshot()
    runs = by_name(snap, spans.RUN)
    assert len(runs) == 2 and levels[0] == levels[1] >= 2
    ids = [snap.spans[i].run for i in runs]
    assert ids[0] != ids[1] and all(i > 0 for i in ids)
    for k, i in enumerate(runs):
        assert snap.spans[i].parent == -1
        mine = [sp for sp in snap.spans if sp.run == ids[k]]
        # every span of a traversal carries its run id, and lies in it
        assert all(snap.spans[i].start <= sp.start and sp.end
                   <= snap.spans[i].end for sp in mine)
        names = [sp.name for sp in mine]
        assert names.count(spans.INIT) == 1
        assert names.count(spans.LEVEL) == levels[k]
        # a dense level reads the device once, directly under the level
        assert names.count(spans.HOST_READ) == levels[k]
        for sp in mine:
            parent = snap.spans[sp.parent].name if sp.parent >= 0 else None
            want = {spans.RUN: None, spans.INIT: spans.RUN,
                    spans.LEVEL: spans.RUN, spans.HOST_READ: spans.LEVEL,
                    spans.EXPAND: spans.LEVEL, spans.FOLD: spans.LEVEL,
                    spans.OWNER_UPDATE: spans.LEVEL}.get(sp.name, parent)
            assert parent == want, sp
            if sp.name == spans.COLLECTIVE:
                assert parent in (spans.LEVEL, spans.EXPAND, spans.FOLD)
    assert snap.dropped == 0
    assert all(sp.end is not None and sp.end >= sp.start
               for sp in snap.spans)


def test_runs_on_two_threads_keep_their_own_ids_and_parents(rec, graph):
    engines = [engine(graph), engine(graph, p=4)]
    errors = []

    def drive(eng):
        try:
            for _ in range(3):
                eng.run([0, 5])
        except Exception as exc:          # reported below
            errors.append(exc)

    with spans.recording():
        threads = [threading.Thread(target=drive, args=(e,))
                   for e in engines]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    snap = spans.snapshot()
    runs = by_name(snap, spans.RUN)
    assert len(runs) == 6 and len({snap.spans[i].run for i in runs}) == 6
    for sp in snap.spans:
        if sp.name == spans.LEVEL:
            run = snap.spans[sp.parent]
            assert run.name == spans.RUN and run.run == sp.run


def test_many_threads_lose_no_span_and_keep_their_parents():
    """More threads than cores, switching as often as the interpreter
    lets them: every span is kept once, under its own thread's run."""
    import os
    import sys

    own = spans.Recorder()
    n_threads, n_runs = 2 * (os.cpu_count() or 4), 200

    def work():
        for _ in range(n_runs):
            with own.open(spans.RUN):
                with own.open(spans.LEVEL):
                    pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with own.recording():
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    snap = own.snapshot()
    assert len(snap.spans) == 2 * n_threads * n_runs and snap.dropped == 0
    runs = [sp for sp in snap.spans if sp.name == spans.RUN]
    assert len({sp.run for sp in runs}) == n_threads * n_runs
    for sp in snap.spans:
        if sp.name == spans.LEVEL:
            parent = snap.spans[sp.parent]
            assert parent.name == spans.RUN and parent.run == sp.run
            assert parent.start <= sp.start <= sp.end <= parent.end


def test_set_up_spans_are_recorded_with_tracing_off(rec, graph):
    assert not spans.on()
    g = shard_graph(*graph, N, 4)
    plan(g, BFSOptions(use_kernel=True), num_sources=4,
         device="cpu").compile()
    snap = spans.snapshot()
    names = [sp.name for sp in snap.spans]
    assert names == [spans.GRAPH_SHARD, spans.SHARD_OUT_EDGES,
                     spans.SHARD_IN_EDGES, spans.ENGINE_COMPILE,
                     spans.TILE_BUILD]
    parents = [snap.spans[sp.parent].name if sp.parent >= 0 else None
               for sp in snap.spans]
    assert parents == [None, spans.GRAPH_SHARD, spans.GRAPH_SHARD, None,
                       spans.ENGINE_COMPILE]
    assert all(sp.run == -1 and sp.end > sp.start for sp in snap.spans)


def test_the_buffer_drops_past_its_bound_and_counts_what_it_drops():
    small = spans.Recorder(capacity=3)
    with small.recording():
        for _ in range(2):
            with small.open(spans.LEVEL):
                with small.open(spans.HOST_READ):
                    pass
        with small.open(spans.LEVEL):
            pass
    snap = small.snapshot()
    assert [sp.name for sp in snap.spans] == [spans.LEVEL, spans.HOST_READ,
                                              spans.LEVEL]
    assert snap.dropped == 2
    assert snap.spans[1].parent == 0 and snap.spans[2].parent == -1
    small.reset()
    assert small.snapshot() == ([], {}, 0)


def test_counters_count_only_while_on(rec):
    spans.count("a", 2)
    with spans.recording():
        spans.count("a", 2)
        spans.count("a")
    assert spans.snapshot().counters.get("a") == 3
    own = spans.Recorder()
    dev = own.device_counter("d", "cpu")
    assert dev is own.device_counter("d", "cpu")
    assert dev.dtype == torch.int64 and dev.shape == (1,)
    dev += 5
    own.count("a", 2)
    assert own.snapshot().counters == {"a": 2, "d": 5}
    own.reset()
    assert own.snapshot().counters == {"d": 0}


def test_spans_map_onto_the_trace_clock_beside_their_ranges(rec, graph,
                                                            tmp_path):
    eng = engine(graph)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run([0, 1, 2, 3])
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    raw = json.loads(path.read_text())
    snap = spans.snapshot(int(raw["baseTimeNanoseconds"]))
    twins = sorted((ev["ts"], ev["name"]) for ev in raw["traceEvents"]
                   if ev.get("cat") == "user_annotation"
                   and ev.get("name", "").startswith("bfs."))
    mine = sorted((sp.trace_us, sp.name) for sp in snap.spans
                  if sp.name.startswith("bfs."))
    assert len(twins) == len(mine) > 10
    for (ts, name), (us, got) in zip(twins, mine):
        assert name == got and abs(ts - us) < 500.0, (name, ts, us)


def ranges_inside_phases(trace: dict) -> list:
    """The ``bfs.*`` ranges of an exported trace, other than the five
    level-loop ranges, that open inside a phase range."""
    ranges = [ev for ev in trace["traceEvents"]
              if ev.get("cat") == "user_annotation"
              and ev.get("name", "").startswith("bfs.")]
    phases = [ev for ev in ranges if ev["name"] in spans.PHASES]
    return [ev["name"] for ev in ranges if ev["name"] not in LOOP
            for ph in phases if ph["tid"] == ev["tid"]
            and ph["ts"] <= ev["ts"] < ph["ts"] + ph["dur"]]


@pytest.mark.parametrize("mode,s", [("dense", 4), ("queue", 1)])
def test_no_new_profiler_range_opens_inside_a_phase(rec, graph, tmp_path,
                                                    mode, s):
    eng = engine(graph, s=s, mode=mode)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(list(range(s)))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    trace = json.loads(path.read_text())
    names = {ev["name"] for ev in trace["traceEvents"]
             if ev.get("cat") == "user_annotation"}
    assert {spans.RUN, spans.INIT, spans.HOST_READ, spans.LEVEL} <= names
    assert ranges_inside_phases(trace) == []
    # the recorder holds the reads that opened no range, under their phase
    snap = spans.snapshot()
    reads = [snap.spans[sp.parent].name for sp in snap.spans
             if sp.name == spans.HOST_READ]
    if mode == "queue":
        assert spans.EXPAND in reads and spans.LEVEL in reads
    else:
        assert set(reads) == {spans.LEVEL}


def test_the_plain_expansion_counts_the_tiles_the_kernel_reads():
    """Tile t is read where its column mask meets the OR over the sources
    of its block column's frontier words; the count adds up launch by
    launch and leaves the product alone."""
    gen = torch.Generator().manual_seed(5)
    cols = torch.tensor([0, 1, 1, 2, 0], dtype=torch.int32)
    rows = torch.tensor([0, 0, 1, 1, 2], dtype=torch.int32)
    dense = torch.rand((5, 128, 128), generator=gen) < 0.01  # [t, row, col]
    dense[4] = False                              # a pad tile
    dense[1, 7, 2] = True                         # column 2: in tile 1 only
    dense[2, :, 2] = False
    bits = pack_bits(dense).transpose(1, 2).contiguous()
    cmask = pack_bits(dense.any(dim=1)[..., None])[..., 0]
    rp = block_row_ptr(rows, cols, 3, 3)
    front = torch.zeros((3 * 128, 2), dtype=torch.uint8)
    front[128 + 2, 1] = 1                         # block column 1, column 2
    fw = pack_bits(front)
    by_hand = 1
    assert expand_tiles_read(cmask, cols, fw) == by_hand
    counter = torch.zeros(1, dtype=torch.int64)
    layout = dict(n_valid=384, n_blocks=1)
    got = bsr_expand_bits(bits, cmask, rp, rows, cols, fw,
                          tiles_read=counter, **layout)
    assert int(counter) == by_hand
    assert torch.equal(got, bsr_expand_bits(bits, cmask, rp, rows, cols,
                                            fw, **layout))
    every = pack_bits(torch.ones((3 * 128, 2), dtype=torch.uint8))
    bsr_expand_bits(bits, cmask, rp, rows, cols, every, tiles_read=counter,
                    **layout)
    assert int(counter) == by_hand + 4            # all but the pad tile
    with pytest.raises(ValueError, match="tiles_read"):
        bsr_expand_bits(bits, cmask, rp, rows, cols, fw,
                        tiles_read=counter.int(), **layout)
