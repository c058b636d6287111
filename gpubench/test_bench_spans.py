"""CPU tests of the per-layer metrics that read the program's span
recorder (``repro_torch.core.spans``): the tile-route engine's own count of
the tiles ``bsr_expand_bits`` reads against ``yardstick.TileModel`` over
each level's frontier, and each new reader on a made-up snapshot, with its
None cases."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from gpubench import graph500, harness, yardstick

ROOT = Path(__file__).resolve().parents[1]
MS = 1_000_000                               # ns


def test_the_engines_tiles_read_is_the_tile_models_count():
    from repro_torch.core import BFSOptions, plan, spans
    from repro_torch.graphs.formats import shard_graph

    n, p, s = 1 << 9, 4, 8
    src, dst = graph500.rmat(9, edge_factor=8, seed=4)
    eng = plan(shard_graph(src, dst, n, p), BFSOptions(use_kernel=True),
               num_sources=s, device="cpu").compile()
    model = yardstick.TileModel(src, dst, n, p)
    rng = np.random.default_rng(2)
    batches = [rng.choice(np.flatnonzero(np.bincount(src, minlength=n)), s,
                          replace=False) for _ in range(3)]
    spans.reset()
    with spans.recording():
        levels = [eng.run(roots).run_stats.levels for roots in batches]
    got = spans.snapshot().counters
    spans.reset()
    want = sum(model.tiles_read(front) for roots in batches
               for front in harness._level_frontiers(eng, roots, n))
    k = eng.kernel_arrays[0].shape[0]
    assert got[spans.EXPAND_LAUNCHES] == sum(levels) > 3
    assert got[spans.TILES_HELD] == k * sum(levels)
    assert 0 < got[spans.TILES_READ] == want < got[spans.TILES_HELD]


def span(name, start_ms, end_ms, parent=-1, run=-1):
    return SimpleNamespace(name=name, start=start_ms * MS, end=end_ms * MS,
                           parent=parent, run=run)


def made_up():
    """Two traversals: the first of two levels (10 ms with a 7 ms read, 5
    ms with a 1 ms read), the second of one (4 ms, of it a 3 ms read and,
    inside an expand, a 1 ms read that is not the level's own); and the
    set-up spans before them."""
    spans = [
        span("graph.shard", 0, 900),
        span("graph.shard.in_edges", 100, 600, parent=0),
        span("engine.compile", 1000, 1800),
        span("engine.tile_build", 1100, 1700, parent=2),
        span("bfs.run", 2000, 2020, run=1),                 # 4
        span("bfs.init", 2000, 2001, parent=4, run=1),
        span("bfs.level", 2001, 2011, parent=4, run=1),     # 6
        span("bfs.host_read", 2004, 2011, parent=6, run=1),
        span("bfs.level", 2011, 2016, parent=4, run=1),     # 8
        span("bfs.host_read", 2015, 2016, parent=8, run=1),
        span("bfs.run", 2100, 2110, run=2),                 # 10
        span("bfs.level", 2101, 2105, parent=10, run=2),    # 11
        span("bfs.expand", 2101, 2102, parent=11, run=2),   # 12
        span("bfs.host_read", 2101, 2102, parent=12, run=2),
        span("bfs.host_read", 2102, 2105, parent=11, run=2),
    ]
    counters = {"bsr_expand_bits.launches": 3,
                "bsr_expand_bits.tiles_held": 400,
                "bsr_expand_bits.tiles_read": 30}
    return SimpleNamespace(spans=spans, counters=counters, dropped=0)


def made_up_run(levels=(2, 1), device_ops=1):
    return SimpleNamespace(traced=[[None] * k for k in levels],
                           trace=SimpleNamespace(ops=[None] * device_ops))


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder, made to hold ``made_up()``."""
    from repro_torch.core import spans

    snap = made_up()
    monkeypatch.setattr(spans, "snapshot", lambda base_ns=0: snap)
    return snap


def read(name, run):
    return harness.reader(ROOT, name)(run)


WANT = {"level_wait_ms": (7 + 1 + 3) / 3,
        "level_enqueue_ms": (3 + 4 + 1) / 3,
        "expand_tiles_read_share.bits": 7.5,
        "setup.tile_build_s": 0.6,
        "setup.shard_in_edges_s": 0.5}


@pytest.mark.parametrize("name", sorted(WANT) + ["level_wait_ms.bits",
                                                  "level_enqueue_ms.bits"])
def test_each_reader_on_a_made_up_snapshot(recorder, name):
    want = WANT[name.removesuffix(".bits")
                if name.startswith("level") else name]
    assert read(name, made_up_run()) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_is_read_from_a_run_that_put_nothing_on_a_device(recorder,
                                                                 name):
    assert read(name, made_up_run(device_ops=0)) is None
    assert read(name, SimpleNamespace(traced=[[None]], trace=None)) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_nothing_is_read_without_the_programs_recorder(monkeypatch, name):
    from repro_torch.core import spans

    monkeypatch.delattr(spans, "snapshot")
    assert read(name, made_up_run()) is None


@pytest.mark.parametrize("levels", [(2,), (2, 1, 1), (2, 2), (1, 1)])
@pytest.mark.parametrize("name", ["level_wait_ms", "level_enqueue_ms",
                                  "expand_tiles_read_share.bits"])
def test_nothing_is_read_where_traversals_or_levels_differ(recorder, name,
                                                           levels):
    assert read(name, made_up_run(levels)) is None


@pytest.mark.parametrize("name", ["level_wait_ms", "level_enqueue_ms",
                                  "expand_tiles_read_share.bits"])
def test_nothing_is_read_from_a_recorder_that_dropped_spans(recorder, name):
    recorder.dropped = 1
    assert read(name, made_up_run()) is None


@pytest.mark.parametrize("counters", [
    {"bsr_expand_bits.launches": 2},          # another count than levels
    {"bsr_expand_bits.tiles_held": 0},
    {"bsr_expand_bits.tiles_read": None}])    # the kernel counted nothing
def test_the_tile_share_needs_a_launch_a_level(recorder, counters):
    for key, value in counters.items():
        if value is None:
            del recorder.counters[key]
        else:
            recorder.counters[key] = value
    assert read("expand_tiles_read_share.bits", made_up_run()) is None


def test_set_up_spans_absent_read_nothing(recorder):
    for sp in recorder.spans:
        if sp.name.startswith(("graph.", "engine.")):
            sp.name = "host.other"
    for name in ("setup.tile_build_s", "setup.shard_in_edges_s"):
        assert read(name, made_up_run()) is None
    # the levels do not rest on the set-up spans
    assert read("level_wait_ms", made_up_run()) == pytest.approx(11 / 3)


def test_a_real_snapshot_reads_like_a_made_up_one():
    """The readers take the program's own ``Snapshot`` and ``Span``."""
    from repro_torch.core import spans

    rec = spans.Recorder()
    with rec.recording():
        for _ in range(2):
            with rec.open(spans.RUN):
                with rec.open(spans.LEVEL):
                    with rec.open(spans.HOST_READ):
                        torch.zeros(1).tolist()
    snap = rec.snapshot()
    run = made_up_run(levels=(1, 1))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(spans, "snapshot", lambda base_ns=0: snap)
        wait = read("level_wait_ms", run)
        enqueue = read("level_enqueue_ms", run)
    levels = [sp for sp in snap.spans if sp.name == spans.LEVEL]
    total = sum(sp.end - sp.start for sp in levels) / 2 / MS
    assert 0 < wait <= total and wait + enqueue == pytest.approx(total)
