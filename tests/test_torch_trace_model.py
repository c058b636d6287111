"""``analysis.trace_model`` on the port's profiler ranges.

``classify`` maps the ``bfs.*`` range names to the JAX module's
``PHASES``; a real CPU profile of a p = 4 dense run splits into one
segment a level, its phases sum to the kept events' total and ``main``
prints the JSON; a synthetic card trace (kernels on a stream timeline,
their launches inside the CPU ranges) is joined through the correlation
ids and the ``ac2g`` flow, and a kernel launched outside every range or
with no launch in the trace lands in ``other`` with no level (the latter
counted as unanchored); and the ranges are no-ops with no profiler.
"""

import json

import numpy as np
import pytest
import torch

from repro.analysis import trace_model as jtm
from repro_torch.analysis import trace_model as tm
from repro_torch.core import BFSOptions, plan, spans
from repro_torch.graphs import generate, shard_graph

torch.set_num_threads(1)


def test_phases_and_surface_are_jax():
    assert tm.PHASES == jtm.PHASES
    for name in ("capture", "find_trace_file", "load_events", "classify",
                 "phase_timings", "split_levels", "parse_trace",
                 "format_summary", "main"):
        assert callable(getattr(tm, name)), name


@pytest.mark.parametrize("name,phase", [
    ("bfs.expand", "expand"), ("bfs.collective", "collective"),
    ("bfs.fold", "fold"), ("bfs.owner_update", "owner_update"),
    ("bfs.level", "other"), ("bfs.other", "other"), ("aten::add", "other"),
    ("expand", "other"), (spans.EXPAND, "expand"),
    (spans.OWNER_UPDATE, "owner_update")])
def test_classify_reads_the_range_names(name, phase):
    assert tm.classify(name) == phase


@pytest.fixture(scope="module")
def cpu_profile(tmp_path_factory):
    src, dst = generate("erdos_renyi", 2000, seed=0)
    eng = plan(shard_graph(src, dst, 2000, 4), BFSOptions(mode="dense"),
               num_sources=4, device="cpu").compile()
    eng.run([0, 1, 2, 3])
    logdir = tmp_path_factory.mktemp("prof")
    with tm.capture(str(logdir)):
        res = eng.run([0, 1, 2, 3])
    return str(logdir), res.stats()


def test_a_cpu_profile_splits_into_one_segment_a_level(cpu_profile):
    logdir, stats = cpu_profile
    ops = tm.load_events(logdir)
    assert ops and all(op.source == "cpu" for op in ops)
    segs = tm.split_levels(ops)
    assert len(segs) == stats.levels == 5
    t = tm.parse_trace(logdir, n_levels=stats.levels)
    assert len(t.levels) == stats.levels and t.source == "cpu"
    assert sum(t.total_s.values()) == pytest.approx(
        sum(op.dur for op in ops), rel=1e-12)
    assert sum(t.counts.values()) == t.n_ops == len(ops)
    assert t.unanchored == 0 and t.unanchored_s == 0.0
    for lv in t.levels:
        assert lv["expand"] > 0 and lv["fold"] > 0 and lv["owner_update"] > 0
    assert t.counts["collective"] >= stats.levels
    summary = tm.format_summary(t)
    assert f"{stats.levels} level segment(s)" in summary
    assert summary.count("  level[") == stats.levels


def test_main_prints_the_json(cpu_profile, capsys):
    logdir, stats = cpu_profile
    trace = tm.find_trace_file(logdir)
    assert tm.main([trace, "--levels", str(stats.levels), "--json"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert len(out["levels"]) == stats.levels and out["source"] == "cpu"
    assert set(out["total_s"]) == set(tm.PHASES)
    assert tm.main([logdir]) == 0
    assert "level[4]" in capsys.readouterr().out


def test_outermost_cpu_ops_only(cpu_profile):
    """An op's inner ops are part of its time: none is kept twice."""
    ops = tm.load_events(cpu_profile[0])
    by_start = sorted(ops, key=lambda o: o.ts)
    ends = np.array([o.ts + o.dur for o in by_start])
    starts = np.array([o.ts for o in by_start])
    # on one thread the kept ops do not overlap
    assert (starts[1:] >= ends[:-1] - 1e-9).all()


def _synthetic_card_trace(path):
    """Two levels of ranges on thread 1; four kernels and a copy on a
    stream timeline (thread 7), launched from inside the ranges, one
    kernel launched after every range, and one whose launch is not in
    the trace."""
    x = lambda cat, name, ts, dur, tid=1, **args: {  # noqa: E731
        "ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid,
        "ts": ts, "dur": dur, "args": args}
    ev = [
        x("user_annotation", "bfs.level", 0, 100),
        x("user_annotation", "bfs.expand", 10, 30),
        x("user_annotation", "bfs.fold", 40, 30),
        x("user_annotation", "bfs.collective", 50, 10),
        x("user_annotation", "bfs.owner_update", 70, 20),
        x("user_annotation", "bfs.level", 100, 100),
        x("user_annotation", "bfs.expand", 110, 40),
        x("cpu_op", "aten::scatter_reduce_", 12, 5),
        x("cuda_runtime", "cudaLaunchKernel", 15, 2, correlation=11),
        x("cuda_runtime", "cudaLaunchKernel", 55, 2, correlation=12),
        x("cuda_runtime", "cudaMemcpyAsync", 75, 2, correlation=13),
        x("cuda_runtime", "cudaLaunchKernel", 95, 2, correlation=14),
        x("cuda_runtime", "cudaMemcpyAsync", 250, 2, correlation=16),
        x("kernel", "scatter_max", 500, 40, tid=7, correlation=11),
        x("kernel", "all_to_all_copy", 560, 5, tid=7, correlation=12),
        x("gpu_memcpy", "Memcpy DtoH", 570, 3, tid=7, correlation=13),
        x("kernel", "pad_mask", 580, 2, tid=7, correlation=14),
        x("kernel", "fold_update_kernel", 600, 7, tid=7, correlation=15),
        x("kernel", "orphan", 700, 1, tid=7, correlation=99),
        x("gpu_memcpy", "dist_readback", 800, 4, tid=7, correlation=16),
        # a launch seen only as the ac2g flow start
        {"ph": "s", "cat": "ac2g", "id": 15, "pid": 1, "tid": 1, "ts": 120,
         "name": "ac2g"},
        {"ph": "f", "cat": "ac2g", "id": 15, "pid": 1, "tid": 7, "ts": 600,
         "name": "ac2g", "bp": "e"},
    ]
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_card_events_join_their_launch_ranges(tmp_path):
    ops = tm.load_events(_synthetic_card_trace(tmp_path / "x.pt.trace.json"))
    got = {op.name: (op.phase, op.level, op.source, op.anchored)
           for op in ops}
    assert got == {
        "scatter_max": ("expand", 0, "device", True),
        "all_to_all_copy": ("collective", 0, "device", True),
        "Memcpy DtoH": ("owner_update", 0, "device", True),
        "pad_mask": ("other", 0, "device", True),
        "fold_update_kernel": ("expand", 1, "device", True),
        "orphan": ("other", None, "device", False),
        "dist_readback": ("other", None, "device", True),
    }
    t = tm.phase_timings(ops)
    assert t.total_s["expand"] == pytest.approx(47e-6)
    assert t.total_s["other"] == pytest.approx(7e-6)
    assert [sum(lv.values()) for lv in t.levels] == pytest.approx(
        [50e-6, 7e-6])
    assert t.levels[0]["other"] == pytest.approx(2e-6)
    assert t.levels[1]["other"] == 0.0
    assert sum(t.total_s.values()) == pytest.approx(62e-6)
    assert t.unanchored == 1 and t.unanchored_s == pytest.approx(1e-6)
    assert t.span_s == pytest.approx(304e-6)
    summary = tm.format_summary(t)
    assert "7 device events (1 with no launch found, 0.001ms)" in summary


def test_find_trace_file_and_a_missing_trace(tmp_path):
    with pytest.raises(FileNotFoundError, match="--profile"):
        tm.find_trace_file(str(tmp_path))
    (tmp_path / "sub").mkdir()
    path = _synthetic_card_trace(tmp_path / "sub" / "a.pt.trace.json")
    assert tm.find_trace_file(str(tmp_path)) == path


def test_ranges_record_only_under_a_profiler():
    assert spans.span(spans.EXPAND) is spans._IDLE
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.span(spans.EXPAND) is not spans._IDLE
    assert spans.span(spans.LEVEL) is spans._IDLE
