"""The port's audits (``repro_torch.analysis``: collective_audit, lint,
locks, report) against the JAX package's (``repro.analysis``), on the CPU.

Mirrors ``tests/test_analysis.py`` case by case with the port's objects:
the census of a recorded traversal (kinds, groups, level membership),
``_recv_bytes`` equal to JAX's, ``match_census``' control, unpriced and
tie-steal paths, HA004 on an engine that reallocates its dist buffer,
HA005 on a runner that reads twice in a dense level, HA001 on a census
that lost the level loop, an escalated 2-D queue level's third read
within its budget, the roofline's price of every shard, the lints on
known-bad sources and the real tree, the lock pass on the same bad
classes as JAX's (the same rule sets) and on the port's ``serve/``, and
the known-bad plan (the real ``alltoall_direct`` queue strategy under a
byte model 100x low: HA003 alone, the traversal still bitwise).  One
subprocess under ``repro.launch.host_devices(4)`` plans the JAX
package's 48 audit variants on ``er:512`` at p = 4: the port's
``roles_for_plan`` and ``describe()["roofline"]`` counts equal JAX's for
every one (no compile: both come from ``describe()``).  The port's
``bfs_audit --all-variants --devices 4 --device cpu`` exits 0.
"""

import contextlib
import io
import json
import math
import os
import runpy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import hlo_audit as jaudit
from repro.analysis.locks import analyze_lock_source as j_analyze_lock_source
from repro_torch.analysis import collective_audit as ca
from repro_torch.analysis import lint as tlint
from repro_torch.analysis.lint import host_read_sites, lint_sources, lint_tree
from repro_torch.analysis.locks import analyze_lock_source, analyze_serve
from repro_torch.analysis.report import RULES, AuditReport
from repro_torch.core import BFSOptions, LocalMesh, plan
from repro_torch.core import exchange as ex
from repro_torch.core.engine import BFSEngine
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph, shard_graph_2d
from repro_torch.graphs.formats import device_block_cache
from repro_torch.launch import bfs_audit, roofline

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
N = 1024


def _graph_and_mesh(partition="1d", n=N, p=4):
    src, dst = generate("erdos_renyi", n, seed=0)
    if partition == "2d":
        return shard_graph_2d(src, dst, n, 2, 2), LocalMesh.grid(2, 2, "cpu")
    return shard_graph(src, dst, n, p), LocalMesh.flat(p, "cpu")


def _engine(n=N, p=4, partition="1d", s=1, **opts):
    src, dst = generate("erdos_renyi", n, seed=0)
    g, mesh = _graph_and_mesh(partition, n, p)
    return plan(g, BFSOptions(**opts), mesh=mesh, num_sources=s,
                partition=partition).compile(), src, dst


# ---------------------------------------------------------------------------
# the census of a recorded traversal
# ---------------------------------------------------------------------------

def test_census_kinds_groups_and_level_membership():
    eng, _, _ = _engine(mode="auto")
    rec = ca.record(eng)
    assert set(rec.levels.values()) == {"dense", "queue", "bottom_up"}
    # the control plane: small all-reduces (the sources' statistics
    # before the first level, then each level's flags), no role
    control = [op for op in rec.ops if op.kind == "all-reduce"]
    assert control and all(op.out_bytes <= ca.CONTROL_CUTOFF
                           and op.dtype == "int64" and not op.hint
                           for op in control)
    assert {op.level_kind for op in control if not op.in_loop} == {
        "sources"}
    data = [op for op in rec.ops if op.kind != "all-reduce"]
    assert data and all(op.in_loop and op.level in rec.levels
                        and op.level_kind == rec.levels[op.level]
                        for op in data)
    assert {op.kind for op in data} == {"all-to-all", "all-gather"}
    assert {(op.group_size, op.n_groups) for op in rec.ops} == {(4, 1)}
    by_hint = {op.hint: op for op in data}
    assert set(by_hint) == {"dense", "queue", "sieve", "bottom_up"}
    # the dense and queue collectives come from the plan's strategies,
    # the sieve's summary gather from the queue level itself
    d = eng.plan.describe()
    assert by_hint["dense"].strategy == f"dense:{d['dense_exchange']}"
    assert by_hint["queue"].strategy == f"queue:{d['queue_exchange']}"
    assert by_hint["sieve"].source.startswith("bfs.py:")
    assert by_hint["dense"].source.startswith("exchange.py:")
    for op in rec.ops:
        assert op.out_bytes == math.prod(op.out_shape) * {
            "int64": 8, "int32": 4, "uint8": 1}[op.dtype]
        assert op.recv_bytes == ca._recv_bytes(op.kind, op.out_bytes, 4)
    # every level reads the device, the sources' statistics once before
    assert {r.level for r in rec.reads} == {0} | set(rec.levels)
    assert [r.level_kind for r in rec.reads].count("sources") == 1


def test_census_of_a_grid_names_its_phases_and_axes():
    eng, _, _ = _engine(partition="2d", mode="auto")
    ops = [op for op in ca.census(eng) if op.kind != "all-reduce"]
    groups = {op.hint: op.group_size for op in ops}
    assert groups == {"expand": 2, "fold": 2, "expand_sparse": 2,
                      "fold_sparse": 2, "sieve": 4, "bottom_up": 4}
    assert {op.axis for op in ops if op.hint == "fold"} == {"rows"}
    assert {op.axis for op in ops if op.hint == "expand"} == {"cols"}


@pytest.mark.parametrize("kind", ["all-gather", "all-to-all",
                                  "reduce-scatter", "all-reduce",
                                  "collective-permute"])
@pytest.mark.parametrize("out_bytes,g", [(800, 4), (100, 4), (4096, 2),
                                         (800, 1), (96, 8)])
def test_recv_bytes_equal_jax(kind, out_bytes, g):
    assert ca._recv_bytes(kind, out_bytes, g) == \
        jaudit._recv_bytes(kind, out_bytes, g)


def test_recv_bytes_conversions():
    assert ca._recv_bytes("all-gather", 800, 4) == pytest.approx(600)
    assert ca._recv_bytes("all-to-all", 800, 4) == pytest.approx(600)
    assert ca._recv_bytes("reduce-scatter", 100, 4) == pytest.approx(300)
    assert ca._recv_bytes("all-reduce", 100, 4) == pytest.approx(150)
    assert ca._recv_bytes("all-gather", 800, 1) == 0.0


def _op(kind, out, g, hint="", level=1):
    return ca.CollectiveOp(kind=kind, out_bytes=out,
                           recv_bytes=ca._recv_bytes(kind, out, g),
                           group_size=g, n_groups=1, in_loop=True,
                           source="s:1", level=level, hint=hint)


def test_match_census_control_unpriced_and_tie_steal():
    # small all-reduce -> control plane, never priced
    rep = AuditReport("t")
    ops = [_op("all-reduce", 4, 4)]
    ca.match_census(ops, [], rep)
    assert ops[0].role == "control" and rep.ok()

    # data-sized op with no candidate role -> HA002
    rep = AuditReport("t")
    ops = [_op("all-to-all", 4096, 4)]
    ca.match_census(ops, [], rep)
    assert "HA002" in rep.rules() and not rep.ok()

    # exact-size tie: two identical gathers, two roles with equal models;
    # the steal pass must give each required role one op
    rep = AuditReport("t")
    ops = [_op("all-gather", 512, 4), _op("all-gather", 512, 4)]
    roles = [ca.Role("sieve", ("all-gather",), 384.0, 4, True),
             ca.Role("bottom_up", ("all-gather",), 384.0, 4, True)]
    assigned = ca.match_census(ops, roles, rep)
    assert rep.ok(), [str(v) for v in rep.violations]
    assert len(assigned["sieve"]) == 1 and len(assigned["bottom_up"]) == 1


def test_match_census_named_roles_per_level_sums_and_info():
    roles = [ca.Role("dense", ("all-to-all",), 600.0, 4, True),
             ca.Role("bottom_up", ("all-gather",), 600.0, 4, True,
                     per_op=False),
             ca.Role("queue", ("all-to-all",), 60.0, 4, True)]
    # a named op goes to its role even where another model is nearer
    rep = AuditReport("t")
    ops = [_op("all-to-all", 80, 4, hint="queue"),
           _op("all-gather", 400, 4, hint="bottom_up", level=2),
           _op("all-gather", 400, 4, hint="bottom_up", level=2)]
    assigned = ca.match_census(ops, roles, rep, reached={"bottom_up"})
    assert [op.role for op in ops] == ["queue", "bottom_up", "bottom_up"]
    # level 2's two gathers sum to the per-level model
    assert not {"HA003", "HA002"} & rep.rules()
    # dense never ran: an info row, not a failure
    info = [v for v in rep.violations if v.rule == "HA001"]
    assert len(info) == 1 and info[0].severity == "info" and rep.ok()
    assert len(assigned["bottom_up"]) == 2
    # the same gap in a traversal that ran dense levels fails
    rep = AuditReport("t")
    ca.match_census([_op("all-to-all", 80, 4, hint="queue")], roles, rep,
                    reached={"dense", "queue_sparse"})
    assert "HA001" in rep.rules()
    # a named op whose role moves no bytes is unpriced
    rep = AuditReport("t")
    ca.match_census([_op("all-to-all", 80, 4, hint="fold")],
                    [ca.Role("fold", ("all-to-all",), 0.0, 4, False)], rep)
    assert rep.rules() == {"HA002"}


def test_match_census_group_size_mismatch_is_ha007():
    rep = AuditReport("t")
    ca.match_census([_op("all-to-all", 800, 2, hint="dense")],
                    [ca.Role("dense", ("all-to-all",), 400.0, 4, True)], rep)
    assert rep.rules() == {"HA007"}


# ---------------------------------------------------------------------------
# the auditor end-to-end on real engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [1, 4])
def test_audit_engine_clean_and_report_round_trips(p):
    eng, _, _ = _engine(p=p, mode="auto", wire_format="auto")
    rep = ca.audit_engine(eng, run_check=True)
    assert rep.ok(), [str(v) for v in rep.violations]
    assert rep.info["trace_count"] == eng.compile_traces
    assert rep.name.startswith("census:1d:auto:")
    assert rep.info["donation"] == {"dist_reused": True}
    d = rep.to_dict()
    assert d["ok"] and d["name"] == rep.name
    assert {v["rule"] for v in d["violations"]} <= set(RULES)
    json.loads(rep.to_json())
    if p == 1:              # every collective of one shard is degenerate
        assert {op["role"] for op in rep.info["census"]
                if op["kind"] != "all-reduce"} == {"degenerate"}
    else:
        assert set(rep.info["ratios"]) == {"dense", "queue", "sieve",
                                           "bottom_up"}
        assert all(r["min"] == r["max"] == 1.0
                   for r in rep.info["ratios"].values())


def test_recording_mesh_shares_the_engine_blocks():
    eng, _, _ = _engine(mode="auto")
    mesh = eng.plan.mesh
    rec = ca.RecordingMesh.like(mesh, eng.plan)
    assert rec == mesh and mesh == rec and hash(rec) == hash(mesh)
    assert rec != LocalMesh.flat(2, "cpu")
    blocks = device_block_cache(eng.plan.graph)
    before = {k: id(v) for k, v in blocks.map.items()}
    ca.record(eng)
    assert {k: id(v) for k, v in blocks.map.items()} == before


def test_recorded_traversal_is_the_engine_traversal():
    eng, src, dst = _engine(mode="dense", wire_format="packed", s=3)
    got = []
    rep = ca.audit_engine(eng, sources=[0, 5, 9],
                          on_result=lambda r: got.append(r.dist_host))
    assert rep.ok(), [str(v) for v in rep.violations]
    np.testing.assert_array_equal(got[0], bfs_reference(src, dst, N,
                                                        [0, 5, 9]))
    np.testing.assert_array_equal(got[0], eng.run([0, 5, 9]).dist_host)


def test_donation_check_fails_on_an_engine_that_reallocates():
    class Reallocating(BFSEngine):
        def run_async(self, sources):
            self._dist = torch.empty_like(self._dist)
            return super().run_async(sources)

    eng, _, _ = _engine(mode="dense")
    rep = AuditReport("t")
    ca.donation_check(eng, rep)
    assert rep.ok() and rep.info["donation"]["dist_reused"]
    bad = Reallocating(eng.plan)
    rep = ca.audit_engine(bad)
    assert rep.rules() == {"HA004"}


def test_host_reads_within_budget_at_the_listed_sites():
    eng, _, _ = _engine(mode="auto")
    rec = ca.record(eng)
    sites = host_read_sites()
    assert {(r.file, r.line) for r in rec.reads} <= sites
    rep = AuditReport("t")
    ca.host_read_check(rec, rep)
    assert rep.ok(), [str(v) for v in rep.violations]
    hr = rep.info["host_reads"]
    assert hr["counted_by"] == "host_read"
    assert hr["max_per_level"] == {"sources": 1, "queue": 2, "dense": 1,
                                   "bottom_up": 1}
    # a read the lint does not list fails the same check
    rep = AuditReport("t")
    ca.host_read_check(rec, rep, sites=set())
    assert rep.rules() == {"HA005"}


def test_host_read_check_fails_on_a_runner_reading_twice_in_a_dense_level(
        monkeypatch):
    dense = ex.get_exchange("dense", "alltoall_direct")

    def reads_twice(cand, mesh, axis):
        mesh.host_read(cand.sum())
        return dense.impl(cand, mesh, axis)

    monkeypatch.setitem(ex._REGISTRY, ("dense", "alltoall_reads"),
                        ex.ExchangeStrategy("alltoall_reads", "dense",
                                            reads_twice, dense.bytes_model))
    eng, _, _ = _engine(mode="dense", wire_format="bytes",
                        dense_exchange="alltoall_reads")
    rep = ca.audit_engine(eng)
    assert rep.rules() == {"HA005"}
    assert any("read the device 2 times (budget 1)" in v.message
               for v in rep.violations)


def test_census_table_renders_loop_rows():
    eng, _, _ = _engine(mode="dense")
    rep = ca.audit_engine(eng)
    lines = ca.census_table(rep).splitlines()
    assert lines[0].startswith("role")
    assert len(lines) == 2 and lines[1].startswith("dense")


@pytest.mark.parametrize("lost", ["levels", "collectives"])
def test_a_census_that_saw_no_level_fails(monkeypatch, lost):
    """A recording that lost the level loop (no level announced, or no
    collective filed inside one at p = 4) fails HA001 rather than passing
    over an empty census."""
    if lost == "levels":
        monkeypatch.setattr(ca.RecordingMesh, "enter_level",
                            lambda self, level, kind: None)
    else:
        real = ca.RecordingMesh._record

        def outside(self, kind, x, y, axis):
            real(self, kind, x, y, axis)
            self.ops[-1].in_loop = False

        monkeypatch.setattr(ca.RecordingMesh, "_record", outside)
    eng, _, _ = _engine(mode="dense")
    rep = ca.audit_engine(eng)
    assert not rep.ok() and "HA001" in rep.rules()
    assert any(v.rule == "HA001" and v.severity == "error"
               and "census saw" in v.message for v in rep.violations)


def test_an_escalated_grid_level_may_recount_the_sieve_hits(monkeypatch):
    """A 2-D queue level whose truncated compressed frontier decodes past
    the width its statistics bound escalates and recounts the sieve's
    hits: a third read, at a listed site, within the escalated budget.
    Forced as ``tests/test_torch_grid_engine.py`` forces it: a width of 1
    on the levels whose frontier overflows a chunk's ``queue_cap``."""
    from repro_torch.core import bfs

    real = bfs._level_runner

    def narrow(part, s, mode, e_total, opts, mesh, dense, queue, bottom_up,
               stats, fused, vwords):
        def narrowed(f):
            f_verts, f_edges, width = stats(f)
            if int((f[..., 0] > 0).sum(1).max()) > opts.queue_cap:
                width = 1
            return f_verts, f_edges, width

        return real(part, s, mode, e_total, opts, mesh, dense, queue,
                    bottom_up, narrowed, fused, vwords)

    monkeypatch.setattr(bfs, "_level_runner", narrow)
    n = 301
    src, dst = generate("star", n, seed=2)
    eng = plan(shard_graph_2d(src, dst, n, 2, 2),
               BFSOptions(mode="queue", queue_cap=4),
               mesh=LocalMesh.grid(2, 2, "cpu"), partition="2d").compile()
    assert eng.plan.sieve
    rec = ca.record(eng, [0])
    np.testing.assert_array_equal(rec.result.dist_host,
                                  bfs_reference(src, dst, n, [0]))
    per_level = {}
    for r in rec.reads:
        per_level[r.level] = per_level.get(r.level, 0) + 1
    assert rec.escalated and max(per_level[lv] for lv in rec.escalated) == 3
    rep = AuditReport("t")
    ca.host_read_check(rec, rep)
    assert rep.ok(), [str(v) for v in rep.violations]
    assert rep.info["host_reads"]["max_per_level"]["escalated"] == 3
    assert ca.audit_engine(eng, sources=[0]).ok()
    # the same reads against a budget of two fail
    monkeypatch.setitem(ca.HOST_READ_BUDGET, "escalated", 2)
    rep = AuditReport("t")
    ca.host_read_check(rec, rep)
    assert rep.rules() == {"HA005"}


def test_queue_plan_reports_unreached_dense_as_info():
    eng, _, _ = _engine(mode="queue")
    rep = ca.audit_engine(eng)
    assert rep.ok()
    info = [v for v in rep.violations if v.severity == "info"]
    assert [v.rule for v in info] == ["HA001"] and "dense" in info[0].message
    assert "info" in rep.summary()


def test_known_bad_byte_model_fails_ha003_alone_and_stays_bitwise():
    """The real ``alltoall_direct`` queue impl re-registered under a byte
    model lying 100x low: the audit fails on the byte accounting alone,
    and the lie is confined to the report."""
    real = ex.get_exchange("queue", "alltoall_direct")
    ex.register_exchange(
        "queue", "alltoall_bad",
        lambda p_, cap, itemsize, density=1.0:
            real.bytes_model(p_, cap, itemsize, density) / 100.0,
    )(real.impl)
    try:
        good, src, dst = _engine(n=2048, mode="queue", wire_format="bytes")
        assert ca.audit_engine(good).ok()
        bad, _, _ = _engine(n=2048, mode="queue", wire_format="bytes",
                            queue_exchange="alltoall_bad")
        got = []
        rep = ca.audit_engine(bad, on_result=lambda r: got.append(
            r.dist_host))
    finally:
        ex.unregister_exchange("queue", "alltoall_bad")
    assert not rep.ok() and rep.rules() == {"HA003"}
    assert all("role 'queue'" in v.message and "ratio 100.000" in v.message
               for v in rep.violations if v.rule == "HA003")
    np.testing.assert_array_equal(got[0], bfs_reference(src, dst, 2048, [0]))


# ---------------------------------------------------------------------------
# the H100 roofline
# ---------------------------------------------------------------------------

def test_roofline_row_prices_the_link_and_the_cuda_cores():
    row = roofline.roofline_row(1e6, 4e6, 1e9, overlap=False)
    assert row["link"] == "hbm" and row["shards"] == 1
    assert row["t_collective_s"] == 2e6 / roofline.HBM_BW
    assert row["t_compute_s"] == (4e6 / roofline.HBM_BW
                                  + 1e9 / roofline.PEAK_FLOPS_FP32)
    assert row["t_level_s"] == row["t_collective_s"] + row["t_compute_s"]
    fused = roofline.roofline_row(1e6, 4e6, 1e9, overlap=True)
    assert fused["t_level_s"] == max(fused["t_collective_s"],
                                     fused["t_compute_s"])
    assert fused["model"] == "overlap(max)" and row["model"] == "serial(sum)"
    assert (roofline.HBM_BW, roofline.PEAK_FLOPS_BF16,
            roofline.PEAK_FLOPS_FP32, roofline.NVLINK_BW) == (
                3.35e12, 989e12, 67e12, 450e9)


@pytest.mark.parametrize("partition", ["1d", "2d"])
def test_roofline_prices_every_shard_of_the_one_card(partition):
    """A ``LocalMesh``'s four shards share one card: each level kind's
    time is four times the price of one shard's counts."""
    g, mesh = _graph_and_mesh(partition)
    pl = plan(g, BFSOptions(mode="auto"), mesh=mesh, partition=partition)
    for kind, row in pl.describe()["roofline"].items():
        one = roofline.roofline_row(row["wire_bytes"], row["hbm_bytes"],
                                    row["flops"],
                                    overlap=row["model"] == "overlap(max)")
        assert row["shards"] == 4, kind
        for t in ("t_collective_s", "t_compute_s", "t_level_s"):
            assert row[t] == pytest.approx(4 * one[t], rel=1e-12), (kind, t)
        assert row["bottleneck"] == one["bottleneck"], kind


# ---------------------------------------------------------------------------
# the 48 variants against the JAX package (one subprocess, 4 host devices)
# ---------------------------------------------------------------------------

AUDIT_N = 512


def _variant_key(part, mode, wire, fused):
    return f"{part}:{mode}:{wire}:{fused}"


def _variants():
    for part in ("1d", "2d"):
        for wire in ("bytes", "packed", "compressed", "auto"):
            for mode in ("dense", "queue", "auto"):
                for fused in (False, "auto"):
                    yield part, mode, wire, fused


def _jax_worker(path: str) -> None:
    """Subprocess body: the JAX plans' roles and roofline rows."""
    import jax
    from jax.sharding import Mesh

    from repro.core import BFSOptions as JOptions
    from repro.core import plan as jplan
    from repro.graphs import generate as jgenerate
    from repro.graphs import shard_graph as jshard
    from repro.graphs import shard_graph_2d as jshard_2d
    from repro.launch.mesh import make_grid_mesh

    src, dst = jgenerate("er", AUDIT_N, seed=0)
    g1, g2 = jshard(src, dst, AUDIT_N, 4), jshard_2d(src, dst, AUDIT_N, 2, 2)
    mesh1 = Mesh(np.asarray(jax.devices()).reshape(4), ("p",))
    mesh2 = make_grid_mesh(2, 2)
    out = {}
    for part, mode, wire, fused in _variants():
        opts = JOptions(mode=mode, wire_format=wire, use_fused_tail=fused)
        pl = (jplan(g2, opts, mesh=mesh2, partition="2d") if part == "2d"
              else jplan(g1, opts, mesh=mesh1, axis="p"))
        out[_variant_key(part, mode, wire, fused)] = {
            "roles": [r.to_dict() for r in jaudit.roles_for_plan(pl)],
            "roofline": pl.describe()["roofline"],
            "fused": bool(pl.use_fused_tail)}
    Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def jax_variants(tmp_path_factory):
    out = tmp_path_factory.mktemp("audit") / "variants.json"
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_analysis as t; t._jax_worker(sys.argv[3])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "src"), str(ROOT / "tests"),
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_variants():
    src, dst = generate("er", AUDIT_N, seed=0)
    g1, g2 = (shard_graph(src, dst, AUDIT_N, 4),
              shard_graph_2d(src, dst, AUDIT_N, 2, 2))
    out = {}
    for part, mode, wire, fused in _variants():
        opts = BFSOptions(mode=mode, wire_format=wire, use_fused_tail=fused)
        pl = (plan(g2, opts, mesh=LocalMesh.grid(2, 2, "cpu"),
                   partition="2d") if part == "2d"
              else plan(g1, opts, mesh=LocalMesh.flat(4, "cpu")))
        out[_variant_key(part, mode, wire, fused)] = pl
    return out


VARIANT_KEYS = [_variant_key(*v) for v in _variants()]


def test_there_are_48_variants():
    assert len(VARIANT_KEYS) == len(set(VARIANT_KEYS)) == 48


@pytest.mark.parametrize("key", VARIANT_KEYS)
def test_roles_and_roofline_counts_equal_jax(jax_variants, port_variants,
                                             key):
    want, pl = jax_variants[key], port_variants[key]
    assert pl.use_fused_tail == want["fused"]
    roles = [r.to_dict() for r in ca.roles_for_plan(pl)]
    for r in roles:
        r["kinds"] = list(r["kinds"])
    assert roles == want["roles"]
    got = pl.describe()["roofline"]
    assert set(got) == set(want["roofline"]) == {"dense", "queue",
                                                 "bottom_up"}
    for kind, row in got.items():
        for field in ("wire_bytes", "hbm_bytes", "flops", "model"):
            assert row[field] == want["roofline"][kind][field], (kind, field)
        assert row["link"] == "hbm"
        # the bottleneck is the port's own H100 terms' (JAX prices TPU
        # constants, so its pick may differ where the terms are close)
        assert row["bottleneck"] == ("collective" if row["t_collective_s"]
                                     >= row["t_compute_s"] else "compute")


def test_bfs_audit_all_variants_on_the_cpu_exits_0(tmp_path):
    out = tmp_path / "audit.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bfs_audit.main(["--graph", f"er:{AUDIT_N}", "--all-variants",
                             "--devices", "4", "--device", "cpu", "--census",
                             "--out", str(out)])
    text = buf.getvalue()
    assert rc == 0, text[-3000:]
    assert "variants: 48 planned, 36 audited" in text
    assert "audit: PASS" in text and "recorded/modeled bytes" in text
    ledger = json.loads(out.read_text())["audit"]
    assert ledger["ok"] and ledger["variants"] == {"planned": 48,
                                                   "audited": 36}
    assert ledger["byte_ratios"] and all(
        lo == hi == 1.0 for lo, hi in ledger["byte_ratios"].values())
    names = [r["name"] for r in ledger["reports"]]
    assert names[-2:] == ["lint:src/repro_torch", "locks:serve"]


def test_bfs_audit_refuses_the_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        bfs_audit.main(["--graph", "er:64"])


# ---------------------------------------------------------------------------
# registry / level-loop lint on known-bad fixtures and the real tree
# ---------------------------------------------------------------------------

BAD_REGISTRY = '''
import torch
from repro_torch.core.exchange import register_exchange

def wrong_arity(n, p):
    return float(n * p)

@register_exchange("dense", "weird", wrong_arity)
def impl_a(x, mesh, axis):
    return x

def impure(p, cap, itemsize, density=1.0):
    return torch.tensor(cap).item()

@register_exchange("queue", "impure_model", impure)
def impl_b(x, mesh, axis):
    return x
'''

BAD_TRACED = '''
import time
import torch

def level(x, mesh):
    t0 = time.perf_counter()
    if torch.any(x > 0):
        x = x + 1
    return x, t0
'''

TABLE_REGISTRY = '''
from repro_torch.core.exchange import register_exchange

def m_gather(n, r, c, s, itemsize):
    return n

def m_gather_packed(n, r, c, s, itemsize):
    return n

def m_short(r, c, cap):
    return cap

for _kind, _name, _model, _wire, _impl in (
        ("expand_row", "gather", m_gather, "bytes", None),
        ("expand_row", "gather_packed", m_gather_packed, "packed", None),
        ("fold_col_sparse", "short", m_short, "bytes", None)):
    register_exchange(_kind, _name, _model, wire=_wire)(_impl)
'''


def test_lint_flags_bad_registrations():
    rep = lint_sources({"core/custom.py": BAD_REGISTRY})
    rules = rep.rules()
    assert "RX001" in rules          # wrong_arity: 2 args, dense needs 5
    assert "RX002" in rules          # impure: torch inside the byte model
    assert "RX003" in rules          # no packed/compressed twins
    assert not rep.ok()
    assert len(rep.info["registrations"]) == 2


def test_lint_reads_a_table_of_registrations():
    rep = lint_sources({"core/custom.py": TABLE_REGISTRY})
    regs = rep.info["registrations"]
    assert [(r["kind"], r["name"], r["wire"]) for r in regs] == [
        ("expand_row", "gather", "bytes"),
        ("expand_row", "gather_packed", "packed"),
        ("fold_col_sparse", "short", "bytes")]
    # the table's third row: 3 args for a 5-arg kind, and no twin
    assert {(v.rule, v.line) for v in rep.violations} == {
        ("RX001", regs[2]["line"]), ("RX003", regs[2]["line"])}


def test_lint_flags_tensor_if_host_read_and_host_clock():
    rep = lint_sources({"core/bfs.py": BAD_TRACED})
    assert {"RX004", "RX005"} <= rep.rules()
    # same source under a path outside the level loop: no loop rules
    rep2 = lint_sources({"serve/tools.py": BAD_TRACED})
    assert not ({"RX004", "RX005"} & rep2.rules())
    reads = BAD_TRACED.replace("    return x, t0",
                               "    flag = bool(x.any())\n"
                               "    n = x.sum().tolist()\n"
                               "    return x, t0, flag, n")
    rep3 = lint_sources({"core/frontier.py": reads})
    assert sorted(v.line for v in rep3.violations
                  if v.rule == "RX004") == [7, 9, 10]


def test_lint_suppression_and_bare_allow():
    suppressed = BAD_TRACED.replace(
        "t0 = time.perf_counter()",
        "t0 = time.perf_counter()  # audit: allow(RX005) -- wall-clock "
        "fixture")
    rep = lint_sources({"core/bfs.py": suppressed})
    assert "RX005" not in rep.rules()          # suppressed with a reason
    assert any(v.rule == "RX005" and v.suppressed for v in rep.violations)

    bare = BAD_TRACED.replace(
        "t0 = time.perf_counter()",
        "t0 = time.perf_counter()  # audit: allow(RX005)")
    rep2 = lint_sources({"core/bfs.py": bare})
    assert "SUP001" in rep2.rules()            # reason string is required


def test_lint_tree_real_port_is_clean():
    rep = lint_tree()
    assert rep.ok(), [str(v) for v in rep.violations]
    regs = {(r["kind"], r["name"], r["wire"])
            for r in rep.info["registrations"]}
    # every strategy of the registry is seen, as the JAX tree's 24
    assert regs == {(k, n, st.wire) for (k, n), st in ex._REGISTRY.items()}
    assert len(regs) == 24
    sup = [v for v in rep.violations if v.suppressed]
    assert sup and all(v.suppress_reason for v in sup)


def test_host_read_sites_are_the_level_loop_reads():
    sites = host_read_sites()
    assert sites and {f for f, _ in sites} == {"repro_torch/core/bfs.py"}
    src = (ROOT / "src" / "repro_torch" / "core" / "bfs.py").read_text()
    lines = src.splitlines()
    assert all("host_read" in lines[ln - 1] or ".tolist()" in lines[ln - 1]
               for _, ln in sites)
    assert sum("mesh.host_read(" in ln for ln in lines) == sum(
        "host_read" in lines[ln - 1] for _, ln in sites)


# ---------------------------------------------------------------------------
# lock-discipline pass on the JAX package's bad classes and the real tree
# ---------------------------------------------------------------------------

LEAKY = '''
import threading

class Leaky:
    # guarded-by(_lock): _x
    def __init__(self):
        self._lock = threading.Lock()
        self._x = 0            # __init__ is exempt

    def bump(self):
        with self._lock:
            self._x += 1

    def peek(self):
        return self._x         # LK001: no lock held
'''

DEADLOCKY = '''
import threading

class Deadlocky:
    # guarded-by(_a): _y
    def __init__(self):
        self._a = threading.Lock()
        self._b = threading.Lock()
        self._y = 0

    def ab(self):
        with self._a:
            with self._b:
                self._y += 1

    def ba(self):
        with self._b:
            with self._a:
                self._y += 1
'''

PHANTOM = '''
class Phantom:
    # guarded-by(_missing): _z
    def __init__(self):
        self._z = 0
'''

LOCK_SOURCES = {"leaky": LEAKY, "deadlocky": DEADLOCKY, "phantom": PHANTOM,
                "all": LEAKY + DEADLOCKY + PHANTOM}


@pytest.mark.parametrize("name", sorted(LOCK_SOURCES))
def test_lock_pass_rules_equal_jax(name):
    src = LOCK_SOURCES[name]
    got = analyze_lock_source(src, "serve/bad.py")
    want = j_analyze_lock_source(src, "serve/bad.py")
    assert got.rules() == want.rules()
    assert [(v.rule, v.line, v.message) for v in got.violations] == \
        [(v.rule, v.line, v.message) for v in want.violations]
    assert got.info == want.info


def test_locks_flag_unguarded_access_cycle_and_unknown_lock():
    rep = analyze_lock_source(LOCK_SOURCES["all"], "serve/bad.py")
    assert rep.rules() == {"LK001", "LK002", "LK003"}
    assert not any(v.rule == "LK001" and "__init__" in v.message
                   for v in rep.violations)


def test_locks_def_level_suppression_covers_method():
    fixed = LEAKY.replace(
        "    def peek(self):",
        "    # audit: allow(LK001) -- read-only probe, callers tolerate"
        " races\n    def peek(self):")
    rep = analyze_lock_source(fixed, "serve/bad.py")
    assert "LK001" not in rep.rules()
    assert any(v.rule == "LK001" and v.suppressed for v in rep.violations)


def test_analyze_serve_real_port_tree_is_clean():
    rep = analyze_serve()
    assert rep.ok(), [str(v) for v in rep.violations]
    sup = [v for v in rep.violations if v.suppressed]
    assert sup and all(v.suppress_reason for v in sup)
    files = {v.file for v in rep.violations}
    assert files == {"repro_torch/serve/engine_cache.py",
                     "repro_torch/serve/resilience/breaker.py"}


def test_serve_modules_carry_every_guard_annotation():
    """The eight ``SERVE_MODULES`` hold the JAX serve tree's 16
    ``guarded-by`` lines, so the lock pass covers what JAX's covers."""
    from repro_torch.analysis import locks

    pkg = ROOT / "src" / "repro_torch" / "serve"
    n = sum((pkg / rel).read_text().count("# guarded-by(")
            for rel in locks.SERVE_MODULES)
    assert len(locks.SERVE_MODULES) == 8 and n == 16


# ---------------------------------------------------------------------------
# the scaling example
# ---------------------------------------------------------------------------

def test_bfs_scaling_torch_prices_over_nvlink(capsys):
    ns = runpy.run_path(str(ROOT / "examples" / "bfs_scaling_torch.py"))
    # the example's reduced sizes, cut a hundredfold for the CPU
    for name, n in ns["REDUCED"].items():
        ns["REDUCED"][name] = n // 100
    assert ns["main"](["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "NVLink at 450 GB/s a direction (H100 SXM, 700 W)" in out
    assert out.count("== ") == 4 and out.count("  64 ") == 4


def test_lint_module_is_the_one_the_audit_reads():
    assert tlint.TRACED_MODULES == ("core/bfs.py", "core/frontier.py")
