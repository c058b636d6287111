"""The port's launchers against the JAX package's, on the CPU.

``bfs_run`` (1-D dense, queue at S = 1, auto; the 2-D partition on a
2 x 2 grid), ``bfs_serve``'s self-driven loop on two lanes (one 2-D,
``--verify --expect-eviction``) and ``bfs_chaos`` run in both packages on
the same arguments: the JAX launchers in one subprocess that forces four
host devices (its own ``host_devices`` path), the port's in process with
``--device cpu --devices 4``.  Their printed lines match field for field
but for wall times and the engine-cache byte estimates (each package
prices its own tensors); the chaos ledgers have the same keys.  Also:
``parse_graph_spec`` against JAX's, ``resolve_cli_device`` and the
launchers' refusal to fall back to the CPU, the deprecated ``bfs()`` and
the ``core`` re-exports, the ``/metrics`` keys against JAX's, and
``examples/quickstart_torch.py``.
"""

import contextlib
import io
import json
import os
import re
import runpy
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.launch as jlaunch
from repro_torch import launch as tlaunch
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph
from repro_torch.launch import bfs_chaos, bfs_run, bfs_serve

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

RUN_CASES = {
    "dense": ["--graph", "erdos_renyi:2000", "--mode", "dense",
              "--sources", "3", "--repeats", "2"],
    "queue": ["--graph", "erdos_renyi:2000", "--mode", "queue",
              "--sources", "1", "--repeats", "2"],
    "auto": ["--graph", "small_world:2000", "--graph", "star:500",
             "--mode", "auto", "--sources", "2", "--repeats", "2"],
    "auto_s1": ["--graph", "erdos_renyi:2000", "--mode", "auto",
                "--sources", "1", "--repeats", "2"],
    "grid": ["--graph", "erdos_renyi:2000", "--partition", "2d", "--grid",
             "2x2", "--mode", "auto", "--sources", "2", "--repeats", "2"],
}
# a budget below one engine of either package: the cache keeps only the
# newest engine, so both packages evict alike
SERVE_ARGS = ["--graph", "er=erdos_renyi:3000", "--graph",
              "ring=chain:800:2x2", "--requests", "10", "--slots", "2",
              "--cache-budget-mb", "0.01", "--verify", "--expect-eviction"]
CHAOS_ARGS = ["--secs", "2", "--n", "300", "--seed", "0"]


def _captured(fn, *args, **kw):
    """``(rc, stdout)`` of one launcher call (``SystemExit`` is its rc)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            rc = fn(*args, **kw)
        except SystemExit as exc:
            rc = exc.code
    return (0 if rc is None else rc), buf.getvalue()


def _jax_worker(path: str, chaos_out: str) -> None:
    """Subprocess body: every JAX launcher case on four host devices."""
    from repro.launch import bfs_chaos as jchaos
    from repro.launch import bfs_run as jrun
    from repro.launch import bfs_serve as jserve

    def argv_main(mod, name, args):
        sys.argv = [name, *args, "--devices", "4"]
        return _captured(mod.main)

    out = {f"run:{k}": argv_main(jrun, "bfs_run", a)
           for k, a in RUN_CASES.items()}
    out["serve"] = argv_main(jserve, "bfs_serve", SERVE_ARGS)
    out["chaos"] = _captured(jchaos.main, [*CHAOS_ARGS, "--out", chaos_out])
    Path(path).write_text(json.dumps(out))


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    out, chaos = tmp / "runs.json", tmp / "chaos.json"
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_launchers as t; "
            "t._jax_worker(sys.argv[3], sys.argv[4])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "src"), str(ROOT / "tests"),
         str(out), str(chaos)], env=env, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    runs = json.loads(out.read_text())
    runs["chaos_ledger"] = json.loads(chaos.read_text())
    return runs


_RUN = re.compile(r"^run\[(\d+)\] sources=(.*?): levels=(\d+) visited=(\d+) "
                  r"modes=(\{.*?\}) comm_bytes/chip=(\S+) wall=\S+s(.*)$")


def _run_lines(text: str) -> list:
    """Each ``run[i]`` line's fields, wall time dropped."""
    return [m.groups() for m in map(_RUN.match, text.splitlines()) if m]


def _untimed(text: str, keep) -> list:
    """The lines starting with one of ``keep``, with seconds and
    ``bytes=`` fields dropped."""
    drop = re.compile(r"\b(bytes|compile_s)=\S+|in \S+s\b| \d+\.\d+s\b|"
                      r"\(\S+ req/s, \S+ ms/req\)|: \d+\.\d+s")
    return [drop.sub("", line) for line in text.splitlines()
            if line.lstrip().startswith(keep)]


@pytest.mark.parametrize("case", sorted(RUN_CASES))
def test_bfs_run_lines_match_jax(jax_runs, case):
    jrc, jout = jax_runs[f"run:{case}"]
    rc, out = _captured(bfs_run.main, [*RUN_CASES[case], "--device", "cpu",
                                       "--devices", "4"])
    assert rc == jrc == 0, out
    got, want = _run_lines(out), _run_lines(jout)
    assert got and got == want
    keep = ("shards=", "grid=", "graph=", "level variants",
            "plan+get_or_compile")
    assert _untimed(out, keep) == _untimed(jout, keep)


def test_bfs_serve_self_driven_matches_jax(jax_runs):
    jrc, jout = jax_runs["serve"]
    rc, out = _captured(bfs_serve.main, [*SERVE_ARGS, "--device", "cpu",
                                         "--devices", "4"])
    assert rc == jrc == 0, out
    keep = ("lane ", "rid=", "cache: ", "verify: ", "10 traversals")
    assert _untimed(out, keep) == _untimed(jout, keep)
    assert "evictions=0" not in out


def test_bfs_chaos_verdict_and_ledger_keys_match_jax(jax_runs, tmp_path):
    jrc, jout = jax_runs["chaos"]
    ledger = tmp_path / "chaos.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bfs_chaos", "--device",
         "cpu", "--devices", "2", "--secs", "6", "--n", "300", "--out",
         str(ledger)], env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == jrc == 0, proc.stdout + proc.stderr
    assert "verdict: OK" in proc.stdout and "verdict: OK" in jout
    got, want = json.loads(ledger.read_text()), jax_runs["chaos_ledger"]
    assert got["ok"] and not got["failures"]
    assert set(got) == set(want)
    for key in ("config", "faults", "watchdog", "metrics"):
        assert set(got[key]) == set(want[key]), key
    assert set(got["breakers"]) == set(want["breakers"]) == {"er", "ring"}
    for name in ("er", "ring"):
        assert set(got["breakers"][name]) == set(want["breakers"][name])
        assert (set(got["metrics"]["lanes"][name])
                == set(want["metrics"]["lanes"][name]))
    assert got["config"]["watchdog_s"] == want["config"]["watchdog_s"] == 1.0
    # the port's metrics add one key: the parents' device edge bytes
    assert (set(got["metrics"]["engine_cache"])
            - set(want["metrics"]["engine_cache"])
            == {"parents_device_bytes"})
    assert got["outcomes"].get("200", 0) > 0


def test_a_corrupted_200_fails_the_chaos_verdict(monkeypatch, tmp_path):
    """Plant one failure: the first 200 a soak worker receives comes back
    with one depth changed, so the bitwise gate must fail the soak."""
    planted = []

    class Corrupting(bfs_chaos.BFSClient):
        def traverse(self, graph, sources, include_parents=False,
                     deadline_ms=None):
            out = super().traverse(graph, sources, include_parents,
                                   deadline_ms)
            # the soak's workers make their clients with a 60 s timeout
            if self.timeout_s == 60.0 and not planted:
                planted.append(graph)
                out["depths"][0][0] += 1
            return out

    monkeypatch.setattr(bfs_chaos, "BFSClient", Corrupting)
    ledger = tmp_path / "chaos.json"
    buf_err = io.StringIO()
    with contextlib.redirect_stderr(buf_err):
        rc, out = _captured(bfs_chaos.main, [
            "--device", "cpu", "--devices", "2", "--secs", "2", "--n", "300",
            "--out", str(ledger)])
    assert planted and rc == 1, out
    got = json.loads(ledger.read_text())
    assert not got["ok"]
    assert any("BITWISE MISMATCH" in f for f in got["failures"])
    assert "verdict: FAIL" in buf_err.getvalue()


GOOD_SPECS = ["er", "er:500", "a=er:500", "g=rmat:1048576:2x2",
              "ring=chain:5000:2x2", "star:10:1X4", "x=small_world"]
BAD_SPECS = ["er:abc", "er:2xq", "a=er:5:zz", "er:1x2x3", "er:"]


@pytest.mark.parametrize("spec", GOOD_SPECS + BAD_SPECS)
def test_parse_graph_spec_matches_jax(spec):
    out = []
    for mod in (jlaunch, tlaunch):
        try:
            out.append(("ok", mod.parse_graph_spec(spec, 77)))
        except SystemExit as exc:
            out.append(("exit", str(exc)))
    assert out[0] == out[1]
    assert (out[0][0] == "ok") == (spec in GOOD_SPECS)


def test_resolve_cli_device(monkeypatch):
    assert tlaunch.resolve_cli_device("cpu") == torch.device("cpu")
    with pytest.raises(SystemExit, match="expects cuda or cpu"):
        tlaunch.resolve_cli_device("tpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="pass --device cpu"):
        tlaunch.resolve_cli_device("cuda")


@pytest.mark.parametrize("launcher", ["bfs_run", "bfs_serve", "bfs_chaos",
                                      "quickstart"])
def test_launchers_default_to_the_card_and_refuse_without_one(monkeypatch,
                                                              launcher):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = ({"bfs_run": bfs_run.main, "bfs_serve": bfs_serve.main,
             "bfs_chaos": bfs_chaos.main}.get(launcher)
            or runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"))
            ["main"])
    with pytest.raises(SystemExit, match="pass --device cpu"):
        main(["--n", "100"])


def test_quickstart_torch_runs_on_the_cpu(capsys):
    main = runpy.run_path(str(ROOT / "examples" / "quickstart_torch.py"))[
        "main"]
    assert main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and out.count(" OK") == 18


def test_deprecated_bfs_warns_and_is_jax_bfs():
    from repro.core import bfs as jbfs
    from repro.graphs import shard_graph as jshard

    from repro_torch.core.bfs import bfs

    src, dst = generate("erdos_renyi", 300, seed=4, avg_degree=4)
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got, gstats = bfs(shard_graph(src, dst, 300, 1), [0, 17, 299],
                          device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        want, wstats = jbfs(jshard(src, dst, 300, 1), [0, 17, 299])
    np.testing.assert_array_equal(got, np.asarray(want))
    np.testing.assert_array_equal(got, bfs_reference(src, dst, 300,
                                                     [0, 17, 299]))
    assert (gstats.levels, gstats.visited, gstats.mode_counts) == (
        wstats.levels, wstats.visited, wstats.mode_counts)


def test_core_reexports_the_exchange_helpers():
    from repro_torch import core
    from repro_torch.core import exchange

    for name in ("exchange_queue", "expand_row", "fold_col"):
        assert getattr(core, name) is getattr(exchange, name)
        assert name in core.__all__


AUDIT_ARGS = ["--mode", "queue", "--wire-format", "bytes", "--sources", "1",
              "--repeats", "1", "--audit", "--device", "cpu", "--devices",
              "4"]


def test_bfs_run_audit_prints_a_census_and_exits_0():
    rc, out = _captured(bfs_run.main, ["--graph", "erdos_renyi:2000",
                                       "--mode", "auto", "--sources", "1",
                                       "--repeats", "1", "--audit",
                                       "--device", "cpu", "--devices", "4"])
    assert rc == 0, out
    assert "[census:1d:auto:auto:S1:fused] ok" in out
    rows = [ln.split()[0] for ln in out.splitlines()
            if ln.split() and ln.split()[0] in ("dense", "queue", "sieve",
                                                "bottom_up")]
    assert set(rows) == {"dense", "queue", "sieve", "bottom_up"}
    assert all("1.000" in ln for ln in out.splitlines()
               if ln.split() and ln.split()[0] in rows)


def test_bfs_run_audit_exits_1_under_a_lying_byte_model(monkeypatch):
    """The real queue strategy priced 100x low fails the audit; the run
    lines still print, and the launcher exits 1."""
    from repro_torch.core import exchange as ex

    real = ex.get_exchange("queue", "alltoall_direct")
    monkeypatch.setitem(ex._REGISTRY, ("queue", "alltoall_direct"),
                        ex.ExchangeStrategy(
                            real.name, real.kind, real.impl,
                            lambda p, cap, itemsize, density=1.0:
                                real.bytes_model(p, cap, itemsize,
                                                 density) / 100.0))
    # a graph of its own: no engine of the honest model is cached for it
    rc, out = _captured(bfs_run.main, ["--graph", "erdos_renyi:2040",
                                       *AUDIT_ARGS])
    assert rc == 1, out
    assert "FAIL" in out and "HA003" in out and "ratio 100.000" in out
    assert "run[0]" in out


DIST_CASES = {
    "1d_auto": ["--graph", "erdos_renyi:2000", "--mode", "auto",
                "--sources", "2", "--repeats", "2"],
    "2d_grid": ["--graph", "rmat:2000", "--partition", "2d", "--grid",
                "1x2", "--mode", "auto", "--sources", "1", "--repeats",
                "2"],
}


@pytest.mark.parametrize("case", sorted(DIST_CASES))
def test_bfs_run_dist_prints_the_in_process_run_lines(case, tmp_path):
    """``torch.distributed.run --nproc-per-node 2 ... bfs_run --dist
    --backend gloo`` (a free port: ``--standalone``; a hard timeout)
    prints, from rank 0 alone, the run lines of the in-process run at
    ``--devices 2``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.bfs_run",
         "--dist", "--device", "cpu", "--backend", "gloo",
         *DIST_CASES[case]], env=env, cwd=tmp_path, capture_output=True,
        text=True, timeout=240)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    rc, want = _captured(bfs_run.main, [*DIST_CASES[case], "--device",
                                        "cpu", "--devices", "2"])
    assert rc == 0
    got = _run_lines(proc.stdout)
    assert got and got == _run_lines(want)
    keep = ("shards=", "grid=", "graph=", "level variants")
    assert _untimed(proc.stdout, keep) == _untimed(want, keep)
    # the other rank printed nothing
    assert proc.stdout.count("run[0]") == 1
    assert ("dist: 2 ranks, gloo through the host, cpu tensors, one shard "
            "a rank") in proc.stdout


def test_bfs_run_dist_needs_torch_distributed_run(monkeypatch):
    for key in tlaunch.DIST_ENV:
        monkeypatch.delenv(key, raising=False)
    rc, _ = _captured(bfs_run.main, ["--dist", "--device", "cpu",
                                     "--backend", "gloo"])
    assert "torch.distributed.run" in str(rc)
