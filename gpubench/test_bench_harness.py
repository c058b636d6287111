"""CPU tests of the benchmark's harness: a whole run of a throwaway cell
added by files alone, the control and the planted faults, the look for a
card and the check of what the measuring process loaded.  Nothing here
needs a card: the harness runs the port on the CPU at a tiny size."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpubench import control, harness

ROOT = Path(__file__).resolve().parents[1]
TINY = {"kind": "rmat", "scale": 9, "edge_factor": 8, "a": 0.57, "b": 0.19,
        "c": 0.19}


def make_root(tmp_path: Path, options: dict, metric: str | None = None):
    """A copy of the benchmark with one throwaway configuration, traffic mix
    and cell added as files (and, with ``metric``, one per-layer metric),
    none of the existing files edited but ``BENCHMARK.json``'s lists."""
    shutil.copytree(ROOT / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "gpubench" / "configs" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "generator": TINY, "graph_seed": 3,
         "partition": {"p": 4, "mesh": "flat"}, "reduced": ["scale"]}))
    (tmp_path / "gpubench" / "traffic" / "t8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "sources": 8,
         "roots": "uniform_nonisolated", "pool_batches": 3,
         "pool_seed": 11, "options": options,
         "warmup_batches": 1, "check_batches": 3, "trace_batches": 2}))
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "gpubench/configs/tiny.json",
                             "reduced": ["scale"], "why": "test"})
    bench["workloads"].append({"name": "tiny.t8", "config": "tiny",
                               "traffic": "t8", "chips": 1, "why": "test"})
    # the new cell joins the metrics of the cell it is like
    like = ("graph500_s20.bits_s64" if options.get("use_kernel")
            else "graph500_s20.dense_s64")
    for m in bench["end_to_end"] + bench["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append("tiny.t8")
    if metric:
        (tmp_path / "gpubench" / "metrics" / f"{metric}.py").write_text(
            "def read(run):\n    return float(len(run.batches))\n")
        bench["per_layer"].append({
            "name": metric, "unit": "batches", "better": "higher",
            "source": "host_clock", "layer": "level loop",
            "moves": "gteps", "workloads": ["tiny.t8"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def run_tiny(root, trace=False, make_engine=harness.default_engine, seed=5):
    return harness.run_cell(root, "tiny.t8", seed, 0.3, trace, "cpu",
                            cache_dir=root / "cache",
                            make_engine=make_engine,
                            log=lambda *a, **k: None)


@pytest.mark.parametrize("options", [{}, {"use_kernel": True}],
                         ids=["dense", "bits"])
def test_a_cell_added_by_files_runs_and_is_correct(tmp_path, options):
    root = make_root(tmp_path, options, metric="batches_run")
    out = run_tiny(root)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    rate = "gteps.bits" if options else "gteps"
    # no card: the device's peak is not read
    assert set(out["metrics"]) == {rate, "setup_s"} | (
        {"batch_ms_p95"} if options else set())
    assert out["metrics"][rate]["unit"] == "GTEPS"
    assert out["metrics"][rate]["value"] > 0
    assert list(out)[-1] == "checks"
    assert out["checks"] == {"dist_mismatches": {"value": 0, "limit": 0}}
    traced = run_tiny(root, trace=True)
    assert traced["correct"]
    # on the CPU nothing runs on a device: the trace readers read nothing
    assert {"batches_run", "setup.shard_s", "setup.compile_s",
            "level_ms" + (".bits" if options else "")} == set(
                traced["metrics"])
    assert traced["metrics"]["batches_run"]["value"] == traced["attempted"]


def test_the_graph_is_served_from_the_cache(tmp_path):
    root = make_root(tmp_path, {})
    run_tiny(root)
    files = sorted(p.name for p in (root / "cache" / "tiny").iterdir())
    assert files == ["comp_edges.npy", "dst.npy", "meta.json",
                     "root_pool.npy", "src.npy"]
    stamp = (root / "cache" / "tiny" / "src.npy").stat().st_mtime_ns
    run_tiny(root)
    assert (root / "cache" / "tiny" / "src.npy").stat().st_mtime_ns == stamp


@pytest.mark.parametrize("fault", ["control", *control.FAULTS])
def test_the_control_and_each_fault_fail_the_check(tmp_path, fault):
    root = make_root(tmp_path, {})
    out = run_tiny(root, make_engine=control.make_engine(fault))
    assert not out["correct"]
    assert out["checks"]["dist_mismatches"]["value"] > 0
    assert out["failed"] >= 1


def test_every_seed_runs_the_same_batches_in_its_own_order(tmp_path):
    root = make_root(tmp_path, {})
    seen = []

    def spy(sharded, run, device):
        eng = harness.default_engine(sharded, run, device)
        inner = eng.run

        def run_(roots):
            seen.append(tuple(int(r) for r in roots))
            return inner(roots)

        eng.run = run_
        return eng

    def window(seed):
        seen.clear()
        run_tiny(root, make_engine=spy, seed=seed)
        return list(seen[1:])                 # after the one warm-up batch

    big = 2 ** 31 + 12345
    first, again, other = window(big), window(big), window(big + 1)
    n = min(len(first), len(again))
    assert n >= 6 and first[:n] == again[:n]
    # whole passes over the pool of 3 batches, each pass a permutation
    for order in (first, other):
        assert len(set(order)) == 3
        for k in range(0, len(order) - 2, 3):
            assert set(order[k:k + 3]) == set(first[:3])
    assert first[:6] != other[:6]
    assert all(len(set(r)) == len(r) == 8 for r in first)


def test_run_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "gpubench" / "run.py"), "--workload",
         "graph500_s20.dense_s64", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_the_measuring_process_loads_neither_jax_nor_repro(tmp_path):
    """A whole tiny run in a fresh process, then ``run.py``'s own check of
    ``sys.modules`` by top-level names compared whole."""
    root = make_root(tmp_path, {"use_kernel": True})
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "from pathlib import Path\n"
        "from gpubench import harness, run\n"
        f"out = harness.run_cell(Path({str(root)!r}), 'tiny.t8', 7, 0.3, "
        "True, 'cpu', cache_dir=Path("
        f"{str(root / 'cache')!r}), log=lambda *a, **k: None)\n"
        "assert out['correct']\n"
        "assert 'repro_torch' in sys.modules\n"
        "print(run.forbidden_modules())\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_the_module_check_compares_whole_top_level_names(monkeypatch):
    from gpubench import run

    monkeypatch.setitem(sys.modules, "reproducible", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert run.forbidden_modules() == [
        m for m in ("flax", "jax", "jaxlib", "repro") if m in sys.modules]
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in run.forbidden_modules()
