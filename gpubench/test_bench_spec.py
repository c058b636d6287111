"""CPU tests of ``BENCHMARK.json`` and the files it names: the characters
of every name and unit, the keys of every entry, the files each name
leads to, the metrics each per-layer metric moves, and the time a full
check of 24 cells would take at ``run_seconds``."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def cells_of(metric) -> list:
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
               and not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_and_plain_names(section):
    entries = BENCH[section]
    assert entries
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert KEYS[section] <= set(e) <= KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer") + (("source",) if section == "configs"
                                       else ()):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
            assert e["source"] in SOURCES
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_bounds_and_end_to_end_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in BENCH["end_to_end"])


def test_every_name_leads_to_its_file():
    bench_dir = ROOT / "gpubench"
    for c in BENCH["configs"]:
        spec = json.loads((ROOT / c["file"]).read_text())
        assert spec["name"] == c["name"] and spec["source"] == c["source"]
        assert spec["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        assert (bench_dir / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (bench_dir / "metrics" / f"{m['name']}.py").is_file()
        assert set(cells_of(m)) <= {w["name"] for w in BENCH["workloads"]}


def test_each_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: set(cells_of(m)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(cells_of(m)) <= e2e[m["moves"]], m["name"]
    for w in BENCH["workloads"]:
        mine = [n for n, cells in e2e.items() if w["name"] in cells]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(w["name"] in cells_of(m) for m in BENCH["per_layer"])


def test_a_full_check_of_24_cells_fits_at_run_seconds():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_the_file_is_small():
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
