"""The port's serving surface of the plan and the engine cache: ``plan_key``
groups plans exactly as the JAX package's does (a CPU and a card plan
never share a key), ``estimated_device_bytes`` covers every tensor a
compiled engine holds, the engines of one graph share one upload of each
block group (freed with the last of them), and ``EngineCache`` /
``GraphCatalog`` behave as the JAX package's (``tests/test_engine_cache.py``'s
cases, run on the port).

p = 1 plans are keyed against the JAX plans in this process; p = 4 plans
(a 2 x 2 grid for 2-D) in one subprocess that forces four host devices
before its JAX import, as ``tests/test_torch_grid_engine.py`` does.
"""

import gc
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions, LocalMesh, plan
from repro_torch.core.engine import BFSEngine, _BlockGroup, plan_ladder
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph, to_2d
from repro_torch.serve.engine_cache import (EngineCache, GraphCatalog,
                                            default_engine_cache,
                                            set_default_cache,
                                            use_default_cache)

torch.set_num_threads(1)

# (label, graph, BFSOptions fields, S, partition, through to_2d): every
# axis of the key matrix — a block-identical twin, another seed, S, mode,
# queue_cap, max_levels, 2-D by the flag and by to_2d, "auto" against its
# resolved name, wire_format, use_kernel — and knobs that resolve away
MATRIX = [
    ("base", "g", {}, 2, None, False),
    ("twin", "twin", {}, 2, None, False),
    ("other_seed", "other", {}, 2, None, False),
    ("s1", "g", {}, 1, None, False),
    ("s3", "g", {}, 3, None, False),
    ("auto", "g", {"mode": "auto"}, 2, None, False),
    ("auto_s1", "g", {"mode": "auto"}, 1, None, False),
    ("queue", "g", {"mode": "queue"}, 1, None, False),
    ("queue_nosieve", "g", {"mode": "queue", "sieve": False}, 1, None,
     False),
    ("queue_cap", "g", {"queue_cap": 2048}, 2, None, False),
    ("max_levels", "g", {"max_levels": 7}, 2, None, False),
    ("max_levels_n", "g", {"max_levels": None}, 2, None, False),
    ("2d_flag", "g", {}, 2, "2d", False),
    ("2d_to2d", "g", {}, 2, None, True),
    ("2d_to2d_twin", "twin", {}, 2, None, True),
    ("2d_auto", "g", {"mode": "auto"}, 2, "2d", False),
    ("exchange_auto", "g", {"dense_exchange": "auto"}, 2, None, False),
    ("exchange_resolved", "g", {"dense_exchange": None}, 2, None, False),
    ("wire_bytes", "g", {"wire_format": "bytes"}, 2, None, False),
    ("wire_packed", "g", {"wire_format": "packed"}, 2, None, False),
    ("wire_compressed", "g", {"wire_format": "compressed"}, 2, None, False),
    ("queue_compressed", "g", {"mode": "queue", "wire_format": "compressed"},
     1, None, False),
    ("unfused", "g", {"use_fused_tail": False}, 2, None, False),
    ("kernel", "g", {"use_kernel": True}, 2, None, False),
    ("kernel_packed", "g", {"use_kernel": True, "wire_format": "packed"},
     2, None, False),
    ("sieve_dense", "g", {"sieve": True}, 2, None, False),
]


def _edges(seed=3, n=200, kind="erdos_renyi", **kw):
    return generate(kind, n, seed=seed, **kw)


def _fields(fields, resolved_name):
    """The matrix fields, ``max_levels=None`` read as the graph's n and
    ``dense_exchange=None`` as the name "auto" resolves to."""
    out = dict(fields)
    if out.get("dense_exchange", "") is None:
        out["dense_exchange"] = resolved_name
    if "max_levels" in out and out["max_levels"] is None:
        out["max_levels"] = 200
    return out


def _groups(keys: list) -> list:
    """The partition of the labels by key equality, canonical."""
    seen = {}
    for label, key in keys:
        seen.setdefault(key, []).append(label)
    return sorted(sorted(v) for v in seen.values())


def _jax_keys(p: int, mesh_1d=None, mesh_2d=None) -> list:
    from repro.core import BFSOptions as JOptions
    from repro.core import plan as jplan
    from repro.graphs import shard_graph as j_shard, to_2d as j_to_2d

    src, dst = _edges()
    graphs = {"g": j_shard(src, dst, 200, p), "twin": j_shard(src, dst, 200, p),
              "other": j_shard(*_edges(seed=9), 200, p)}
    resolved = jplan(graphs["g"], JOptions(dense_exchange="auto"),
                     num_sources=2, mesh=mesh_1d).dense_strategy.name
    r, c = (2, 2) if p == 4 else (1, 1)
    keys = []
    for label, gname, fields, s, part, via_to_2d in MATRIX:
        if p > 1 and fields.get("use_kernel"):
            continue
        g = graphs[gname]
        opts = JOptions(**_fields(fields, resolved))
        if via_to_2d:
            pl = jplan(j_to_2d(g, r, c), opts, num_sources=s, mesh=mesh_2d)
        elif part == "2d":
            pl = jplan(g, opts, num_sources=s, partition="2d", mesh=mesh_2d)
        else:
            pl = jplan(g, opts, num_sources=s, mesh=mesh_1d)
        keys.append((label, pl.plan_key()))
    return _groups(keys)


def _port_keys(p: int, device="cpu") -> list:
    src, dst = _edges()
    graphs = {"g": shard_graph(src, dst, 200, p),
              "twin": shard_graph(src, dst, 200, p),
              "other": shard_graph(*_edges(seed=9), 200, p)}
    mesh_1d = LocalMesh.flat(p, device) if p > 1 else None
    mesh_2d = LocalMesh.grid(2, 2, device) if p == 4 else None
    resolved = plan(graphs["g"], BFSOptions(dense_exchange="auto"),
                    num_sources=2, mesh=mesh_1d,
                    device=None if mesh_1d else device).dense_strategy.name
    r, c = (2, 2) if p == 4 else (1, 1)
    kw1 = {"mesh": mesh_1d} if mesh_1d else {"device": device}
    kw2 = {"mesh": mesh_2d} if mesh_2d else {"device": device}
    keys = []
    for label, gname, fields, s, part, via_to_2d in MATRIX:
        if p > 1 and fields.get("use_kernel"):
            continue
        g = graphs[gname]
        opts = BFSOptions(**_fields(fields, resolved))
        if via_to_2d:
            pl = plan(to_2d(g, r, c), opts, num_sources=s, **kw2)
        elif part == "2d":
            pl = plan(g, opts, num_sources=s, partition="2d", **kw2)
        else:
            pl = plan(g, opts, num_sources=s, **kw1)
        keys.append((label, pl.plan_key()))
    return _groups(keys)


def _jax_worker(path: str) -> None:
    """Subprocess body: the JAX key groups at p = 4 (flat and 2 x 2)."""
    import jax
    from jax.sharding import Mesh

    from repro.launch.mesh import make_grid_mesh

    mesh_1d = Mesh(np.asarray(jax.devices()[:4]).reshape(4), ("bfs_p",))
    Path(path).write_text(json.dumps(
        _jax_keys(4, mesh_1d=mesh_1d, mesh_2d=make_grid_mesh(2, 2))))


@pytest.fixture(scope="module")
def jax_p4_groups(tmp_path_factory):
    out = tmp_path_factory.mktemp("keys") / "groups.json"
    root = Path(__file__).resolve().parents[1]
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_engine_cache as t; t._jax_worker(sys.argv[3])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(root / "src"), str(root / "tests"),
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


# ---------------------------------------------------------------------------
# plan_key
# ---------------------------------------------------------------------------

def test_plan_key_groups_the_matrix_as_jax():
    groups = _port_keys(1)
    assert groups == _jax_keys(1)
    # the matrix is not vacuous: some plans share a key, most do not
    assert any(len(g) > 1 for g in groups) and len(groups) > 15
    shared = [g for g in groups if "base" in g][0]
    assert {"twin", "unfused", "sieve_dense", "max_levels_n"} <= set(shared)
    assert any({"exchange_auto", "exchange_resolved"} <= set(g)
               for g in groups)
    assert ["2d_flag", "2d_to2d", "2d_to2d_twin"] in groups


def test_plan_key_groups_the_matrix_as_jax_on_four_shards(jax_p4_groups):
    assert _port_keys(4) == jax_p4_groups


def test_plan_key_holds_the_mesh_device():
    src, dst = _edges()
    g = shard_graph(src, dst, 200, 1)
    cpu = plan(g, BFSOptions(), num_sources=2, device="cpu")
    card = plan(g, BFSOptions(), num_sources=2, device="meta")
    assert cpu.plan_key() != card.plan_key()
    assert cpu.plan_key()[3][2] == torch.device("cpu")
    assert card.plan_key() == plan(g, BFSOptions(), num_sources=2,
                                   device="meta").plan_key()
    # the device is all that differs
    assert cpu.plan_key()[:3] == card.plan_key()[:3]
    assert cpu.plan_key()[4:] == card.plan_key()[4:]
    g4 = shard_graph(src, dst, 200, 4)
    grid = [plan(g4, BFSOptions(), mesh=LocalMesh.grid(2, 2, d),
                 partition="2d").plan_key() for d in ("cpu", "meta")]
    assert grid[0] != grid[1]


def test_plan_key_2d_same_from_either_entry_path():
    src, dst = _edges(n=120)
    g = shard_graph(src, dst, 120, 1)
    via_flag = plan(g, BFSOptions(mode="dense"), partition="2d",
                    device="cpu")
    via_container = plan(to_2d(g, 1, 1), BFSOptions(mode="dense"),
                         device="cpu")
    assert via_flag.plan_key() == via_container.plan_key()
    assert to_2d(g, 1, 1) is to_2d(g, 1, 1)


def test_to_2d_is_one_object_across_threads():
    src, dst = _edges(n=400)
    g = shard_graph(src, dst, 400, 4)
    got = []
    threads = [threading.Thread(target=lambda: got.append(to_2d(g, 2, 2)))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 6 and all(x is got[0] for x in got)


# ---------------------------------------------------------------------------
# estimated_device_bytes against the tensors a compiled engine holds
# ---------------------------------------------------------------------------

def _held_storages(eng: BFSEngine) -> dict:
    """Every tensor the engine holds — its attributes, its block groups
    and the closures of its level loop — by storage, with its bytes."""
    out, seen = {}, set()

    def visit(x):
        if id(x) in seen:
            return
        seen.add(id(x))
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            out[st.data_ptr()] = st.nbytes()
        elif isinstance(x, (tuple, list)):
            for y in x:
                visit(y)
        elif isinstance(x, dict):
            for y in x.values():
                visit(y)
        elif isinstance(x, _BlockGroup):
            visit(x.arrays)
        elif callable(x) and getattr(x, "__closure__", None):
            for cell in x.__closure__:
                try:
                    visit(cell.cell_contents)
                except ValueError:        # an empty cell
                    pass

    visit({k: v for k, v in vars(eng).items() if k != "plan"})
    return out


STAR = "star"
ENGINE_CASES = {
    "dense_p1": ("er", 1, None, 4, {}),
    "dense_p4_bytes": ("er", 4, None, 4, {"wire_format": "bytes"}),
    "dense_p4_unfused": ("rmat", 4, None, 4, {"use_fused_tail": False,
                                               "wire_format": "packed"}),
    "queue_p2_compressed_sieve": ("er", 2, None, 1, {
        "mode": "queue", "wire_format": "compressed", "sieve": True}),
    "auto_p4": ("rmat", 4, None, 4, {"mode": "auto"}),
    "auto_p4_bytes": ("rmat", 4, None, 1, {"mode": "auto",
                                           "wire_format": "bytes"}),
    "kernel_p1": ("er", 1, None, 4, {"use_kernel": True}),
    "kernel_p4_packed": ("rmat", 4, None, 4, {"use_kernel": True,
                                              "wire_format": "packed"}),
    "2d_dense": ("rmat", 4, "2d", 4, {}),
    "2d_dense_bytes": ("er", 4, "2d", 4, {"wire_format": "bytes"}),
    "2d_queue": ("er", 4, "2d", 1, {"mode": "queue"}),
    "2d_auto": ("rmat", 4, "2d", 4, {"mode": "auto"}),
    "2d_auto_star": (STAR, 4, "2d", 1, {"mode": "auto"}),
}
GRAPHS = {"er": ("erdos_renyi", 300, {"avg_degree": 5.0}),
          "rmat": ("rmat", 300, {"edge_factor": 8}),
          STAR: ("star", 2000, {})}


def _engine_case(name, s=None):
    graph, p, part, s0, fields = ENGINE_CASES[name]
    kind, n, kw = GRAPHS[graph]
    src, dst = generate(kind, n, seed=1, **kw)
    g = shard_graph(src, dst, n, p)
    mesh = (LocalMesh.grid(2, 2, "cpu") if part == "2d" and p == 4
            else LocalMesh.flat(p, "cpu"))
    pl = plan(g, BFSOptions(**fields), num_sources=s or s0, mesh=mesh,
              partition=part)
    return src, dst, n, g, pl


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_estimate_covers_what_the_engine_holds(name):
    src, dst, n, g, pl = _engine_case(name)
    eng = pl.compile()
    s = pl.num_sources
    res = eng.run(list(range(s)))
    np.testing.assert_array_equal(res.dist_host,
                                  bfs_reference(src, dst, n, list(range(s))))
    held = sum(_held_storages(eng).values())
    terms = pl.device_byte_terms()
    assert held > 0 and terms["resident"] + terms["work"] >= held, (
        terms, held)
    assert pl.estimated_device_bytes() == sum(terms.values()) >= held
    assert eng.estimated_device_bytes() == pl.estimated_device_bytes()
    if name == "2d_auto_star":
        # the skew case: the in-edge blocks out-pad the forward blocks
        assert pl.graph2d.bottom_up_in_cap() > pl.graph2d.e_cap


@pytest.mark.parametrize("name", ["dense_p1", "auto_p4", "kernel_p1",
                                  "2d_dense", "2d_auto"])
def test_estimate_grows_with_s(name):
    small = _engine_case(name, s=1)[-1]
    big = _engine_case(name, s=4)[-1]
    assert big.estimated_device_bytes() > small.estimated_device_bytes()
    assert big.device_byte_terms()["work"] == 4 * \
        small.device_byte_terms()["work"]


def test_estimate_prices_the_auto_blocks():
    """A 2-D ``auto`` plan prices its lazily built bottom-up blocks, and
    the queue modes price their out-edge state, above ``dense``."""
    src, dst = _edges(n=300)
    g = shard_graph(src, dst, 300, 4)
    mesh = LocalMesh.grid(2, 2, "cpu")
    est = {mode: plan(g, BFSOptions(mode=mode), mesh=mesh, partition="2d",
                      num_sources=1).device_byte_terms()["resident"]
           for mode in ("dense", "queue", "auto")}
    assert est["dense"] < est["queue"] < est["auto"]


# ---------------------------------------------------------------------------
# shared device blocks
# ---------------------------------------------------------------------------

def rungs_run(*engines):
    """Each engine's run on its first S vertices: ``(S, dist_host)``."""
    return [(e.plan.num_sources,
             e.run(list(range(e.plan.num_sources))).dist_host)
            for e in engines]


def _ptrs(eng) -> set:
    return set(_held_storages(eng))


@pytest.mark.parametrize("name", ["dense_p4_bytes", "auto_p4", "kernel_p1",
                                  "2d_dense", "2d_auto"])
def test_rungs_share_one_upload_and_free_it_with_the_last(name):
    src, dst, n, g, pl = _engine_case(name, s=1)
    rungs = plan_ladder(g, pl.opts, mesh=pl.mesh, ladder=(1, 4),
                        partition=pl.partition)
    e1, e4 = (rungs[s].compile() for s in (1, 4))
    blocks = g.__dict__["_device_blocks"]
    assert len(blocks) == len(e1._block_holders) > 0
    assert all(a is b for a, b in zip(e1._block_holders, e4._block_holders))
    shared = _ptrs(e1) & _ptrs(e4)
    group_ptrs = {t.untyped_storage().data_ptr()
                  for h in e1._block_holders
                  for t in (h.arrays if isinstance(h.arrays, tuple)
                            else (h.arrays,))
                  if isinstance(t, torch.Tensor)}
    assert group_ptrs and group_ptrs <= shared
    # each engine's own dist buffer is its own
    assert e1._dist.data_ptr() != e4._dist.data_ptr()
    for s, eng in rungs_run(e1, e4):
        np.testing.assert_array_equal(
            eng, bfs_reference(src, dst, n, list(range(s))))
    del e1
    gc.collect()
    assert len(blocks) > 0                  # e4 still holds them
    del e4
    gc.collect()
    assert len(blocks) == 0


def test_a_to_2d_view_shares_its_parents_block_map():
    src, dst = _edges(n=300)
    g = shard_graph(src, dst, 300, 4)
    e1 = plan(g, BFSOptions(), mesh=LocalMesh.flat(4, "cpu")).compile()
    g2 = to_2d(g, 2, 2)
    assert g2.__dict__["_device_blocks"] is g.__dict__["_device_blocks"]
    e2 = plan(g2, BFSOptions(), mesh=LocalMesh.grid(2, 2, "cpu")).compile()
    names = sorted(k[2] for k in g.__dict__["_device_blocks"].map)
    assert names == ["edges_2d:packed", "edges_csr", "valid", "valid_2d"]
    del e1, e2
    gc.collect()
    assert len(g.__dict__["_device_blocks"]) == 0


def test_engines_of_two_devices_or_meshes_do_not_share():
    src, dst = _edges(n=300)
    g = shard_graph(src, dst, 300, 4)
    e1 = plan(g, BFSOptions(), mesh=LocalMesh.flat(4, "cpu")).compile()
    e2 = plan(g, BFSOptions(), mesh=LocalMesh((2, 2), ("a", "b"), "cpu"),
              axis=("a", "b")).compile()
    assert not set(map(id, e1._block_holders)) & set(
        map(id, e2._block_holders))


def test_concurrent_compiles_upload_each_group_once():
    src, dst = _edges(n=400)
    g = shard_graph(src, dst, 400, 4)
    mesh = LocalMesh.flat(4, "cpu")
    engines = []
    threads = [threading.Thread(target=lambda s=s: engines.append(
        plan(g, BFSOptions(mode="auto"), mesh=mesh,
             num_sources=s).compile())) for s in (1, 2, 3, 4, 5, 6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert len(engines) == 6
    assert len({tuple(map(id, e._block_holders)) for e in engines}) == 1


# ---------------------------------------------------------------------------
# EngineCache (the JAX package's cases, on the port)
# ---------------------------------------------------------------------------

def _graph(kind="erdos_renyi", n=200, seed=3, p=1, **kw):
    src, dst = generate(kind, n, seed=seed, **kw)
    return src, dst, shard_graph(src, dst, n, p)


def _plan(g, **fields):
    s = fields.pop("num_sources", 1)
    return plan(g, BFSOptions(mode="dense", **fields), num_sources=s,
                device="cpu")


def test_cache_hit_miss_counters_and_dedup():
    _, _, g = _graph(n=100)
    cache = EngineCache()
    p_a = _plan(g, max_levels=3)
    e1 = cache.get_or_compile(p_a)
    e2 = cache.get_or_compile(_plan(g, max_levels=3))
    assert e1 is e2
    st = cache.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (1, 1, 1)
    assert st["compile_s_total"] > 0 and st["hit_rate"] == 0.5
    assert p_a in cache and e1 in cache
    cache.get_or_compile(_plan(g, max_levels=4))
    assert cache.stats()["misses"] == 2 and len(cache) == 2


def test_cache_byte_budget_evicts_lru_first():
    _, _, g = _graph(n=100)
    plans = [_plan(g, max_levels=3 + i) for i in range(3)]
    unit = plans[0].estimated_device_bytes()
    assert all(p.estimated_device_bytes() == unit for p in plans)
    cache = EngineCache(max_device_bytes=2 * unit)
    cache.get_or_compile(plans[0])
    cache.get_or_compile(plans[1])
    assert cache.stats()["evictions"] == 0
    cache.get_or_compile(plans[0])
    cache.get_or_compile(plans[2])
    st = cache.stats()
    assert st["evictions"] == 1 and st["entries"] == 2
    assert st["device_bytes"] <= 2 * unit
    assert plans[0] in cache and plans[2] in cache
    assert plans[1] not in cache
    cache.get_or_compile(plans[1])
    assert cache.stats()["misses"] == 4


def test_cache_pinned_engine_survives_eviction():
    _, _, g = _graph(n=100)
    plans = [_plan(g, max_levels=3 + i) for i in range(3)]
    unit = plans[0].estimated_device_bytes()
    cache = EngineCache(max_device_bytes=2 * unit)
    cache.get_or_compile(plans[0], pin=True)
    cache.get_or_compile(plans[1])
    cache.get_or_compile(plans[2])
    assert plans[0] in cache and plans[1] not in cache
    st = cache.stats()
    assert st["evictions"] == 1 and st["pinned"] == 1
    assert cache.pin(plans[2]) is True
    assert cache.pin(plans[1]) is False
    cache.unpin(plans[2])
    cache.unpin(plans[0])
    cache.get_or_compile(_plan(g, max_levels=9))
    assert plans[0] not in cache


def test_cache_single_oversized_entry_is_kept():
    _, _, g = _graph(n=100)
    p_big = _plan(g, max_levels=3)
    cache = EngineCache(max_device_bytes=max(
        1, p_big.estimated_device_bytes() // 2))
    eng = cache.get_or_compile(p_big)
    assert eng is not None and p_big in cache
    cache.get_or_compile(_plan(g, max_levels=4))
    assert p_big not in cache


def test_cache_eviction_frees_the_engine_and_its_blocks():
    """An evicted engine that nothing else holds is dropped: its blocks
    leave the graph's weak map (the device memory frees)."""
    _, _, g = _graph(n=100)
    p_a, p_b = _plan(g, max_levels=3), _plan(g, max_levels=4)
    cache = EngineCache(max_entries=1)
    cache.get_or_compile(p_a)
    blocks = g.__dict__["_device_blocks"]
    holders = set(map(id, cache.get(p_a)._block_holders))
    cache.get_or_compile(p_b)                # p_a evicted, its blocks stay
    assert p_a not in cache and len(blocks) == len(holders)
    cache.clear()
    gc.collect()
    assert len(blocks) == 0


def test_cache_get_or_compile_coalesces_across_threads():
    _, _, g = _graph(n=150)
    cache = EngineCache()
    results, errors = [], []

    def worker():
        try:
            results.append(cache.get_or_compile(_plan(g, max_levels=4)))
        except Exception as exc:  # pragma: no cover - surfaced by assert
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 6
    assert all(r is results[0] for r in results)
    st = cache.stats()
    assert st["misses"] == 1 and st["hits"] == 5


def test_cache_counters_consistent_under_threaded_ladder_load():
    _, _, g = _graph(n=140)
    cache = EngineCache()
    ladder = (1, 2, 4)
    n_threads, per_thread = 8, 9
    engines, errors = {s: [] for s in ladder}, []

    def worker(tid):
        try:
            for k in range(per_thread):
                s = ladder[(tid + k) % len(ladder)]
                eng = cache.get_or_compile(_plan(g, num_sources=s))
                engines[s].append(eng)
        except Exception as exc:  # pragma: no cover - surfaced by assert
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    st = cache.stats()
    total = n_threads * per_thread
    assert st["misses"] == len(ladder)
    assert st["hits"] + st["misses"] == total
    assert st["entries"] == len(ladder) and st["compile_s_total"] > 0
    assert st["hit_rate"] == pytest.approx(st["hits"] / total)
    for s in ladder:
        assert engines[s] and all(e is engines[s][0] for e in engines[s])
    for s, p in plan_ladder(g, BFSOptions(mode="dense"), ladder=ladder,
                            device="cpu").items():
        assert cache.get(p) is engines[s][0]


def test_default_cache_env_and_swap(monkeypatch):
    cache = EngineCache(max_entries=2)
    with use_default_cache(cache):
        assert default_engine_cache() is cache
    assert default_engine_cache() is not cache
    monkeypatch.setenv("BFS_ENGINE_CACHE_ENTRIES", "3")
    monkeypatch.setenv("BFS_ENGINE_CACHE_MB", "1.5")
    prev = set_default_cache(None)
    try:
        env = default_engine_cache()
        assert env.max_entries == 3 and env.max_device_bytes == int(
            1.5 * 2**20)
        monkeypatch.setenv("BFS_ENGINE_CACHE_ENTRIES", "0")
        monkeypatch.setenv("BFS_ENGINE_CACHE_MB", "0")
        set_default_cache(None)
        unbounded = default_engine_cache()
        assert unbounded.max_entries is None
        assert unbounded.max_device_bytes is None
    finally:
        set_default_cache(prev)


def test_cache_rejects_bad_bounds():
    with pytest.raises(ValueError, match="max_device_bytes"):
        EngineCache(max_device_bytes=0)
    with pytest.raises(ValueError, match="max_entries"):
        EngineCache(max_entries=-1)


def test_graph_catalog_register_lookup_and_2d_reuse():
    _, _, g = _graph(n=90)
    cat = GraphCatalog()
    cat.register("er", g)
    assert "er" in cat and cat.get("er") is g
    assert cat.names() == ["er"] and len(cat) == 1
    cat.register("er", g)
    _, _, g2 = _graph(n=90, seed=11)
    with pytest.raises(ValueError, match="already registered"):
        cat.register("er", g2)
    with pytest.raises(KeyError, match="not registered"):
        cat.get("missing")
    with pytest.raises(ValueError, match="non-empty"):
        cat.register("", g2)
    assert cat.get_2d("er", 1, 1) is to_2d(g, 1, 1)
    cat.register("er2d", to_2d(g, 1, 1))
    assert cat.get_2d("er2d", 1, 1) is to_2d(g, 1, 1)
    with pytest.raises(ValueError, match="grid"):
        cat.get_2d("er2d", 2, 2)
    # one graph under two names is allowed (lanes share its engines)
    cat.register("er_alias", g)
    assert cat.get("er_alias") is cat.get("er")
    cat.unregister("er")
    assert "er" not in cat


def test_catalog_get_2d_engines_share_through_the_cache():
    """A 2-D lane's engines come from the object ``to_2d`` caches, so two
    lanes planned on ``get_2d`` share one engine a rung."""
    _, _, g = _graph(n=160, p=4)
    cat = GraphCatalog()
    cat.register("g", g)
    cache = EngineCache()
    mesh = LocalMesh.grid(2, 2, "cpu")
    e = [cache.get_or_compile(plan(cat.get_2d("g", 2, 2), BFSOptions(),
                                   mesh=mesh, num_sources=2))
         for _ in range(2)]
    assert e[0] is e[1] and cache.stats()["misses"] == 1
