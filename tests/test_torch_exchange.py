"""Port exchange registry and LocalMesh collectives: byte models and plan-
time strategy resolution equal the JAX package's; every dense strategy
hands each owner the OR of all shards' slices, and every queue strategy
hands shard i row i of every shard's buffers."""

import itertools

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import exchange as jex
from repro_torch.core import engine as tengine
from repro_torch.core import exchange as ex
from repro_torch.core.mesh import LocalMesh, own_block

# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _registry(mod):
    return {k: (st.wire, st.bytes_model) for k, st in mod._REGISTRY.items()}


def test_registries_name_the_same_strategies_in_order():
    assert list(_registry(ex)) == list(_registry(jex))
    for key, (wire, _) in _registry(ex).items():
        assert wire == _registry(jex)[key][0], key
    for name in ("DENSE_STRATEGIES", "QUEUE_STRATEGIES",
                 "EXPAND_ROW_STRATEGIES", "FOLD_COL_STRATEGIES",
                 "EXPAND_ROW_SPARSE_STRATEGIES", "FOLD_COL_SPARSE_STRATEGIES"):
        assert tuple(getattr(ex, name)) == tuple(getattr(jex, name))


_DENSE_ARGS = [(n, p, s, isz, axes)
               for n, p in ((64, 1), (4096, 8), (1 << 20, 4), (100_000, 1),
                            (300, 4), (1000, 2))
               for s in (1, 64) for isz in (1, 4)
               for axes in ((), (p,), (2, max(1, p // 2)))]
_GRID_ARGS = [(n, r, c, s, isz) for n, r, c in ((64, 1, 1), (4096, 2, 4),
                                                (1000, 2, 2), (300, 4, 1))
              for s in (1, 8) for isz in (1, 4)]
_SPARSE_ARGS = [(p, cap, isz, dens) for p in (1, 2, 8)
                for cap in (1, 1024) for isz in (4,)
                for dens in (1.0, 0.01, 0.0, 4.0)]
_SPARSE_GRID_ARGS = [(r, c, cap, isz, dens) for r, c in ((1, 1), (2, 4))
                     for cap in (16, 1024) for isz in (4,)
                     for dens in (1.0, 0.02)]


@pytest.mark.parametrize("kind,args", [
    ("dense", _DENSE_ARGS), ("queue", _SPARSE_ARGS),
    ("expand_row", _GRID_ARGS), ("fold_col", _GRID_ARGS),
    ("expand_row_sparse", _SPARSE_GRID_ARGS),
    ("fold_col_sparse", _SPARSE_GRID_ARGS)])
def test_byte_models_equal_jax(kind, args):
    names = [n for k, n in ex._REGISTRY if k == kind]
    assert names
    for name, a in itertools.product(names, args):
        got = ex.get_exchange(kind, name).bytes_model(*a)
        want = jex.get_exchange(kind, name).bytes_model(*a)
        assert got == want, (kind, name, a)


def test_level_byte_helpers_equal_jax():
    for n, p, s in ((4096, 8, 2), (1000, 4, 64), (77, 1, 1)):
        for wire in ("bytes", "packed"):
            assert ex.bottomup_level_bytes(n, p, s, wire=wire) == \
                jex.bottomup_level_bytes(n, p, s, wire=wire)
        assert ex.dense_level_bytes("hierarchical", n, p, s, 1, (2, 2)) == \
            jex.dense_level_bytes("hierarchical", n, p, s, 1, (2, 2))
    assert ex.queue_level_bytes("alltoall_direct_compressed", 4, 1024, 4,
                                0.1) == jex.queue_level_bytes(
        "alltoall_direct_compressed", 4, 1024, 4, 0.1)
    assert ex.grid_level_bytes("allgather_packed", "alltoall_reduce", 4096,
                               2, 4, 3) == jex.grid_level_bytes(
        "allgather_packed", "alltoall_reduce", 4096, 2, 4, 3)
    assert ex.grid_sparse_level_bytes("allgather", "allgather_merge", 2, 4,
                                      64) == jex.grid_sparse_level_bytes(
        "allgather", "allgather_merge", 2, 4, 64)


@pytest.mark.parametrize("p,axes_sizes", [(1, (1,)), (2, (2,)), (4, (4,)),
                                          (4, (2, 2)), (8, (2, 4))])
@pytest.mark.parametrize("wire_format", ["auto", "bytes", "packed",
                                         "compressed"])
def test_strategy_and_wire_resolution_equal_jax(p, axes_sizes, wire_format):
    n = 1000 * p
    for s in (1, 64):
        for name in ["auto"] + list(ex.DENSE_STRATEGIES):
            args = (n, p, s, 1, axes_sizes)
            assert tengine._resolve_strategy(
                "dense", name, args, wire_format).name == \
                jengine._resolve_strategy("dense", name, args,
                                          wire_format).name
        for name in ["auto"] + list(ex.QUEUE_STRATEGIES):
            args = (p, 1024, 4, 1024 / (n // p))
            assert tengine._resolve_strategy(
                "queue", name, args, wire_format).name == \
                jengine._resolve_strategy("queue", name, args,
                                          wire_format).name
        assert tengine._resolve_bottom_up_wire(wire_format, n, p, s) == \
            jengine._resolve_bottom_up_wire(wire_format, n, p, s)
        for mode, sieve in itertools.product(("dense", "queue", "auto"),
                                             (True, False, "auto")):
            assert tengine._resolve_sieve(sieve, mode, p, s) == \
                jengine._resolve_sieve(sieve, mode, p, s)
    for fused, mode, wire in itertools.product(
            (False, "auto"), ("dense", "queue", "auto"), ("bytes", "packed")):
        assert tengine._resolve_fused_tail(fused, mode, wire) == \
            jengine._resolve_fused_tail(fused, mode, wire)


def test_explicit_twin_resolution_errors_match_jax():
    for mod, emod in ((tengine, ex), (jengine, jex)):
        emod.register_exchange("dense", "_solo", lambda *a: 1.0)(None)
        try:
            with pytest.raises(ValueError, match="no packed variant"):
                mod._resolve_strategy("dense", "_solo", (64, 2, 1, 1, (2,)),
                                      "packed")
            assert mod._resolve_strategy(
                "dense", "_solo", (64, 2, 1, 1, (2,)), "auto").name == "_solo"
        finally:
            emod.unregister_exchange("dense", "_solo")
        with pytest.raises(ValueError, match="packed wire"):
            mod._resolve_fused_tail(True, "dense", "bytes")


# ---------------------------------------------------------------------------
# LocalMesh collectives
# ---------------------------------------------------------------------------

def _stacked(rng, p, length, s, dtype=np.int64):
    return torch.from_numpy(rng.integers(0, 100, (p, length, s)).astype(dtype))


@pytest.mark.parametrize("shape,axis", [
    ((4,), "a"), ((2, 3), ("a", "b")), ((2, 3), "a"), ((2, 3), "b"),
    ((2, 3), ("b", "a")), ((2, 2, 2), ("a", "c"))])
def test_local_mesh_collectives_match_definitions(shape, axis):
    names = ("a", "b", "c")[:len(shape)]
    mesh = LocalMesh(shape, names, "cpu")
    rng = np.random.default_rng(len(shape))
    g = mesh.axis_size(axis)
    blk, s = 3, 2
    x = _stacked(rng, mesh.p, g * blk, s)
    coords = np.array(list(np.ndindex(*shape)))          # shard -> coords
    axes = mesh.axes(axis)
    dims = [names.index(a) for a in axes]

    def group_index(i):              # major-first over the given axes
        idx = 0
        for d in dims:
            idx = idx * shape[d] + coords[i][d]
        return idx

    def members(i):                  # shards of i's group, by group index
        out = {}
        for k in range(mesh.p):
            if all(coords[k][d] == coords[i][d]
                   for d in range(len(shape)) if d not in dims):
                out[group_index(k)] = k
        return [out[r] for r in range(g)]

    idx = mesh.axis_index(axis)
    a2a = mesh.all_to_all(x, axis)
    gat = mesh.all_gather(x, axis)
    rs = mesh.psum_scatter(x, axis)
    for i in range(mesh.p):
        me, group = group_index(i), members(i)
        assert int(idx[i]) == me
        for r, k in enumerate(group):
            assert torch.equal(a2a[i, r * blk:(r + 1) * blk],
                               x[k, me * blk:(me + 1) * blk])
            assert torch.equal(gat[i, r], x[k])
        want = sum(x[k, me * blk:(me + 1) * blk] for k in group)
        assert torch.equal(rs[i], want)
    owned = own_block(x, idx, blk)
    for i in range(mesh.p):
        k = int(idx[i])
        assert torch.equal(owned[i], x[i, k * blk:(k + 1) * blk])


def test_local_mesh_rejects_bad_axes():
    mesh = LocalMesh((2, 2), ("a", "b"), "cpu")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        mesh.axis_size("z")
    with pytest.raises(ValueError, match="repeated"):
        mesh.axes(("a", "a"))
    with pytest.raises(ValueError):
        LocalMesh((2,), ("a", "b"), "cpu")


@pytest.mark.parametrize("strategy", list(ex.DENSE_STRATEGIES))
@pytest.mark.parametrize("shape,shard", [((1,), 37), ((2,), 40), ((4,), 37),
                                         ((2, 2), 45), ((4,), 64)])
def test_dense_strategies_or_merge_owned_slices(strategy, shape, shard):
    names = ("a", "b")[:len(shape)]
    mesh = LocalMesh(shape, names, "cpu")
    p, s = mesh.p, 3
    n = p * shard
    rng = np.random.default_rng(shard + p)
    cand = torch.from_numpy((rng.random((p, n, s)) < 0.3).astype(np.uint8))
    own = ex.exchange_dense(cand, mesh, tuple(names), strategy)
    want = cand.amax(dim=0).reshape(p, shard, s)
    assert own.dtype == cand.dtype
    assert torch.equal(own, want), strategy


def test_not_ported_strategies_raise_with_roadmap_item():
    """The 2-D strategies this test once held to their placeholder now
    route blocks to their owners on a 2 x 2 grid: the compressed sparse
    expand gathers the grid row's payloads, the fold sends block ``rr``
    of each column cell to row rank ``rr`` and max-merges there."""
    mesh = LocalMesh((2, 2), ("rows", "cols"), "cpu")
    pay = torch.arange(4 * 5, dtype=torch.uint8).reshape(4, 5)
    st = ex.get_exchange("expand_row_sparse", "allgather_compressed")
    got = st.impl(pay, mesh, "cols")
    for k in range(4):
        row = k // 2
        assert torch.equal(got[k], pay[2 * row: 2 * row + 2].reshape(-1))
    cand = torch.randint(0, 2, (4, 2 * 3, 2), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0))
    own = ex.get_exchange("fold_col", "alltoall_reduce").impl(cand, mesh,
                                                              "rows")
    for k in range(4):
        rr, col = k // 2, k % 2
        want = torch.maximum(cand[col, 3 * rr:3 * rr + 3],
                             cand[2 + col, 3 * rr:3 * rr + 3])
        assert torch.equal(own[k], want)


@pytest.mark.parametrize("strategy", list(ex.QUEUE_STRATEGIES))
@pytest.mark.parametrize("shape", [(1,), (2,), (4,), (2, 2)])
def test_queue_strategies_route_rows_to_owners(strategy, shape):
    """Shard i receives row i of every shard's (p, cap) buffers: JAX's
    tiled all_to_all for the direct strategies, the all_gather plus own
    row for the merge ones; id buffers and compressed payloads alike."""
    names = ("a", "b")[:len(shape)]
    mesh = LocalMesh(shape, names, "cpu")
    p = mesh.p
    st = ex.get_exchange("queue", strategy)
    rng = np.random.default_rng(p)
    if st.wire == "compressed":
        x = torch.from_numpy(rng.integers(0, 256, (p, p, 9)).astype(np.uint8))
    else:
        x = torch.from_numpy(rng.integers(-1, 1000, (p, p, 5)).astype(
            np.int32))
    got = ex.exchange_queue(x, mesh, tuple(names), strategy)
    assert got.dtype == x.dtype
    assert torch.equal(got, x.transpose(0, 1)), strategy
    with pytest.raises(ValueError, match="buckets a shard"):
        ex.exchange_queue(torch.cat([x, x], 1), mesh, tuple(names), strategy)


@pytest.mark.parametrize("shape", [(1,), (3,), (2, 2)])
def test_allgather_frontier_replicates_every_shard(shape):
    names = ("a", "b")[:len(shape)]
    mesh = LocalMesh(shape, names, "cpu")
    f = torch.arange(mesh.p * 5 * 2, dtype=torch.int32).reshape(mesh.p, 5, 2)
    got = ex.allgather_frontier(f, mesh, tuple(names))
    assert got.shape == (mesh.p, mesh.p * 5, 2)
    for i in range(mesh.p):
        assert torch.equal(got[i], f.reshape(-1, 2))


def test_registry_register_select_unregister():
    @ex.register_exchange("dense", "_test_free", lambda *a: -1.0)
    def _impl(cand, mesh, axis):
        return cand
    try:
        assert ex.select_exchange("dense", 64, 2, 1, 1, (2,)).name == \
            "_test_free"
        assert "_test_free" in ex.DENSE_STRATEGIES
        assert ex.select_exchange("dense", 64, 2, 1, 1, (2,),
                                  wire="packed").wire == "packed"
    finally:
        ex.unregister_exchange("dense", "_test_free")
    assert "_test_free" not in ex.DENSE_STRATEGIES
    with pytest.raises(ValueError, match="registered"):
        ex.get_exchange("dense", "_test_free")
    with pytest.raises(ValueError, match="unknown exchange kind"):
        ex.get_exchange("nope", "x")
    with pytest.raises(ValueError, match="wire format"):
        ex.register_exchange("dense", "x", lambda *a: 0, wire="zip")
