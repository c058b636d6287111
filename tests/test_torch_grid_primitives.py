"""The port's 2-D partition pieces bitwise against the JAX package:
``Partition2D``, ``shard_graph_2d`` / ``to_2d`` / ``from_jax_arrays_2d``
and the bottom-up blocks, ``default_grid`` and ``LocalMesh.grid``, the
2-D frontier primitives (each JAX function run shard by shard against
the port's one batched call over the stacked shards), and
``bfs_reference_2d`` with its schedule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfr
from repro.core.partition import Partition2D as JPartition2D
from repro.core.ref import bfs_reference_2d as j_bfs_reference_2d
from repro.graphs import shard_graph as j_shard_graph
from repro.graphs import shard_graph_2d as j_shard_graph_2d
from repro.graphs import to_2d as j_to_2d
from repro.launch.mesh import default_grid as j_default_grid
from repro_torch.core import LocalMesh, Partition2D, default_grid
from repro_torch.core import frontier as fr
from repro_torch.core.ref import bfs_reference, bfs_reference_2d
from repro_torch.graphs import (from_jax_arrays_2d, generate, shard_graph,
                                shard_graph_2d, to_2d)

# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)

GRIDS = [(1, 1), (2, 2), (4, 1), (1, 4), (2, 3)]
GRAPHS = [("erdos_renyi", 301, {"avg_degree": 5.0}),
          ("star", 97, {}), ("rmat", 256, {"edge_factor": 8})]


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


@pytest.mark.parametrize("n", [1, 97, 301, 512])
@pytest.mark.parametrize("r,c", GRIDS)
def test_partition2d_matches_jax(n, r, c):
    t, j = Partition2D(n, r, c), JPartition2D(n, r, c)
    assert (t.p, t.shard_size, t.n, t.kind, t.row_block_size,
            t.fold_size) == (j.p, j.shard_size, j.n, j.kind,
                             j.row_block_size, j.fold_size)
    v = np.arange(t.n)
    np.testing.assert_array_equal(t.owner(v), j.owner(v))
    np.testing.assert_array_equal(t.local_id(v), j.local_id(v))
    np.testing.assert_array_equal(t.fold_index(v), j.fold_index(v))
    k = np.arange(t.p)
    np.testing.assert_array_equal(t.grid_row(k), j.grid_row(k))
    np.testing.assert_array_equal(t.grid_col(k), j.grid_col(k))
    assert [t.row_start(i) for i in range(r)] == \
        [j.row_start(i) for i in range(r)]
    assert (t.flat.n_logical, t.flat.p) == (j.flat.n_logical, j.flat.p)
    np.testing.assert_array_equal(t.valid_mask_local(), j.valid_mask_local())
    # torch tensors take the same maps
    np.testing.assert_array_equal(t.fold_index(torch.arange(t.n)).numpy(),
                                  j.fold_index(v))


def test_partition2d_rejects_empty_grids():
    for args in ((0, 2, 2), (8, 0, 2), (8, 2, 0)):
        with pytest.raises(ValueError, match="bad partition"):
            Partition2D(*args)


@pytest.mark.parametrize("kind,n,kw", GRAPHS)
@pytest.mark.parametrize("r,c", GRIDS)
def test_shard_graph_2d_and_bottom_up_blocks_bitwise(kind, n, kw, r, c):
    src, dst = generate(kind, n, seed=3, **kw)
    t, j = shard_graph_2d(src, dst, n, r, c), j_shard_graph_2d(src, dst, n,
                                                               r, c)
    for name in ("src_rowlocal", "dst_fold"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
        assert getattr(t, name).dtype == np.int32
    assert (t.e_cap, t.n_edges, t.p) == (j.e_cap, j.n_edges, j.p)
    for a, b in zip(t.edge_list(), j.edge_list()):
        np.testing.assert_array_equal(a, b)
    assert t.bottom_up_in_cap() == j.bottom_up_in_cap()
    assert "_bottom_up_blocks" not in t.__dict__     # only the cap so far
    for a, b in zip(t.bottom_up_blocks(), j.bottom_up_blocks()):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32
    assert t.in_e_cap == j.in_e_cap
    # fills: (0, -1) for the cell blocks, (-1, -1) for the in-edge blocks
    pad = t.dst_fold < 0
    assert (t.src_rowlocal[pad] == 0).all()
    in_pad = t.in_src_global < 0
    assert (t.in_dst_local[in_pad] == -1).all()
    # the cell-bucketed edge list is the input's edge multiset
    got = np.stack(t.edge_list(), 1)
    want = np.stack([src, dst], 1)
    np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])],
                                  want[np.lexsort(want.T[::-1])])
    assert t.fingerprint() == shard_graph_2d(src, dst, n, r, c).fingerprint()


def test_shard_graph_2d_rejects_out_of_range_edges():
    with pytest.raises(ValueError, match="endpoints"):
        shard_graph_2d(np.array([0, 9]), np.array([1, 2]), 9, 2, 2)


@pytest.mark.parametrize("r,c", [(2, 2), (4, 1), (1, 4)])
def test_to_2d_is_cached_and_equals_jax(r, c):
    src, dst = generate("rmat", 256, seed=1, edge_factor=8)
    g = shard_graph(src, dst, 256, r * c)
    g2 = to_2d(g, r, c)
    assert to_2d(g, r, c) is g2
    j2 = j_to_2d(j_shard_graph(src, dst, 256, r * c), r, c)
    for name in ("src_rowlocal", "dst_fold"):
        np.testing.assert_array_equal(getattr(g2, name), getattr(j2, name))
    with pytest.raises(ValueError, match="does not match"):
        to_2d(g, r * c, 2)
    carried = from_jax_arrays_2d(j2)
    assert (carried.part.r, carried.part.c) == (r, c)
    for a, b in zip(carried.bottom_up_blocks(), j2.bottom_up_blocks()):
        np.testing.assert_array_equal(a, b)
    assert carried.fingerprint() == g2.fingerprint()


@pytest.mark.parametrize("p", list(range(1, 17)) + [30, 64, 97])
def test_default_grid_matches_jax(p):
    assert default_grid(p) == j_default_grid(p)


@pytest.mark.parametrize("r,c", GRIDS)
def test_grid_mesh_puts_chunk_k_at_cell_k_div_c_k_mod_c(r, c):
    mesh = LocalMesh.grid(r, c, "cpu")
    k = torch.arange(r * c)
    assert mesh.axis_names == ("rows", "cols") and mesh.p == r * c
    assert torch.equal(mesh.axis_index("rows"), k // c)
    assert torch.equal(mesh.axis_index("cols"), k % c)
    # over both axes, major-first: chunk order
    assert torch.equal(mesh.axis_index(("rows", "cols")), k)


# ---------------------------------------------------------------------------
# frontier primitives: JAX shard by shard against one stacked port call
# ---------------------------------------------------------------------------

def _cells(kind, n, kw, r, c, s, density, seed):
    src, dst = generate(kind, n, seed=seed, **kw)
    g = j_shard_graph_2d(src, dst, n, r, c)
    part = g.part
    rng = np.random.default_rng(seed)
    frows = (rng.random((part.p, part.row_block_size, s))
             < density).astype(np.uint8)
    return g, part, frows


@pytest.mark.parametrize("r,c", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("s", [1, 3])
def test_expand_dense_2d_and_packed_bitwise_vs_jax(r, c, s):
    g, part, frows = _cells("rmat", 256, {"edge_factor": 8}, r, c, s, 0.2,
                            r + 7 * c + s)
    b, fold_len = part.shard_size, part.fold_size
    want = np.stack([np.asarray(jfr.expand_dense_2d(
        jnp.asarray(frows[k]), jnp.asarray(g.src_rowlocal[k]),
        jnp.asarray(g.dst_fold[k]), fold_len)) for k in range(part.p)])
    got = fr.expand_dense_2d(torch.from_numpy(frows),
                             torch.from_numpy(g.src_rowlocal),
                             torch.from_numpy(g.dst_fold), fold_len)
    assert got.dtype == torch.uint8 and got.shape == (part.p, fold_len, s)
    np.testing.assert_array_equal(got.numpy(), want)
    # packed: the row frontier as c gathered chunks of words
    words = np.stack([np.asarray(jfr.pack_bits(jnp.asarray(frows[k]),
                                               n_blocks=c))
                      for k in range(part.p)])
    want_p = np.stack([np.asarray(jfr.expand_dense_2d_packed(
        jnp.asarray(words[k]), jnp.asarray(g.src_rowlocal[k]),
        jnp.asarray(g.dst_fold[k]), fold_len, b)) for k in range(part.p)])
    tw = fr.pack_bits(torch.from_numpy(frows), n_blocks=c)
    np.testing.assert_array_equal(_u32(tw), words)
    got_p = fr.expand_dense_2d_packed(tw, torch.from_numpy(g.src_rowlocal),
                                      torch.from_numpy(g.dst_fold), fold_len,
                                      b)
    np.testing.assert_array_equal(got_p.numpy(), want_p)
    np.testing.assert_array_equal(got_p.numpy(), want)


def test_expand_dense_2d_fan_in_past_256_does_not_wrap():
    """300 frontier sources of one target in one cell: a max merge, never
    a uint8 sum."""
    part = Partition2D(1200, 2, 2)
    src_rowlocal = np.arange(300, dtype=np.int32)[None]
    dst_fold = np.full((1, 300), 5, np.int32)
    frow = np.ones((1, part.row_block_size, 1), np.uint8)
    got = fr.expand_dense_2d(torch.from_numpy(frow),
                             torch.from_numpy(src_rowlocal),
                             torch.from_numpy(dst_fold), part.fold_size)
    assert int(got[0, 5, 0]) == 1 and int(got.sum()) == 1


@pytest.mark.parametrize("shard,cap,frac", [
    (50, 8, 0.5), (50, 64, 0.5), (50, 20, 0.0), (50, 7, 1.0), (37, 37, 0.9),
    (300, 1024, 0.1)])
def test_pack_frontier_ids_bitwise_vs_jax(shard, cap, frac):
    rng = np.random.default_rng(shard + cap)
    front = (rng.random((3, shard, 1)) < frac).astype(np.uint8)
    got = fr.pack_frontier_ids(torch.from_numpy(front), cap)
    for k in range(3):
        want = jfr.pack_frontier_ids(jnp.asarray(front[k]), cap)
        for gt, w in zip(got, want):
            np.testing.assert_array_equal(gt[k].numpy(), np.asarray(w))
    assert got[0].dtype == torch.int32 and got[0].shape == (3, cap)


@pytest.mark.parametrize("c,shard,cap", [(1, 40, 8), (2, 40, 8), (4, 33, 50)])
def test_unpack_row_frontier_bitwise_vs_jax(c, shard, cap):
    rng = np.random.default_rng(c * shard)
    ids = rng.integers(-1, shard + 3, (3, c * cap)).astype(np.int32)
    got = fr.unpack_row_frontier(torch.from_numpy(ids), c, shard)
    assert got.shape == (3, c * shard, 1) and got.dtype == torch.uint8
    for k in range(3):
        want = jfr.unpack_row_frontier(jnp.asarray(ids[k]), c, shard)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want))
    # the round trip of pack_frontier_ids
    front = (rng.random((3 * c, shard, 1)) < 0.2).astype(np.uint8)
    packed = fr.pack_frontier_ids(torch.from_numpy(front), shard)[0]
    row = fr.unpack_row_frontier(packed.reshape(3, c * shard), c, shard)
    np.testing.assert_array_equal(row.numpy().reshape(-1),
                                  front.reshape(-1))


_j_buckets_2d = jax.jit(jfr.build_queue_buckets_2d,
                        static_argnames=("part2", "cap", "local_update",
                                         "dedupe"))


@pytest.mark.parametrize("dedupe", [True, False])
@pytest.mark.parametrize("local_update", [True, False])
@pytest.mark.parametrize("cap", [3, 64])
@pytest.mark.parametrize("r,c", [(2, 2), (4, 1), (1, 4)])
def test_build_queue_buckets_2d_bitwise_vs_jax(dedupe, local_update, cap, r,
                                               c):
    part2 = JPartition2D(301, r, c)
    tpart = Partition2D(301, r, c)
    rng = np.random.default_rng(cap + 2 * dedupe + local_update + 5 * r)
    e = 120
    dst = rng.integers(0, part2.fold_size, (part2.p, e)).astype(np.int32)
    dst[:, :10] = dst[:, 10:20]                       # duplicates
    dst[:, -3:] = part2.fold_size - 1                 # the top fold index
    active = rng.random((part2.p, e)) < 0.6
    me_row = np.arange(part2.p) // c
    got = fr.build_queue_buckets_2d(
        torch.from_numpy(dst), torch.from_numpy(active), tpart,
        torch.from_numpy(me_row), cap, local_update=local_update,
        dedupe=dedupe)
    assert got[0].shape == (part2.p, r, cap)
    overflowed = False
    for k in range(part2.p):
        want = _j_buckets_2d(jnp.asarray(dst[k]), jnp.asarray(active[k]),
                             part2, jnp.int32(me_row[k]), cap,
                             local_update=local_update, dedupe=dedupe)
        for gt, w in zip(got, want):
            np.testing.assert_array_equal(gt[k].numpy(), np.asarray(w))
        overflowed |= bool(want[3])
    if cap == 3 and r > 1:            # the escalation case is reached
        assert overflowed


# ---------------------------------------------------------------------------
# the 2-D host simulation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n,kw", GRAPHS + [("chain", 75, {})])
@pytest.mark.parametrize("r,c", [(2, 2), (4, 1), (1, 4)])
@pytest.mark.parametrize("mode,s,cap", [("dense", 3, 1024), ("queue", 1, 4),
                                        ("queue", 1, 1024), ("auto", 1, 4),
                                        ("auto", 3, 1024)])
def test_bfs_reference_2d_equals_jax_schedule_included(kind, n, kw, r, c,
                                                       mode, s, cap):
    src, dst = generate(kind, n, seed=5, **kw)
    sources = [0, 11, 40][:s]
    got = bfs_reference_2d(src, dst, n, sources, r, c, mode=mode,
                           queue_cap=cap, return_schedule=True)
    want = j_bfs_reference_2d(src, dst, n, sources, r, c, mode=mode,
                              queue_cap=cap, return_schedule=True)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], bfs_reference(src, dst, n,
                                                        sources))
