"""Port graph inputs (repro_torch.graphs, core.partition, configs) against
the JAX package: the same seeds give the same arrays, bitwise."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs.base import BFS_WORKLOADS as J_WORKLOADS
from repro.core.partition import Partition1D as JPartition1D
from repro.graphs import generators as jgen
from repro.graphs import shard_graph as j_shard_graph
from repro.graphs.formats import block_sparse_adjacency as j_bsa
from repro_torch.configs import BFS_WORKLOADS, bfs_workload
from repro_torch.core.partition import Partition1D
from repro_torch.graphs import generators as tgen
from repro_torch.graphs.formats import (block_sparse_adjacency,
                                        from_jax_arrays, shard_graph)
from repro_torch.kernels.bsr_spmm.ref import unpack_bit_tiles

GRAPHS = [("star", 97, {}), ("chain", 75, {}),
          ("erdos_renyi", 301, {"avg_degree": 6.0}),
          ("er", 200, {"avg_degree": 3.0}),
          ("small_world", 301, {"k": 6, "beta": 0.2}),
          ("sw", 150, {}),
          ("rmat", 301, {"edge_factor": 8})]


@pytest.mark.parametrize("kind,n,kw", GRAPHS)
@pytest.mark.parametrize("seed", [0, 7])
def test_generators_bitwise(kind, n, kw, seed):
    ts, td = tgen.generate(kind, n, seed=seed, **kw)
    js, jd = jgen.generate(kind, n, seed=seed, **kw)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_array_equal(td, jd)
    assert ts.dtype == js.dtype


def test_batched_molecules_bitwise():
    t = tgen.batched_molecules(9, 20, 3, 4, seed=2)
    j = jgen.batched_molecules(9, 20, 3, 4, seed=2)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,p", [(1, 1), (97, 4), (128, 2), (301, 4), (5, 8)])
def test_partition_matches_jax(n, p):
    t, j = Partition1D(n, p), JPartition1D(n, p)
    assert (t.shard_size, t.n, t.kind) == (j.shard_size, j.n, j.kind)
    v = np.arange(t.n)
    np.testing.assert_array_equal(t.owner(v), j.owner(v))
    np.testing.assert_array_equal(t.local_id(v), j.local_id(v))
    np.testing.assert_array_equal(t.valid_mask_local(), j.valid_mask_local())
    for k in range(p):
        assert t.shard_logical_slice(k) == j.shard_logical_slice(k)
    with pytest.raises(ValueError):
        Partition1D(0, p)


@pytest.mark.parametrize("kind,n,kw", GRAPHS[:3] + GRAPHS[-1:])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_shard_graph_and_bsr_shards_bitwise(kind, n, kw, p):
    src, dst = tgen.generate(kind, n, seed=3, **kw)
    tg, jg = shard_graph(src, dst, n, p), j_shard_graph(src, dst, n, p)
    for f in ("src_local", "dst_global", "in_src_global", "in_dst_local"):
        np.testing.assert_array_equal(getattr(tg, f), getattr(jg, f))
        assert getattr(tg, f).dtype == getattr(jg, f).dtype
    assert tg.n_edges == jg.n_edges
    np.testing.assert_array_equal(tg.degrees(), jg.degrees())
    for a, b in zip(tg.edge_list(), jg.edge_list()):
        np.testing.assert_array_equal(a, b)
    assert tg.fingerprint() == jg.fingerprint()
    assert tg.bsr_shard_caps() == jg.bsr_shard_caps()
    tb = tg.bsr_shards(block=32)
    jb = jg.bsr_shards(block=32)
    for a, b in zip(tb[:3], jb[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
    assert tb[3:] == jb[3:]
    # the carried-across container is the same graph
    cg = from_jax_arrays(jg)
    assert cg.fingerprint() == jg.fingerprint()
    np.testing.assert_array_equal(cg.flat()[1], np.concatenate(
        [jg.dst_global[j] for j in range(p)]))


def test_bsr_shards_pad_tiles_repeat_last_row():
    """Uneven shards (a star's hub shard holds most tiles): pad tiles are
    zero and repeat the last block row."""
    n, p = 700, 4
    src, dst = tgen.generate("star", n)
    tg = shard_graph(src, dst, n, p)
    blocks, br, _, _, _ = tg.bsr_shards(block=64)
    nonempty = blocks.reshape(p, blocks.shape[1], -1).amax(dim=2) > 0
    assert not bool(nonempty.all())          # some shard carries pad tiles
    for j in range(p):
        k = int(nonempty[j].sum())
        assert bool((br[j, k:] == br[j, k - 1]).all())
        assert bool((br[j, 1:] >= br[j, :-1]).all())


def test_block_sparse_adjacency_bitwise():
    src, dst = tgen.generate("small_world", 300, seed=1, k=4, beta=0.3)
    for a, b in zip(block_sparse_adjacency(src, dst, 300, 64),
                    j_bsa(src, dst, 300, 64)):
        np.testing.assert_array_equal(a, b)


def test_shard_graph_rejects_out_of_range_edges():
    with pytest.raises(ValueError):
        shard_graph(np.array([0, 5]), np.array([1, 2]), 5, 1)


def test_to_device_uploads_int32_blocks():
    src, dst = tgen.generate("chain", 40)
    g = shard_graph(src, dst, 40, 2)
    dev = g.to_device("cpu")
    assert set(dev) == {"src_local", "dst_global", "in_src_global",
                        "in_dst_local"}
    np.testing.assert_array_equal(dev["dst_global"].numpy(), g.dst_global)


def test_bfs_workloads_match_jax():
    assert [dataclasses.astuple(w) for w in BFS_WORKLOADS] == \
        [dataclasses.astuple(w) for w in J_WORKLOADS]
    assert bfs_workload("rmat_1m").n_vertices == 1 << 20
    with pytest.raises(KeyError):
        bfs_workload("nope")


@pytest.mark.parametrize("graph", ["rmat_dups", "star"])
@pytest.mark.parametrize("p", [1, 2, 4])
def test_bsr_bit_shards_unpack_to_the_jax_f32_tiles(graph, p):
    """The one-bit tiles at block 128, unpacked, are the JAX package's f32
    tiles bitwise: with every third edge repeated (a bit set twice stays
    one bit), and on a star, whose uneven shards carry all-zero pad
    tiles."""
    if graph == "rmat_dups":
        n = 700
        src, dst = tgen.generate("rmat", n, seed=5, edge_factor=8)
        src, dst = np.concatenate([src, src[::3]]), np.concatenate(
            [dst, dst[::3]])
    else:
        n = 700
        src, dst = tgen.generate("star", n)
    tg, jg = shard_graph(src, dst, n, p), j_shard_graph(src, dst, n, p)
    bits, cmask, br, bc, row_pad, col_pad = tg.bsr_bit_shards()
    jblocks, jbr, jbc, jrow_pad, jcol_pad = jg.bsr_shards(block=128)
    assert bits.dtype == cmask.dtype == torch.int32
    assert bits.shape == (*jblocks.shape[:2], 128, 4)
    np.testing.assert_array_equal(unpack_bit_tiles(bits).numpy(), jblocks)
    np.testing.assert_array_equal(br.numpy(), jbr)
    np.testing.assert_array_equal(bc.numpy(), jbc)
    assert (row_pad, col_pad) == (jrow_pad, jcol_pad)
    # column masks: bit c of word w where column 32 w + c holds an edge
    cols_used = jblocks.max(axis=2) > 0                  # (p, K, 128)
    want = np.zeros(cmask.shape, np.uint32)
    for c in range(128):
        want[..., c // 32] |= cols_used[..., c].astype(np.uint32) << (c % 32)
    np.testing.assert_array_equal(cmask.numpy().view(np.uint32), want)
    if graph == "star" and p > 1:
        assert not cols_used.any(axis=2).all()          # pad tiles exist
