"""Kernels A1-A3, the engine's bit-tile expansion (``bsr_expand_bits``)
and its default edge-list expansion (``expand_dense``): their plain torch
versions bitwise against the JAX kernels (or the JAX expansion) on the
CPU, and the wrappers' dispatch and checks.  The
CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.frontier import expand_dense as j_expand_dense
from repro.core.frontier import pack_bits as j_pack_bits
from repro.kernels.bsr_spmm import ops as j_ops
from repro.kernels.bsr_spmm.kernel import bitpack_words as j_bitpack_words
from repro.kernels.bsr_spmm.ref import bsr_spmm_ref as j_bsr_spmm_ref
from repro.kernels.fold_update import fold_update as j_fold_update
from repro_torch.core import BFSOptions, plan, spans
from repro_torch.core.frontier import (INF, dense_edge_index,
                                       expand_dense_edges, pack_bits,
                                       packed_words)
from repro_torch.graphs import shard_graph
from repro_torch.kernels.bsr_spmm import ops
from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                 bitpack_words_plain,
                                                 block_row_ptr,
                                                 bsr_expand_bits, bsr_spmm)
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref, unpack_bit_tiles
from repro_torch.kernels.expand_dense import (edge_csr, expand_dense,
                                              expand_dense_plain)
from repro_torch.kernels.fold_update import fold_update

# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _fold_inputs(rng, lead, m, s):
    w = packed_words(m)
    raw = rng.integers(0, 2 ** 32, (*lead, w, s), dtype=np.uint64)
    raw = raw.astype(np.uint32)
    if m % 32:                                    # pad bits are zero
        raw[..., -1, :] &= np.uint32((1 << (m % 32)) - 1)
    dist = np.where(rng.random((*lead, m, s)) < 0.5, INF,
                    rng.integers(0, 9, (*lead, m, s))).astype(np.int32)
    return raw, dist


def _u32(t):
    return t.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# A1 fold_update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,s", [(1, 1), (32, 2), (37, 3), (100, 1),
                                 (64, 5)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_fold_update_plain_bitwise_vs_jax(m, s, use_pallas):
    rng = np.random.default_rng(m * 10 + s)
    raw, dist = _fold_inputs(rng, (), m, s)
    jd, jn, jw = j_fold_update(jnp.asarray(raw), jnp.asarray(dist), 5,
                               use_pallas=use_pallas)
    words = torch.from_numpy(raw.view(np.int32).copy())
    before = fold_update.launches
    td, tn, tw = fold_update(words, torch.from_numpy(dist), 5)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(_u32(tw), np.asarray(jw))
    assert fold_update.launches == before        # CPU: plain version only


def test_fold_update_batched_and_inplace():
    rng = np.random.default_rng(3)
    raw, dist = _fold_inputs(rng, (3,), 45, 2)
    words = torch.from_numpy(raw.view(np.int32).copy())
    d0 = torch.from_numpy(dist.copy())
    out = fold_update(words, d0, 2)
    for k in range(3):
        jd, jn, jw = j_fold_update(jnp.asarray(raw[k]), jnp.asarray(dist[k]),
                                   2, use_pallas=False)
        np.testing.assert_array_equal(out[0][k].numpy(), np.asarray(jd))
        np.testing.assert_array_equal(out[1][k].numpy(), np.asarray(jn))
        np.testing.assert_array_equal(_u32(out[2][k]), np.asarray(jw))
    assert torch.equal(d0, torch.from_numpy(dist))       # not in place
    d2, new, nwords = fold_update(words, d0, 2, inplace=True)
    assert d2 is d0 and torch.equal(d0, out[0])
    assert torch.equal(nwords, pack_bits(new))


def test_fold_update_checks_shapes():
    words = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="packed_words"):
        fold_update(words, torch.zeros((100, 3), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="batch"):
        fold_update(words, torch.zeros((40, 4), dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="int32"):
        fold_update(words.float(), torch.zeros((40, 3), dtype=torch.int32), 1)


# ---------------------------------------------------------------------------
# A2 bsr_spmm and A3 bitpack_words
# ---------------------------------------------------------------------------

def _bsr_case(rng, binary: bool, block: int = 32):
    """4 block rows x 3 block cols; block row 1 has no tile (empty row) and
    the tile list ends with two all-zero pad tiles repeating the last
    block row, as a padded shard's list does."""
    rows = np.array([0, 0, 2, 3, 3, 3, 3], np.int32)
    cols = np.array([0, 2, 1, 0, 2, 0, 0], np.int32)
    k = rows.size
    if binary:
        blocks = (rng.random((k, block, block)) < 0.1).astype(np.float32)
        x = (rng.random((3 * block, 5)) < 0.3).astype(np.float32)
    else:
        blocks = rng.standard_normal((k, block, block)).astype(np.float32)
        x = rng.standard_normal((3 * block, 5)).astype(np.float32)
    blocks[-2:] = 0.0
    return blocks, rows, cols, x, 4 * block


@pytest.mark.parametrize("binary", [True, False])
def test_bsr_spmm_plain_vs_jax_ref_with_empty_row_and_pad_tiles(binary):
    rng = np.random.default_rng(int(binary))
    blocks, rows, cols, x, n_rows_pad = _bsr_case(rng, binary)
    want = np.asarray(j_bsr_spmm_ref(jnp.asarray(blocks), jnp.asarray(rows),
                                     jnp.asarray(cols), jnp.asarray(x),
                                     n_rows_pad=n_rows_pad))
    tb, tr, tc, tx = map(torch.from_numpy, (blocks, rows, cols, x))
    before = bsr_spmm.launches
    ref = bsr_spmm_ref(tb, tr, tc, tx, n_rows_pad=n_rows_pad)
    got = bsr_spmm(tb, block_row_ptr(tr, tc, 4, 3), tc, tx,
                   n_rows_pad=n_rows_pad, block=32)
    assert torch.equal(got, ref)
    assert not bool(ref[32:64].any())            # the empty block row
    if binary:                                   # integer sums: exact
        np.testing.assert_array_equal(ref.numpy(), want)
    else:
        # f32 sums of 32-64 products in another order than jnp's einsum
        np.testing.assert_allclose(ref.numpy(), want, rtol=1e-5, atol=1e-4)
    assert bsr_spmm.launches == before


def test_frontier_expand_ops_vs_jax():
    rng = np.random.default_rng(5)
    blocks, rows, cols, x, n_rows_pad = _bsr_case(rng, True)
    tb, tr, tc = map(torch.from_numpy, (blocks, rows, cols))
    f = torch.from_numpy(x.astype(np.uint8))
    y = np.asarray(j_bsr_spmm_ref(jnp.asarray(blocks), jnp.asarray(rows),
                                  jnp.asarray(cols), jnp.asarray(x),
                                  n_rows_pad=n_rows_pad))
    cand = ops.frontier_expand(tb, tr, tc, f, n_rows_pad=n_rows_pad, block=32)
    np.testing.assert_array_equal(cand.numpy(), (y > 0).astype(np.uint8))
    for n_valid, n_blocks in ((128, 2), (96, 3), (90, 2)):  # 64/32 aligned, 45 not
        got = ops.frontier_expand_packed(tb, tr, tc, f, n_rows_pad=n_rows_pad,
                                         n_valid=n_valid, n_blocks=n_blocks,
                                         block=32)
        want = j_pack_bits(jnp.asarray((y[:n_valid] > 0).astype(np.uint8)),
                           n_blocks)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    np.testing.assert_array_equal(
        ops.spmm_reference(tb, tr, tc, torch.from_numpy(x),
                           n_rows_pad=n_rows_pad).numpy(), y)


@pytest.mark.parametrize("w,s", [(1, 1), (3, 4), (8, 2)])
def test_bitpack_plain_vs_jax_interpret(w, s):
    rng = np.random.default_rng(w * 7 + s)
    mask = (rng.random((32 * w, s)) < 0.5).astype(np.float32) * \
        rng.integers(1, 4, (32 * w, s)).astype(np.float32)
    mask[31] = 2.0                                # bit 31 set everywhere
    want = np.asarray(j_bitpack_words(jnp.asarray(mask), interpret=True))
    before = bitpack_words.launches
    got = bitpack_words(torch.from_numpy(mask))
    np.testing.assert_array_equal(_u32(got), want)
    assert torch.equal(got, bitpack_words_plain(torch.from_numpy(mask)))
    assert bitpack_words.launches == before


def test_spmm_wrappers_check_inputs():
    tb = torch.zeros((2, 32, 32))
    tr = torch.tensor([0, 1], dtype=torch.int32)
    tc = torch.tensor([0, 0], dtype=torch.int32)
    x = torch.zeros((32, 3))
    with pytest.raises(ValueError, match="aligned"):
        bsr_spmm(tb, block_row_ptr(tr, tc, 2, 1), tc, x, n_rows_pad=64)
    with pytest.raises(ValueError, match="do not match"):
        bsr_spmm(tb, block_row_ptr(tr, tc, 3, 1), tc, x, n_rows_pad=64,
                 block=32)
    with pytest.raises(ValueError, match="sorted"):
        block_row_ptr(tr.flip(0), tc, 2, 1)
    with pytest.raises(ValueError, match="block rows outside"):
        block_row_ptr(tr, tc, 1, 1)
    with pytest.raises(ValueError, match="block cols outside"):
        block_row_ptr(tr, tc + 1, 2, 1)
    with pytest.raises(ValueError, match="32-aligned"):
        bitpack_words(torch.zeros((33, 2)))
    assert block_row_ptr(tr, tc, 4, 1).tolist() == [0, 1, 2, 2, 2]


# ---------------------------------------------------------------------------
# bsr_expand_bits: the engine's one-bit boolean expansion
# ---------------------------------------------------------------------------

def _bit_tiles(blocks: torch.Tensor):
    """``(K, 128, 128)`` 0/1 tiles ``[row, col]`` as ``bsr_bit_shards``
    lays them out: ``(K, 128, 4)`` column words and the ``(K, 4)`` column
    mask."""
    bits = pack_bits(blocks).transpose(1, 2).contiguous()      # (K, col, 4)
    cmask = pack_bits((blocks.amax(dim=1) > 0)[..., None])[..., 0]
    return bits, cmask


def _bit_case(rng, s: int, zero_frontier: bool = False):
    """``_bsr_case``'s layout at block 128: 4 block rows x 3 block cols,
    block row 1 empty, two all-zero pad tiles repeating the last row."""
    rows = np.array([0, 0, 2, 3, 3, 3, 3], np.int32)
    cols = np.array([0, 2, 1, 0, 2, 0, 0], np.int32)
    blocks = (rng.random((rows.size, 128, 128)) < 0.02).astype(np.float32)
    blocks[-2:] = 0.0
    x = (rng.random((384, s)) < 0.3).astype(np.uint8)
    if zero_frontier:
        x[:] = 0
    return blocks, rows, cols, x


def test_bit_tiles_round_trip():
    blocks = torch.from_numpy(_bit_case(np.random.default_rng(0), 1)[0])
    bits, cmask = _bit_tiles(blocks)
    assert bits.shape == (7, 128, 4) and cmask.shape == (7, 4)
    assert torch.equal(unpack_bit_tiles(bits), blocks)
    assert not bool(cmask[-2:].any())            # pad tiles: empty mask


# (n_valid, n_blocks): one aligned segment, four aligned ones, segments of
# 125 and 150 rows (a word straddles each boundary), and of 16 (< 32)
LAYOUTS = [(512, 1), (512, 4), (500, 4), (450, 3), (96, 6)]


@pytest.mark.parametrize("s", [1, 4, 64])
@pytest.mark.parametrize("n_valid,n_blocks", LAYOUTS)
def test_bsr_expand_bits_plain_vs_jax_ops(s, n_valid, n_blocks):
    rng = np.random.default_rng(s * 100 + n_valid + n_blocks)
    blocks, rows, cols, x = _bit_case(rng, s)
    want = np.asarray(j_ops.frontier_expand_packed(
        jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(x), n_rows_pad=512, n_valid=n_valid, n_blocks=n_blocks,
        interpret=True))
    bits, cmask = _bit_tiles(torch.from_numpy(blocks))
    tc = torch.from_numpy(cols)
    fwords = pack_bits(torch.from_numpy(x))
    before = bsr_expand_bits.launches
    tr = torch.from_numpy(rows)
    got = bsr_expand_bits(bits, cmask, block_row_ptr(tr, tc, 4, 3), tr, tc,
                          fwords, n_valid=n_valid, n_blocks=n_blocks)
    assert got.shape == (n_blocks * packed_words(n_valid // n_blocks), s)
    np.testing.assert_array_equal(_u32(got), want)
    assert bsr_expand_bits.launches == before    # CPU: plain version only


@pytest.mark.parametrize("n_valid,n_blocks", [(512, 4), (450, 3)])
def test_bsr_expand_bits_all_zero_frontier(n_valid, n_blocks):
    blocks, rows, cols, x = _bit_case(np.random.default_rng(1), 4,
                                      zero_frontier=True)
    bits, cmask = _bit_tiles(torch.from_numpy(blocks))
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)
    got = bsr_expand_bits(bits, cmask, block_row_ptr(tr, tc, 4, 3), tr, tc,
                          pack_bits(torch.from_numpy(x)), n_valid=n_valid,
                          n_blocks=n_blocks)
    want = np.asarray(j_ops.frontier_expand_packed(
        jnp.asarray(blocks), jnp.asarray(rows), jnp.asarray(cols),
        jnp.asarray(x), n_rows_pad=512, n_valid=n_valid, n_blocks=n_blocks,
        interpret=True))
    assert not bool(got.any())
    np.testing.assert_array_equal(_u32(got), want)


@pytest.mark.parametrize("n_valid,n_blocks", [(256, 2), (200, 4)])
def test_bsr_expand_bits_groups_are_packed_apart(n_valid, n_blocks):
    """Two groups of two block rows (the engine's stacked shards): each
    group's first n_valid rows pack on their own, as the JAX package packs
    each shard's candidates."""
    rng = np.random.default_rng(n_valid)
    blocks, rows, cols, x = _bit_case(rng, 3)
    y = np.asarray(j_bsr_spmm_ref(jnp.asarray(blocks), jnp.asarray(rows),
                                  jnp.asarray(cols),
                                  jnp.asarray(x, dtype=jnp.float32),
                                  n_rows_pad=512)).reshape(2, 256, 3)
    want = np.concatenate([np.asarray(j_pack_bits(
        jnp.asarray((y[g, :n_valid] > 0).astype(np.uint8)), n_blocks))
        for g in range(2)])
    bits, cmask = _bit_tiles(torch.from_numpy(blocks))
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)
    got = bsr_expand_bits(bits, cmask, block_row_ptr(tr, tc, 4, 3), tr, tc,
                          pack_bits(torch.from_numpy(x)), n_valid=n_valid,
                          n_blocks=n_blocks, rows_per_group=256)
    np.testing.assert_array_equal(_u32(got), want)


def test_bsr_expand_bits_checks_inputs():
    blocks, rows, cols, x = _bit_case(np.random.default_rng(2), 2)
    bits, cmask = _bit_tiles(torch.from_numpy(blocks))
    tr, tc = torch.from_numpy(rows), torch.from_numpy(cols)
    rp = block_row_ptr(tr, tc, 4, 3)
    fw = pack_bits(torch.from_numpy(x))
    ok = dict(n_valid=512, n_blocks=4)
    with pytest.raises(ValueError, match="int32"):
        bsr_expand_bits(bits.float(), cmask, rp, tr, tc, fw, **ok)
    with pytest.raises(ValueError, match="int32"):
        bsr_expand_bits(bits, cmask, rp, tr, tc.long(), fw, **ok)
    with pytest.raises(ValueError, match="128-wide"):
        bsr_expand_bits(bits[:, :64], cmask, rp, tr, tc, fw, **ok)
    with pytest.raises(ValueError, match="128-wide"):
        bsr_expand_bits(bits, cmask[:-1], rp, tr, tc, fw, **ok)
    with pytest.raises(ValueError, match="whole"):
        bsr_expand_bits(bits, cmask, rp, tr, tc, fw[:-1], **ok)
    with pytest.raises(ValueError, match="whole"):
        bsr_expand_bits(bits, cmask, rp, tr, tc, fw[:0], **ok)
    with pytest.raises(ValueError, match="128-wide"):
        bsr_expand_bits(bits, cmask, rp, rp, tc, fw, **ok)
    with pytest.raises(ValueError, match="int32"):
        bsr_expand_bits(bits, cmask, rp, tr.long(), tc, fw, **ok)
    for bad in (dict(n_valid=513, n_blocks=1), dict(n_valid=510, n_blocks=4),
                dict(n_valid=256, n_blocks=1, rows_per_group=192)):
        with pytest.raises(ValueError, match="blocked layout"):
            bsr_expand_bits(bits, cmask, rp, tr, tc, fw, **bad)


# ---------------------------------------------------------------------------
# expand_dense: the default engine's edge-list expansion
# ---------------------------------------------------------------------------

def _hub_graph(p: int, seed: int = 0):
    """601 vertices (padding vertices at p = 4), the last 50 isolated; a
    hub with 300 out-edges (vertex 5) and one with 300 in-edges (vertex
    7); the shards' padded blocks carry padding edges."""
    rng = np.random.default_rng(seed)
    n_logical, live = 601, 551
    src = [rng.integers(0, live, 1500), np.full(300, 5),
           rng.choice(live, 300, replace=False)]
    dst = [rng.integers(0, live, 1500), rng.choice(live, 300, replace=False),
           np.full(300, 7)]
    g = shard_graph(np.concatenate(src).astype(np.int32),
                    np.concatenate(dst).astype(np.int32), n_logical, p)
    assert (g.dst_global < 0).any()                  # padding edges
    return g


def _frontier(rng, kind: str, p: int, shard: int, s: int, n_logical: int):
    if kind == "empty":
        f = np.zeros((p, shard, s), np.uint8)
    elif kind == "full":
        f = np.ones((p, shard, s), np.uint8)
    else:                  # random, with the two hubs in some columns
        f = (rng.random((p, shard, s)) < 0.1).astype(np.uint8)
        f.reshape(-1, s)[5, ::2] = 1
        f.reshape(-1, s)[rng.integers(0, n_logical, 8), 1::3] = 1
    f.reshape(-1, s)[n_logical:] = 0                 # padding vertices
    return f


@pytest.mark.parametrize("kind", ["random", "empty", "full"])
@pytest.mark.parametrize("p", [1, 4])
@pytest.mark.parametrize("s", [1, 3, 64, 100])
def test_expand_dense_plain_bitwise_vs_jax(kind, p, s):
    """The CSR and the dispatcher's plain version: bitwise the gather and
    scatter-max over ``dense_edge_index`` rows and JAX's expansion, each
    packed per owner block; the edges-read count is the out-degree of the
    sources in some column's frontier."""
    g = _hub_graph(p)
    shard, n = g.part.shard_size, g.part.n
    f = _frontier(np.random.default_rng(s), kind, p, shard, s,
                  g.part.n_logical)
    src_l, dst_g = torch.from_numpy(g.src_local), torch.from_numpy(g.dst_global)
    row_ptr, dst = edge_csr(src_l, dst_g, shard)
    # the CSR: each shard's valid edges stably sorted by source
    for j in range(p):
        valid = g.dst_global[j] >= 0
        order = np.argsort(g.src_local[j][valid], kind="stable")
        lo, hi = int(row_ptr[j * shard]), int(row_ptr[(j + 1) * shard])
        np.testing.assert_array_equal(dst[lo:hi].numpy(),
                                      g.dst_global[j][valid][order])
        np.testing.assert_array_equal(
            row_ptr[j * shard:(j + 1) * shard + 1].diff().numpy(),
            np.bincount(g.src_local[j][valid], minlength=shard))
    assert row_ptr.dtype == torch.int64 and dst.dtype == torch.int32
    counter = torch.zeros(1, dtype=torch.int64)
    ft = torch.from_numpy(f)
    got = expand_dense(ft, row_ptr, dst, n=n, n_blocks=p, edges_read=counter)
    assert got.shape == (p, p * packed_words(shard), s)
    rows = dense_edge_index(src_l, dst_g, shard, n)
    plain = pack_bits(expand_dense_edges(ft.reshape(p * shard, s), *rows,
                                         p * n).view(p, n, s), n_blocks=p)
    assert torch.equal(got, plain)
    want = np.stack([np.asarray(j_pack_bits(j_expand_dense(
        jnp.asarray(f[j]), jnp.asarray(g.src_local[j]),
        jnp.asarray(g.dst_global[j]), n), n_blocks=p)) for j in range(p)])
    np.testing.assert_array_equal(_u32(got), want)
    active = f.reshape(p, shard, s).any(-1)
    valid = g.dst_global >= 0
    pushed = sum(int(active[j][g.src_local[j][valid[j]]].sum())
                 for j in range(p))
    assert int(counter) == pushed
    if kind == "empty":
        assert not got.any() and pushed == 0
    if kind == "full":
        assert pushed == int(valid.sum())


@pytest.mark.parametrize("slice_edges", [1, 37, 1 << 24])
def test_edge_csr_is_the_same_in_any_slices_from_host_blocks(
        monkeypatch, slice_edges):
    """Host (numpy) blocks moved and sorted a slice at a time give the CSR
    of the whole tensors sorted at once."""
    import repro_torch.kernels.expand_dense as ed

    g = _hub_graph(4, seed=5)
    shard = g.part.shard_size
    want = ed.edge_csr(torch.from_numpy(g.src_local),
                       torch.from_numpy(g.dst_global), shard)
    monkeypatch.setattr(ed, "EDGE_SLICE", slice_edges)
    got = ed.edge_csr(g.src_local, g.dst_global, shard, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_expand_dense_checks_inputs():
    g = _hub_graph(4)
    shard, n = g.part.shard_size, g.part.n
    row_ptr, dst = edge_csr(torch.from_numpy(g.src_local),
                            torch.from_numpy(g.dst_global), shard)
    f = torch.zeros((4, shard, 2), dtype=torch.uint8)
    ok = dict(n=n, n_blocks=4)
    assert expand_dense(f, row_ptr, dst, **ok).shape == (
        4, 4 * packed_words(shard), 2)
    with pytest.raises(ValueError, match="uint8"):
        expand_dense(f.int(), row_ptr, dst, **ok)
    with pytest.raises(ValueError, match="int64 row_ptr"):
        expand_dense(f, row_ptr.int(), dst, **ok)
    with pytest.raises(ValueError, match="int32 targets"):
        expand_dense(f, row_ptr, dst.long(), **ok)
    with pytest.raises(ValueError, match="not .shards, shard, S."):
        expand_dense(f[0], row_ptr, dst, **ok)
    with pytest.raises(ValueError, match="CSR"):
        expand_dense(f[:3], row_ptr, dst, **ok)
    with pytest.raises(ValueError, match="CSR"):
        expand_dense(f, row_ptr, dst[None], **ok)
    with pytest.raises(ValueError, match="blocks"):
        expand_dense(f, row_ptr, dst, n=n, n_blocks=3)
    with pytest.raises(ValueError, match="blocks"):
        expand_dense(f, row_ptr, dst, n=n, n_blocks=0)
    for bad in (torch.zeros(1, dtype=torch.int32),
                torch.zeros(2, dtype=torch.int64)):
        with pytest.raises(ValueError, match="counter"):
            expand_dense(f, row_ptr, dst, edges_read=bad, **ok)
    with pytest.raises(ValueError, match="uint8"):
        expand_dense_plain(f.bool(), row_ptr, dst, **ok)


@pytest.mark.parametrize("opts,engaged", [
    (BFSOptions(), True), (BFSOptions(mode="auto"), True),
    (BFSOptions(wire_format="bytes"), False),
    (BFSOptions(use_kernel=True), False)])
def test_engine_routes_dense_levels_through_expand_dense(opts, engaged):
    """The packed 1-D dense wire expands every dense level with
    ``expand_dense`` (the recorder's launch count equals the dense
    levels, its edge count the out-edges of each level's frontier); the
    bytes wire and ``use_kernel`` never do."""
    g = _hub_graph(4, seed=3)
    eng = plan(g, opts, num_sources=3, device="cpu").compile()
    spans.reset()
    with spans.recording():
        res = eng.run([5, 7, 100])
        counts = spans.snapshot().counters
    dense = res.stats().mode_counts["dense"]
    assert dense > 0
    assert counts.get(spans.DENSE_LAUNCHES, 0) == (dense if engaged else 0)
    assert (counts.get(spans.EDGES_READ, 0) > 0) == engaged
