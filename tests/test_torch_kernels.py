"""Kernels A1-A3 and the engine's bit-tile expansion (``bsr_expand_bits``):
their plain torch versions bitwise against the JAX kernels on the CPU,
and the wrappers' dispatch and checks.  The
CUDA kernels themselves are held to the plain versions on the card by
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.frontier import pack_bits as j_pack_bits
from repro.kernels.bsr_spmm import ops as j_ops
from repro.kernels.bsr_spmm.kernel import bitpack_words as j_bitpack_words
from repro.kernels.bsr_spmm.ref import bsr_spmm_ref as j_bsr_spmm_ref
from repro.kernels.fold_update import fold_update as j_fold_update
from repro_torch.core.frontier import INF, pack_bits, packed_words
from repro_torch.kernels.bsr_spmm import ops
from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                 bitpack_words_plain,
                                                 block_row_ptr,
                                                 bsr_expand_bits, bsr_spmm)
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref, unpack_bit_tiles
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
