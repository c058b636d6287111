"""Port dense frontier primitives (repro_torch.core.frontier) bitwise
against repro.core.frontier: packed words (int32 carrying the uint32
pattern), pad bits, source injection, and the uint8 scatter-max that must
not wrap at 256 in-edges."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jfr
from repro_torch.core import frontier as fr
from repro_torch.core.partition import Partition1D

# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores
torch.set_num_threads(1)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _pack_ref(mask: np.ndarray, n_blocks: int) -> np.ndarray:
    """Independent numpy word packer (LSB-first, blocked per segment)."""
    total, s = mask.shape
    m = total // n_blocks
    w = -(-m // 32)
    out = np.zeros((n_blocks * w, s), np.uint32)
    for b in range(n_blocks):
        for i in range(m):
            out[b * w + i // 32] |= ((mask[b * m + i] > 0).astype(np.uint32)
                                     << np.uint32(i % 32))
    return out


@pytest.mark.parametrize("m,n_blocks,s", [
    (1, 1, 1), (31, 1, 2), (32, 1, 1), (33, 1, 1), (5, 4, 2), (500, 4, 1),
    (96, 3, 3), (37, 3, 2), (64, 2, 5)])
def test_pack_unpack_bitwise_vs_jax(m, n_blocks, s):
    rng = np.random.default_rng(m * 1000 + n_blocks)
    mask = (rng.random((m * n_blocks, s)) < 0.4).astype(np.uint8)
    mask[-1] = 1                                 # bit 31 / sign bit cases
    words = fr.pack_bits(torch.from_numpy(mask), n_blocks=n_blocks)
    want = np.asarray(jfr.pack_bits(jnp.asarray(mask), n_blocks=n_blocks))
    assert words.dtype == torch.int32
    assert words.shape == (n_blocks * fr.packed_words(m), s)
    np.testing.assert_array_equal(_u32(words), want)
    back = fr.unpack_bits(words, m, n_blocks=n_blocks)
    np.testing.assert_array_equal(back.numpy(), mask)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jfr.unpack_bits(jnp.asarray(want), m,
                                                 n_blocks=n_blocks)))


def test_sign_bit_words_unpack_like_uint32():
    """Bit 31 set makes the int32 word negative; >> sign-extends, and the
    & 1 of every bit test keeps the unpack exact."""
    raw = np.array([[0x80000000, 0xFFFFFFFF], [0x80000001, 0x7FFFFFFF]],
                   np.uint32)
    words = torch.from_numpy(raw.view(np.int32).copy())
    assert int(words[0, 0]) < 0
    got = fr.unpack_bits(words, 64, n_blocks=1)
    want = np.asarray(jfr.unpack_bits(jnp.asarray(raw), 64))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_u32(fr.pack_bits(got)), raw)


def test_pack_unpack_random_shapes_property():
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=40, deadline=None)
    @given(m=st.integers(1, 150), n_blocks=st.integers(1, 5),
           s=st.integers(1, 3), seed=st.integers(0, 2 ** 16))
    def prop(m, n_blocks, s, seed):
        rng = np.random.default_rng(seed)
        mask = (rng.random((m * n_blocks, s)) < 0.3).astype(np.uint8)
        words = fr.pack_bits(torch.from_numpy(mask), n_blocks=n_blocks)
        assert np.array_equal(_u32(words), _pack_ref(mask, n_blocks))
        assert np.array_equal(
            fr.unpack_bits(words, m, n_blocks=n_blocks).numpy(), mask)

    prop()


def test_padding_bits_never_leak_into_merge():
    """A full-ones mask leaves each block's pad bits zero, an OR merge
    cannot invent them, and unpack drops even forged pad bits."""
    m, n_blocks, s = 37, 3, 2
    w = fr.packed_words(m)
    ones = torch.ones((m * n_blocks, s), dtype=torch.uint8)
    words = fr.pack_bits(ones, n_blocks=n_blocks)
    for b in range(n_blocks):
        last = _u32(words[b * w + (m - 1) // 32])
        assert (last >> np.uint32(m % 32)).max() == 0
    merged = words[:w] | words[w:2 * w] | words[2 * w:]
    assert torch.equal(fr.unpack_bits(merged, m), torch.ones((m, s),
                                                            dtype=torch.uint8))
    forged = words.clone().reshape(n_blocks, w, s)
    forged[:, -1] |= -(1 << (m % 32))          # every pad bit high
    back = fr.unpack_bits(forged.reshape(-1, s), m, n_blocks=n_blocks)
    assert torch.equal(back, ones)


def test_pack_bits_leading_batch_dims():
    rng = np.random.default_rng(4)
    mask = (rng.random((3, 2 * 45, 2)) < 0.5).astype(np.uint8)
    words = fr.pack_bits(torch.from_numpy(mask), n_blocks=2)
    for k in range(3):
        np.testing.assert_array_equal(
            _u32(words[k]), np.asarray(jfr.pack_bits(jnp.asarray(mask[k]),
                                                     n_blocks=2)))
    np.testing.assert_array_equal(
        fr.unpack_bits(words, 45, n_blocks=2).numpy(), mask)


@pytest.mark.parametrize("sources", [[0, 5, -1, 9], [3], [-1, -1], [11, 2]])
def test_init_dist_frontier_bitwise(sources):
    n, n_logical = 12, 10
    src = np.asarray(sources, np.int32)
    d, f = fr.init_dist_frontier(torch.from_numpy(src), n, n_logical)
    jd, jf = jfr.init_dist_frontier(jnp.asarray(src), n, n_logical)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    # reuse of preallocated buffers overwrites them completely
    buf = (torch.zeros((n, len(sources)), dtype=torch.int32),
           torch.ones((n, len(sources)), dtype=torch.uint8))
    d2, f2 = fr.init_dist_frontier(torch.from_numpy(src), n, n_logical,
                                   out=buf)
    assert d2 is buf[0] and torch.equal(d2, d) and torch.equal(f2, f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_expand_dense_bitwise_vs_jax(seed):
    rng = np.random.default_rng(seed)
    shard, n, s, e = 13, 40, 3, 60
    frontier = (rng.random((shard, s)) < 0.4).astype(np.uint8)
    src_local = rng.integers(0, shard, e).astype(np.int32)
    dst_global = rng.integers(-1, n, e).astype(np.int32)   # -1 = padding
    got = fr.expand_dense(torch.from_numpy(frontier),
                          torch.from_numpy(src_local),
                          torch.from_numpy(dst_global), n)
    want = jfr.expand_dense(jnp.asarray(frontier), jnp.asarray(src_local),
                            jnp.asarray(dst_global), n)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("fan_in", [255, 256, 257, 512, 1000])
def test_expand_dense_fan_in_past_256_does_not_wrap(fan_in):
    """A vertex with >= 256 in-edges from the frontier: a uint8 sum would
    wrap to 0 at 256 (index_put_ with accumulate does); the max does not."""
    s = 2
    frontier = torch.ones((fan_in, s), dtype=torch.uint8)
    src_local = torch.arange(fan_in, dtype=torch.int32)
    dst_global = torch.zeros(fan_in, dtype=torch.int32)
    cand = fr.expand_dense(frontier, src_local, dst_global, 4)
    assert cand.tolist() == [[1, 1], [0, 0], [0, 0], [0, 0]]
    want = jfr.expand_dense(jnp.asarray(frontier.numpy()),
                            jnp.asarray(src_local.numpy()),
                            jnp.asarray(dst_global.numpy()), 4)
    np.testing.assert_array_equal(cand.numpy(), np.asarray(want))


def test_expand_dense_stacked_shards_equal_per_shard():
    rng = np.random.default_rng(9)
    p, shard, n, s, e = 3, 7, 21, 2, 30
    frontier = torch.from_numpy((rng.random((p, shard, s)) < 0.5)
                                .astype(np.uint8))
    src_local = torch.from_numpy(rng.integers(0, shard, (p, e)).astype(np.int32))
    dst_global = torch.from_numpy(rng.integers(-1, n, (p, e)).astype(np.int32))
    stacked = fr.expand_dense(frontier, src_local, dst_global, n)
    for j in range(p):
        assert torch.equal(stacked[j], fr.expand_dense(
            frontier[j], src_local[j], dst_global[j], n))


@pytest.mark.parametrize("cap,id_range", [(1, 1), (16, 1000), (1024, 250),
                                          (1024, 100_000), (7, 2 ** 29)])
def test_byte_size_helpers_match_jax(cap, id_range):
    assert fr.compressed_capacity(cap, id_range) == \
        jfr.compressed_capacity(cap, id_range)
    assert fr.sieve_layout(id_range) == jfr.sieve_layout(id_range)
    assert fr.varint_len(id_range) == jfr.varint_len(id_range)
    assert fr.INF == int(jfr.INF)


@pytest.mark.parametrize("n_logical,p", [(300, 4), (97, 1), (64, 2)])
def test_packed_initial_frontier_matches_jax(n_logical, p):
    """The first level's packed frontier, as the bit-tile expansion reads
    it (``pack_bits`` of each shard of ``init_dist_frontier``), is what the
    JAX package makes of it: empty slots and bit 31 included."""
    part = Partition1D(n_logical, p)
    srcs = np.array([0, n_logical - 1, -1, 31, n_logical + 3,
                     part.shard_size - 1], np.int32)
    _, jfront = jfr.init_dist_frontier(jnp.asarray(srcs), part.n, n_logical)
    want = np.asarray(jfr.pack_bits(jfront, p)).reshape(p, -1, srcs.size)
    _, front = fr.init_dist_frontier(torch.from_numpy(srcs), part.n,
                                     n_logical)
    got = fr.pack_bits(front.view(p, part.shard_size, srcs.size))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
