"""Port dense frontier primitives (repro_torch.core.frontier) bitwise
against repro.core.frontier: packed words (int32 carrying the uint32
pattern), pad bits, source injection, and the uint8 scatter-max that must
not wrap at 256 in-edges."""

import jax
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


# the JAX references of the sparse primitives, one compile per shape
# instead of one per op
_j_bottom_up = jax.jit(jfr.expand_bottom_up, static_argnums=3)
_j_bottom_up_packed = jax.jit(jfr.expand_bottom_up_packed,
                              static_argnums=(3, 4))
_j_buckets = jax.jit(jfr.build_queue_buckets,
                     static_argnames=("part", "cap", "local_update", "dedupe"))
_j_apply = jax.jit(jfr.apply_queue, static_argnums=2)
_j_encode = jax.jit(jfr.encode_delta_varint, static_argnums=(1, 2))
_j_decode = jax.jit(jfr.decode_delta_varint, static_argnums=(1, 2))
_j_summary = jax.jit(jfr.sieve_summary, static_argnums=(1, 2))
_j_lookup = jax.jit(jfr.sieve_lookup, static_argnums=(2, 3, 4, 5))


# ---------------------------------------------------------------------------
# bottom-up expansion
# ---------------------------------------------------------------------------

def _in_edges(rng, p, shard, e):
    """Seeded in-edge blocks with every padding kind: a valid source over
    a -1 destination (must not wrap into the last row), the builder's own
    fill (source -1, destination 0), and a destination past the shard."""
    n = p * shard
    src = rng.integers(0, n, (p, e)).astype(np.int32)
    dst = rng.integers(0, shard, (p, e)).astype(np.int32)
    src[:, -3], dst[:, -3] = n - 1, -1
    src[:, -2], dst[:, -2] = -1, 0
    src[:, -1], dst[:, -1] = 0, shard
    return src, dst


@pytest.mark.parametrize("seed,p,shard,s", [(0, 1, 37, 1), (1, 3, 37, 2),
                                            (2, 4, 64, 3), (3, 2, 5, 1)])
def test_expand_bottom_up_bitwise_vs_jax(seed, p, shard, s):
    rng = np.random.default_rng(seed)
    n, w = p * shard, fr.packed_words(shard)
    fglob = (rng.random((n, s)) < 0.3).astype(np.uint8)
    fglob[-1] = 1                              # the row a -1 would wrap to
    words = np.asarray(jfr.pack_bits(jnp.asarray(fglob), n_blocks=p))
    src, dst = _in_edges(rng, p, shard, 90)
    t_words = torch.from_numpy(words.view(np.int32).copy())
    stacked = fr.expand_bottom_up(torch.from_numpy(fglob).expand(p, n, s),
                                  torch.from_numpy(src),
                                  torch.from_numpy(dst), shard)
    stacked_w = fr.expand_bottom_up_packed(t_words.expand(p, p * w, s),
                                           torch.from_numpy(src),
                                           torch.from_numpy(dst), shard, w)
    for j in range(p):
        want = np.asarray(_j_bottom_up(
            jnp.asarray(fglob), jnp.asarray(src[j]), jnp.asarray(dst[j]),
            shard))
        want_w = np.asarray(_j_bottom_up_packed(
            jnp.asarray(words), jnp.asarray(src[j]), jnp.asarray(dst[j]),
            shard, w))
        np.testing.assert_array_equal(want_w, want)
        got = fr.expand_bottom_up(torch.from_numpy(fglob),
                                  torch.from_numpy(src[j]),
                                  torch.from_numpy(dst[j]), shard)
        got_w = fr.expand_bottom_up_packed(t_words, torch.from_numpy(src[j]),
                                           torch.from_numpy(dst[j]), shard, w)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got_w.numpy(), want)
        np.testing.assert_array_equal(stacked[j].numpy(), want)
        np.testing.assert_array_equal(stacked_w[j].numpy(), want)


# ---------------------------------------------------------------------------
# sparse queue primitives
# ---------------------------------------------------------------------------

def _bucket_case(rng, part, e, frac_active):
    dst = rng.integers(0, part.n_logical, e).astype(np.int32)
    dst[::7] = dst[0]                                  # duplicates
    dst[-1] = -1                                       # a padding edge
    active = rng.random(e) < frac_active
    active[-1] = False
    return dst, active


@pytest.mark.parametrize("dedupe", [True, False])
@pytest.mark.parametrize("local_update", [True, False])
@pytest.mark.parametrize("cap", [3, 64])
def test_build_queue_buckets_bitwise_vs_jax(dedupe, local_update, cap):
    part = Partition1D(301, 4)
    rng = np.random.default_rng(cap + 2 * dedupe + local_update)
    dsts, acts, wants = [], [], []
    overflowed = False
    for me in range(part.p):
        dst, active = _bucket_case(rng, part, 120, 0.6)
        want = _j_buckets(
            jnp.asarray(dst), jnp.asarray(active), part, jnp.int32(me), cap,
            local_update=local_update, dedupe=dedupe)
        got = fr.build_queue_buckets(
            torch.from_numpy(dst), torch.from_numpy(active), part, me, cap,
            local_update=local_update, dedupe=dedupe)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[0].dtype == torch.int32 and got[1].dtype == torch.uint8
        overflowed |= bool(want[3])
        dsts.append(dst), acts.append(active), wants.append(want)
    assert overflowed == (cap == 3)
    # the stacked build (one row per shard) equals the per-shard builds
    got = fr.build_queue_buckets(
        torch.from_numpy(np.stack(dsts)), torch.from_numpy(np.stack(acts)),
        part, torch.arange(part.p), cap, local_update=local_update,
        dedupe=dedupe)
    for k in range(4):
        np.testing.assert_array_equal(
            got[k].numpy(), np.stack([np.asarray(w[k]) for w in wants]))


def test_build_queue_buckets_dedupe_sentinel_at_the_int32_edge():
    """The dedupe sentinel is the padded size ``n``, here 2,147,483,520:
    duplicate targets at the top of the id space dedupe to one copy each,
    bitwise the JAX buckets."""
    part = Partition1D(4095 * 524416, 4095)
    assert part.n < 2 ** 31 and part.n + part.shard_size > 2 ** 31
    top = part.n - 1 - np.arange(6, dtype=np.int64) * part.shard_size // 2
    dst = np.concatenate([top, top[::-1], [0, part.n - 1]]).astype(np.int32)
    active = np.ones(dst.shape, bool)
    for local_update in (True, False):
        want = _j_buckets(
            jnp.asarray(dst), jnp.asarray(active), part,
            jnp.int32(part.p - 1), 3, local_update=local_update, dedupe=True)
        got = fr.build_queue_buckets(
            torch.from_numpy(dst), torch.from_numpy(active), part,
            part.p - 1, 3, local_update=local_update, dedupe=True)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        sent = got[0].numpy().reshape(-1)
        sent = np.sort(sent[sent >= 0])
        assert np.unique(sent).size == sent.size


@pytest.mark.parametrize("seed", [0, 1])
def test_apply_queue_bitwise_vs_jax(seed):
    rng = np.random.default_rng(seed)
    p, shard, cap = 4, 19, 10
    recv = rng.integers(-1, p * shard, (p, p, cap)).astype(np.int32)
    recv[:, :, -1] = -1
    got = fr.apply_queue(torch.from_numpy(recv), torch.arange(p), shard)
    for me in range(p):
        want = np.asarray(_j_apply(jnp.asarray(recv[me]),
                                          jnp.int32(me), shard))
        np.testing.assert_array_equal(got[me].numpy(), want)
        np.testing.assert_array_equal(
            fr.apply_queue(torch.from_numpy(recv[me]), me, shard).numpy(),
            want)


# ---------------------------------------------------------------------------
# compressed wire
# ---------------------------------------------------------------------------

def _codec_ids(rng, cap, id_range, count):
    ids = np.full(cap, -1, np.int32)
    live = rng.choice(id_range, min(count, id_range, cap), replace=False)
    ids[: live.size] = live
    rng.shuffle(ids)
    return ids


@pytest.mark.parametrize("cap,id_range,count", [
    (16, 1000, 5), (16, 1000, 16), (64, 2 ** 29, 40), (8, 100, 0),
    (32, 300, 32), (256, 250, 250), (40, 70, 40), (5, 2 ** 28 + 9, 5)])
def test_delta_varint_codec_bitwise_vs_jax(cap, id_range, count):
    """Payload bytes bitwise in varint mode, in bitmap mode (dense sets of
    a small range, where the header's bit 31 is set) and at the varint
    capacity overflow; the decode returns JAX's ids from the same bytes."""
    rng = np.random.default_rng(cap * 7 + count)
    ids = np.stack([_codec_ids(rng, cap, id_range, count),
                    _codec_ids(rng, cap, id_range, max(0, count - 3))])
    byte_caps = [fr.compressed_capacity(cap, id_range), 4 + cap // 2]
    if id_range < 10_000:                        # a bitmap slot that fits
        byte_caps.append(4 + 4 * fr.packed_words(id_range))
    for byte_cap in byte_caps:
        got_buf, got_ovf = fr.encode_delta_varint(torch.from_numpy(ids),
                                                  byte_cap, id_range)
        assert got_buf.shape == (2, byte_cap) and got_buf.dtype == torch.uint8
        for r in range(2):
            buf, ovf = _j_encode(jnp.asarray(ids[r]), byte_cap,
                                               id_range)
            np.testing.assert_array_equal(got_buf[r].numpy(),
                                          np.asarray(buf))
            assert bool(got_ovf[r]) == bool(ovf)
            want = np.asarray(_j_decode(buf, cap, id_range))
            dec = fr.decode_delta_varint(torch.from_numpy(np.array(buf)),
                                         cap, id_range)
            np.testing.assert_array_equal(dec.numpy(), want)
            assert dec.dtype == torch.int32
            if not bool(ovf):
                live = np.sort(ids[r][ids[r] >= 0])
                np.testing.assert_array_equal(want[: live.size], live)
        dec = fr.decode_delta_varint(got_buf, cap, id_range)
        for r in range(2):
            np.testing.assert_array_equal(
                dec[r].numpy(),
                fr.decode_delta_varint(got_buf[r], cap, id_range).numpy())


def test_codec_header_bit_31_and_garbage_bytes_decode_like_jax():
    """A header with bit 31 set is bitmap mode whatever its count bits
    say; a stream of arbitrary bytes (five-byte groups whose top bits fall
    off a 32-bit lane, sums that wrap) decodes as JAX's uint32 does."""
    rng = np.random.default_rng(11)
    cap, id_range = 24, 200
    byte_cap = 4 + 4 * fr.packed_words(id_range)
    for hdr in (0x80000005, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF, 3):
        buf = rng.integers(0, 256, byte_cap).astype(np.uint8)
        buf[:4] = np.frombuffer(np.uint32(hdr).tobytes(), np.uint8)
        for rng_ in (id_range, 2 ** 29):
            want = np.asarray(_j_decode(jnp.asarray(buf), cap,
                                                      rng_))
            got = fr.decode_delta_varint(torch.from_numpy(buf), cap, rng_)
            np.testing.assert_array_equal(got.numpy(), want)
    word = torch.tensor(-123456789, dtype=torch.int32)
    np.testing.assert_array_equal(
        fr._le_bytes(word).numpy(),
        np.asarray(jfr._le_bytes(jnp.uint32(np.uint32(2 ** 32 - 123456789)))))


# ---------------------------------------------------------------------------
# visited sieve
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard,p", [(37, 3), (1024, 2), (3000, 2),
                                     (2050, 1), (1, 4)])
def test_sieve_summary_and_lookup_bitwise_vs_jax(shard, p):
    """Summary words bitwise (a straddling final bucket where the layout
    has one: its pad slots count as visited) and the lookup of every id
    and of -1 padding."""
    bits, bucket, words = fr.sieve_layout(shard)
    rng = np.random.default_rng(shard + p)
    dist = np.where(rng.random((p, shard)) < 0.9, 3, 2 ** 30).astype(np.int32)
    dist[:, : bucket * (bits // 2)] = 1          # some buckets fully visited
    dist[:, -(shard % bucket or bucket):] = 2    # the final bucket visited
    got = fr.sieve_summary(torch.from_numpy(dist), bits, bucket)
    want = np.stack([np.asarray(_j_summary(jnp.asarray(dist[j]), bits,
                                                  bucket))
                     for j in range(p)])
    np.testing.assert_array_equal(_u32(got), want)
    gwords = want.reshape(-1)
    gids = np.concatenate([np.arange(p * shard), [-1, -5]]).astype(np.int32)
    hit = fr.sieve_lookup(torch.from_numpy(gwords.view(np.int32).copy()),
                          torch.from_numpy(gids), shard, bits, bucket, words)
    jhit = _j_lookup(jnp.asarray(gwords), jnp.asarray(gids), shard,
                            bits, bucket, words)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert hit[: bucket * (bits // 2)].all() and not hit[-2:].any()
    # stacked lookups against each shard's own copy of the summary
    gw = torch.from_numpy(gwords.view(np.int32).copy()).expand(p, -1)
    hit2 = fr.sieve_lookup(gw, torch.from_numpy(gids).expand(p, -1), shard,
                           bits, bucket, words)
    assert torch.equal(hit2, hit.expand(p, -1))
