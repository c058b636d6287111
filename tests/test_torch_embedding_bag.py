"""The port's EmbeddingBag (A5) on the CPU against the JAX package: the
plain version against the Pallas kernel in interpret mode (bitwise), the
oracle against the JAX oracle, mean mode, pads and the index range.  The
CUDA kernel itself is held to the plain version in
tests/test_torch_cuda.py."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ops as j_ops
from repro.kernels.embedding_bag.kernel import \
    embedding_bag_sum as j_embedding_bag_sum
from repro.kernels.embedding_bag.ref import (embedding_bag_mean_ref as
                                             j_mean_ref,
                                             embedding_bag_sum_ref as
                                             j_sum_ref)
from repro_torch.kernels.embedding_bag import ops
from repro_torch.kernels.embedding_bag.kernel import (CTAS_PER_SM,
                                                      GATHER_ROW_BYTES,
                                                      L2_TABLE_BYTES,
                                                      MAX_ROW_BYTES,
                                                      SMALL_ROW_BYTES,
                                                      SMEM_BLOCK, SMEM_SM,
                                                      bag_geometry,
                                                      embedding_bag_sum,
                                                      embedding_bag_sum_plain,
                                                      gather_geometry)
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_mean_ref,
                                                   embedding_bag_sum_ref)

torch.set_num_threads(1)

# (B, L, V, D): DeepFM's bag of 39 fields over 10-wide rows, and the four
# shapes of tests/test_kernels.py
SHAPES = [(64, 39, 1000, 10), (8, 4, 64, 128), (16, 1, 32, 256),
          (4, 13, 128, 128), (32, 3, 1000, 8)]
DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16}
EPS32 = float(np.finfo(np.float32).eps)


def _t(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x).astype(np.float32)


def _inputs(b, l, v, d, dtype, seed=None):
    """A normal table and indices in [-1, V) (so about 1 slot in V + 1 is
    a pad), from numpy."""
    rng = np.random.default_rng(b * l + v if seed is None else seed)
    table = rng.standard_normal((v, d)).astype(np.float32).astype(dtype)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    return idx, table


def _order_bound(idx, table) -> np.ndarray:
    """Two f32 sums of the same L terms in any two orders differ by at most
    2 (L - 1) eps sum |x| (elementwise, (B, D))."""
    rows = np.where((idx >= 0)[..., None],
                    np.abs(table.astype(np.float32))[np.maximum(idx, 0)], 0)
    return 2 * max(idx.shape[1] - 1, 1) * EPS32 * rows.sum(axis=1)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,v,d", SHAPES)
def test_plain_is_bitwise_the_interpret_kernel(b, l, v, d, dtype):
    """Both sum a bag's rows in f32 in slot order, then cast once."""
    idx, table = _inputs(b, l, v, d, DTYPES[dtype])
    want = j_embedding_bag_sum(jnp.asarray(idx), jnp.asarray(table),
                               interpret=True)
    got = embedding_bag_sum_plain(_t(idx), _t(table))
    assert got.dtype == (torch.float32 if dtype == "f32" else torch.bfloat16)
    np.testing.assert_array_equal(_f32(got), _f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,l,v,d", SHAPES)
def test_oracle_matches_the_jax_oracle(b, l, v, d, dtype):
    """Another f32 sum order (up to 3.8e-6 apart at (64, 39)); in bf16 the
    two f32 sums may also round to neighbouring bf16 values."""
    idx, table = _inputs(b, l, v, d, DTYPES[dtype])
    want = _f32(j_sum_ref(jnp.asarray(idx), jnp.asarray(table)))
    got = _f32(embedding_bag_sum_ref(_t(idx), _t(table)))
    tol = _order_bound(idx, table)
    if dtype == "bf16":
        tol = tol + 2.0 ** -8 * np.abs(want)
    assert np.all(np.abs(got - want) <= tol)


def test_wrapper_on_a_cpu_tensor_runs_the_plain_version():
    idx, table = _inputs(64, 39, 1000, 10, np.float32)
    before = embedding_bag_sum.launches
    got = embedding_bag_sum(_t(idx), _t(table))
    assert embedding_bag_sum.launches == before
    assert torch.equal(got, embedding_bag_sum_plain(_t(idx), _t(table)))
    assert torch.equal(ops.embedding_bag(_t(idx), _t(table)), got)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_mean_mode_matches_jax(dtype):
    """The kernel path's mean is bitwise the JAX kernel path's (the same
    sum divided by the count in the table's dtype); the oracles agree
    within the sum-order bound."""
    idx, table = _inputs(64, 39, 1000, 10, DTYPES[dtype])
    idx[:5] = -1                                       # all-padded bags
    want = j_ops.embedding_bag(jnp.asarray(idx), jnp.asarray(table),
                               mode="mean", interpret=True)
    got = ops.embedding_bag(_t(idx), _t(table), mode="mean")
    np.testing.assert_array_equal(_f32(got), _f32(want))
    assert not _f32(got)[:5].any()
    want_ref = _f32(j_mean_ref(jnp.asarray(idx), jnp.asarray(table)))
    got_ref = _f32(ops.embedding_bag(_t(idx), _t(table), mode="mean",
                                     use_kernel=False))
    tol = _order_bound(idx, table)
    if dtype == "bf16":
        tol = tol + 2.0 ** -7 * np.abs(want_ref)       # two bf16 roundings
    assert np.all(np.abs(got_ref - want_ref) <= tol)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mean_and_all_padded_bags(use_kernel):
    """tests/test_kernels.py's case: an all-padded bag gives zeros in both
    modes."""
    table = torch.arange(16, dtype=torch.float32)[:, None].expand(16, 8)
    idx = torch.tensor([[0, 2, -1], [-1, -1, -1]], dtype=torch.int32)
    mean = ops.embedding_bag(idx, table.contiguous(), mode="mean",
                             use_kernel=use_kernel)
    assert torch.equal(mean, torch.tensor([[1.0] * 8, [0.0] * 8]))
    total = ops.embedding_bag(idx, table.contiguous(), use_kernel=use_kernel)
    assert torch.equal(total, torch.tensor([[2.0] * 8, [0.0] * 8]))


@pytest.mark.parametrize("b,l", [(0, 4), (3, 0), (0, 0)])
def test_empty_shapes_give_zeros(b, l):
    table = torch.ones((5, 3))
    idx = torch.zeros((b, l), dtype=torch.int32)
    for fn in (embedding_bag_sum, embedding_bag_sum_ref):
        out = fn(idx, table)
        assert out.shape == (b, 3) and not out.any()


def test_pad_over_a_non_finite_row_0_gives_the_oracle_value():
    """The Pallas kernel adds row max(idx, 0) * valid, so a pad over an inf
    in row 0 gives inf * 0 = NaN; the oracle's ``where`` gives 0.  The
    port keeps the oracle's contract: a pad adds nothing."""
    table = np.array([[np.inf, 1.0], [2.0, 3.0]], np.float32)
    idx = np.array([[1, -1]], np.int32)
    want = [[2.0, 3.0]]
    np.testing.assert_array_equal(
        np.asarray(j_sum_ref(jnp.asarray(idx), jnp.asarray(table))), want)
    pallas = np.asarray(j_embedding_bag_sum(jnp.asarray(idx),
                                            jnp.asarray(table),
                                            interpret=True))
    assert np.isnan(pallas[0, 0]) and pallas[0, 1] == 3.0
    for fn in (embedding_bag_sum_plain, embedding_bag_sum,
               embedding_bag_sum_ref):
        np.testing.assert_array_equal(fn(_t(idx), _t(table)).numpy(), want)


@pytest.mark.parametrize("fn", [embedding_bag_sum_plain, embedding_bag_sum,
                                embedding_bag_sum_ref,
                                lambda i, t: ops.embedding_bag(i, t,
                                                               mode="mean")])
def test_an_index_past_the_table_raises(fn):
    """``jnp.take`` fills NaN and the Pallas kernel reads past the table;
    the port raises."""
    table = torch.ones((10, 4))
    idx = torch.tensor([[0, 3], [9, 10]], dtype=torch.int32)
    with pytest.raises(IndexError, match="index 10 out of range"):
        fn(idx, table)


def test_wrapper_refuses_what_it_does_not_take():
    table = torch.ones((10, 4))
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_sum(torch.zeros((2, 3), dtype=torch.int64), table)
    with pytest.raises(ValueError, match=r"\(B, L\)"):
        embedding_bag_sum(torch.zeros(3, dtype=torch.int32), table)
    with pytest.raises(ValueError, match="max"):
        ops.embedding_bag(torch.zeros((2, 3), dtype=torch.int32), table,
                          mode="max")
    for dtype in (torch.float16, torch.float64):     # as on a CUDA table
        with pytest.raises(ValueError, match="f32 or bf16"):
            embedding_bag_sum(torch.zeros((2, 3), dtype=torch.int32),
                              table.to(dtype))


@pytest.mark.parametrize("seed", range(4))
def test_plain_is_a_sum_of_the_valid_rows(seed):
    """Against a Python loop over each bag's valid slots, in slot order."""
    rng = np.random.default_rng(seed)
    b, l, v = rng.integers(1, 9), rng.integers(1, 7), rng.integers(2, 41)
    table = rng.standard_normal((v, 16)).astype(np.float32)
    idx = rng.integers(-3, v, (b, l)).astype(np.int32)
    got = embedding_bag_sum_plain(_t(idx), _t(table)).numpy()
    for i in range(b):
        want = np.zeros(16, np.float32)
        for j in idx[i]:
            if j >= 0:
                want = want + table[j]
        np.testing.assert_array_equal(got[i], want)


# (B, L): DeepFM's serve_bulk bags, a tail tile, a bag longer than a stage
# at wide rows, one bag, more bags than CTAs at one slot
GEOMETRY_SHAPES = [(262_144, 39), (1000, 39), (5, 300), (1, 1), (997, 1)]


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,l", GEOMETRY_SHAPES)
def test_launch_geometry_covers_every_bag_and_fits(b, l, itemsize):
    """For D = 1 .. 1,024 (and the widest rows the gather takes): the
    persistent grid's tiles and chunks cover every (bag, slot) exactly
    once, the tail tile included; the ring fits 227 KB with two CTAs an
    SM; the granule divides the row; bf16 with odd D takes the plain-load
    route (the gather's own geometry, before the route rule)."""
    for d in [*range(1, 1025), *range(1025, 4100, 31), 4096, 4097]:
        row = d * itemsize
        g = gather_geometry(b, l, d, itemsize)
        if itemsize == 2 and d % 2:
            assert g.route == "loads", d
            continue
        if row > MAX_ROW_BYTES:
            assert g.route == "loads", d
            continue
        assert g.route == "gather", d
        assert g.granule in (4, 8, 16) and row % g.granule == 0, d
        assert g.granule == max(x for x in (4, 8, 16) if row % x == 0), d
        # the tiles, walked by the grid as the kernel does (tile = cta + k
        # * grid for k < my_tiles), hold bags [t * bags, ...) clipped to B
        cta = np.arange(g.grid)
        assert 1 <= g.grid <= g.tiles
        assert ((g.tiles - 1 - cta) // g.grid + 1).sum() == g.tiles, d
        nb = np.minimum(g.bags, b - np.arange(g.tiles) * g.bags)
        assert nb.min() >= 1 and nb.sum() == b, d
        # the chunks of a tile cover its L slots; a chunked tile is one bag
        nl = np.minimum(g.slots, l - np.arange(g.chunks) * g.slots)
        assert nl.min() >= 1 and nl.sum() == l, d
        assert g.chunks == 1 or g.bags == 1, d
        # a stage holds an item: its span (+ 3 words of unaligned head), its
        # rows, and with chunks a bag's partial sums
        assert g.idx_words >= g.bags * g.slots + 3 and g.idx_words % 4 == 0
        assert g.row_stage_bytes >= g.bags * g.slots * row
        assert g.row_stage_bytes % 16 == 0
        assert g.acc_bytes == (4 * d if g.chunks > 1 else 0)
        assert 2 <= g.stages <= 8
        stage = g.idx_words * 4 + g.row_stage_bytes
        assert g.smem_bytes == 64 + g.stages * stage + g.acc_bytes
        assert g.smem_bytes <= SMEM_BLOCK, d
        assert CTAS_PER_SM * (g.smem_bytes + 1024) <= SMEM_SM, d


def test_launch_geometry_of_deepfm_bags():
    """The serve_bulk bags: 40-byte rows in five 8-byte copies, three
    stages of 19 bags (29,640 bytes of rows), a persistent grid of two CTAs
    an SM."""
    g = bag_geometry(262_144, 39, 39_000_000, 10, 4)
    assert (g.route, g.granule, g.stages, g.bags, g.chunks) == (
        "gather", 8, 3, 19, 1)
    assert (g.row_stage_bytes, g.grid, g.tiles) == (29_648, 264, 13_798)
    assert bag_geometry(262_144, 39, 39_000_000, 10, 4,
                        align=4).granule == 4
    assert gather_geometry(256, 8, 128, 2).granule == 16
    assert gather_geometry(4, 300, 128, 4).chunks == 5


@pytest.mark.parametrize("itemsize", [4, 2], ids=["f32", "bf16"])
def test_route_rule_by_row_width_and_table_size(itemsize):
    """The gather for rows of at most 16 bytes on any table and of at most
    40 bytes on a table past 48 MiB; plain loads for the rest, bf16 with
    odd D always; on both sides of the table-size threshold."""
    for d in range(1, 1025):
        row = d * itemsize
        v_l2 = L2_TABLE_BYTES // row                  # 48 MiB or just under
        for v in (1, v_l2, v_l2 + 1, 39_000_000):
            g = bag_geometry(262_144, 39, v, d, itemsize)
            gather = (row <= SMALL_ROW_BYTES or (
                row <= GATHER_ROW_BYTES and v * row > L2_TABLE_BYTES)) and (
                itemsize == 4 or d % 2 == 0)
            assert g.route == ("gather" if gather else "loads"), (d, v)
            if gather:
                assert g == gather_geometry(262_144, 39, d, itemsize)


# route_bench on an H100 80GB HBM3 at 700 W (262,144 x 39 uniform ids):
# (dtype bytes, D, table MiB, gather ms, plain-load ms), a sample of the
# readings where one route was more than 10% faster.  Of its 160 readings
# the rule takes the slower route at 13, by at most 10.8% (bf16 D = 8 on
# an 8 MiB table)
ROUTE_BENCH = [
    (4, 1, 8, 0.102, 0.116), (4, 1, 1536, 0.347, 0.406),
    (4, 4, 40, 0.157, 0.199), (4, 8, 8, 0.135, 0.096),
    (4, 8, 24, 0.136, 0.118), (4, 10, 8, 0.203, 0.128),
    (4, 16, 24, 0.241, 0.136), (4, 32, 128, 0.489, 0.401),
    (4, 128, 1536, 2.507, 1.875), (4, 512, 1536, 9.33, 7.344),
    (2, 2, 24, 0.112, 0.151), (2, 10, 24, 0.181, 0.130),
    (2, 16, 24, 0.17, 0.144), (2, 64, 8, 0.623, 0.544),
    (2, 128, 56, 1.253, 1.123)]


@pytest.mark.parametrize("itemsize,d,mib,gather_ms,loads_ms", ROUTE_BENCH)
def test_route_rule_takes_the_route_timed_faster(itemsize, d, mib, gather_ms,
                                                 loads_ms):
    """At these readings of route_bench, the rule takes the route that
    was timed faster."""
    v = mib * 2 ** 20 // (d * itemsize)
    route = bag_geometry(262_144, 39, v, d, itemsize).route
    assert route == ("gather" if gather_ms < loads_ms else "loads")
