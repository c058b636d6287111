"""The twelve 2-D exchange strategies over ``LocalMesh.grid`` on 2 x 2,
4 x 1 and 1 x 4: each routes its blocks as JAX's collective does under
``shard_map`` on the ``(rows, cols)`` mesh — the expand kinds gather the
c cells of a grid row (tiled, in column order), the fold kinds send block
``rr`` of every cell of a grid column to the cell at row rank ``rr`` and
merge there — and the byte models are JAX's."""

import numpy as np
import pytest
import torch

from repro.core import exchange as jex
from repro_torch.core import LocalMesh
from repro_torch.core import exchange as ex
from repro_torch.core import frontier as fr

GRIDS = [(2, 2), (4, 1), (1, 4)]
IDS = [f"{r}x{c}" for r, c in GRIDS]
KINDS_2D = ("expand_row", "fold_col", "expand_row_sparse", "fold_col_sparse")
STRATEGIES = [(k, n) for k in KINDS_2D for n in getattr(
    ex, {"expand_row": "EXPAND_ROW_STRATEGIES",
         "fold_col": "FOLD_COL_STRATEGIES",
         "expand_row_sparse": "EXPAND_ROW_SPARSE_STRATEGIES",
         "fold_col_sparse": "FOLD_COL_SPARSE_STRATEGIES"}[k])]


def test_the_twelve_strategies_are_registered_as_in_jax():
    assert len(STRATEGIES) == 12
    for kind, name in STRATEGIES:
        st, jst = ex.get_exchange(kind, name), jex.get_exchange(kind, name)
        assert st.wire == jst.wire
        args = ((4096, 2, 2, 3, 1) if kind in ("expand_row", "fold_col")
                else (2, 2, 64, 4, 64 / 1024))
        assert st.bytes_model(*args) == jst.bytes_model(*args)


def _row_gather(x, r, c):
    """(p, blk, ...) -> (p, c*blk, ...): cell (i, j) gets row i's blocks."""
    p = r * c
    return np.stack([np.concatenate([x[(k // c) * c + jj] for jj in range(c)])
                     for k in range(p)])


def _column_blocks(x, r, c):
    """(p, r*blk, ...) -> (p, r, blk, ...): cell (i, j) gets block i of
    every cell (rr, j) of its column, in row order."""
    p = r * c
    blk = x.shape[1] // r
    return np.stack([np.stack([x[rr * c + k % c][(k // c) * blk:
                                                 (k // c + 1) * blk]
                               for rr in range(r)]) for k in range(p)])


def _payload(kind, wire, p, r, rng):
    if kind in ("expand_row", "fold_col"):
        rows = (r if kind == "fold_col" else 1) * 10
        if wire == "packed":
            return rng.integers(-2 ** 31, 2 ** 31, (p, rows, 3),
                                dtype=np.int64).astype(np.int32)
        return (rng.random((p, rows, 3)) < 0.3).astype(np.uint8)
    shape = (p, 9) if kind == "expand_row_sparse" else (p, r, 9)
    if wire == "compressed":
        return rng.integers(0, 256, shape).astype(np.uint8)
    return rng.integers(-1, 1000, shape).astype(np.int32)


@pytest.mark.parametrize("kind,name", STRATEGIES,
                         ids=[f"{k}.{n}" for k, n in STRATEGIES])
@pytest.mark.parametrize("r,c", GRIDS, ids=IDS)
def test_grid_strategy_routes_blocks_to_owners(kind, name, r, c):
    mesh = LocalMesh.grid(r, c, "cpu")
    p = r * c
    st = ex.get_exchange(kind, name)
    rng = np.random.default_rng(p + 3 * r + len(name))
    x = _payload(kind, st.wire, p, r, rng)
    axis = "cols" if kind.startswith("expand") else "rows"
    got = st.impl(torch.from_numpy(x), mesh, axis)
    assert got.dtype == torch.from_numpy(x).dtype
    if kind.startswith("expand"):
        want = _row_gather(x, r, c)
    elif kind == "fold_col_sparse":
        want = np.stack([np.stack([x[rr * c + k % c][k // c]
                                   for rr in range(r)]) for k in range(p)])
    else:
        blocks = _column_blocks(x, r, c)
        want = (np.bitwise_or.reduce(blocks, axis=1) if st.wire == "packed"
                else blocks.max(axis=1))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("r,c", GRIDS, ids=IDS)
@pytest.mark.parametrize("strategy", ["allgather", "allgather_packed"])
def test_expand_row_helper_is_transparent(r, c, strategy):
    mesh = LocalMesh.grid(r, c, "cpu")
    f = (torch.rand((r * c, 37, 2), generator=torch.Generator().manual_seed(
        r)) < 0.4).to(torch.uint8)
    got = ex.expand_row(f, mesh, "cols", strategy)
    np.testing.assert_array_equal(got.numpy(), _row_gather(f.numpy(), r, c))


@pytest.mark.parametrize("r,c", GRIDS, ids=IDS)
@pytest.mark.parametrize("strategy", list(ex.FOLD_COL_STRATEGIES))
def test_fold_col_helper_or_merges_owned_slices(r, c, strategy):
    """Every fold strategy (the bf16 sum of reduce_scatter, the packed
    twins) gives each cell the OR of its column's blocks for it."""
    mesh = LocalMesh.grid(r, c, "cpu")
    cand = (torch.rand((r * c, r * 45, 3),
                       generator=torch.Generator().manual_seed(c)) < 0.3
            ).to(torch.uint8)
    got = ex.fold_col(cand, mesh, "rows", strategy)
    want = _column_blocks(cand.numpy(), r, c).max(axis=1)
    assert got.dtype == cand.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if r > 1:
        with pytest.raises(ValueError, match="divisible"):
            ex.fold_col(cand[:, 1:], mesh, "rows", strategy)


def test_reduce_scatter_folds_merge_as_or():
    """The bf16 sum of 0/1 blocks reads as their OR, and the packed twin
    ORs words (a sum would carry across bit lanes): a 4 x 1 column with
    every bit set in every cell."""
    mesh = LocalMesh.grid(4, 1, "cpu")
    cand = torch.ones((4, 4 * 8, 1), dtype=torch.uint8)
    got = ex.fold_col(cand, mesh, "rows", "reduce_scatter")
    assert bool((got == 1).all())
    words = fr.pack_bits(cand, n_blocks=4)
    merged = ex.get_exchange("fold_col", "reduce_scatter_packed").impl(
        words, mesh, "rows")
    assert torch.equal(merged, fr.pack_bits(torch.ones((4, 8, 1),
                                                       dtype=torch.uint8)))
