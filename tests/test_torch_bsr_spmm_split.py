"""The A2 kernel's arithmetic and schedule on the CPU: the split-TF32
emulation (``ref.bsr_spmm_split_ref``) against the JAX oracle, one-pass
TF32 against the same tolerance, the kernel's work list
(``kernel.bsr_spmm_work``) and the wrapper's refusals of what its TMA
cannot take.  The kernel itself is held to the plain version on the card
by tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from helpers.tiny_inf import plant_spmm

from repro.kernels.bsr_spmm.ref import bsr_spmm_ref as j_bsr_spmm_ref
from repro_torch.kernels.bsr_spmm.kernel import (SPMM_D_TILE, SPMM_MAX_TILES,
                                                 block_row_ptr, bsr_spmm,
                                                 bsr_spmm_work)
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref, bsr_spmm_split_ref
from repro_torch.kernels.tf32 import (needs_least_hi, split_tf32, tf32_rna,
                                     tf32_trunc)

torch.set_num_threads(1)

EPS = float(np.finfo(np.float32).eps)

# 4 block rows x 3 block cols at block 128: block row 1 has no tile, the
# list ends with two all-zero pad tiles repeating the last block row
ROWS = np.array([0, 0, 2, 3, 3, 3, 3], np.int32)
COLS = np.array([0, 2, 1, 0, 2, 0, 0], np.int32)


def _case(seed: int, tiles: str, xs: str, d: int = 64, density=0.05):
    rng = np.random.default_rng(seed)
    k = ROWS.size
    blocks = (rng.random((k, 128, 128)) < density).astype(np.float32)
    if tiles == "uniform":
        blocks *= rng.uniform(-1, 1, blocks.shape).astype(np.float32)
    blocks[-2:] = 0.0
    if xs == "01":
        x = (rng.random((384, d)) < 0.3).astype(np.float32)
    else:
        x = rng.uniform(-1, 1, (384, d)).astype(np.float32)
    return blocks, x


def _jax(blocks, x):
    return np.asarray(j_bsr_spmm_ref(jnp.asarray(blocks), jnp.asarray(ROWS),
                                     jnp.asarray(COLS), jnp.asarray(x),
                                     n_rows_pad=512))


def _torch(fn, blocks, x):
    return fn(torch.from_numpy(blocks), torch.from_numpy(ROWS),
              torch.from_numpy(COLS), torch.from_numpy(x), n_rows_pad=512)


def _tol2(blocks) -> float:
    """chip_smoke.py's f32 hold: each output sums at most ``deg`` terms of
    magnitude <= 1, so two summation orders differ by at most
    ``2 * deg * eps * deg``."""
    a = np.zeros((512, 384), np.float32)
    for t, (r, c) in enumerate(zip(ROWS, COLS)):
        a[128 * r:128 * (r + 1), 128 * c:128 * (c + 1)] += blocks[t]
    deg = int((a != 0).sum(axis=1).max())
    return 2.0 * deg * deg * EPS


@pytest.mark.parametrize("scale", [1e-30, 1.0, 3e5, 1e30])
def test_split_parts_are_tf32_and_sum_to_v(scale):
    rng = np.random.default_rng(7)
    v = torch.from_numpy((rng.standard_normal(4096) * scale).astype(
        np.float32))
    hi, lo, finite = split_tf32(v)
    assert bool(finite.all())
    for part in (hi, lo):                   # 13 low mantissa bits clear
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    assert torch.equal(v - hi + hi, v)      # lo before rounding is exact
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max()
    assert float(rel) <= 2.0 ** -21         # lo rounded to 11 bits
    assert torch.equal(tf32_trunc(hi), hi) and torch.equal(tf32_rna(lo), lo)


def test_tf32_rna_rounds_ties_away_from_zero():
    base = 1.0 + 2.0 ** -10                 # a TF32 value
    half = 2.0 ** -11                       # half a TF32 ulp at 1
    v = torch.tensor([base + half, -(base + half), base + half / 2,
                      1.0 + half], dtype=torch.float32)
    want = torch.tensor([base + 2.0 ** -10, -(base + 2.0 ** -10), base,
                         1.0 + 2.0 ** -10], dtype=torch.float32)
    assert torch.equal(tf32_rna(v), want)
    assert torch.equal(tf32_trunc(v[:2]), torch.tensor([base, -base]))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("xs", ["01", "frontier"])
def test_split_emulation_bitwise_vs_jax_on_01(seed, xs):
    """0/1 tiles against 0/1 x (a frontier: few sources, sparse): every lo
    is 0, every sum an exact integer, so the emulation is the JAX oracle
    bit for bit, the empty block row and the pad tiles included."""
    blocks, x = _case(seed, "01", "01", d=64 if xs == "01" else 3)
    if xs == "frontier":
        x = (x * (np.random.default_rng(seed).random(x.shape) < 0.2)
             ).astype(np.float32)
    got = _torch(bsr_spmm_split_ref, blocks, x).numpy()
    np.testing.assert_array_equal(got, _jax(blocks, x))
    assert not got[128:256].any()           # the empty block row


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tiles", ["01", "uniform"])
def test_split_emulation_within_tol2_vs_jax(seed, tiles):
    blocks, x = _case(seed, tiles, "uniform")
    tol2 = _tol2(blocks)
    err = np.abs(_torch(bsr_spmm_split_ref, blocks, x).numpy()
                 - _jax(blocks, x)).max()
    assert err <= tol2, (err, tol2)
    # and well inside it: the split loses at most about 2^-20 a term
    assert err <= tol2 / 16, (err, tol2)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("tiles", ["01", "uniform"])
def test_one_pass_tf32_breaks_tol2(seed, tiles):
    """The planted fault of chip_smoke.py's A2 hold: the same product with
    the operands rounded once to TF32 reads above ``tol2``."""
    blocks, x = _case(seed, tiles, "uniform")
    tb, tx = torch.from_numpy(blocks), torch.from_numpy(x)
    y1 = bsr_spmm_ref(tf32_rna(tb), torch.from_numpy(ROWS),
                      torch.from_numpy(COLS), tf32_rna(tx), n_rows_pad=512)
    err = np.abs(y1.numpy() - _jax(blocks, x)).max()
    assert err > _tol2(blocks), (err, _tol2(blocks))


def test_split_emulation_non_finite_as_plain():
    """inf and NaN in x, and in the tiles, give the plain version's
    non-finite pattern and its finite values within tol2; inf in a tile
    against inf in x at the same k gives NaN (the plain product: inf)."""
    blocks, x = _case(3, "uniform", "uniform")
    tol2 = _tol2(blocks)
    x[5, 1] = np.inf                        # block col 0
    x[200, 2] = -np.inf                     # block col 1
    x[300, 3] = np.nan                      # block col 2
    x[10, 4] = np.float32(np.frombuffer(np.uint32(0x7F800001).tobytes(),
                                        np.float32)[0])   # low-bit NaN
    blocks[0, 7, 9] = np.inf
    blocks[2, 4, 100] = np.nan
    got = _torch(bsr_spmm_split_ref, blocks, x).numpy()
    want = _torch(bsr_spmm_ref, blocks, x).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= tol2
    x[9, 0] = np.inf                        # tile 0's column 9 (its inf)
    got = _torch(bsr_spmm_split_ref, blocks, x).numpy()
    want = _torch(bsr_spmm_ref, blocks, x).numpy()
    assert np.isposinf(want[7, 0]) and np.isnan(got[7, 0])


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("where", ["x", "tiles"])
def test_split_emulation_takes_a_value_below_2_136_against_inf_as_plain(
        where, sign):
    """2^-140 (TF32 truncates it to 0) against +-inf at one k, inf in x or
    in a tile: +-inf as the plain product, where a hi of 0 read
    0 * inf = NaN; the rest of y as the plain version's, finite values
    within tol2."""
    blocks, x = _case(4, "uniform", "uniform")
    tb, tx = torch.from_numpy(blocks), torch.from_numpy(x)
    plant_spmm(tb, tx, where, sign)
    got = _torch(bsr_spmm_split_ref, blocks, x).numpy()
    want = _torch(bsr_spmm_ref, blocks, x).numpy()
    assert want[7, 0] == sign * np.inf and got[7, 0] == want[7, 0]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max() <= _tol2(blocks)


def test_split_gives_a_value_below_2_136_the_least_tf32_hi():
    """A nonzero value whose TF32 truncation is 0 has hi copysign(2^-136),
    lo within half a TF32 ulp of 2^-136 of it; 0 and -0 keep hi 0."""
    v = torch.tensor([2.0 ** -140, -2.0 ** -140, 2.0 ** -149,
                      2.0 ** -136 - 2.0 ** -149, 0.0, -0.0, 2.0 ** -130])
    hi, lo, finite = split_tf32(v)
    assert bool(finite.all())
    least = 2.0 ** -136
    assert hi.tolist() == [least, -least, least, least, 0.0, 0.0,
                           2.0 ** -130]
    assert torch.equal(torch.signbit(hi), torch.signbit(v))
    assert torch.equal(tf32_rna(lo), lo)
    assert bool(((hi.double() + lo.double() - v.double()).abs()
                 <= least / 2).all())


@pytest.mark.parametrize("value,want", [
    (1.0, 0), (0.0, 0), (-0.0, 0), (2.0 ** -136, 0), (3.4e38, 0),
    (2.0 ** -140, 1), (-2.0 ** -140, 1), (2.0 ** -149, 1),
    (float("inf"), 1), (float("-inf"), 1), (float("nan"), 1)])
def test_needs_least_hi_flags_an_x_that_can_meet_inf_through_a_tiny_value(
        value, want):
    """The wrapper's device flag picks the kernel build with the 2^-136 hi
    where x holds a non-finite value or a nonzero one below 2^-136."""
    x = torch.full((256, 3), 0.5)
    x[100, 1] = value
    flag = needs_least_hi(x)
    assert flag.dtype == torch.int32 and flag.tolist() == [want]


@pytest.mark.parametrize("d", [1, 63, 64, 65, 70, 200])
def test_work_list_covers_each_item_once_largest_row_first(d):
    rows = torch.tensor([0, 0, 2, 3, 3, 3, 3, 5], dtype=torch.int32)
    cols = torch.zeros_like(rows)
    row_ptr = block_row_ptr(rows, cols, 7, 1)
    work = bsr_spmm_work(row_ptr, d)
    n_dt = -(-d // SPMM_D_TILE)
    assert work.dtype == torch.int32
    assert sorted(work.tolist()) == list(range(7 * n_dt))   # each once
    br, j = work // n_dt, work % n_dt
    counts = (row_ptr[1:] - row_ptr[:-1])[br.long()]
    assert bool((counts[1:] <= counts[:-1]).all())          # largest first
    assert br[::n_dt].tolist() == [3, 0, 2, 5, 1, 4, 6]     # ties by row
    assert j.reshape(7, n_dt).tolist() == [list(range(n_dt))] * 7
    assert torch.equal(work, bsr_spmm_work(row_ptr, d))      # every call


def test_work_list_without_tiles_lists_every_row():
    row_ptr = torch.zeros(5, dtype=torch.int32)
    assert bsr_spmm_work(row_ptr, 130).tolist() == list(range(12))


def _meta_operands(k: int, offset: int = 0):
    """Tiles, row_ptr, block columns and x on the meta device (nothing is
    allocated), the tiles ``offset`` floats past an aligned base."""
    flat = torch.empty(offset + k * 128 * 128, device="meta")
    blocks = flat[offset:].view(k, 128, 128)
    row_ptr = torch.zeros(2, dtype=torch.int32, device="meta")
    cols = torch.zeros(k, dtype=torch.int32, device="meta")
    return blocks, row_ptr, cols, torch.empty((128, 4), device="meta")


@pytest.mark.parametrize("offset,refused", [(1, True), (4, False)])
def test_spmm_refuses_misaligned_tiles(offset, refused):
    """TMA needs a 16-byte aligned base: 4 bytes past one is refused, 16
    bytes past one reaches the next check (no kernel for meta)."""
    blocks, row_ptr, cols, x = _meta_operands(2, offset)
    match = "16-byte aligned" if refused else "no kernel for device meta"
    with pytest.raises(ValueError, match=match):
        bsr_spmm(blocks, row_ptr, cols, x, n_rows_pad=128)


@pytest.mark.parametrize("k,refused", [(SPMM_MAX_TILES, True),
                                       (SPMM_MAX_TILES - 1, False)])
def test_spmm_refuses_too_many_tiles(k, refused):
    blocks, row_ptr, cols, x = _meta_operands(k)
    match = "int32" if refused else "no kernel for device meta"
    with pytest.raises(ValueError, match=match):
        bsr_spmm(blocks, row_ptr, cols, x, n_rows_pad=128)
