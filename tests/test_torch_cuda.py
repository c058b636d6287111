"""The port's CUDA kernels, engine, LM prefill, the MoE layer, DeepFM and
GNN steps on the card, against their plain torch versions and the serial
oracle, and the traversal service with its HTTP front end.  Imports only
the port (no JAX), so the machine with the card runs it as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips where torch.cuda.is_available() is false."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core import BFSOptions, plan
from repro_torch.core.frontier import INF, pack_bits, packed_words
from repro_torch.core.ref import bfs_reference, validate_bfs
from repro_torch.graphs import generate, shard_graph
from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                 bitpack_words_plain,
                                                 block_row_ptr,
                                                 bsr_expand_bits,
                                                 bsr_expand_bits_plain,
                                                 bsr_spmm)
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.kernels.embedding_bag.kernel import (_launch, bag_geometry,
                                                      embedding_bag_sum,
                                                      embedding_bag_sum_plain,
                                                      gather_geometry)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                        split_kv)
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                   attention_ref,
                                                   split_kv_ref)
from repro_torch.kernels.fold_update import fold_update, fold_update_plain
from repro_torch.launch.steps import build_bundle
from repro_torch.models import transformer as tf
from repro_torch.models.convert import (deepfm_from_jax_params,
                                        deepfm_to_numpy)
from repro_torch.models.recsys import deepfm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("lead,m,s", [((), 37, 3), ((4,), 1000, 64),
                                      ((), 32, 1)])
def test_fold_update_kernel_matches_plain(cuda, lead, m, s):
    gen = torch.Generator(device=cuda).manual_seed(m)
    w = packed_words(m)
    words = torch.randint(-2 ** 31, 2 ** 31, (*lead, w, s), generator=gen,
                          device=cuda, dtype=torch.int64).to(torch.int32)
    if m % 32:                                    # pad bits are zero
        words[..., -1, :] &= (1 << (m % 32)) - 1
    d = torch.where(torch.rand((*lead, m, s), generator=gen, device=cuda)
                    < 0.5, INF, 4).to(torch.int32)
    before = fold_update.launches
    got = fold_update(words, d, 3)
    want = fold_update_plain(words, d, 3)
    torch.cuda.synchronize()
    assert fold_update.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    d2, _, _ = fold_update(words, d, 3, inplace=True)
    assert d2 is d and torch.equal(d, want[0])


def _spmm_case(gen, dev, binary: bool, d: int, long_row: int = 0):
    """4 block rows x 3 block cols: block row 1 empty unless ``long_row``
    tiles fill it (more than the kernel's ring of 3 panels holds), two
    zero pad tiles repeating the last block row."""
    rows = [0, 0] + [1] * long_row + [2, 3, 3, 3, 3]
    cols = [0, 2] + [i % 3 for i in range(long_row)] + [1, 0, 2, 0, 0]
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    cols = torch.tensor(cols, dtype=torch.int32, device=dev)
    k = rows.numel()
    if binary:
        blocks = (torch.rand((k, 128, 128), generator=gen, device=dev)
                  < 0.1).float()
        x = (torch.rand((384, d), generator=gen, device=dev) < 0.3).float()
    else:
        blocks = torch.randn((k, 128, 128), generator=gen, device=dev)
        x = torch.randn((384, d), generator=gen, device=dev)
    blocks[-2:] = 0.0
    return blocks, rows, cols, x


@pytest.mark.parametrize("long_row", [0, 9])
@pytest.mark.parametrize("d", [1, 63, 64, 65, 70, 200])
@pytest.mark.parametrize("binary", [True, False])
def test_bsr_spmm_kernel_matches_ref(cuda, binary, d, long_row):
    """Widths below, at and past the kernel's 64-column items, odd and
    even; block row 1 empty or longer than the panel ring."""
    gen = torch.Generator(device=cuda).manual_seed(int(binary) + d)
    blocks, rows, cols, x = _spmm_case(gen, cuda, binary, d, long_row)
    row_ptr = block_row_ptr(rows, cols, 4, 3)
    before = bsr_spmm.launches
    got = bsr_spmm(blocks, row_ptr, cols, x, n_rows_pad=512)
    assert bsr_spmm.launches == before + 1
    want = bsr_spmm_ref(blocks, rows, cols, x, n_rows_pad=512)
    if binary:
        assert torch.equal(got, want)
    else:   # f32 sums of <= 1,152 products, summed in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    if not long_row:
        assert not bool(got[128:256].any())      # the empty block row
    # one consumer owns each output block and sums its tiles in order
    assert torch.equal(got, bsr_spmm(blocks, row_ptr, cols, x,
                                     n_rows_pad=512))


def test_bsr_spmm_kernel_without_tiles_writes_zeros(cuda):
    none = torch.empty((0,), dtype=torch.int32, device=cuda)
    x = torch.randn((384, 70), device=cuda)
    before = bsr_spmm.launches
    got = bsr_spmm(torch.empty((0, 128, 128), device=cuda),
                   block_row_ptr(none, none, 4, 3), none, x, n_rows_pad=512)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1
    assert torch.equal(got, torch.zeros((512, 70), device=cuda))


@pytest.mark.parametrize("where", ["x", "tiles"])
def test_bsr_spmm_kernel_non_finite_as_plain(cuda, where):
    """inf and NaN (a NaN whose payload TF32 truncation would drop too)
    give the plain version's non-finite pattern; the rest within the
    randn tolerance."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    blocks, rows, cols, x = _spmm_case(gen, cuda, False, 64)
    low_nan = torch.tensor([0x7F800001], dtype=torch.int32).view(
        torch.float32).item()
    if where == "x":
        x[5, 1], x[200, 2], x[300, 3], x[10, 4] = (
            float("inf"), float("-inf"), float("nan"), low_nan)
    else:
        blocks[0, 7, 9], blocks[2, 4, 100], blocks[3, 1, 2] = (
            float("inf"), low_nan, float("-inf"))
    got = bsr_spmm(blocks, block_row_ptr(rows, cols, 4, 3), cols, x,
                   n_rows_pad=512)
    want = bsr_spmm_ref(blocks, rows, cols, x, n_rows_pad=512)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(torch.isinf(got), inf)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-4)


def test_bsr_spmm_kernel_many_items(cuda):
    """More items than the persistent grid's CTAs (300 block rows x 4
    column tiles), rows of 0 to 12 tiles, against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    counts = torch.randint(0, 13, (300,), generator=gen, device=cuda)
    rows = torch.repeat_interleave(torch.arange(300, device=cuda),
                                   counts).to(torch.int32)
    cols = torch.randint(0, 8, (rows.numel(),), generator=gen,
                         device=cuda).to(torch.int32)
    blocks = torch.randn((rows.numel(), 128, 128), generator=gen,
                         device=cuda)
    x = torch.randn((1024, 200), generator=gen, device=cuda)
    row_ptr = block_row_ptr(rows, cols, 300, 8)
    got = bsr_spmm(blocks, row_ptr, cols, x, n_rows_pad=300 * 128)
    want = bsr_spmm_ref(blocks, rows, cols, x, n_rows_pad=300 * 128)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


def test_bitpack_kernel_matches_plain(cuda):
    mask = torch.rand((32 * 50, 64), device=cuda) * 2 - 1
    before = bitpack_words.launches
    assert torch.equal(bitpack_words(mask), bitpack_words_plain(mask))
    assert bitpack_words.launches == before + 1


def _bit_operands(gen, dev, rows, cols, n_block_cols, s, density=0.02,
                  pad=0, frontier=0.3):
    """Random one-bit tiles at the given block rows and columns (the last
    ``pad`` tiles all zero, as a shard's pad tiles), their column masks,
    the block-row pointer, the block rows and columns, and a packed
    frontier of ``s`` sources."""
    rows = torch.tensor(rows, dtype=torch.int32, device=dev)
    cols = torch.tensor(cols, dtype=torch.int32, device=dev)
    k = rows.numel()
    dense = torch.rand((k, 128, 128), generator=gen, device=dev) < density
    if pad:
        dense[-pad:] = False
    bits = pack_bits(dense).transpose(1, 2).contiguous()        # (K, col, 4)
    cmask = pack_bits((dense.any(dim=1))[..., None])[..., 0]
    n_rows = int(rows.max()) + 1
    rp = block_row_ptr(rows, cols, n_rows, n_block_cols)
    x = (torch.rand((128 * n_block_cols, s), generator=gen, device=dev)
         < frontier).to(torch.uint8)
    return bits, cmask, rp, rows, cols, pack_bits(x)


def _hold_expand(*ops, **layout):
    before = bsr_expand_bits.launches
    got = bsr_expand_bits(*ops, **layout)
    want = bsr_expand_bits_plain(*ops, **layout)
    torch.cuda.synchronize()
    assert bsr_expand_bits.launches == before + 1
    assert torch.equal(got, want)
    return got


@pytest.mark.parametrize("s", [1, 63, 64, 65, 130])
@pytest.mark.parametrize("n_valid,n_blocks", [(512, 4), (500, 4), (96, 6)])
def test_bsr_expand_bits_kernel_matches_plain(cuda, s, n_valid, n_blocks):
    """Block row 1 empty, two pad tiles repeating the last block row;
    aligned segments, segments of 125 rows and of 16."""
    gen = torch.Generator(device=cuda).manual_seed(s + n_valid)
    ops = _bit_operands(gen, cuda, [0, 0, 2, 3, 3, 3, 3],
                        [0, 2, 1, 0, 2, 0, 0], 3, s, pad=2)
    got = _hold_expand(*ops, n_valid=n_valid, n_blocks=n_blocks)
    assert bool(got.any())


def test_bsr_expand_bits_kernel_merges_a_split_row(cuda):
    """2,000 tiles in one block row span many chunks (and CTAs), merged
    with atomicOr; a second group of rows packs on its own, with
    unaligned segments (rows_per_group 384, 3 segments of 100)."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    rows = [0] * 2000 + [1, 4, 4, 5]
    cols = [i % 40 for i in range(2000)] + [3, 0, 39, 7]
    ops = _bit_operands(gen, cuda, rows, cols, 40, 64, density=0.001,
                        frontier=0.05)
    _hold_expand(*ops, n_valid=384, n_blocks=1)
    _hold_expand(*ops, n_valid=300, n_blocks=3, rows_per_group=384)


def test_bsr_expand_bits_kernel_all_zero_frontier(cuda):
    gen = torch.Generator(device=cuda).manual_seed(3)
    ops = _bit_operands(gen, cuda, [0, 0, 2, 3], [0, 2, 1, 0], 3, 64,
                        frontier=0.0)
    got = _hold_expand(*ops, n_valid=500, n_blocks=4)
    assert not bool(got.any())


def test_bsr_expand_bits_without_tiles_launches_nothing(cuda):
    """No tile: the output is zeros, and the count does not move, since no
    kernel ran."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    ops = _bit_operands(gen, cuda, [0, 2], [0, 1], 2, 8)
    bits, cmask, rp, rows, cols, fw = ops
    empty = (bits[:0], cmask[:0], torch.zeros_like(rp), rows[:0], cols[:0],
             fw)
    before = bsr_expand_bits.launches
    got = bsr_expand_bits(*empty, n_valid=384, n_blocks=3)
    assert bsr_expand_bits.launches == before
    assert got.shape == (3 * 4, 8) and not bool(got.any())


def test_bsr_expand_bits_refuses_mixed_devices_and_dtypes(cuda):
    gen = torch.Generator(device=cuda).manual_seed(5)
    bits, cmask, rp, rows, cols, fw = _bit_operands(gen, cuda, [0, 1],
                                                    [0, 1], 2, 4)
    layout = dict(n_valid=256, n_blocks=1)
    with pytest.raises(ValueError, match="tensors on"):
        bsr_expand_bits(bits, cmask, rp, rows, cols, fw.cpu(), **layout)
    with pytest.raises(ValueError, match="tensors on"):
        bsr_expand_bits(bits.cpu(), cmask, rp, rows, cols, fw, **layout)
    with pytest.raises(ValueError, match="tensors on"):
        bsr_expand_bits(bits, cmask, rp, rows.cpu(), cols, fw, **layout)
    with pytest.raises(ValueError, match="int32"):
        bsr_expand_bits(bits, cmask, rp, rows, cols, fw.to(torch.uint8),
                        **layout)
    with pytest.raises(ValueError, match="int32"):
        bsr_expand_bits(bits, cmask.long(), rp, rows, cols, fw, **layout)
    with pytest.raises(ValueError, match="contiguous"):
        bsr_expand_bits(bits, cmask, rp, rows, cols,
                        torch.cat([fw, fw], dim=1)[:, ::2], **layout)


def test_engine_use_kernel_launches_the_bit_expansion_each_level(cuda):
    """Under use_kernel the engine holds no f32 tile, launches
    bsr_expand_bits once a level and the f32 bsr_spmm never."""
    n = 1001
    src, dst = generate("rmat", n, seed=4)
    roots = [0, 5, 77, 1000]
    for p, opts in ((1, BFSOptions(use_kernel=True, wire_format="packed")),
                    (4, BFSOptions(use_kernel=True)),
                    (3, BFSOptions(use_kernel=True, wire_format="bytes"))):
        eng = plan(shard_graph(src, dst, n, p), opts,
                   num_sources=4).compile()
        assert all(t.dtype == torch.int32 for t in eng.kernel_arrays)
        a2, bx = bsr_spmm.launches, bsr_expand_bits.launches
        res = eng.run(roots)
        np.testing.assert_array_equal(res.dist_host,
                                      bfs_reference(src, dst, n, roots))
        assert bsr_spmm.launches == a2
        assert bsr_expand_bits.launches == bx + res.run_stats.levels


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    words = torch.zeros((2, 6), dtype=torch.int32, device=cuda)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        fold_update(words, torch.zeros((40, 3), dtype=torch.int32,
                                       device=cuda), 1)
    with pytest.raises(ValueError, match="f32"):
        bitpack_words(torch.zeros((32, 2), dtype=torch.float64, device=cuda))


@pytest.mark.parametrize("p,opts", [
    (4, BFSOptions()), (1, BFSOptions(wire_format="packed")),
    (1, BFSOptions(use_kernel=True, wire_format="packed")),
    (2, BFSOptions(use_kernel=True, wire_format="bytes")),
    (3, BFSOptions(wire_format="bytes"))])
def test_engine_on_the_card_matches_the_oracle(cuda, p, opts):
    n = 1001
    src, dst = generate("rmat", n, seed=4)
    roots = [0, 5, 77, 1000]
    want = bfs_reference(src, dst, n, roots)
    res = plan(shard_graph(src, dst, n, p), opts,
               num_sources=4).compile().run(roots)
    assert res.dist.device.type == "cuda"
    np.testing.assert_array_equal(res.dist_host, want)
    validate_bfs(src, dst, roots, res.dist[:n, :4])


@pytest.mark.parametrize("p,s,opts", [
    (4, 1, BFSOptions(mode="queue")),
    (2, 1, BFSOptions(mode="queue", queue_cap=4, wire_format="compressed")),
    (3, 1, BFSOptions(mode="queue", wire_format="bytes", dedupe=False,
                      queue_exchange="allgather_merge")),
    (4, 1, BFSOptions(mode="auto")),
    (1, 1, BFSOptions(mode="auto", wire_format="packed", sieve=True)),
    (4, 4, BFSOptions(mode="auto")),
    (2, 4, BFSOptions(mode="auto", wire_format="bytes"))])
def test_sparse_engines_on_the_card_equal_the_cpu(cuda, p, s, opts):
    """Queue and auto engines on the card: dist bitwise and every run
    stat equal to the same plan on the CPU (whose runs the CPU tests hold
    to the JAX engine), and A1 once a dense level under the fused tail."""
    n = 1001
    src, dst = generate("rmat", n, seed=4)
    roots = [0, 5, 77, 1000][:s]
    g = shard_graph(src, dst, n, p)
    pl = plan(g, opts, num_sources=s)
    a1 = fold_update.launches
    res = pl.compile().run(roots)
    assert res.dist.device.type == "cuda"
    cpu = plan(g, opts, num_sources=s, device="cpu").compile().run(roots)
    np.testing.assert_array_equal(res.dist_host, cpu.dist_host)
    st = res.run_stats.to_host()
    assert st == cpu.run_stats.to_host()
    dense = st["mode_counts"]["dense"]
    assert fold_update.launches - a1 == (dense if pl.use_fused_tail else 0)
    validate_bfs(src, dst, roots, res.dist[:n, :s])


@pytest.mark.parametrize("grid,s,opts", [
    ((2, 2), 4, BFSOptions()),
    ((2, 2), 4, BFSOptions(wire_format="bytes")),
    ((4, 1), 4, BFSOptions()),
    ((1, 4), 4, BFSOptions()),
    ((2, 2), 1, BFSOptions(mode="queue")),
    ((2, 2), 1, BFSOptions(mode="queue", queue_cap=4,
                           wire_format="compressed", use_fused_tail=True)),
    ((1, 4), 1, BFSOptions(mode="queue", wire_format="bytes", dedupe=False,
                           fold_sparse_exchange="allgather_merge")),
    ((2, 2), 1, BFSOptions(mode="auto")),
    ((4, 1), 1, BFSOptions(mode="auto", queue_cap=4)),
    ((2, 2), 4, BFSOptions(mode="auto"))])
def test_grid_engines_on_the_card_equal_the_cpu(cuda, grid, s, opts):
    """2-D engines on the card: dist bitwise and every run stat equal to
    the same plan on the CPU (whose runs the CPU tests hold to the JAX
    2-D engine), and A1 once a dense level under the fused tail."""
    from repro_torch.core import LocalMesh

    n = 1001
    r, c = grid
    src, dst = generate("rmat", n, seed=4)
    roots = [0, 5, 77, 1000][:s]
    g = shard_graph(src, dst, n, r * c)
    pl = plan(g, opts, num_sources=s, mesh=LocalMesh.grid(r, c, cuda),
              partition="2d")
    a1 = fold_update.launches
    res = pl.compile().run(roots)
    assert res.dist.device.type == "cuda"
    cpu = plan(g, opts, num_sources=s, mesh=LocalMesh.grid(r, c, "cpu"),
               partition="2d").compile().run(roots)
    np.testing.assert_array_equal(res.dist_host, cpu.dist_host)
    st = res.run_stats.to_host()
    assert st == cpu.run_stats.to_host()
    dense = st["mode_counts"]["dense"] + (st["mode_counts"]["queue"]
                                          if st["overflowed"] else 0)
    launched = fold_update.launches - a1
    if not pl.use_fused_tail:
        assert launched == 0
    elif not st["overflowed"]:
        assert launched == dense
    else:                  # escalated queue levels run the fused tail too
        assert st["mode_counts"]["dense"] <= launched <= dense
    validate_bfs(src, dst, roots, res.dist[:n, :s])


def _attn_tolerance(dtype, v):
    """f32: the kernel's online softmax and FMA order against the plain
    version's materialized f32 scores: 2e-5, the JAX package's own
    kernel-vs-oracle bound (tests/test_kernels.py).  bf16: the kernel
    rounds p to bf16 before PV (at most 2^-9 * max|v| in the output) and
    both round the output to bf16 once (together at most one ulp, 2^-7
    relative): atol 2^-9 * max|v|, rtol 2^-6."""
    if dtype == torch.float32:
        return {"atol": 2e-5, "rtol": 2e-5}
    return {"atol": 2.0 ** -9 * float(v.abs().max()), "rtol": 2.0 ** -6}


@pytest.mark.parametrize("dtype,dh,b,hq,hkv,sq,skv,causal,window", [
    (torch.float32, 128, 1, 2, 2, 100, 77, False, 0),
    (torch.bfloat16, 128, 2, 4, 2, 100, 77, False, 0),
    (torch.bfloat16, 256, 2, 4, 2, 300, 300, True, 0),
    (torch.bfloat16, 256, 1, 4, 1, 257, 257, True, 40),
    (torch.float32, 64, 2, 8, 2, 130, 130, True, 33),
    (torch.float32, 32, 1, 2, 1, 10, 3, True, 2),     # rows 4..: no key
    (torch.bfloat16, 32, 1, 2, 2, 1, 64, False, 0)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, dh, b, hq, hkv,
                                              sq, skv, causal, window):
    gen = torch.Generator(device=cuda).manual_seed(sq * 7 + dh)
    q = torch.randn((b, hq, sq, dh), generator=gen, device=cuda).to(dtype)
    k = torch.randn((b, hkv, skv, dh), generator=gen, device=cuda).to(dtype)
    v = torch.randn((b, hkv, skv, dh), generator=gen, device=cuda).to(dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tolerance(dtype, v))
    if (sq, skv) == (10, 3):
        assert not bool(got[:, :, 4:].any())


@pytest.mark.parametrize("dh,b,hq,hkv,sq,skv,causal,window", [
    (32, 1, 2, 2, 1, 1, True, 0),
    (64, 2, 4, 2, 63, 63, True, 0),
    (128, 1, 8, 1, 65, 65, True, 2),          # a window inside a kv tile
    (256, 1, 2, 1, 200, 200, True, 33),
    (128, 2, 4, 2, 1000, 1500, False, 0),     # non-causal, Skv > Sq
    (256, 1, 4, 4, 1500, 1500, True, 1024),
    (64, 1, 2, 2, 1, 1000, False, 0),
    (256, 1, 2, 2, 65, 200, False, 0),
    (32, 1, 8, 1, 10, 3, True, 2),            # rows 4..: no key
    (256, 1, 2, 1, 300, 3, True, 2)])         # a whole q tile sees no key
def test_flash_attention_bf16_wgmma_route_matches_plain(cuda, dh, b, hq, hkv,
                                                        sq, skv, causal,
                                                        window):
    """The bf16 route (wgmma + TMA) at every head width, ragged lengths,
    GQA groups 1, 2 and 8: elementwise within the bf16 tolerance, each
    (batch, head) slice within 2^-7 relative L2 (chip_smoke.py's
    A4_HEAD_TOL), and rows that see no key exactly zero."""
    gen = torch.Generator(device=cuda).manual_seed(sq * 31 + skv + dh)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda
                           ).to(torch.bfloat16)
               for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                             (b, hkv, skv, dh)))
    before = (flash_attention.launches_bf16, flash_attention.launches_f32)
    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches_bf16,
            flash_attention.launches_f32) == (before[0] + 1, before[1])
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **_attn_tolerance(torch.bfloat16, v))
    diff = (got.float() - want.float()).flatten(2).norm(dim=-1)
    heads = diff / want.float().flatten(2).norm(dim=-1).clamp_min(1e-30)
    assert float(heads.max()) <= 2.0 ** -7, heads
    dead = ~attention_mask(sq, skv, causal=causal, window=window,
                           device=cuda).any(dim=-1)
    assert not bool(got[:, :, dead].any())


F32_ROUTE_CASES = [
    (32, 1, 2, 2, 1, 1, True, 0),
    (64, 2, 4, 2, 63, 63, True, 0),
    (128, 1, 8, 1, 65, 65, True, 2),          # a window inside a kv tile
    (256, 1, 2, 1, 200, 200, True, 33),
    (128, 2, 4, 2, 1000, 1500, False, 0),     # non-causal, Skv > Sq
    (256, 1, 4, 4, 1500, 1500, True, 1024),
    (64, 1, 2, 2, 1, 1000, False, 0),
    (256, 1, 2, 2, 65, 200, False, 0),
    (32, 1, 8, 1, 10, 3, True, 2),            # rows 4..: no key
    (256, 1, 2, 1, 300, 3, True, 2)]          # a whole q tile sees no key


def _f32_qkv(cuda, dh, b, hq, hkv, sq, skv):
    gen = torch.Generator(device=cuda).manual_seed(sq * 31 + skv + dh)
    return [torch.randn(shape, generator=gen, device=cuda)
            for shape in ((b, hq, sq, dh), (b, hkv, skv, dh),
                          (b, hkv, skv, dh))]


@pytest.mark.parametrize("dh,b,hq,hkv,sq,skv,causal,window",
                         F32_ROUTE_CASES)
def test_flash_attention_f32_split_tf32_route_matches_plain(
        cuda, dh, b, hq, hkv, sq, skv, causal, window):
    """The f32 route (split TF32 on wgmma, after its pre-pass) at every
    head width, ragged lengths, GQA groups 1, 2 and 8: elementwise and each
    (batch, head) slice within 2e-5 (the f32 hold, unchanged from the
    CUDA-core kernel it replaced), rows that see no key exactly zero, two
    calls bitwise equal, one f32 launch and one pre-pass a call."""
    q, k, v = _f32_qkv(cuda, dh, b, hq, hkv, sq, skv)
    before = (flash_attention.launches_bf16, flash_attention.launches_f32,
              split_kv.launches)
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert (flash_attention.launches_bf16, flash_attention.launches_f32,
            split_kv.launches) == (before[0], before[1] + 2, before[2] + 2)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert torch.equal(got, again)
    torch.testing.assert_close(got, want, **_attn_tolerance(torch.float32, v))
    diff = (got - want).flatten(2).norm(dim=-1)
    heads = diff / want.flatten(2).norm(dim=-1).clamp_min(1e-30)
    assert float(heads.max()) <= 2e-5, heads
    dead = ~attention_mask(sq, skv, causal=causal, window=window,
                           device=cuda).any(dim=-1)
    assert not bool(got[:, :, dead].any())


@pytest.mark.parametrize("shape", [(1, 2, 37, 64), (2, 1, 130, 256),
                                   (1, 1, 1, 32), (1, 3, 64, 128)])
def test_split_kv_kernel_matches_plain_bitwise(cuda, shape):
    """The f32 route's pre-pass (K's lo, V^T in key order and its lo, zero
    past Skv) bit for bit against its plain version, NaN and inf
    included."""
    gen = torch.Generator(device=cuda).manual_seed(shape[2])
    k, v = (torch.randn(shape, generator=gen, device=cuda) for _ in range(2))
    for t in (k, v):
        t.view(-1)[::7] *= 1e-30               # values far below 1
        t.view(-1)[3] = float("nan")
        t.view(-1)[-1] = float("-inf")
    before = split_kv.launches
    got = split_kv(k, v)
    torch.cuda.synchronize()
    assert split_kv.launches == before + 1
    for a, b in zip(got, split_kv_ref(k, v)):
        assert a.shape == b.shape
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_flash_attention_f32_nan_key_makes_nan_rows_as_plain(cuda):
    """A NaN in k makes NaN exactly the rows that see that key, as the
    plain version does (the row max propagates NaN)."""
    q, k, v = _f32_qkv(cuda, 64, 1, 2, 1, 200, 200)
    k[0, 0, 70] = float("nan")
    got = flash_attention(q, k, v, causal=True, window=40)
    want = attention_ref(q, k, v, causal=True, window=40)
    torch.cuda.synchronize()
    assert torch.equal(got.isnan(), want.isnan())
    rows = got.isnan().any(dim=-1)[0, 0].nonzero().flatten().tolist()
    assert rows == list(range(70, 110))
    finite = ~want.isnan()
    torch.testing.assert_close(got[finite], want[finite],
                               **_attn_tolerance(torch.float32, v))


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_flash_attention_f32_infinite_key_as_plain(cuda, sign):
    """An infinite key against q exact in TF32 (upcast from bf16, its lo
    0): NaN exactly the rows the plain version makes NaN (score +inf), the
    key dropped where the score is -inf, the finite rows within 2e-5."""
    q, k, v = _f32_qkv(cuda, 64, 1, 2, 1, 200, 200)
    q = q.to(torch.bfloat16).float()
    k[0, 0, 70, 5] = sign * float("inf")
    got = flash_attention(q, k, v, causal=True, window=0)
    want = attention_ref(q, k, v, causal=True, window=0)
    torch.cuda.synchronize()
    nan = want.isnan().any(dim=-1)
    assert torch.equal(got.isnan().any(dim=-1), nan)
    assert 0 < int(nan.sum()) < int((~nan).sum())
    torch.testing.assert_close(got[~nan], want[~nan],
                               **_attn_tolerance(torch.float32, v))


def test_flash_attention_refuses_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((1, 2, 8, 48), device=cuda)
    with pytest.raises(ValueError, match="head widths"):
        flash_attention(q, q, q)
    kv = torch.zeros((1, 2, 8, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="all f32 or all"):
        flash_attention(kv.float(), kv, kv)
    odd = torch.zeros(2 * 8 * 64 + 1, device=cuda)[1:].view(1, 2, 8, 64)
    with pytest.raises(ValueError, match="aligned"):
        attn_ops.attention(odd, odd, odd)


def test_prefill_on_the_card_runs_a4_once_per_layer(cuda):
    """gemma3's REDUCED pattern with 32-wide heads (the kernel's smallest)
    in bf16: the kernel prefill against the plain-attention prefill."""
    cfg = dataclasses.replace(get_arch("gemma3_12b").reduced, head_dim=32,
                              n_layers=12, dtype="bfloat16")
    params = tf.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 70), device=cuda)
    before = flash_attention.launches
    logits, cache, _ = tf.prefill(cfg, params, tokens, 80)
    assert flash_attention.launches == before + cfg.n_layers
    plain, cache_p, _ = tf.prefill(cfg, params, tokens, 80, use_kernel=False)
    assert flash_attention.launches == before + cfg.n_layers
    assert bool(torch.isfinite(logits).all())
    # the first layer's k, v come before any attention: bitwise
    assert torch.equal(cache[0]["k"][0], cache_p[0]["k"][0])
    rel = float((logits.float() - plain.float()).norm() / plain.float().norm())
    assert rel < 2.0 ** -4, rel


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,v,d", [
    (1000, 39, 5000, 10),      # DeepFM's bag: 40-byte rows, not 16-aligned
    (256, 8, 10_000, 128),     # bench_kernels' shape
    (7, 3, 50, 1), (5, 17, 40, 300), (3, 1, 9, 257), (100, 9, 64, 8)])
def test_embedding_bag_kernel_is_bitwise_the_plain_version(cuda, dtype, b, l,
                                                           v, d):
    """Both add a bag's rows in f32 in slot order: bitwise in f32 and bf16,
    with about one slot in eight a pad and some bags all pads."""
    gen = torch.Generator(device=cuda).manual_seed(b * l + d)
    table = torch.randn((v, d), generator=gen, device=cuda).to(dtype)
    idx = torch.randint(0, v, (b, l), generator=gen, device=cuda,
                        dtype=torch.int32)
    pads = torch.rand((b, l), generator=gen, device=cuda) < 0.125
    idx = torch.where(pads, -1 - idx % 3, idx)         # any negative pads
    idx[: max(1, b // 10)] = -1
    before = embedding_bag_sum.launches
    got = embedding_bag_sum(idx, table)
    want = embedding_bag_sum_plain(idx, table)
    torch.cuda.synchronize()
    assert embedding_bag_sum.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    assert not got[: max(1, b // 10)].any()
    mean = bag_ops.embedding_bag(idx, table, mode="mean")
    assert torch.equal(mean, bag_ops.embedding_bag(idx.cpu(), table.cpu(),
                                                   mode="mean").to(cuda))


def test_embedding_bag_kernel_edges(cuda):
    """Empty shapes launch nothing; a pad over an inf in row 0 adds
    nothing; an index past the table raises before any launch."""
    table = torch.tensor([[float("inf"), 1.0], [2.0, 3.0]], device=cuda)
    before = embedding_bag_sum.launches
    for b, l in ((0, 4), (3, 0)):
        out = embedding_bag_sum(torch.zeros((b, l), dtype=torch.int32,
                                            device=cuda), table)
        assert out.shape == (b, 2) and not out.any()
    assert embedding_bag_sum.launches == before
    idx = torch.tensor([[1, -1]], dtype=torch.int32, device=cuda)
    assert embedding_bag_sum(idx, table).tolist() == [[2.0, 3.0]]
    with pytest.raises(IndexError, match="out of range"):
        embedding_bag_sum(idx + 2, table)
    with pytest.raises(ValueError, match="f32 or bf16"):
        embedding_bag_sum(idx, table.half())
    assert embedding_bag_sum.launches == before + 1


def _bag_case(dev, b, l, v, d, dtype, seed):
    """A normal table and indices with about one slot in eight a pad."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = torch.randn((v, d), generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, v, (b, l), generator=gen, device=dev,
                        dtype=torch.int32)
    pads = torch.rand((b, l), generator=gen, device=dev) < 0.125
    return torch.where(pads, -1, idx), table


def _held_bitwise(idx, table, route):
    """One launch, by ``route``, bitwise to the plain version."""
    counts = (embedding_bag_sum.launches, embedding_bag_sum.launches_gather,
              embedding_bag_sum.launches_loads)
    got = embedding_bag_sum(idx, table)
    want = embedding_bag_sum_plain(idx, table)
    torch.cuda.synchronize()
    gather = route == "gather"
    assert (embedding_bag_sum.launches, embedding_bag_sum.launches_gather,
            embedding_bag_sum.launches_loads) == (
        counts[0] + 1, counts[1] + gather, counts[2] + (not gather))
    assert got.dtype == table.dtype and torch.equal(got, want)
    return got


def _gather_bitwise(idx, table):
    """The gather launched on its own (``_launch`` with route "gather",
    whatever the rule gives the shape), bitwise to the plain version."""
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    assert _launch(idx, table, out, "gather").route == "gather"
    assert torch.equal(out, embedding_bag_sum_plain(idx, table))


# 1,300,000 rows of 40 bytes and 2,600,000 of 20 are 52 MB, past 48 MiB
@pytest.mark.parametrize("dtype,d,granule,v,route", [
    (torch.float32, 1, 4, 3000, "gather"),
    (torch.float32, 2, 8, 3000, "gather"),
    (torch.float32, 4, 16, 3000, "gather"),
    (torch.float32, 10, 8, 3000, "loads"),
    (torch.float32, 10, 8, 1_300_000, "gather"),
    (torch.float32, 96, 16, 3000, "loads"),
    (torch.bfloat16, 2, 4, 3000, "gather"),
    (torch.bfloat16, 4, 8, 3000, "gather"),
    (torch.bfloat16, 8, 16, 3000, "gather"),
    (torch.bfloat16, 10, 4, 3000, "loads"),
    (torch.bfloat16, 10, 4, 2_600_000, "gather"),
    (torch.bfloat16, 7, 0, 3000, "loads"),
    (torch.bfloat16, 129, 0, 3000, "loads")])
def test_embedding_bag_routes_and_granules(cuda, dtype, d, granule, v,
                                           route):
    """One D for each granule, on both sides of the rule's table size, and
    bf16 with odd D on the plain-load route; the gather held on its own
    wherever it takes the rows.  B = 1,999 is no multiple of the tile."""
    b, l = 1999, 21
    itemsize = 2 if dtype == torch.bfloat16 else 4
    assert bag_geometry(b, l, v, d, itemsize).route == route
    g = gather_geometry(b, l, d, itemsize)
    assert g.granule == granule
    assert g.route == "loads" or g.bags == 1 or b % g.bags, g
    idx, table = _bag_case(cuda, b, l, v, d, dtype, d)
    _held_bitwise(idx, table, route)
    if granule:
        _gather_bitwise(idx, table)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,d", [(5, 300, 128), (3, 2000, 10),
                                   (37, 300, 1024), (2, 50, 2000)])
def test_embedding_bag_bags_longer_than_a_stage(cuda, dtype, b, l, d):
    """A bag whose rows outgrow a stage is summed by the gather in chunks,
    its partial sums carried between them in slot order (at D = 2,000 a
    row is more granules than a CTA has threads); the rule gives these
    shapes the plain loads, held too."""
    g = gather_geometry(b, l, d, 2 if dtype == torch.bfloat16 else 4)
    assert g.route == "gather" and g.chunks > 1 and g.bags == 1
    idx, table = _bag_case(cuda, b, l, 500, d, dtype, l + d)
    _held_bitwise(idx, table, "loads")
    _gather_bitwise(idx, table)


@pytest.mark.parametrize("offset", [1, 2, 3, 5])
def test_embedding_bag_unaligned_index_span(cuda, offset):
    """idx starting ``offset`` int32 past a 16-byte boundary, so every
    tile's span has an unaligned head and tail."""
    b, l = 777, 39
    gen = torch.Generator(device=cuda).manual_seed(offset)
    flat = torch.randint(-1, 4000, (b * l + offset,), generator=gen,
                         device=cuda, dtype=torch.int32)
    idx = flat[offset:].view(b, l)
    assert idx.data_ptr() % 16 == 4 * (offset % 4)
    table = torch.randn((4000, 4), generator=gen, device=cuda)
    _held_bitwise(idx, table, "gather")
    _held_bitwise(idx[1:], table, "gather")


@pytest.mark.parametrize("dtype,d,offset", [
    (torch.float32, 4, 1), (torch.float32, 4, 2), (torch.float32, 2, 1),
    (torch.bfloat16, 8, 2), (torch.bfloat16, 8, 4)])
def test_embedding_bag_table_off_its_alignment(cuda, dtype, d, offset):
    """A contiguous table ``offset`` elements into its storage: the copy
    granule narrows to what the table's address allows."""
    v = 3000
    gen = torch.Generator(device=cuda).manual_seed(d + offset)
    flat = torch.randn((v * d + offset,), generator=gen, device=cuda)
    table = flat.to(dtype)[offset:].view(v, d)
    idx = torch.randint(-1, v, (500, 13), generator=gen, device=cuda,
                        dtype=torch.int32)
    ptr = table.data_ptr()
    g = bag_geometry(500, 13, v, d, table.element_size(), align=ptr & -ptr)
    assert g.route == "gather" and g.granule < d * table.element_size()
    _held_bitwise(idx, table, "gather")


def test_embedding_bag_table_past_2_pow_31_elements(cuda):
    """A (2^28, 10) f32 table (10.7 GB, 2.7e9 elements): bags that read
    its last rows need int64 offsets."""
    v, d = 2 ** 28, 10
    table = torch.empty((v, d), device=cuda)
    table[-4096:].normal_(generator=torch.Generator(device=cuda
                                                    ).manual_seed(0))
    table[:-4096].fill_(0.5)
    gen = torch.Generator(device=cuda).manual_seed(1)
    idx = torch.randint(v - 4096, v, (4096, 39), generator=gen, device=cuda,
                        dtype=torch.int32)
    idx[:, ::7] = torch.randint(0, v, (4096, 6), generator=gen, device=cuda,
                                dtype=torch.int32)
    idx[::5, -1] = -1
    got = _held_bitwise(idx, table, "gather")
    assert got.abs().sum() > 0
    del table


def test_deepfm_steps_on_the_card_match_the_cpu(cuda):
    """REDUCED DeepFM, the same weights on the card and on the CPU: the
    gathered rows bitwise, the scores within f32 rounding."""
    spec = get_arch("deepfm")
    for shape in ("serve_p99", "retrieval_cand"):
        on_card = build_bundle(spec, shape, reduced=True)
        on_cpu = build_bundle(spec, shape, reduced=True, device="cpu")
        params = on_card.init_params(torch.Generator(device=cuda
                                                     ).manual_seed(0))
        params["lin_table"].normal_(0.0, 0.1)
        host = deepfm_from_jax_params(deepfm_to_numpy(params), "cpu")
        batch, host_batch = on_card.make_batch(0), on_cpu.make_batch(0)
        emb, _ = deepfm._embed(on_card.cfg, params, batch["sparse"])
        emb_h, _ = deepfm._embed(on_cpu.cfg, host, host_batch["sparse"])
        assert torch.equal(emb.cpu(), emb_h)
        got = on_card.fn(params, batch).cpu()
        want = on_cpu.fn(host, host_batch)
        assert bool(torch.isfinite(got).all())
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_deepfm_train_step_on_the_card_matches_the_cpu(cuda):
    """One REDUCED DeepFM train step from the same state on the card and
    on the CPU: loss, grad_norm and every leaf of the new state within f32
    rounding (full f32 products: allow_tf32 off)."""
    from repro_torch import tree as tr
    from repro_torch.models.convert import (train_state_from_jax,
                                            train_state_to_numpy)

    spec = get_arch("deepfm")
    on_card = build_bundle(spec, "train_batch", reduced=True)
    on_cpu = build_bundle(spec, "train_batch", reduced=True, device="cpu")
    state = on_card.make_state(on_card.init_params(
        torch.Generator(device=cuda).manual_seed(0)))
    host = train_state_from_jax(train_state_to_numpy(state), "cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        new, m = on_card.fn(state, on_card.make_batch(0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    new_h, m_h = on_cpu.fn(host, on_cpu.make_batch(0))
    for k in ("loss", "grad_norm", "lr"):
        torch.testing.assert_close(m[k].cpu(), m_h[k], rtol=1e-5, atol=0)
    for a, b in zip(tr.leaves(new), tr.leaves(new_h)):
        assert a.device.type == "cuda"
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-7)


def test_reshard_state_between_train_steps_is_bitwise(cuda):
    """REDUCED DeepFM on the card: 2 steps, ``reshard_state`` onto a
    (data 1, model 4) mesh on the card (device to device), then from a
    CPU copy back onto the card (through the host), then 2 more steps:
    losses and the final state bitwise those of 4 steps without a
    reshard, and every resharded leaf a new tensor."""
    from repro_torch import tree as tr
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.launch.shardings import recsys_param_specs, state_specs
    from repro_torch.train.elastic import reshard_state

    bundle = build_bundle(get_arch("deepfm"), "train_batch", reduced=True)
    params = bundle.init_params(torch.Generator(device=cuda).manual_seed(0))
    batch = bundle.make_batch(0)
    mesh = LocalMesh((1, 4), ("data", "model"), cuda)
    specs = state_specs(recsys_param_specs(bundle.cfg, mesh), params, mesh)

    def run(state, steps):
        losses = []
        for _ in range(steps):
            state, m = bundle.fn(state, batch)
            losses.append(m["loss"].item())
        return state, losses

    want, want_l = run(bundle.make_state(params), 4)
    state, l1 = run(bundle.make_state(params), 2)
    moved = reshard_state(state, mesh, specs)
    for a, b in zip(tr.leaves(moved), tr.leaves(state)):
        assert a.device == cuda and a.data_ptr() != b.data_ptr()
        assert torch.equal(a, b)
    host = tr.map_tree(lambda x: x.cpu(), moved)
    one = LocalMesh((1, 1), ("data", "model"), cuda)
    back = reshard_state(host, one, state_specs(
        recsys_param_specs(bundle.cfg, one), params, one))
    assert all(x.device == cuda for x in tr.leaves(back))
    got, l2 = run(back, 2)
    assert l1 + l2 == want_l
    for a, b in zip(tr.leaves(got), tr.leaves(want)):
        assert torch.equal(a, b)


def test_lm_train_step_on_the_card_matches_the_cpu(cuda):
    """Two REDUCED gemma3 train steps (f32; the train route runs no
    kernel, so head_dim 16 runs on the card) from the same state on the
    card and on the CPU: the metrics, and every leaf of the state within
    1e-5 relative L2 (full f32 products: allow_tf32 off)."""
    from repro_torch import tree as tr

    spec = get_arch("gemma3_12b")
    on_card = build_bundle(spec, "train_4k", reduced=True, microbatches=2)
    on_cpu = build_bundle(spec, "train_4k", reduced=True, device="cpu",
                          microbatches=2)
    host = on_cpu.make_state(on_cpu.init_params(
        torch.Generator().manual_seed(0)))
    state = tr.map_tree(lambda t: t.to(cuda, copy=True), host)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(2):
            state, m = on_card.fn(state, on_card.make_batch(i))
            host, m_h = on_cpu.fn(host, on_cpu.make_batch(i))
            for k in ("loss", "grad_norm", "lr"):
                torch.testing.assert_close(m[k].cpu(), m_h[k], rtol=1e-5,
                                           atol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(tr.leaves(state), tr.leaves(host)):
        assert a.device.type == "cuda"
        err = float((a.cpu().double() - b.double()).norm())
        assert err <= 1e-5 * float(b.double().norm())


@pytest.mark.parametrize("mesh_shape", [None, (1, 4), (2, 2)])
def test_moe_layer_on_the_card_matches_the_cpu(cuda, mesh_shape):
    """The MoE layer (16 experts top-4, a shared expert, capacity lowered
    so that it drops) on the card and on the CPU from the same f32
    weights and tokens, locally or on a ``LocalMesh`` of ``mesh_shape``:
    the same experts picked and dropped, ``lb_loss`` and the output
    within f32 rounding (allow_tf32 off).  The tokens' k-th and (k+1)-th
    probabilities are 1e-5 apart or more, a hundred times the f32
    rounding of the router's logits, so no near-tie can route otherwise on
    the card."""
    from repro_torch import tree as tr
    from repro_torch.configs import MoEConfig
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.models import moe

    cfg = MoEConfig(n_experts=16, top_k=4, d_ff=48, capacity_factor=0.7,
                    shared_experts=1)
    host = moe.init_moe_params(torch.Generator().manual_seed(0), 32, cfg,
                               torch.float32)
    x = torch.randn((256, 32), generator=torch.Generator().manual_seed(1))
    probs = torch.softmax(x.double() @ host["router"].double(), -1)
    top = probs.sort(-1, descending=True).values
    assert float((top[:, 3] - top[:, 4]).min()) > 1e-5
    card = tr.map_tree(lambda t: t.to(cuda), host)

    def run(params, xs, dev):
        if mesh_shape is None:
            return moe.moe_apply(params, xs, cfg)
        mesh = LocalMesh(mesh_shape, ("data", "model"), dev)
        return moe.moe_apply(params, xs, cfg, mesh)

    want, aux_h = run(host, x, "cpu")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, aux = run(card, x.to(cuda), cuda)
        _, _, e_card = moe._route(card["router"], x.to(cuda), cfg.top_k)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    _, _, e_host = moe._route(host["router"], x, cfg.top_k)
    assert torch.equal(e_card.cpu(), e_host)
    assert int(aux["dropped"]) == int(aux_h["dropped"]) > 0
    torch.testing.assert_close(aux["lb_loss"].cpu(), aux_h["lb_loss"],
                               rtol=1e-5, atol=0)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch_id,shape_name", [
    ("gcn_cora", "ogb_products"), ("gatedgcn", "minibatch_lg"),
    ("schnet", "molecule"), ("graphcast", "full_graph_sm")])
def test_gnn_train_step_on_the_card_matches_the_cpu(cuda, arch_id,
                                                    shape_name):
    """Two REDUCED GNN train steps from the same state on the card and on
    the CPU (no kernel runs: gathers, index_add, f32 products with TF32
    off): the metrics, and every leaf of the state within 1e-5 relative
    L2."""
    from repro_torch import tree as tr

    spec = get_arch(arch_id)
    on_card = build_bundle(spec, shape_name, reduced=True)
    on_cpu = build_bundle(spec, shape_name, reduced=True, device="cpu")
    host = on_cpu.make_state(on_cpu.init_params(
        torch.Generator().manual_seed(0)))
    state = tr.map_tree(lambda t: t.to(cuda, copy=True), host)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(2):
            state, m = on_card.fn(state, on_card.make_batch(i))
            host, m_h = on_cpu.fn(host, on_cpu.make_batch(i))
            for k in ("loss", "grad_norm", "lr"):
                torch.testing.assert_close(m[k].cpu(), m_h[k], rtol=1e-5,
                                           atol=0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    for a, b in zip(tr.leaves(state), tr.leaves(host)):
        assert a.device.type == "cuda"
        err = float((a.cpu().double() - b.double()).norm())
        assert err <= 1e-5 * max(float(b.double().norm()), 1e-30)


def test_decode_step_on_the_card_matches_the_cpu(cuda):
    """gemma3 REDUCED (f32; decode runs no kernel, so head_dim 16 runs on
    the card): a CPU prefill's cache carried to the card, then one decode
    step at per-sequence positions on each: logits and cache within f32
    rounding."""
    from repro_torch.models.convert import from_jax_params, to_numpy

    cfg = get_arch("gemma3_12b").reduced
    params = tf.init_params(cfg, torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab, (2, 20),
                           generator=torch.Generator().manual_seed(1))
    _, cache, _ = tf.prefill(cfg, params, tokens, 40)
    card_params = from_jax_params(to_numpy(params), cuda)
    card_cache = [{n: c[n].to(cuda) for n in "kv"} for c in cache]
    pos = torch.tensor([20, 13], dtype=torch.int32)
    tok = torch.tensor([5, 7])
    want, cache = tf.decode_step(cfg, params, cache, pos, tok)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got, card_cache = tf.decode_step(cfg, card_params, card_cache,
                                         pos.to(cuda), tok.to(cuda))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    for c, h in zip(card_cache, cache):
        for n in "kv":
            torch.testing.assert_close(c[n].cpu(), h[n], rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------------------------
# the traversal service and its HTTP front end on the card
# ---------------------------------------------------------------------------

def _serving_graphs():
    src, dst = generate("rmat", 3000, seed=2, edge_factor=8)
    return src, dst, 3000, shard_graph(src, dst, 3000, 4)


def test_service_on_the_card_equals_the_cpu_service(cuda):
    """Mixed 1-D and 2-D lanes and a ``use_kernel`` lane: the card's
    service answers as the CPU's, lanes of one graph share its blocks,
    and A1 and ``bsr_expand_bits`` launch on the serving path."""
    from repro_torch.core import LocalMesh
    from repro_torch.graphs import device_block_cache
    from repro_torch.serve.bfs_service import BFSService, TraversalRequest
    from repro_torch.serve.engine_cache import EngineCache, GraphCatalog

    src, dst, n, g = _serving_graphs()
    g1 = shard_graph(src, dst, n, 1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        cat = GraphCatalog()
        cat.register("r", g)
        cat.register("k", g1)
        svc = BFSService(opts=BFSOptions(), batch_buckets=(1, 8),
                         cache=EngineCache(), catalog=cat, device=dev)
        svc.add_graph("r")
        svc.add_graph("r2", cat.get_2d("r", 2, 2),
                      mesh=LocalMesh.grid(2, 2, dev))
        svc.add_graph("k", opts=BFSOptions(use_kernel=True,
                                           wire_format="packed"))
        fold_update.launches = bsr_expand_bits.launches = 0
        reqs = [TraversalRequest(rid=i, source=s, graph=name)
                for i, (name, s) in enumerate(
                    [("r", 0), ("r2", 5), ("k", 9), ("r", 17), ("k", 0)])]
        for r in reqs:
            svc.submit(r)
        svc.run_until_drained()
        res = {name: svc.traverse(name, list(range(6)))[0].dist_host
               for name in ("r", "r2", "k")}
        out[dev.type] = ([r.dist for r in reqs], res,
                         fold_update.launches, bsr_expand_bits.launches,
                         len(device_block_cache(g)))
    (cuda_step, cuda_res, a1, bits, groups), (cpu_step, cpu_res, *_) = \
        out["cuda"], out["cpu"]
    for got, want in zip(cuda_step, cpu_step):
        np.testing.assert_array_equal(got, want)
    for name in cuda_res:
        np.testing.assert_array_equal(cuda_res[name], cpu_res[name])
        np.testing.assert_array_equal(
            cuda_res[name], bfs_reference(src, dst, n, list(range(6))))
    assert a1 > 0 and bits > 0
    assert groups == 4          # 1-D and 2-D rows and masks, once each


def test_http_frontend_on_the_card(cuda):
    """``serve_http`` over a card service: depths bitwise the oracle's,
    parents derived on the card equal the host rule, and a split arm
    under a compile fault."""
    import json
    import threading
    import urllib.request

    from repro_torch.serve.bfs_service import BFSService
    from repro_torch.serve.engine_cache import EngineCache
    from repro_torch.serve.frontend import derive_parents, serve_http
    from repro_torch.serve.resilience import faults

    src, dst, n, g = _serving_graphs()
    svc = BFSService(opts=BFSOptions(), batch_buckets=(2, 8),
                     cache=EngineCache(), device=cuda)
    svc.add_graph("r", g)
    httpd, fe = serve_http(svc, "127.0.0.1", 0, log=lambda *a: None,
                           watchdog_timeout_s=30.0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/traverse"

    def call(body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type":
                                              "application/json"})
        with urllib.request.urlopen(req, timeout=30) as rsp:
            return json.loads(rsp.read())

    try:
        # the S = 8 rung's first compile fails: four runs of S = 2
        srcs = list(range(0, 80, 10))
        with faults.active(faults.FaultPlan([faults.FaultSpec(
                site="cache.compile", match="S=8 ")])):
            out = call({"graph": "r", "sources": srcs})
        np.testing.assert_array_equal(np.asarray(out["depths"]).T,
                                      bfs_reference(src, dst, n, srcs))
        assert out["bucket"] == 2
        assert fe.metrics_payload()["lanes"]["r"]["degraded"] == {
            "split:2": 1}
        srcs = [3, 1, 2999]
        out = call({"graph": "r", "sources": srcs, "include_parents": True})
        want = bfs_reference(src, dst, n, srcs)
        np.testing.assert_array_equal(np.asarray(out["depths"]).T, want)
        np.testing.assert_array_equal(np.asarray(out["parents"]).T,
                                      derive_parents(src, dst, want))
        assert out["bucket"] == 8
    finally:
        fe.shutdown(timeout_s=30)
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def test_parents_of_a_cpu_lane_and_a_card_lane_of_one_graph(cuda):
    """Two lanes of one graph, one on the CPU and one on the card: each
    keeps its own device edge list (keyed by graph and device) and both
    return the host rule's parents; a drain frees both lists."""
    from repro_torch.core import LocalMesh
    from repro_torch.serve.bfs_service import BFSService
    from repro_torch.serve.engine_cache import EngineCache
    from repro_torch.serve.frontend import derive_parents
    from repro_torch.serve.frontend.server import BFSFrontend

    src, dst, n, g = _serving_graphs()
    svc = BFSService(opts=BFSOptions(), batch_buckets=(4,),
                     cache=EngineCache())
    svc.add_graph("host", g, mesh=LocalMesh.flat(4, "cpu"))
    svc.add_graph("card", g, mesh=LocalMesh.flat(4, cuda))
    fe = BFSFrontend(svc, log=lambda *a: None)
    srcs = [3, 1, 2999]
    want = bfs_reference(src, dst, n, srcs)
    try:
        for lane in ("host", "card"):
            out = fe.traverse(lane, srcs, include_parents=True,
                              timeout_s=60)
            np.testing.assert_array_equal(np.asarray(out["depths"]).T, want)
            np.testing.assert_array_equal(np.asarray(out["parents"]).T,
                                          derive_parents(src, dst, want))
        assert sorted(k[1] for k in fe._edges) == sorted(["cpu", str(cuda)])
        assert fe.parents_device_bytes() == 2 * 16 * g.edge_list()[0].size
        assert fe.drain(timeout_s=30) and not fe._edges
    finally:
        fe.shutdown(timeout_s=30)
