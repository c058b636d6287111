"""The port's CUDA kernels and engine on the card, against their plain
torch versions and the serial oracle.  Imports only the port (no JAX), so
the machine with the card runs it as it is:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Every test skips where torch.cuda.is_available() is false."""

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions, plan
from repro_torch.core.frontier import INF, packed_words
from repro_torch.core.ref import bfs_reference, validate_bfs
from repro_torch.graphs import generate, shard_graph
from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                 bitpack_words_plain,
                                                 block_row_ptr, bsr_spmm)
from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
from repro_torch.kernels.fold_update import fold_update, fold_update_plain

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


@pytest.mark.parametrize("binary", [True, False])
def test_bsr_spmm_kernel_matches_ref(cuda, binary):
    """An empty block row (row 1) and two zero pad tiles repeating the last
    block row; 70 columns span two 64-column tiles of the kernel."""
    gen = torch.Generator(device=cuda).manual_seed(int(binary))
    rows = torch.tensor([0, 0, 2, 3, 3, 3, 3], dtype=torch.int32, device=cuda)
    cols = torch.tensor([0, 2, 1, 0, 2, 0, 0], dtype=torch.int32, device=cuda)
    if binary:
        blocks = (torch.rand((7, 128, 128), generator=gen, device=cuda)
                  < 0.1).float()
        x = (torch.rand((384, 70), generator=gen, device=cuda) < 0.3).float()
    else:
        blocks = torch.randn((7, 128, 128), generator=gen, device=cuda)
        x = torch.randn((384, 70), generator=gen, device=cuda)
    blocks[-2:] = 0.0
    before = bsr_spmm.launches
    got = bsr_spmm(blocks, block_row_ptr(rows, cols, 4, 3), cols, x,
                   n_rows_pad=512)
    want = bsr_spmm_ref(blocks, rows, cols, x, n_rows_pad=512)
    assert bsr_spmm.launches == before + 1
    if binary:
        assert torch.equal(got, want)
    else:   # f32 sums of <= 256 products, summed in another order
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert not bool(got[128:256].any())          # the empty block row


def test_bitpack_kernel_matches_plain(cuda):
    mask = torch.rand((32 * 50, 64), device=cuda) * 2 - 1
    before = bitpack_words.launches
    assert torch.equal(bitpack_words(mask), bitpack_words_plain(mask))
    assert bitpack_words.launches == before + 1


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
