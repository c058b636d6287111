"""Sum-mode EmbeddingBag (A5) — wrapper of the hand-written CUDA kernel
``emb_bag_sum`` in ``csrc/embedding_bag_kernels.cu``, the port of
``repro.kernels.embedding_bag.kernel``.

On a CUDA tensor ``embedding_bag_sum`` launches the kernel or raises; on a
CPU tensor it runs the plain version, ``embedding_bag_sum_plain``.  Both
sum each bag's rows in f32 in slot order and skip the pads, then cast to
the table's dtype: on a finite table that is bitwise the Pallas kernel's
sum (which multiplies a pad's row 0 by 0, and so gives NaN over a
non-finite row 0 where these give the oracle's value).  An index >= V
raises in both (``ref.check_indices``): one reduction over the indices
and a host read, which on the serve_bulk bags (262,144 x 39) takes
0.053 ms of the wrapper's 0.591 ms (NVIDIA H100 80GB HBM3, 700.00 W,
``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag.ref import check_indices

INT_MAX = 2 ** 31 - 1                # grid.x; L and D are ints in the kernel
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def embedding_bag_sum_plain(indices: torch.Tensor,
                            table: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch: an f32 sum over the L slots in
    order, a pad slot adding nothing, then a cast."""
    check_indices(indices, table)
    acc = torch.zeros((indices.shape[0], table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for l in range(indices.shape[1]):
        idx = indices[:, l]
        valid = idx >= 0
        acc[valid] += table[idx[valid]].float()
    return acc.to(table.dtype)


def embedding_bag_sum(indices: torch.Tensor,
                      table: torch.Tensor) -> torch.Tensor:
    """indices: (B, L) int32, any negative index a pad; table: (V, D) f32
    or bf16 (another dtype raises on either device).  Returns (B, D) in the
    table's dtype (f32 accumulation); an empty bag gives zeros."""
    if table.dtype not in _DTYPES:
        raise ValueError(f"embedding_bag_sum takes an f32 or bf16 table, "
                         f"not {table.dtype}")
    if max((*indices.shape, *table.shape[1:]), default=0) > INT_MAX:
        raise ValueError(f"embedding_bag_sum takes B, L, D <= {INT_MAX}")
    if table.device.type == "cpu":
        return embedding_bag_sum_plain(indices, table)
    check_indices(indices, table)
    dev = _build.require_cuda("embedding_bag_sum", indices, table)
    b, l = indices.shape
    d = table.shape[1]
    out = torch.empty((b, d), dtype=table.dtype, device=dev)
    if out.numel() == 0:
        return out
    if l == 0:
        return out.zero_()
    _build.launch("emb_bag_sum", dev, indices.data_ptr(), table.data_ptr(),
                  out.data_ptr(), b, l, d, _DTYPES[table.dtype])
    embedding_bag_sum.launches += 1
    return out


embedding_bag_sum.launches = 0
