"""Plain torch EmbeddingBag oracle: gather + mask + sum — the port of
``repro.kernels.embedding_bag.ref``.

The same semantics as the JAX oracle: pad slots (any negative index) go
through ``where`` and add zero, so a pad over a non-finite row 0 adds
nothing.  Unlike ``jnp.take``, which fills an index >= V with NaN, an
index >= V raises.
"""

from __future__ import annotations

import torch


def check_indices(indices: torch.Tensor, table: torch.Tensor) -> None:
    """Raise unless indices is (B, L) int32 and table (V, D), with every
    index < V (one reduction over the indices and a host read)."""
    if indices.dim() != 2 or table.dim() != 2:
        raise ValueError(f"embedding_bag takes indices (B, L) and a table "
                         f"(V, D); got {tuple(indices.shape)}, "
                         f"{tuple(table.shape)}")
    if indices.dtype != torch.int32:
        raise ValueError(f"embedding_bag takes int32 indices, not "
                         f"{indices.dtype}")
    if indices.numel():
        top = int(indices.max())
        if top >= table.shape[0]:
            raise IndexError(f"embedding_bag: index {top} out of range for "
                             f"a table of {table.shape[0]} rows")


def bag_mean(sums: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Mean mode from sum mode: each bag's (B, D) sum divided, in its
    dtype, by the bag's count of valid slots (at least 1)."""
    counts = (indices >= 0).sum(dim=1, keepdim=True).clamp_min(1)
    return sums / counts.to(sums.dtype)


def embedding_bag_sum_ref(indices: torch.Tensor,
                          table: torch.Tensor) -> torch.Tensor:
    """indices: (B, L) int32, negative pads; table: (V, D).  Returns (B, D)
    in the table's dtype."""
    check_indices(indices, table)
    valid = (indices >= 0)[..., None]
    rows = table[indices.clamp(min=0)]                     # (B, L, D)
    return torch.where(valid, rows, 0).sum(dim=1).to(table.dtype)


def embedding_bag_mean_ref(indices: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    return bag_mean(embedding_bag_sum_ref(indices, table), indices)
