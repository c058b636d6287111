"""Public EmbeddingBag entry point — the port of
``repro.kernels.embedding_bag.ops``.

``use_kernel=True`` sends every call to the A5 wrapper (on a CUDA tensor
that launches the kernel or raises; there is no quiet fallback);
``use_kernel=False`` is the explicit oracle path.  Mean mode divides the
sum, in the table's dtype, by each bag's count of valid slots (at least
1), as the JAX wrapper does.
"""

from __future__ import annotations

from repro_torch.kernels.embedding_bag.kernel import embedding_bag_sum
from repro_torch.kernels.embedding_bag.ref import (bag_mean,
                                                   embedding_bag_mean_ref,
                                                   embedding_bag_sum_ref)


def embedding_bag(indices, table, *, mode: str = "sum",
                  use_kernel: bool = True):
    """EmbeddingBag(sum|mean) over (B, L) bags of rows of a (V, D) table.
    The operands are made contiguous (a copy where they are views) for the
    kernel."""
    if mode not in ("sum", "mean"):
        raise ValueError(mode)
    if not use_kernel:
        if mode == "sum":
            return embedding_bag_sum_ref(indices, table)
        return embedding_bag_mean_ref(indices, table)
    s = embedding_bag_sum(indices.contiguous(), table.contiguous())
    return s if mode == "sum" else bag_mean(s, indices)
