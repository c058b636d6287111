"""1-D vertex-block partition (paper §2.1), the port of ``repro.core.partition``.

Every vertex of ``G(V, E)`` has exactly one *owner* shard, and only the
owner decides visitation and assigns a BFS level (owner-computes rule,
paper §2.3).  The distribution is a contiguous block one — vertex ``v`` is
owned by ``v // ceil(n/p)`` — so ``find_owner`` is one integer divide and
a shard's slice of any vertex-indexed array is a plain static slice.

The id maps are arithmetic only, so they work unchanged on python ints,
numpy arrays and torch tensors.  The 2-D partition waits for the 2-D slice
of the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np


class _BlockVertexMixin:
    """Shared owner/local-id algebra for contiguous block distributions.

    Relies on ``self.p``, ``self.shard_size``, ``self.n_logical`` and
    ``self.n``.
    """

    def owner(self, v):
        """``find_owner`` from the paper's algorithm (fig. 2, line 15).

        Valid for every padded id in ``[0, n)``: the tail padding ids
        ``[n_logical, n)`` land on the last shard(s) by construction
        (``n = p * shard_size``), never out of range.
        """
        return v // self.shard_size

    find_owner = owner  # the paper's name for the same map

    def local_id(self, v):
        return v - (v // self.shard_size) * self.shard_size

    def global_id(self, shard, local):
        return shard * self.shard_size + local

    def shard_start(self, shard: int) -> int:
        return shard * self.shard_size

    def shard_slice(self, shard: int) -> slice:
        """Padded-coordinate slice ``[shard*size, (shard+1)*size)``."""
        if not 0 <= shard < self.p:
            raise ValueError(f"shard {shard} outside [0, {self.p})")
        return slice(shard * self.shard_size, (shard + 1) * self.shard_size)

    def shard_logical_slice(self, shard: int) -> slice:
        """``shard_slice`` clipped to the logical vertex range."""
        s = self.shard_slice(shard)
        return slice(min(s.start, self.n_logical), min(s.stop, self.n_logical))

    def counts_per_owner(self, v: np.ndarray) -> np.ndarray:
        return np.bincount(np.asarray(self.owner(v)), minlength=self.p)

    def pad_vertex_array(self, x: np.ndarray, fill=0) -> np.ndarray:
        """Pad a length-``n_logical`` vertex-indexed array to length ``n``."""
        if x.shape[0] == self.n:
            return x
        pad = [(0, self.n - x.shape[0])] + [(0, 0)] * (x.ndim - 1)
        return np.pad(x, pad, constant_values=fill)

    def valid_mask_local(self) -> np.ndarray:
        """(p, shard_size) bool — True where the local slot is a real vertex."""
        gids = np.arange(self.n).reshape(self.p, self.shard_size)
        return gids < self.n_logical


@dataclasses.dataclass(frozen=True)
class Partition1D(_BlockVertexMixin):
    """Block 1-D partition of ``n_logical`` ids over ``p`` shards.

    ``n`` is padded up so every shard owns exactly ``shard_size`` ids;
    padding ids (``>= n_logical``) are valid to store but are never real
    vertices.
    """

    n_logical: int
    p: int

    def __post_init__(self):
        if self.n_logical <= 0 or self.p <= 0:
            raise ValueError(f"bad partition ({self.n_logical=}, {self.p=})")

    @property
    def kind(self) -> str:
        return "1d"

    @property
    def shard_size(self) -> int:
        return -(-self.n_logical // self.p)  # ceil div

    @property
    def n(self) -> int:
        """Padded global size (``p * shard_size``)."""
        return self.shard_size * self.p
