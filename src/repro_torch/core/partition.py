"""Vertex-block partitions (paper §2.1), the port of ``repro.core.partition``.

Every vertex of ``G(V, E)`` has exactly one *owner* shard, and only the
owner decides visitation and assigns a BFS level (owner-computes rule,
paper §2.3).  The distribution is a contiguous block one — vertex ``v`` is
owned by ``v // ceil(n/p)`` — so ``find_owner`` is one integer divide and
a shard's slice of any vertex-indexed array is a plain static slice.

The id maps are arithmetic only, so they work unchanged on python ints,
numpy arrays and torch tensors.  ``Partition2D`` keeps ``Partition1D``'s
vertex chunks and assigns each edge to a cell of an ``r x c`` grid.
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


@dataclasses.dataclass(frozen=True)
class Partition2D(_BlockVertexMixin):
    """2-D block partition of the adjacency matrix over an ``r x c`` grid.

    Vertices keep the same contiguous chunks as ``Partition1D(n, r*c)``
    (chunk ``k`` on grid cell ``(k // c, k % c)``), so vertex-indexed
    arrays shard identically under both schemes.  Edge ``(u, v)`` lives on
    the cell at grid row ``grid_row(owner(u))`` and grid column
    ``grid_col(owner(v))``.

    The blocks of each level's two-phase exchange:

      * row block ``i`` (expand phase) — the ``c`` contiguous chunks owned
        by grid row ``i``: global ids ``[i*c*b, (i+1)*c*b)``, gathered
        among the ``c`` cells of the row.
      * fold layout (column phase) — a cell's candidates target the ``r``
        chunks of its grid column ``j`` (chunks ``j, c+j, ...``), stored
        transposed as ``fold_index(v) = row_rank(owner(v)) * b +
        local_id(v)`` so the column all-to-all (``r`` participants)
        delivers chunk-contiguous slices straight to their owners.
    """

    n_logical: int
    r: int
    c: int

    def __post_init__(self):
        if self.n_logical <= 0 or self.r <= 0 or self.c <= 0:
            raise ValueError(
                f"bad partition ({self.n_logical=}, {self.r=}, {self.c=})")

    @property
    def kind(self) -> str:
        return "2d"

    @property
    def p(self) -> int:
        return self.r * self.c

    @property
    def shard_size(self) -> int:
        return -(-self.n_logical // self.p)  # ceil div

    @property
    def n(self) -> int:
        return self.shard_size * self.p

    # --- grid coordinate maps ---
    def grid_row(self, shard):
        return shard // self.c

    def grid_col(self, shard):
        return shard - (shard // self.c) * self.c

    @property
    def row_block_size(self) -> int:
        """Vertices per grid row (the expand-phase frontier segment)."""
        return self.c * self.shard_size

    @property
    def fold_size(self) -> int:
        """Length of the transposed fold-phase candidate layout (r * b)."""
        return self.r * self.shard_size

    def row_start(self, grid_row: int) -> int:
        return grid_row * self.row_block_size

    def fold_index(self, v):
        """Transposed candidate index: ``row_rank(owner(v)) * b + local``."""
        own = self.owner(v)
        return self.grid_row(own) * self.shard_size + self.local_id(v)

    @property
    def flat(self) -> Partition1D:
        """The equivalent 1-D vertex partition (identical owner map)."""
        return Partition1D(self.n_logical, self.p)
