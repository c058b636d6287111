"""``LocalMesh``: p virtual shards stacked on one device.

The port's counterpart of ``jax.sharding.Mesh`` + ``shard_map``
(``repro.core.compat``).  Every per-shard array carries the shards as a
leading ``(p, ...)`` dimension, so per-shard computation is one batched
tensor op and each collective is a reshape plus a local reduction:

  * ``all_to_all`` (tiled, split and concat on dim 0) is a transpose of
    the ``(p_src, p_dst, block, ...)`` blocks;
  * ``all_gather`` is a broadcast of every shard's array to every shard;
  * ``psum_scatter`` (tiled) is a sum over the source shards of each
    destination block.

A mesh may have several named axes (``shape=(2, 2)``); shard ``k`` sits at
the row-major coordinate of ``k`` over ``shape``, as ``Mesh``'s devices
do.  A collective over a tuple of axes spans the shards that differ only
in those coordinates, linearized major-first in the order given (JAX's
rule), so the hierarchical exchange can hop one axis at a time.
``LocalMesh.grid(r, c, device)`` is the ``(rows, cols)`` mesh of the 2-D
partition: shard ``k`` sits at grid cell ``(k // c, k % c)`` and owns
vertex chunk ``k``.  Each collective runs inside a ``bfs.collective``
profiler range (``core.spans``); the level loop's host reads go through
``host_read``.

The level loop reads across shards only through the mesh: ``psum`` and
``pmax`` are its replicated control reductions (JAX's ``lax.psum`` of the
termination flag, the level statistics and the overflow flag), and
``local_shards`` names the shards held here (all ``p`` on a
``LocalMesh``).  ``core.dist_mesh.DistMesh`` is the same interface over a
``torch.distributed`` group, one shard per rank.

A loss over the shards (owner-exchange GraphCast,
``models.gnn.dist_graphcast``) is differentiated through the mesh:
here ``all_to_all`` and ``psum`` are reshapes, permutes and sums, which
autograd differentiates itself, and ``replicate`` (parameters every
shard reads) is the identity, since the shards share the one tensor and
autograd sums their contributions.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.spans import COLLECTIVE, HOST_READ, span


def check_shape(shape, axis_names) -> tuple:
    """``(shape, axis_names)`` as int and name tuples, or a ValueError."""
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names "
                         f"{axis_names}")
    if any(int(s) < 1 for s in shape):
        raise ValueError(f"mesh sizes must be >= 1 ({shape})")
    return tuple(int(s) for s in shape), tuple(axis_names)


class MeshAxes:
    """The axis bookkeeping both meshes share (``shape`` and
    ``axis_names`` are the subclass's)."""

    @property
    def p(self) -> int:
        return math.prod(self.shape)

    def axes(self, axis) -> tuple:
        axes = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"unknown mesh axis {a!r}; mesh has "
                                 f"{self.axis_names}")
        if len(set(axes)) != len(axes):
            raise ValueError(f"repeated mesh axis in {axes}")
        return axes

    def axis_size(self, axis) -> int:
        return math.prod(self.shape[self.axis_names.index(a)]
                         for a in self.axes(axis))


@dataclasses.dataclass(frozen=True)
class LocalMesh(MeshAxes):
    shape: tuple
    axis_names: tuple
    device: torch.device

    #: how a collective's bytes travel: permutes on the one card's HBM
    link = "hbm"

    def __post_init__(self):
        shape, names = check_shape(self.shape, self.axis_names)
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "axis_names", names)
        object.__setattr__(self, "device", torch.device(self.device))

    @classmethod
    def flat(cls, p: int, device, name: str = "bfs_p") -> "LocalMesh":
        """A one-axis mesh of ``p`` shards."""
        return cls((p,), (name,), device)

    @classmethod
    def grid(cls, r: int, c: int, device,
             names: tuple = ("rows", "cols")) -> "LocalMesh":
        """An ``r x c`` mesh for the 2-D edge partition: the expand phase
        gathers over ``names[1]`` (within a grid row), the fold phase
        merges over ``names[0]`` (within a grid column)."""
        return cls((r, c), names, device)

    @property
    def local_shards(self) -> range:
        """The global indices of the shards held here: all ``p``, stacked
        in order on the one device."""
        return range(self.p)

    def key(self) -> tuple:
        """What ``BFSPlan.plan_key`` keys the mesh on."""
        return (self.axis_names, self.shape, self.device)

    def describe(self) -> dict:
        return {"kind": "LocalMesh", "shape": self.shape,
                "axis_names": self.axis_names, "device": str(self.device),
                "transport": "stacked shards on one device"}

    # --- group layout: (p, ...) <-> (G participants, O groups, ...) -------
    def _perm(self, axis):
        dims = [self.axis_names.index(a) for a in self.axes(axis)]
        rest = [d for d in range(len(self.shape)) if d not in dims]
        return dims + rest, len(dims)

    def _to_groups(self, x: torch.Tensor, axis) -> torch.Tensor:
        perm, k = self._perm(axis)
        nd = len(self.shape)
        y = x.reshape(*self.shape, *x.shape[1:])
        y = y.permute(*perm, *range(nd, y.dim()))
        g = math.prod(y.shape[:k])
        return y.reshape(g, self.p // g, *x.shape[1:])

    def _from_groups(self, y: torch.Tensor, axis) -> torch.Tensor:
        perm, k = self._perm(axis)
        nd = len(self.shape)
        y = y.reshape(*(self.shape[d] for d in perm), *y.shape[2:])
        inv = [perm.index(d) for d in range(nd)]
        y = y.permute(*inv, *range(nd, y.dim()))
        return y.reshape(self.p, *y.shape[nd:])

    # --- the level loop's control plane ------------------------------------
    def host_read(self, x: torch.Tensor):
        """Read a small control tensor (a termination flag, the level
        statistics, an overflow predicate) to the host: ``x.tolist()``.
        The JAX loop reduces these with replicated psums; here every
        device-to-host read of the level loop goes through this method,
        so a recording mesh (``analysis.collective_audit``) counts them a
        level, and the recorder times each as a ``bfs.host_read`` span."""
        with span(HOST_READ):
            return x.tolist()

    def enter_level(self, level: int, kind: str) -> None:
        """The level loop says what it runs next: ``kind`` is ``"sources"``
        (level 0, the sources' statistics), ``"dense"``, ``"queue"`` or
        ``"bottom_up"`` (``level`` >= 1), ``"escalated"`` (a queue level
        that overflowed and now runs its dense exchange) or ``"outside"``
        (the loop is done).  Nothing here; a recording mesh
        (``analysis.collective_audit``) files each collective and host
        read under it."""

    def replicate(self, leaves: list) -> list:
        """Parameters that every shard reads (JAX's ``P()`` in-spec): the
        leaves themselves; their gradient sums every shard's use."""
        return list(leaves)

    # --- collectives on stacked (p, ...) arrays ----------------------------
    def axis_index(self, axis) -> torch.Tensor:
        """(p,) int64: each shard's index within its ``axis`` group."""
        g = self.axis_size(axis)
        idx = torch.arange(g, device=self.device)[:, None].expand(
            g, self.p // g)
        return self._from_groups(idx, axis)

    def all_to_all(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Tiled all-to-all over dim 0 of each shard's array: block ``k``
        of shard ``i``'s ``(G*blk, ...)`` array lands as block ``i`` of
        shard ``k``'s result."""
        with span(COLLECTIVE):
            y = self._to_groups(x, axis)                 # (G, O, G*blk, ...)
            g, o, length = y.shape[:3]
            y = y.reshape(g, o, g, length // g, *y.shape[3:])
            y = y.permute(2, 1, 0, *range(3, y.dim()))  # (G_dst, O, G_src, ...)
            return self._from_groups(
                y.reshape(g, o, length, *y.shape[4:]), axis)

    def all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Untiled all-gather: ``(p, ...)`` -> ``(p, G, ...)``, row ``k`` of
        shard ``i``'s result is the array of group member ``k``."""
        with span(COLLECTIVE):
            y = self._to_groups(x, axis)                 # (G_src, O, ...)
            g = y.shape[0]
            y = y.transpose(0, 1).unsqueeze(0).expand(
                g, *y.transpose(0, 1).shape)
            return self._from_groups(y, axis)            # (p, G_src, ...)

    def psum_scatter(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Tiled reduce-scatter (sum) over dim 0: shard ``k`` receives the
        sum over its group of every member's block ``k``."""
        with span(COLLECTIVE):
            y = self._to_groups(x, axis)                 # (G, O, G*blk, ...)
            g, o, length = y.shape[:3]
            y = y.reshape(g, o, g, length // g, *y.shape[3:]).sum(
                dim=0, dtype=x.dtype)                    # (O, G_dst, blk, ...)
            return self._from_groups(y.transpose(0, 1), axis)

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Replicated sum over ``axis``: every member of a group receives
        the sum of the group's arrays (JAX's ``lax.psum``)."""
        with span(COLLECTIVE):
            y = self._to_groups(x, axis)                 # (G, O, ...)
            return self._from_groups(
                y.sum(dim=0, keepdim=True, dtype=x.dtype).expand_as(y), axis)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Replicated maximum over ``axis`` (JAX's ``lax.pmax``)."""
        with span(COLLECTIVE):
            y = self._to_groups(x, axis)
            return self._from_groups(
                y.amax(dim=0, keepdim=True).expand_as(y), axis)


def default_grid(p: int) -> tuple:
    """Most-square ``(r, c)`` factorization of ``p`` (``r <= c``).

    The 2-D exchange cost scales with ``r + c``, which a square grid
    minimizes; a prime ``p`` degenerates to ``(1, p)`` (no fold phase).
    """
    r = int(p ** 0.5)
    while p % r:
        r -= 1
    return r, p // r


def own_block(x: torch.Tensor, index: torch.Tensor, blk: int) -> torch.Tensor:
    """Per shard ``i``, block ``index[i]`` of length ``blk`` along dim 1:
    ``(p, G*blk, ...)`` -> ``(p, blk, ...)`` (JAX's ``dynamic_slice_in_dim``
    at ``axis_index * blk`` under ``shard_map``)."""
    p, length = x.shape[:2]
    y = x.reshape(p, length // blk, blk, *x.shape[2:])
    return y[torch.arange(p, device=x.device), index]
