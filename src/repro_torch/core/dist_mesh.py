"""``DistMesh``: one shard per rank of a ``torch.distributed`` group.

The port's counterpart of a multi-device ``jax.sharding.Mesh`` under
``shard_map`` (``repro.core.compat``, ``repro.launch.mesh``): each rank
holds one shard, as each of the paper's processors holds one vertex block
and its edges, and reaches the other shards only through collectives.  It
has ``LocalMesh``'s interface, so the level loops, the exchange
strategies and the engine run unchanged on either mesh: every per-shard
tensor keeps a leading dimension, of 1 here (``local_shards`` is this
rank's one index), and each collective maps onto the group's:

  * ``all_to_all`` (tiled) -> ``all_to_all_single``;
  * ``all_gather`` -> the flat all-gather into one tensor, viewed as
    ``(1, G, ...)``;
  * ``psum_scatter`` (tiled) -> reduce-scatter (sum) into one tensor;
  * ``psum`` / ``pmax`` -> ``all_reduce`` with ``SUM`` / ``MAX``.

Packed OR-merges stay all-to-all or all-gather plus a local OR
(``exchange._or_reduce``): NCCL has no bitwise-OR reduction.

A mesh may have several named axes; shard ``k`` (the rank within the
group) sits at the row-major coordinate of ``k`` over ``shape``.  The
constructor makes, on every rank and in one fixed order, a process group
for each subset of the axes (the whole group for all of them); a
collective over a tuple of axes runs on that subset's group.
``new_group`` orders its members by rank, which linearizes the tuple in
mesh order, while the tuple's own linearization is major-first in the
order given (JAX's rule, as ``LocalMesh``): where the two differ, the
blocks are permuted before and after the collective.

A loss over the shards (owner-exchange GraphCast,
``models.gnn.dist_graphcast``) is differentiated through the mesh, as
JAX differentiates through ``shard_map``; the collectives of
``torch.distributed`` are not differentiable, so where the input needs a
gradient:

  * ``all_to_all`` runs as an autograd function whose backward is the
    all-to-all of the cotangent (the tiled all-to-all is a permutation
    that is its own transpose);
  * ``psum`` passes the cotangent through unchanged: every rank
    differentiates its own replica of the sum, so each rank's summand
    gets the replica's cotangent once, not p times;
  * ``replicate`` (parameters every rank reads, JAX's ``P()`` in-spec)
    is the identity forward and one ``all_reduce`` (sum) of all the
    leaves' gradients backward, so each gradient sums every rank's
    contribution exactly once.

The BFS engine never asks for a gradient, so its collectives take the
plain route.

Backends: ``nccl`` (one rank a card, device tensors) and ``gloo`` (CPU
tensors, or CUDA tensors of ranks that share a card: NCCL refuses two
ranks on one GPU; ``gloo`` carries CUDA tensors through the host itself,
all five collectives, so nothing here stages them).  ``describe()``
reports the transport.  The mesh raises if no process group is
initialized or if the group's size differs from the shape's; it never
carries on as a one-rank mesh.
"""

from __future__ import annotations

import itertools
import math

import torch
import torch.distributed as dist

from repro_torch.core.mesh import MeshAxes, check_shape
from repro_torch.core.spans import COLLECTIVE, span

def _all_gather_single(out, inp, group):
    # the name without a deprecation warning where this torch has it
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, inp, group=group)


def _reduce_scatter_single(out, inp, group):
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, inp, op=dist.ReduceOp.SUM, group=group)


def _call(op: str, out: torch.Tensor, inp: torch.Tensor, group) -> None:
    """One group collective of ``op`` from ``inp`` into ``out``."""
    if op == "all_to_all":
        dist.all_to_all_single(out, inp, group=group)
    elif op == "all_gather":
        _all_gather_single(out, inp, group)
    elif op == "psum_scatter":
        _reduce_scatter_single(out, inp, group)
    else:
        out.copy_(inp)
        dist.all_reduce(out, op=(dist.ReduceOp.SUM if op == "psum"
                                 else dist.ReduceOp.MAX), group=group)


def _wants_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllToAll(torch.autograd.Function):
    """``mesh.all_to_all`` with the all-to-all of the cotangent as its
    backward."""

    @staticmethod
    def forward(ctx, mesh, x, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh._all_to_all(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return None, ctx.mesh._all_to_all(grad.contiguous(), ctx.axis), None


class _ReplicaSum(torch.autograd.Function):
    """``mesh.psum`` whose backward passes this rank's cotangent to this
    rank's summand."""

    @staticmethod
    def forward(ctx, mesh, x, axis):
        return mesh._all_reduce("psum", x, axis)

    @staticmethod
    def backward(ctx, grad):
        return None, grad, None


class _Replicate(torch.autograd.Function):
    """Identity on every leaf; backward, one all-reduce (sum) of all the
    leaves' gradients over the whole group."""

    @staticmethod
    def forward(ctx, mesh, *leaves):
        if len({t.dtype for t in leaves}) > 1:
            raise TypeError("replicate: leaves of one dtype only")
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in leaves)

    @staticmethod
    def backward(ctx, *grads):
        # grads are materialized: a leaf the loss missed arrives as zeros
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=ctx.mesh.group)
        out, at = [], 0
        for g in grads:
            out.append(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        return (None, *out)


class DistMesh(MeshAxes):
    """A mesh of ``prod(shape)`` shards, one on each rank of ``group``
    (the default group when None), on this rank's ``device``."""

    #: a collective's bytes cross the link between cards
    link = "nvlink"

    def __init__(self, shape, axis_names, device, group=None):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "DistMesh needs an initialized torch.distributed process "
                "group (init_process_group, or launch.init_distributed)")
        self.shape, self.axis_names = check_shape(shape, axis_names)
        self.device = torch.device(device)
        self.group = group
        self.ranks = tuple(dist.get_process_group_ranks(
            group if group is not None else dist.group.WORLD))
        if len(self.ranks) != self.p:
            raise ValueError(f"the process group has {len(self.ranks)} "
                             f"ranks; a mesh of shape {self.shape} needs "
                             f"{self.p}")
        self.rank = dist.get_rank(group)
        if self.rank < 0:
            raise ValueError("this process is not a member of the group")
        self.backend = str(dist.get_backend(group))
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not "
                             f"{self.device}")
        self._groups = self._make_groups()
        self._layouts, self._index = {}, {}

    @classmethod
    def flat(cls, device, group=None, name: str = "bfs_p") -> "DistMesh":
        """A one-axis mesh over every rank of ``group``."""
        ws = dist.get_world_size(group) if dist.is_initialized() else 1
        return cls((ws,), (name,), device, group)

    @classmethod
    def grid(cls, r: int, c: int, device, names: tuple = ("rows", "cols"),
             group=None) -> "DistMesh":
        """An ``r x c`` mesh for the 2-D edge partition: rank ``k`` sits at
        grid cell ``(k // c, k % c)`` and owns vertex chunk ``k``."""
        return cls((r, c), names, device, group)

    # --- identity ------------------------------------------------------
    def key(self) -> tuple:
        """What ``BFSPlan.plan_key`` and the device block cache key on: a
        ``DistMesh`` plan never shares a ``LocalMesh`` plan's engine."""
        return (self.axis_names, self.shape, self.device,
                ("dist", self.backend, self.ranks))

    def __eq__(self, other):
        if not isinstance(other, DistMesh):
            return NotImplemented
        return self.key() == other.key()

    def __hash__(self):
        return hash(self.key())

    def __repr__(self):
        return (f"DistMesh(shape={self.shape}, axis_names={self.axis_names}, "
                f"device={self.device}, rank={self.rank}, "
                f"backend={self.backend!r})")

    @property
    def local_shards(self) -> range:
        """The global index of the one shard this rank holds."""
        return range(self.rank, self.rank + 1)

    @property
    def transport(self) -> str:
        """How a collective's bytes travel."""
        if self.backend == "gloo":
            return f"gloo through the host, {self.device.type} tensors"
        return f"nccl, {self.device.type} tensors"

    @property
    def collectives_sync(self) -> bool:
        """True when every collective synchronizes the host (``gloo`` is a
        host transport), so counting synchronizing calls cannot tell the
        level loop's reads from its exchanges."""
        return self.backend == "gloo"

    def describe(self) -> dict:
        return {"kind": "DistMesh", "shape": self.shape,
                "axis_names": self.axis_names, "device": str(self.device),
                "backend": self.backend, "transport": self.transport,
                "rank": self.rank, "ranks": self.ranks}

    # --- groups and layouts -------------------------------------------
    def _coords(self, k: int) -> tuple:
        out = []
        for size in reversed(self.shape):
            out.append(k % size)
            k //= size
        return tuple(reversed(out))

    def _member_index(self, k: int, dims) -> int:
        """Shard ``k``'s index in its group over ``dims``, major-first in
        the order of ``dims``."""
        c, idx = self._coords(k), 0
        for d in dims:
            idx = idx * self.shape[d] + c[d]
        return idx

    def _make_groups(self) -> dict:
        """``{dims: (group, members)}`` for this rank's group over every
        subset of the axes (as sorted dims) with more than one shard.
        Every rank calls ``new_group`` for every group, in one order."""
        nd, out = len(self.shape), {}
        mine = self._coords(self.rank)
        for size in range(1, nd + 1):
            for dims in itertools.combinations(range(nd), size):
                if math.prod(self.shape[d] for d in dims) == 1:
                    continue
                if len(dims) == nd or math.prod(self.shape[d] for d in dims
                                                ) == self.p:
                    out[dims] = (self.group, tuple(range(self.p)))
                    continue
                rest = [d for d in range(nd) if d not in dims]
                for fixed in itertools.product(
                        *(range(self.shape[d]) for d in rest)):
                    members = tuple(
                        k for k in range(self.p)
                        if tuple(self._coords(k)[d] for d in rest) == fixed)
                    g = dist.new_group([self.ranks[k] for k in members])
                    if tuple(mine[d] for d in rest) == fixed:
                        out[dims] = (g, members)
        return out

    def _layout(self, axis):
        """``(group, G, order, inverse)`` of a collective over ``axis``:
        ``order[j]`` is the tuple-order member index of group rank ``j``
        (None where the two orders agree); ``G == 1`` has no group."""
        key = self.axes(axis)
        got = self._layouts.get(key)
        if got is None:
            dims = [self.axis_names.index(a) for a in key]
            g = math.prod(self.shape[d] for d in dims)
            if g == 1:
                got = (None, 1, None, None)
            else:
                group, members = self._groups[tuple(sorted(dims))]
                order = [self._member_index(k, dims) for k in members]
                if order == list(range(g)):
                    got = (group, g, None, None)
                else:
                    inv = [order.index(m) for m in range(g)]
                    got = (group, g,
                           torch.tensor(order, device=self.device),
                           torch.tensor(inv, device=self.device))
            self._layouts[key] = got
        return got

    # --- the level loop's control plane --------------------------------
    def host_read(self, x: torch.Tensor):
        """Read this rank's replica of a value the mesh already reduced
        (every rank reads the same, so every rank takes the same branch)."""
        return x.tolist()

    def enter_level(self, level: int, kind: str) -> None:
        """Nothing here (``LocalMesh.enter_level``)."""

    # --- collectives on (1, ...) per-rank arrays ------------------------
    def axis_index(self, axis) -> torch.Tensor:
        """(1,) int64: this rank's index within its ``axis`` group."""
        key = self.axes(axis)
        got = self._index.get(key)
        if got is None:
            dims = [self.axis_names.index(a) for a in key]
            got = self._index[key] = torch.tensor(
                [self._member_index(self.rank, dims)], device=self.device)
        return got

    def replicate(self, leaves: list) -> list:
        """Parameters that every rank reads (JAX's ``P()`` in-spec): the
        leaves, whose gradients are summed over the group once, in one
        all-reduce (the module docstring)."""
        if not any(_wants_grad(t) for t in leaves):
            return list(leaves)
        return list(_Replicate.apply(self, *leaves))

    def all_to_all(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Tiled all-to-all over dim 1 of the ``(1, G*blk, ...)`` array:
        block ``k`` goes to group member ``k``; block ``i`` of the result
        came from member ``i``.  Differentiable where ``x`` needs a
        gradient."""
        if _wants_grad(x):
            return _AllToAll.apply(self, x, axis)
        return self._all_to_all(x, axis)

    def _all_to_all(self, x: torch.Tensor, axis) -> torch.Tensor:
        group, g, order, inv = self._layout(axis)
        with span(COLLECTIVE):
            if g == 1:
                return x
            blocks = x[0].reshape(g, x.shape[1] // g, *x.shape[2:])
            if order is not None:
                blocks = blocks[order]
            inp = blocks.contiguous()
            out = torch.empty_like(inp)
            _call("all_to_all", out, inp, group)
            if inv is not None:
                out = out[inv]
            return out.reshape(x.shape)

    def all_gather(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Untiled all-gather: ``(1, ...)`` -> ``(1, G, ...)``, row ``k``
        the array of group member ``k``."""
        group, g, _, inv = self._layout(axis)
        with span(COLLECTIVE):
            if g == 1:
                return x.unsqueeze(1)
            # the (1, ...) input is one of the output's G row blocks
            inp = x.contiguous()
            out = inp.new_empty((g, *x.shape[1:]))
            _call("all_gather", out, inp, group)
            if inv is not None:
                out = out[inv]
            return out.unsqueeze(0)

    def psum_scatter(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Tiled reduce-scatter (sum) over dim 1: this rank receives the
        sum over its group of every member's block of its own index."""
        group, g, order, _ = self._layout(axis)
        with span(COLLECTIVE):
            if g == 1:
                return x
            blocks = x[0].reshape(g, x.shape[1] // g, *x.shape[2:])
            if order is not None:
                blocks = blocks[order]
            inp = blocks.contiguous()
            out = inp.new_empty((1, *inp.shape[1:]))
            _call("psum_scatter", out, inp, group)
            return out.reshape(1, x.shape[1] // g, *x.shape[2:])

    def _all_reduce(self, op: str, x: torch.Tensor, axis) -> torch.Tensor:
        group, g, _, _ = self._layout(axis)
        with span(COLLECTIVE):
            if g == 1:
                return x
            inp = x.contiguous()
            out = torch.empty_like(inp)
            _call(op, out, inp, group)
            return out

    def psum(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Replicated sum over ``axis`` (``all_reduce`` with ``SUM``);
        where ``x`` needs a gradient, its backward is the identity (the
        module docstring)."""
        if _wants_grad(x):
            return _ReplicaSum.apply(self, x, axis)
        return self._all_reduce("psum", x, axis)

    def pmax(self, x: torch.Tensor, axis) -> torch.Tensor:
        """Replicated maximum over ``axis`` (``all_reduce`` with ``MAX``)."""
        return self._all_reduce("pmax", x, axis)
