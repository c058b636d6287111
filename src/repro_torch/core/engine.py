"""Compile-once BFS lifecycle: ``plan() -> BFSPlan -> compile() -> BFSEngine``
— the port of ``repro.core.engine`` (the 1-D and 2-D partitions, each in
the dense, queue and ``auto`` modes).

  * ``plan(graph, opts, mesh=..., device=...)`` — host-side validation and
    static-shape derivation: checks options, resolves exchange strategies
    from the registry, fixes the ``LocalMesh`` and the source-batch
    capacity S.  Cheap; pure metadata (``BFSPlan``).
  * ``BFSPlan.compile()`` — uploads the graph's edge rows (or, under
    ``use_kernel``, the one-bit blocked adjacency; queue and ``auto``
    plans also the out-edge blocks, ``auto`` the in-edge rows of the
    bottom-up levels; a 2-D plan its grid cells' edge blocks) to the
    device and allocates the ``(n, S)`` dist and frontier buffers once.
  * ``BFSEngine.run(sources)`` — per traversal: sources are injected on
    the device into the reused buffers (the analogue of JAX's donated
    dist buffer), then the level loop runs.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
machine without CUDA, ``plan()`` without a device raises rather than
carrying on on the CPU.  ``partition="2d"`` (inferred from a
``ShardedGraph2D``) runs the 2-D edge partition over an ``r x c``
``LocalMesh`` (``LocalMesh.grid``).  ``plan_key`` /
``estimated_device_bytes`` and the serving fault seams (ROADMAP Queue A
item 9) and the H100 roofline in ``describe()`` (item 11) come with later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core import exchange as ex
from repro_torch.core import frontier as fr
from repro_torch.core.bfs import (BFSOptions, BFSStats, INF, make_level_loop,
                                  make_level_loop_2d, validate_sources)
from repro_torch.core.mesh import LocalMesh

if TYPE_CHECKING:   # graphs.formats imports core.partition, which runs core
    from repro_torch.graphs.formats import ShardedGraph, ShardedGraph2D


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without CUDA and without an explicit device this raises."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the port on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Per-run stats and results
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BFSRunStats:
    """Per-traversal statistics.  The Python level loop already knows
    them on the host, so they are plain numbers."""

    levels: int
    comm_bytes: float          # analytic per-chip, summed in float32
    overflowed: bool           # a queue level overflowed (and ran dense)
    mode_counts: tuple         # (dense, queue, bottom_up) levels
    sieve_hits: int            # candidates dropped pre-collective
    level_seconds: tuple = ()  # host wall time of each level, ending in
                               # the level's termination sync

    def block(self) -> "BFSRunStats":
        return self

    def to_host(self) -> dict:
        return {
            "levels": int(self.levels),
            "comm_bytes": float(self.comm_bytes),
            "overflowed": bool(self.overflowed),
            "mode_counts": {"dense": int(self.mode_counts[0]),
                            "queue": int(self.mode_counts[1]),
                            "bottom_up": int(self.mode_counts[2])},
            "sieve_hits": int(self.sieve_hits),
        }


@dataclasses.dataclass
class BFSResult:
    """One traversal's outputs.

    ``dist`` is the padded global ``(n, S)`` int32 distance matrix on the
    device.  It *is* the engine's reused buffer, so the engine's next run
    overwrites it: read ``dist_host`` (or clone ``dist``) first.  Reading
    ``dist_host`` of a result whose buffer was reused raises.
    """

    dist: torch.Tensor
    run_stats: BFSRunStats
    n_logical: int
    n_sources: int             # actual requested sources (<= compiled S)
    _engine: Optional["BFSEngine"] = dataclasses.field(default=None,
                                                       repr=False)
    _generation: int = 0

    def block(self) -> "BFSResult":
        _sync(self.dist.device)
        return self

    @property
    def dist_host(self) -> np.ndarray:
        """Host copy of the distances sliced to the logical vertices and
        the requested sources (made once and cached)."""
        if not hasattr(self, "_dist_host"):
            if (self._engine is not None
                    and self._engine._generation != self._generation):
                raise RuntimeError("this result's dist buffer was reused by "
                                   "a later run of its engine; read "
                                   "dist_host before running again")
            # a copy even on the CPU, where .cpu() would alias the buffer
            self._dist_host = self.dist[: self.n_logical, : self.n_sources].to(
                "cpu", copy=True).numpy()
        return self._dist_host

    def stats(self) -> BFSStats:
        h = self.run_stats.to_host()
        visited = int((self.dist_host < INF).sum())
        return BFSStats(levels=h["levels"], visited=visited,
                        comm_bytes=h["comm_bytes"],
                        overflowed=h["overflowed"],
                        mode_counts=h["mode_counts"],
                        sieve_hits=h["sieve_hits"])


# ---------------------------------------------------------------------------
# Plan: validated static metadata for one (graph, opts, mesh, S) traversal
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BFSPlan:
    graph: ShardedGraph
    opts: BFSOptions
    mesh: LocalMesh
    axis: object               # str or tuple of mesh axis names
    axes_sizes: tuple
    num_sources: int           # compiled source-batch capacity S
    max_levels: int
    dense_strategy: Optional[ex.ExchangeStrategy] = None
    queue_strategy: Optional[ex.ExchangeStrategy] = None
    # 2-D plans: the r x c cell blocks and the four phase strategies that
    # replace the dense and queue exchanges
    partition: str = "1d"
    graph2d: Optional["ShardedGraph2D"] = None
    expand_strategy: Optional[ex.ExchangeStrategy] = None
    fold_strategy: Optional[ex.ExchangeStrategy] = None
    expand_sparse_strategy: Optional[ex.ExchangeStrategy] = None
    fold_sparse_strategy: Optional[ex.ExchangeStrategy] = None
    bottom_up_wire: str = "bytes"
    sieve: bool = False
    use_fused_tail: bool = False

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def describe(self) -> dict:
        """Static plan metadata: shapes, resolved strategies and wires, and
        the analytic per-level exchange bytes of each level kind (the JAX
        plan's keys, bar its TPU roofline)."""
        part = self.graph.part
        s, cap = self.num_sources, self.opts.queue_cap
        meta = {
            "mode": self.opts.mode,
            "partition": self.partition,
            "device": str(self.device),
            "p": part.p,
            "n": part.n,
            "n_logical": part.n_logical,
            "shard_size": part.shard_size,
            "num_sources": s,
            "max_levels": self.max_levels,
            "axes": self.axis if isinstance(self.axis, tuple) else (self.axis,),
            "axes_sizes": self.axes_sizes,
            "use_fused_tail": self.use_fused_tail,
            "use_kernel": self.opts.use_kernel,
            "sieve": self.sieve,
        }

        # sparse phases report their payload layout: "ids" or "compressed"
        def sparse_wire(strategy):
            return "ids" if strategy.wire == "bytes" else strategy.wire

        if self.partition == "2d":
            part2 = self.graph2d.part
            r, c, b = part2.r, part2.c, part2.shard_size
            density = cap / b
            sieve_bytes = ((part2.p - 1) * fr.sieve_layout(b)[2] * 4
                           if self.sieve else 0)
            phase_bytes = {
                "expand": self.expand_strategy.bytes_model(part2.n, r, c, s,
                                                           1),
                "fold": self.fold_strategy.bytes_model(part2.n, r, c, s, 1),
                "expand_sparse": self.expand_sparse_strategy.bytes_model(
                    r, c, cap, 4, density),
                "fold_sparse": self.fold_sparse_strategy.bytes_model(
                    r, c, cap, 4, density),
            }
            meta.update({
                "grid": (r, c),
                "expand_exchange": self.expand_strategy.name,
                "fold_exchange": self.fold_strategy.name,
                "expand_sparse_exchange": self.expand_sparse_strategy.name,
                "fold_sparse_exchange": self.fold_sparse_strategy.name,
                "wire_formats": {
                    "expand": self.expand_strategy.wire,
                    "fold": self.fold_strategy.wire,
                    "expand_sparse": sparse_wire(self.expand_sparse_strategy),
                    "fold_sparse": sparse_wire(self.fold_sparse_strategy),
                    "bottom_up": self.bottom_up_wire,
                },
                # no in_e_cap: the bottom-up blocks build at compile time
                "e_cap": self.graph2d.e_cap,
                "phase_bytes": phase_bytes,
                "dense_level_bytes": (phase_bytes["expand"]
                                      + phase_bytes["fold"]),
                "queue_level_bytes": (phase_bytes["expand_sparse"]
                                      + phase_bytes["fold_sparse"]
                                      + sieve_bytes),
                "bottom_up_level_bytes": ex.bottomup_level_bytes(
                    part2.n, part2.p, s, 1, wire=self.bottom_up_wire),
            })
            return meta
        sieve_bytes = ((part.p - 1) * fr.sieve_layout(part.shard_size)[2] * 4
                       if self.sieve else 0)
        meta.update({
            "dense_exchange": self.dense_strategy.name,
            "queue_exchange": self.queue_strategy.name,
            "wire_formats": {
                "dense": self.dense_strategy.wire,
                "queue": sparse_wire(self.queue_strategy),
                "bottom_up": self.bottom_up_wire,
            },
            "e_cap": self.graph.e_cap,
            "in_e_cap": self.graph.in_e_cap,
            "dense_level_bytes": self.dense_strategy.bytes_model(
                part.n, part.p, s, 1, self.axes_sizes),
            "queue_level_bytes": self.queue_strategy.bytes_model(
                part.p, cap, 4, cap / part.shard_size) + sieve_bytes,
            "bottom_up_level_bytes": ex.bottomup_level_bytes(
                part.n, part.p, s, 1, wire=self.bottom_up_wire),
        })
        return meta

    def compile(self) -> "BFSEngine":
        return BFSEngine(self)


_SPARSE_KINDS = ("queue", "expand_row_sparse", "fold_col_sparse")


def _resolve_strategy(kind: str, name: str, model_args: tuple,
                      wire_format: str = "bytes"):
    """Registry lookup, or byte-model auto-selection for name="auto".

    ``wire_format`` resolves each phase's payload layout: dense kinds
    choose between the uint8 mask and the ``<name>_packed`` twin, sparse
    kinds between raw ids and the ``<name>_compressed`` twin ("packed"
    maps to raw ids there, "compressed" to packed on dense kinds); "auto"
    takes whichever twin models fewer bytes, ties keeping the base.  A name
    that already carries the twin suffix is an explicit choice.
    """
    sparse = kind in _SPARSE_KINDS
    suffix = "_compressed" if sparse else "_packed"
    if sparse:
        effective = {"bytes": "bytes", "packed": "bytes",
                     "compressed": "compressed",
                     "auto": "auto"}[wire_format]
    else:
        effective = {"bytes": "bytes", "packed": "packed",
                     "compressed": "packed", "auto": "auto"}[wire_format]
    if name == "auto":
        wire = None if effective == "auto" else effective
        return ex.select_exchange(kind, *model_args, wire=wire)
    if effective == "bytes" or name.endswith(suffix):
        return ex.get_exchange(kind, name)
    try:
        twin = ex.get_exchange(kind, name + suffix)
    except ValueError:
        if effective != "auto":
            raise ValueError(
                f"{kind} strategy {name!r} has no {suffix[1:]} variant; "
                f"use wire_format='bytes' or 'auto'") from None
        return ex.get_exchange(kind, name)
    if effective != "auto":
        return twin
    base = ex.get_exchange(kind, name)
    return (twin if twin.bytes_model(*model_args)
            < base.bytes_model(*model_args) else base)


def _resolve_sieve(sieve, mode: str, p: int, s: int) -> bool:
    """Resolve ``BFSOptions.sieve``: only where a queue path runs, with a
    single source column; "auto" turns it on exactly when p > 1."""
    if mode == "dense" or s != 1:
        return False
    if sieve == "auto":
        return p > 1
    return bool(sieve)


def _resolve_bottom_up_wire(wire_format: str, n: int, p: int, s: int) -> str:
    """Packed-vs-bytes for the bottom-up frontier gather."""
    if wire_format == "packed":
        return "packed"
    if wire_format == "auto" and (
            ex.bottomup_level_bytes(n, p, s, wire="packed")
            < ex.bottomup_level_bytes(n, p, s)):
        return "packed"
    return "bytes"


def _resolve_fused_tail(use_fused_tail, mode: str, dense_wire: str) -> bool:
    """Resolve ``BFSOptions.use_fused_tail``: the fused kernel consumes the
    packed merged words, so ``True`` on a bytes wire fails loudly and
    "auto" turns it on exactly where the dense wire is packed (dense/auto
    modes)."""
    if use_fused_tail is False:
        return False
    packed = dense_wire == "packed"
    if use_fused_tail is True:
        if not packed:
            raise ValueError(
                "use_fused_tail=True needs the dense/fold phase on a "
                f"packed wire (resolved wire is {dense_wire!r}); set "
                "wire_format='packed' or 'auto', or drop the flag")
        return True
    return packed and mode in ("dense", "auto")


def plan(graph: ShardedGraph, opts: BFSOptions = BFSOptions(), *,
         mesh: Optional[LocalMesh] = None, axis=None, num_sources: int = 1,
         partition: Optional[str] = None, device=None) -> BFSPlan:
    """Validate options/topology and derive the static traversal shapes.

    ``mesh`` defaults to a one-axis ``LocalMesh`` of the graph's ``p``
    shards on ``device`` (CUDA unless given); a mesh passed in carries its
    own device.  ``num_sources`` fixes the source-batch capacity S; an
    engine accepts any 1..S sources per run.
    """
    # deferred: graphs.formats imports core.partition, which runs core
    from repro_torch.graphs.formats import ShardedGraph2D, to_2d

    opts.validate()
    part = graph.part
    s = int(num_sources)
    if num_sources < 1:
        raise ValueError(f"num_sources must be >= 1 ({num_sources})")
    if partition is None:
        partition = "2d" if isinstance(graph, ShardedGraph2D) else "1d"
    if partition not in ("1d", "2d"):
        raise ValueError(f"unknown partition scheme {partition!r}; "
                         "expected '1d' | '2d'")
    if opts.mode == "queue" and num_sources != 1:
        raise ValueError("queue frontier supports a single source "
                         f"(num_sources={num_sources})")
    if opts.use_kernel and opts.mode != "dense":
        raise ValueError(
            f"use_kernel requires mode='dense' (got mode={opts.mode!r}); "
            "the bsr_spmm expansion has no queue/bottom-up analog")
    if partition == "2d":
        if opts.use_kernel:
            raise ValueError("use_kernel is a 1-D dense path (the blocked "
                             "adjacency is encoded per vertex shard); not "
                             "available with partition='2d'")
        if mesh is None:
            if part.p != 1:
                raise ValueError("pass a 2-axis mesh whose r*c equals the "
                                 f"graph's p={part.p}")
            mesh = LocalMesh.grid(1, 1, resolve_device(device))
        elif device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device!r} differs from the mesh's "
                             f"{mesh.device}")
        axes = mesh.axes(axis if axis is not None else mesh.axis_names)
        if len(axes) != 2:
            raise ValueError(f"partition='2d' needs exactly two mesh axes "
                             f"(rows, cols); got {axes}")
        r, c = (mesh.axis_size(a) for a in axes)
        if r * c != part.p or mesh.p != part.p:
            raise ValueError(f"mesh grid {r}x{c} does not multiply to the "
                             f"graph's p={part.p}")
        if isinstance(graph, ShardedGraph2D):
            # the cell blocks are encoded for one grid shape; another
            # would index them wrongly
            if (part.r, part.c) != (r, c):
                raise ValueError(
                    f"graph's edge blocks are laid out for a "
                    f"{part.r}x{part.c} grid; mesh is {r}x{c}")
            graph2d = graph
        else:
            graph2d = to_2d(graph, r, c)
        grid_args = (graph2d.part.n, r, c, s, 1)
        # sparse models take the plan's frontier density, so compressed
        # twins price the payload the loop ships
        sparse_args = (r, c, opts.queue_cap, 4,
                       opts.queue_cap / graph2d.part.shard_size)
        # the fused tail reads the fold words, so it keys off the fold wire
        fold_strategy = _resolve_strategy(
            "fold_col", opts.fold_exchange, grid_args, opts.wire_format)
        return BFSPlan(
            graph=graph, opts=opts, mesh=mesh, axis=axes,
            axes_sizes=(r, c), num_sources=s,
            max_levels=opts.max_levels or part.n_logical,
            partition="2d", graph2d=graph2d,
            expand_strategy=_resolve_strategy(
                "expand_row", opts.expand_exchange, grid_args,
                opts.wire_format),
            fold_strategy=fold_strategy,
            expand_sparse_strategy=_resolve_strategy(
                "expand_row_sparse", opts.expand_sparse_exchange,
                sparse_args, opts.wire_format),
            fold_sparse_strategy=_resolve_strategy(
                "fold_col_sparse", opts.fold_sparse_exchange, sparse_args,
                opts.wire_format),
            bottom_up_wire=_resolve_bottom_up_wire(
                opts.wire_format, graph2d.part.n, part.p, s),
            sieve=_resolve_sieve(opts.sieve, opts.mode, part.p, s),
            use_fused_tail=_resolve_fused_tail(
                opts.use_fused_tail, opts.mode, fold_strategy.wire),
        )

    if isinstance(graph, ShardedGraph2D):
        raise ValueError("partition='1d' needs a 1-D ShardedGraph; this "
                         "graph holds 2-D edge blocks")

    if mesh is None:
        mesh = LocalMesh.flat(part.p, resolve_device(device))
        axis = "bfs_p"
    elif device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device!r} differs from the mesh's "
                         f"{mesh.device}")
    axis = axis if axis is not None else tuple(mesh.axis_names)
    axis = tuple(axis) if isinstance(axis, (list, tuple)) else axis
    axes = mesh.axes(axis)
    axes_sizes = tuple(mesh.axis_size(a) for a in axes)
    if int(np.prod(axes_sizes)) != part.p or mesh.p != part.p:
        raise ValueError(f"mesh axes {axes} of sizes {axes_sizes} do not "
                         f"multiply to the graph's p={part.p}")

    dense_strategy = _resolve_strategy(
        "dense", opts.dense_exchange,
        (part.n, part.p, s, 1, axes_sizes), opts.wire_format)
    return BFSPlan(
        graph=graph, opts=opts, mesh=mesh, axis=axis,
        axes_sizes=axes_sizes, num_sources=s,
        max_levels=opts.max_levels or part.n_logical,
        dense_strategy=dense_strategy,
        queue_strategy=_resolve_strategy(
            "queue", opts.queue_exchange,
            (part.p, opts.queue_cap, 4, opts.queue_cap / part.shard_size),
            opts.wire_format),
        bottom_up_wire=_resolve_bottom_up_wire(
            opts.wire_format, part.n, part.p, s),
        sieve=_resolve_sieve(opts.sieve, opts.mode, part.p, s),
        use_fused_tail=_resolve_fused_tail(
            opts.use_fused_tail, opts.mode, dense_strategy.wire),
    )


# ---------------------------------------------------------------------------
# Engine: device-resident graph and reused (n, S) buffers
# ---------------------------------------------------------------------------

class BFSEngine:
    """A compiled traversal: run any number of source sets.

    Holds, for its lifetime, the edge rows of the dense expansion (or,
    under ``use_kernel``, the one-bit tiles, their column masks, the
    block-row pointer, the block columns and each tile's block row:
    ``kernel_arrays``), for queue and ``auto`` plans the out-edge blocks,
    for ``auto`` plans the in-edge rows of the bottom-up levels, and the
    ``(n, S)`` dist and frontier buffers, which every ``run`` reinitializes
    in place.  A 2-D plan holds its cells' blocks the same way
    (``_build_2d``).

    ``trace_count`` stays at ``compile_traces`` (the level function is
    built once at construction and never rebuilt), for parity with the
    JAX engine whose tests pin it.
    """

    def __init__(self, plan_: BFSPlan):
        self.plan = plan_
        graph, opts = plan_.graph, plan_.opts
        part = graph.part
        dev = plan_.device
        s = plan_.num_sources
        self._generation = 0
        self.kernel_arrays = None
        if plan_.partition == "2d":
            self._run_levels = self._build_2d()
        else:
            self._run_levels = self._build_1d()
        self._dist = torch.empty((part.n, s), dtype=torch.int32, device=dev)
        self._frontier = torch.empty((part.n, s), dtype=torch.uint8,
                                     device=dev)
        self._trace_count = 1
        self.compile_traces = self._trace_count

    def _build_2d(self):
        """Upload the cell blocks and build the 2-D level loop.

        Every mode keeps the expansion's edge rows: the packed rows of
        ``expand_dense_2d_packed`` where the fused tail reads a packed
        expand, else the row block's byte rows.  Queue and ``auto`` plans
        keep the ``(p, e_cap)`` blocks for queue levels and statistics,
        and only ``auto`` builds the bottom-up in-edge blocks and uploads
        their rows.
        """
        pl_, opts = self.plan, self.plan.opts
        g2 = pl_.graph2d
        part2 = g2.part
        dev = pl_.device
        b, c = part2.shard_size, part2.c
        src_rowlocal = torch.as_tensor(g2.src_rowlocal).to(dev)
        dst_fold = torch.as_tensor(g2.dst_fold).to(dev)
        if pl_.use_fused_tail and pl_.expand_strategy.wire == "packed":
            edge_rows = fr.dense_2d_packed_edge_index(
                src_rowlocal, dst_fold, b, part2.fold_size)
        else:
            edge_rows = fr.dense_edge_index(src_rowlocal, dst_fold, c * b,
                                            part2.fold_size)
        out_edges = (src_rowlocal, dst_fold) if opts.mode != "dense" else None
        in_rows = None
        if opts.mode == "auto":
            in_rows = self._bottom_up_rows(g2.in_src_global, g2.in_dst_local,
                                           part2)
        return make_level_loop_2d(
            part2, pl_.num_sources, g2.n_edges, pl_.mesh, pl_.axis[0],
            pl_.axis[1], opts, pl_.expand_strategy, pl_.fold_strategy,
            pl_.expand_sparse_strategy, pl_.fold_sparse_strategy, edge_rows,
            out_edges=out_edges, in_rows=in_rows,
            bottom_up_wire=pl_.bottom_up_wire, sieve=pl_.sieve,
            fused=pl_.use_fused_tail)

    def _bottom_up_rows(self, in_src_global, in_dst_local, part):
        """Upload in-edge blocks as ``bottom_up_edge_index`` rows for the
        plan's bottom-up wire."""
        packed = self.plan.bottom_up_wire == "packed"
        w = fr.packed_words(part.shard_size)
        dev = self.plan.device
        return fr.bottom_up_edge_index(
            torch.as_tensor(in_src_global).to(dev),
            torch.as_tensor(in_dst_local).to(dev), part.shard_size,
            part.p * w if packed else part.n, w if packed else None)

    def _build_1d(self):
        """Upload the 1-D blocks and build the 1-D level loop."""
        plan_ = self.plan
        graph, opts = plan_.graph, plan_.opts
        part = graph.part
        dev = plan_.device
        s = plan_.num_sources
        expand_fn, expand_packed, edge_rows = None, False, None
        if opts.use_kernel:
            expand_fn, expand_packed = self._build_kernel_expand()
        else:
            src_local = torch.as_tensor(graph.src_local).to(dev)
            dst_global = torch.as_tensor(graph.dst_global).to(dev)
            edge_rows = fr.dense_edge_index(src_local, dst_global,
                                            part.shard_size, part.n)
        self._edge_rows = edge_rows
        out_edges = in_rows = None
        if opts.mode != "dense":
            # queue levels and the auto statistics read the out-edge
            # blocks; only auto runs bottom-up levels over the in-edges
            out_edges = (src_local, dst_global)
        if opts.mode == "auto":
            in_rows = self._bottom_up_rows(graph.in_src_global,
                                           graph.in_dst_local, part)
        return make_level_loop(
            part, s, graph.n_edges, plan_.mesh, plan_.axis,
            plan_.axes_sizes, opts, plan_.dense_strategy,
            plan_.queue_strategy, edge_rows, out_edges=out_edges,
            in_rows=in_rows, expand_fn=expand_fn,
            expand_emits_packed=expand_packed,
            bottom_up_wire=plan_.bottom_up_wire, sieve=plan_.sieve,
            fused=plan_.use_fused_tail)

    @property
    def trace_count(self) -> int:
        return self._trace_count

    def _build_kernel_expand(self):
        """Bit-tile frontier expansion (``bsr_expand_bits``).

        Each shard's 128x128-blocked *transposed* adjacency (rows = global
        candidate ids, cols = the shard's local sources) is uploaded once,
        at one bit an entry (``bsr_bit_shards``; no f32 tile is made).
        The p shards' tile lists are laid out as one block-diagonal
        block-CSR matrix — shard ``j``'s rows and columns offset by ``j``
        times its padded row and column counts — so one launch expands
        every shard, and emits each shard's candidates as the
        per-owner-blocked words of the packed wire.  The frontier goes in
        packed: as A1 re-packed it where the fused tail runs, else (the
        first level, an unfused plan) as ``pack_bits`` of the byte
        frontier; a bytes wire unpacks the candidate words.

        Returns ``(expand_fn, emits_packed)``.
        """
        from repro_torch.kernels.bsr_spmm.kernel import (DEFAULT_BLOCK,
                                                         block_row_ptr,
                                                         bsr_expand_bits)

        graph = self.plan.graph
        part = graph.part
        p, shard, n = part.p, part.shard_size, part.n
        dev = self.plan.device
        bits, cmask, brs, bcs, row_pad, col_pad = graph.bsr_bit_shards(
            device=dev)
        kmax, blk = bits.shape[1], DEFAULT_BLOCK
        nbr, nbc = row_pad // blk, col_pad // blk
        offs = torch.arange(p, device=dev, dtype=torch.int32)[:, None]
        rows = (brs + offs * nbr).reshape(-1)
        cols = (bcs + offs * nbc).reshape(-1).contiguous()
        tiles = bits.reshape(p * kmax, blk, blk // 32)
        cmask = cmask.reshape(p * kmax, blk // 32)
        row_ptr = block_row_ptr(rows, cols, p * nbr, p * nbc)
        # the closure holds the arrays, not the engine: no cycle keeps a
        # dropped engine's tiles on the device
        arrays = self.kernel_arrays = (tiles, cmask, row_ptr, rows, cols)
        packed = self.plan.dense_strategy.wire == "packed"
        w_in, w_out = fr.packed_words(shard), col_pad // 32

        def expand_fn(frontier, words):                 # (p, shard, S)
            s = frontier.shape[-1]
            if words is None:
                words = fr.pack_bits(frontier)          # (p, W, S)
            if w_out > w_in:                            # zero block columns
                words = torch.nn.functional.pad(words,
                                                (0, 0, 0, w_out - w_in))
            cand = bsr_expand_bits(
                *arrays, words.reshape(p * w_out, s), n_valid=n,
                n_blocks=p, rows_per_group=row_pad).reshape(p, p * w_in, s)
            if packed:
                return cand
            return fr.unpack_bits(cand, shard, p)       # (p, n, S) uint8

        return expand_fn, packed

    def run_async(self, sources) -> BFSResult:
        """Run one traversal without a final device sync.

        ``sources`` may hold 1..S vertex ids; unused engine columns stay
        empty (all-INF, sliced off by ``dist_host``).  The level loop
        itself reads one or two values a level from the device (see
        ``core.bfs``).
        """
        pl_ = self.plan
        part = pl_.graph.part
        src_arr = validate_sources(sources, part.n_logical,
                                   max_sources=pl_.num_sources)
        n_req = int(src_arr.shape[0])
        if src_arr.max() > np.iinfo(np.int32).max:
            raise ValueError("source ids exceed int32 range; the engine's "
                             "distance/source buffers are int32")
        padded = np.full((pl_.num_sources,), -1, dtype=np.int32)
        padded[:n_req] = src_arr
        self._generation += 1
        src_dev = torch.from_numpy(padded).to(pl_.device)
        fr.init_dist_frontier(src_dev, part.n, part.n_logical,
                              out=(self._dist, self._frontier))
        stats = BFSRunStats(*self._run_levels(self._dist, self._frontier,
                                              pl_.max_levels))
        return BFSResult(
            dist=self._dist, run_stats=stats,
            n_logical=part.n_logical, n_sources=n_req,
            _engine=self, _generation=self._generation)

    def run(self, sources) -> BFSResult:
        """Run one traversal to completion (syncs the device)."""
        return self.run_async(sources).block()
