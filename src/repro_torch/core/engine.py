"""Compile-once BFS lifecycle: ``plan() -> BFSPlan -> compile() -> BFSEngine``
— the port of ``repro.core.engine`` (the 1-D and 2-D partitions, each in
the dense, queue and ``auto`` modes).

  * ``plan(graph, opts, mesh=..., device=...)`` — host-side validation and
    static-shape derivation: checks options, resolves exchange strategies
    from the registry, fixes the ``LocalMesh`` and the source-batch
    capacity S.  Cheap; pure metadata (``BFSPlan``).
  * ``BFSPlan.compile()`` — uploads the graph's out-edges as a CSR by
    source on a packed dense wire (``kernels.expand_dense``), as edge rows
    on a bytes wire (or, under ``use_kernel``, the one-bit blocked
    adjacency; queue and ``auto`` plans also the out-edge blocks, ``auto``
    the in-edge rows of the bottom-up levels; a 2-D plan its grid cells'
    edge blocks) to the device and allocates the ``(n, S)`` dist and
    frontier buffers once.
  * ``BFSEngine.run(sources)`` — per traversal: sources are injected on
    the device into the reused buffers (the analogue of JAX's donated
    dist buffer), then the level loop runs.

Entry points run on CUDA unless the caller passes ``device="cpu"``; on a
machine without CUDA, ``plan()`` without a device raises rather than
carrying on on the CPU.  ``partition="2d"`` (inferred from a
``ShardedGraph2D``) runs the 2-D edge partition over an ``r x c``
``LocalMesh`` (``LocalMesh.grid``).

On a ``DistMesh`` (``core.dist_mesh``: one shard per rank of a
``torch.distributed`` group) every rank plans the same graph, compiles
only its own shard's blocks and ``(shard, S)`` buffers, and runs the same
levels; ``BFSResult.dist_host`` is the global matrix, all-gathered once
after the level loop and the same on every rank.

The serving surface: ``BFSPlan.plan_key()`` (what the ``EngineCache``
keys on), ``estimated_device_bytes()`` (what it charges), the bucket
ladder helpers ``normalize_ladder`` / ``pick_bucket`` / ``plan_ladder``,
the fault seams ``engine.compile`` and ``engine.dispatch``, and one
upload of each block group per graph and mesh, shared by every engine
that needs it.  ``describe()["roofline"]`` prices each level kind on the
H100 (``launch.roofline``) from the JAX plan's byte and operation counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import weakref
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from repro_torch.core import bfs
from repro_torch.core import exchange as ex
from repro_torch.core import frontier as fr
from repro_torch.core import spans
from repro_torch.core.bfs import (BFSOptions, BFSStats, INF, make_level_loop,
                                  make_level_loop_2d, validate_sources)
from repro_torch.core.mesh import LocalMesh
from repro_torch.core.spans import span
from repro_torch.launch.roofline import roofline_row
# chaos layer: a no-op global read unless a FaultPlan is installed (a
# stdlib-only module; degrade.py defers its engine import, so no cycle)
from repro_torch.serve.resilience import faults as _faults

if TYPE_CHECKING:   # graphs.formats imports core.partition, which runs core
    from repro_torch.graphs.formats import ShardedGraph, ShardedGraph2D


def _held(mesh) -> slice:
    """The shards ``mesh`` holds here, as a slice of a graph's ``(p,
    ...)`` host blocks."""
    held = mesh.local_shards
    return slice(held[0], held[-1] + 1)


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
    device (on a ``DistMesh``, this rank's ``(shard, S)`` rows).  It *is*
    the engine's reused buffer, so the engine's next run overwrites it:
    read ``dist_host`` (or clone ``dist``) first.  Reading ``dist_host`` of
    a result whose buffer was reused raises.  On a ``DistMesh`` the run
    gathers ``dist_host`` itself, so it is read already.
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
            lock = (self._engine._lock if self._engine is not None
                    else contextlib.nullcontext())
            with lock:       # no run of the engine overlaps the copy
                if (self._engine is not None
                        and self._engine._generation != self._generation):
                    raise RuntimeError("this result's dist buffer was reused "
                                       "by a later run of its engine; read "
                                       "dist_host before running again")
                # a copy even on the CPU, where .cpu() would alias the buffer
                self._dist_host = self.dist[
                    : self.n_logical, : self.n_sources].to(
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
        """Static plan metadata: shapes, resolved strategies and wires, the
        analytic per-level exchange bytes of each level kind (the JAX
        plan's keys), ``mesh`` (the mesh's kind and transport) and
        ``roofline``: each level kind's H100 roofline row
        (``launch.roofline.roofline_row``) over the JAX plan's byte and
        operation counts, which equal JAX's exactly.  On a ``LocalMesh``
        the collective is priced as HBM traffic and every term paid by each
        of its shards on the one card; on a ``DistMesh`` a card holds one
        shard and the collective crosses NVLink."""
        part = self.graph.part
        s, cap = self.num_sources, self.opts.queue_cap
        shards, link = len(self.mesh.local_shards), self.mesh.link
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
            "mesh": self.mesh.describe(),
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
            # HBM traffic = edge index reads (8B/edge) + frontier gather/
            # candidate scatter (1B/edge/source) + fold-width candidate
            # array passes + the dist read/write + mask tails
            e_p = self.graph2d.e_cap
            # byte passes only the *unfused* tail pays: the frontier pack
            # feeding the expand allgather, the c-segment row unpack the
            # expansion reads, the fold-word unpack, and the separate
            # new-frontier mask pass
            elim_hbm = (c + 5) * b * s if self.use_fused_tail else 0
            elim_flops = (c + 2) * b * s if self.use_fused_tail else 0
            meta["roofline"] = {
                "dense": roofline_row(
                    meta["dense_level_bytes"],
                    hbm_bytes=(8 * e_p + 2 * e_p * s
                               + (3 * r * b + 10 * b) * s - elim_hbm),
                    flops=(e_p + r * b + 4 * b) * s - elim_flops,
                    overlap=self.use_fused_tail, shards=shards, link=link),
                "queue": roofline_row(
                    meta["queue_level_bytes"],
                    hbm_bytes=(8 * e_p + e_p * s + 16 * (r + c) * cap
                               + 8 * b * s),
                    flops=(e_p + (r + c) * cap) * s,
                    overlap=False, shards=shards, link=link),
                "bottom_up": roofline_row(
                    meta["bottom_up_level_bytes"],
                    # the in-edge blocks build at compile time; the forward
                    # e_cap is the same-order proxy describe() may use
                    hbm_bytes=8 * e_p + e_p * s + 8 * b * s,
                    flops=e_p * s,
                    overlap=self.use_fused_tail, shards=shards, link=link),
            }
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
        e_p, in_e = self.graph.e_cap, self.graph.in_e_cap
        shard = part.shard_size
        # unfused-only byte passes (the 1-D shape of the 2-D list: the
        # expand-side frontier pack, the merged-word unpack, the separate
        # new-frontier mask pass)
        elim_hbm = 5 * shard * s if self.use_fused_tail else 0
        elim_flops = 2 * shard * s if self.use_fused_tail else 0
        meta["roofline"] = {
            "dense": roofline_row(
                meta["dense_level_bytes"],
                hbm_bytes=(8 * e_p + 2 * e_p * s
                           + (3 * part.n + 10 * shard) * s - elim_hbm),
                flops=(e_p + part.n + 4 * shard) * s - elim_flops,
                overlap=self.use_fused_tail, shards=shards, link=link),
            "queue": roofline_row(
                meta["queue_level_bytes"],
                hbm_bytes=(8 * e_p + e_p * s + 16 * part.p * cap
                           + 8 * shard * s),
                flops=(e_p + part.p * cap) * s,
                overlap=False, shards=shards, link=link),
            "bottom_up": roofline_row(
                meta["bottom_up_level_bytes"],
                hbm_bytes=8 * in_e + in_e * s + 8 * shard * s,
                flops=in_e * s,
                overlap=self.use_fused_tail, shards=shards, link=link),
        }
        return meta

    def plan_key(self) -> tuple:
        """Canonical hashable fingerprint of everything a compile depends
        on: graph content, options, mesh, partition scheme, source
        capacity and the *resolved* exchange strategies (the JAX plan's
        key).  Two plans with equal keys build identical engines, so the
        ``EngineCache`` (serve/engine_cache.py) hands out one engine for
        both.  Strategies enter by resolved name, so ``"auto"`` and the
        strategy it resolved to key the same; the graph enters by content
        hash, so two block-identical graphs share engines.  The mesh
        enters by axis names, shape and ``torch.device`` (``mesh.key()``; a
        ``DistMesh`` adds its backend and ranks): a CPU plan and a card
        plan never share an engine, nor a stacked and a distributed one.
        """
        mesh_key = self.mesh.key()
        o = self.opts
        opt_key = (o.mode, o.local_update, o.dedupe, o.queue_cap,
                   o.queue_threshold, o.bottom_up_threshold, o.use_kernel,
                   # the bottom-up gather and the sieve have no registry
                   # strategy, so their resolutions key here, as does the
                   # resolved fused tail
                   self.bottom_up_wire, self.sieve, self.use_fused_tail)
        strat_key = tuple(
            st.name if st is not None else None
            for st in (self.dense_strategy, self.queue_strategy,
                       self.expand_strategy, self.fold_strategy,
                       self.expand_sparse_strategy, self.fold_sparse_strategy))
        graph_fp = (self.graph2d.fingerprint() if self.partition == "2d"
                    else self.graph.fingerprint())
        axis_key = (tuple(self.axis) if isinstance(self.axis, tuple)
                    else self.axis)
        return ("bfs_plan", graph_fp, self.partition, mesh_key, axis_key,
                opt_key, strat_key, self.num_sources, self.max_levels)

    def device_byte_terms(self) -> dict:
        """The three parts of ``estimated_device_bytes``, in bytes:

          * ``resident`` — what a compiled engine holds for its lifetime
            and shares with every engine of the graph on the same mesh
            (``DeviceBlockCache``): on a packed 1-D dense wire the out-edge
            CSR of ``kernels.expand_dense`` (an int32 target an edge and
            ``shard + 1`` int64 offsets a shard), else the int64 rows of
            the valid edges (``dense_edge_index``, 16 bytes an edge; a
            fused packed 2-D expand's ``dense_2d_packed_edge_index``, 28),
            or under ``use_kernel`` the one-bit tiles (2 KiB a tile) with
            their column masks, block rows, columns and row pointer; in queue
            and ``auto`` the out-edge state of the padded blocks
            (``out_edge_state``: int64 sources, int32 targets and the
            mask, 13 bytes a slot, and int64 out-degrees); in ``auto``
            the bottom-up rows (``bottom_up_edge_index``: 24 bytes an
            edge, 28 with the packed wire's bit); the validity words and
            the shards' mesh indices.
          * ``work`` — the ``(n, S)`` int32 dist and uint8 frontier, one
            generation, reused in place by every run.
          * ``transient`` — the most one step allocates on top: a level
            (below) or the build of a block group (int64 index
            temporaries over the padded blocks, under 64 bytes a slot).

        The level transients: ``expand_dense`` ORs into a ``(p * n,
        ceil(S / 64))`` table of 64-bit masks, beside each source row's
        masks, and writes the words (with the exchange's copies, under half
        a byte a candidate); the plain dense expansion of a bytes wire
        gathers an ``(E, S)`` uint8 array and scatters into ``(p, n, S)``
        candidates, which ``pack_bits`` turns into words through a bool, a
        padded bool and two int32 copies (10 bytes a candidate); a
        packed 2-D or bottom-up expansion gathers ``(E, S)`` int32 words
        and a uint8 copy (5 bytes an edge a column); a queue level's
        packing, sort and bucket temporaries over the padded blocks stay
        under 96 bytes a slot, and it may escalate to a dense level;
        besides, every level holds the previous and the new frontier and
        the packed generations (``4 n S``).

        On a ``DistMesh`` every term counts this rank's shard: its edges,
        slots and ``(shard, S)`` rows (the ``(n, S)`` candidates of a
        shard's dense level stay ``n`` long), so the ranks' ``resident``
        terms sum to the stacked engine's.
        """
        s = self.num_sources
        opts = self.opts
        mode = opts.mode
        held = self.mesh.local_shards
        local = len(held)
        g = self.graph2d if self.partition == "2d" else self.graph
        part = g.part
        n = part.n
        rows = local * part.shard_size

        def count(per_shard, total):
            # a stacked mesh holds every shard: the total needs no count
            return total if local == part.p else int(per_shard()[held].sum())

        edges = count(g.edge_counts, g.n_edges)
        slots = local * g.e_cap
        if self.partition == "2d":
            r, c = part.r, part.c
            slots_in = local * g.bottom_up_in_cap() if mode == "auto" else 0
            packed_rows = (self.use_fused_tail
                           and self.expand_strategy.wire == "packed")
            resident = edges * (28 if packed_rows else 16)
            if mode != "dense":
                resident += 13 * slots + 8 * rows * c
            dense_t = 5 * edges * s + 10 * (r + c) * rows * s
        else:
            slots_in = local * g.in_e_cap if mode == "auto" else 0
            if opts.use_kernel:
                kmax, blk = g.bsr_shard_caps()
                resident = (local * kmax * (blk * blk // 8 + blk // 8 + 8)
                            + 4 * (local * (-(-n // blk)) + 1))
                dense_t = 10 * local * n * s
            elif self.dense_strategy.wire == "packed":
                # expand_dense: its CSR, then a level's mask table, the
                # sources' masks and the words with the exchange's copies
                k64 = -(-s // 64)
                resident = 4 * edges + 8 * (rows + local)
                dense_t = 8 * k64 * (local * n + rows) + local * n * s // 2
            else:
                resident = 16 * edges
                dense_t = edges * s + 10 * local * n * s
            if mode != "dense":
                resident += 13 * slots + 8 * rows
        e_in = count(g.in_edge_counts, g.n_edges) if mode == "auto" else 0
        resident += e_in * (28 if self.bottom_up_wire == "packed" else 24)
        # the validity words, and each shard's indices along the mesh
        resident += 4 * fr.packed_words(part.shard_size) * local + 32 * local
        levels = [dense_t]
        if mode != "dense":
            levels.append(96 * slots + 10 * local * n + dense_t)
        if mode == "auto":
            levels.append(5 * e_in * s + local * n * s + 10 * rows * s)
        build = 64 * max(slots, slots_in)
        if opts.use_kernel:
            build += 64 * edges
        return {"resident": int(resident), "work": 5 * rows * s,
                "transient": int(max(max(levels) + 4 * rows * s, build))}

    def estimated_device_bytes(self) -> int:
        """Upper bound on the device memory a compiled engine of this plan
        takes over its compile and a run: ``resident + work + transient``
        of ``device_byte_terms``.  It is what the serving ``EngineCache``
        charges against its budget, priced from the static shapes before
        compiling.  It counts each engine's shared blocks in full, the
        safe direction for an eviction budget.
        """
        return sum(self.device_byte_terms().values())

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


def normalize_ladder(ladder) -> tuple:
    """Canonicalize a batch-size bucket ladder: ints, deduped, ascending.

    The serving front end compiles one engine per rung and routes every
    request to the smallest rung that fits, so a malformed ladder must
    fail at configuration time, not on the first mid-sized request.
    """
    rungs = tuple(sorted({int(s) for s in ladder}))
    if not rungs:
        raise ValueError("bucket ladder must name at least one batch size")
    if rungs[0] < 1:
        raise ValueError(f"bucket ladder sizes must be >= 1 ({list(ladder)})")
    return rungs


def pick_bucket(n_sources: int, ladder) -> int:
    """Smallest ladder rung that fits ``n_sources`` (bucket routing).

    The engine leaves unused source columns empty (``run_async`` accepts
    1..S sources), so routing to a larger rung costs only the padded
    columns' device work, never a recompile.
    """
    n = int(n_sources)
    if n < 1:
        raise ValueError(f"n_sources must be >= 1 ({n_sources})")
    for s in normalize_ladder(ladder):
        if n <= s:
            return s
    raise ValueError(
        f"{n} sources exceed the largest bucket {max(ladder)} of ladder "
        f"{sorted(set(int(s) for s in ladder))}; add a larger rung or "
        "split the request")


def plan_ladder(graph, opts: BFSOptions = BFSOptions(), *,
                mesh: Optional[LocalMesh] = None, axis=None,
                ladder=(1, 8, 64), partition: Optional[str] = None,
                device=None) -> dict:
    """Plan one engine per batch-size bucket: ``{S: BFSPlan}`` ascending.

    All rungs share the graph's device blocks (the per-(mesh, axis,
    group) upload dedup), so an extra rung costs its ``(n, S)`` working
    buffers, not a second copy of the graph.
    """
    return {s: plan(graph, opts, mesh=mesh, axis=axis, num_sources=s,
                    partition=partition, device=device)
            for s in normalize_ladder(ladder)}


# ---------------------------------------------------------------------------
# Engine: device-resident graph and reused (n, S) buffers
# ---------------------------------------------------------------------------

class _BlockGroup:
    """Weakref-able holder for one group of uploaded device tensors.

    The per-graph dedup map (``graphs.formats.DeviceBlockCache``) holds
    these *weakly* while each engine keeps a strong reference for its
    lifetime: engines of one graph share a single upload, and when the
    last engine holding a group is dropped (say, evicted from the
    serving ``EngineCache``) its device memory frees.
    """

    __slots__ = ("arrays", "__weakref__")

    def __init__(self, arrays):
        self.arrays = arrays


class BFSEngine:
    """A compiled traversal: run any number of source sets.

    Holds, for its lifetime, the out-edge CSR of the dense expansion (on
    a bytes wire its edge rows; under ``use_kernel`` the one-bit tiles,
    their column masks, the block-row pointer, the block columns and each
    tile's block row: ``kernel_arrays``), for queue and ``auto`` plans the
    out-edge state, for ``auto`` plans the in-edge rows of the bottom-up
    levels, and the ``(n, S)`` dist and frontier buffers, which every
    ``run`` reinitializes in place.  A 2-D plan holds its cells' blocks the same way
    (``_build_2d``).  The blocks are uploaded once per graph, mesh, axis
    and group (``graphs.formats.DeviceBlockCache``), so every engine of a
    ladder shares them, and they free with the last engine holding them.

    Runs of one engine are serialized by a lock, which reading a result's
    ``dist_host`` also takes.  ``settle()`` reads the last result's host
    copy before a run reuses its buffer (the serving layer calls it).

    ``trace_count`` stays at ``compile_traces`` (the level function is
    built once at construction and never rebuilt), for parity with the
    JAX engine whose tests pin it.
    """

    def __init__(self, plan_: BFSPlan):
        with spans.setup_span(spans.ENGINE_COMPILE):
            self._compile(plan_)

    def _compile(self, plan_: BFSPlan) -> None:
        from repro_torch.graphs.formats import device_block_cache

        self.plan = plan_
        _faults.fire("engine.compile", _faults.plan_tag(plan_))
        part = plan_.graph.part
        dev = plan_.device
        s = plan_.num_sources
        self._generation = 0
        self._lock = threading.RLock()
        self._last = None             # weakref to the last run's result
        self.kernel_arrays = None
        self._block_holders = []
        owner = plan_.graph2d if plan_.partition == "2d" else plan_.graph
        # engines compile from several threads (EngineCache compiles
        # outside its lock), so the check-then-upload runs under the
        # graph's own lock: one graph's group is never uploaded twice,
        # and compiles of unrelated graphs never wait on each other
        blocks = device_block_cache(owner)
        with blocks.lock:
            def cached(group, build):
                key = (plan_.mesh, plan_.axis, group)
                holder = blocks.map.get(key)
                if holder is None:
                    holder = blocks.map[key] = _BlockGroup(build())
                self._block_holders.append(holder)
                return holder.arrays

            if plan_.partition == "2d":
                self._run_levels = self._build_2d(cached)
            else:
                self._run_levels = self._build_1d(cached)
        # the rows of the shards held here: all n on a LocalMesh
        rows = len(plan_.mesh.local_shards) * part.shard_size
        self._dist = torch.empty((rows, s), dtype=torch.int32, device=dev)
        self._frontier = torch.empty((rows, s), dtype=torch.uint8,
                                     device=dev)
        self._trace_count = 1
        self.compile_traces = self._trace_count

    def estimated_device_bytes(self) -> int:
        """What the serving ``EngineCache`` charges for this engine: its
        plan's ``estimated_device_bytes()``."""
        return self.plan.estimated_device_bytes()

    def _build_2d(self, cached):
        """Upload the cell blocks and build the 2-D level loop.

        Every mode keeps the expansion's edge rows: the packed rows of
        ``expand_dense_2d_packed`` where the fused tail reads a packed
        expand, else the row block's byte rows.  Queue and ``auto`` plans
        keep the ``(p, e_cap)`` blocks' ``out_edge_state_2d`` for queue
        levels and statistics, and only ``auto`` builds the bottom-up
        in-edge blocks and uploads their rows.
        """
        pl_, opts = self.plan, self.plan.opts
        g2 = pl_.graph2d
        part2 = g2.part
        dev = pl_.device
        b, c = part2.shard_size, part2.c
        held = _held(pl_.mesh)
        uploads = {}

        def cells():
            if not uploads:
                uploads["cells"] = (
                    torch.as_tensor(g2.src_rowlocal[held]).to(dev),
                    torch.as_tensor(g2.dst_fold[held]).to(dev))
            return uploads["cells"]

        packed_rows = pl_.use_fused_tail and pl_.expand_strategy.wire == "packed"
        if packed_rows:
            edge_rows = cached("edges_2d:packed",
                               lambda: fr.dense_2d_packed_edge_index(
                                   *cells(), b, part2.fold_size))
        else:
            edge_rows = cached("edges_2d:bytes",
                               lambda: fr.dense_edge_index(
                                   *cells(), c * b, part2.fold_size))
        out_edges = in_rows = None
        if opts.mode != "dense":
            out_edges = cached("out_edges_2d", lambda: bfs.out_edge_state_2d(
                *cells(), part2, pl_.mesh, pl_.axis[1]))
        uploads.clear()
        if opts.mode == "auto":
            in_rows = self._bottom_up_rows(cached, "bottom_up_2d", g2, part2)
        vwords = cached("valid_2d", lambda: bfs.valid_words(part2, pl_.mesh))
        return make_level_loop_2d(
            part2, pl_.num_sources, g2.n_edges, pl_.mesh, pl_.axis[0],
            pl_.axis[1], opts, pl_.expand_strategy, pl_.fold_strategy,
            pl_.expand_sparse_strategy, pl_.fold_sparse_strategy, edge_rows,
            out_edges=out_edges, in_rows=in_rows,
            bottom_up_wire=pl_.bottom_up_wire, sieve=pl_.sieve,
            fused=pl_.use_fused_tail, vwords=vwords)

    def _bottom_up_rows(self, cached, group, graph, part):
        """The in-edge blocks as ``bottom_up_edge_index`` rows for the
        plan's bottom-up wire (one shared group per wire)."""
        wire = self.plan.bottom_up_wire
        packed = wire == "packed"
        w = fr.packed_words(part.shard_size)
        dev = self.plan.device
        held = _held(self.plan.mesh)
        return cached(f"{group}:{wire}", lambda: fr.bottom_up_edge_index(
            torch.as_tensor(graph.in_src_global[held]).to(dev),
            torch.as_tensor(graph.in_dst_local[held]).to(dev),
            part.shard_size, part.p * w if packed else part.n,
            w if packed else None))

    def _build_1d(self, cached):
        """Upload the 1-D blocks and build the 1-D level loop."""
        plan_ = self.plan
        graph, opts = plan_.graph, plan_.opts
        part = graph.part
        dev = plan_.device
        s = plan_.num_sources
        held = _held(plan_.mesh)
        uploads = {}

        def blocks():
            if not uploads:
                uploads["out"] = (
                    torch.as_tensor(graph.src_local[held]).to(dev),
                    torch.as_tensor(graph.dst_global[held]).to(dev))
            return uploads["out"]

        expand_fn, expand_packed, edge_rows = None, False, None
        if opts.use_kernel:
            expand_fn, expand_packed = self._build_kernel_expand(cached)
        elif plan_.dense_strategy.wire == "packed":
            expand_fn, expand_packed = self._build_dense_expand(cached), True
        else:
            edge_rows = cached("edges", lambda: fr.dense_edge_index(
                *blocks(), part.shard_size, part.n))
        out_edges = in_rows = None
        if opts.mode != "dense":
            # queue levels and the auto statistics read the out-edge
            # blocks; only auto runs bottom-up levels over the in-edges
            out_edges = cached("out_edges", lambda: bfs.out_edge_state(
                *blocks(), part.shard_size))
        uploads.clear()
        if opts.mode == "auto":
            in_rows = self._bottom_up_rows(cached, "bottom_up", graph, part)
        vwords = cached("valid", lambda: bfs.valid_words(part, plan_.mesh))
        return make_level_loop(
            part, s, graph.n_edges, plan_.mesh, plan_.axis,
            plan_.axes_sizes, opts, plan_.dense_strategy,
            plan_.queue_strategy, edge_rows, out_edges=out_edges,
            in_rows=in_rows, expand_fn=expand_fn,
            expand_emits_packed=expand_packed,
            bottom_up_wire=plan_.bottom_up_wire, sieve=plan_.sieve,
            fused=plan_.use_fused_tail, vwords=vwords)

    @property
    def trace_count(self) -> int:
        return self._trace_count

    def _build_kernel_expand(self, cached):
        """Bit-tile frontier expansion (``bsr_expand_bits``).

        Each shard's 128x128-blocked *transposed* adjacency (rows = global
        candidate ids, cols = the shard's local sources) is uploaded once,
        at one bit an entry (``bsr_bit_shards``; no f32 tile is made).
        The tile lists of the shards held here (all p on a
        ``LocalMesh``, a rank's own on a ``DistMesh``) are laid out as one
        block-diagonal block-CSR matrix — the ``j``-th held shard's rows
        and columns offset by ``j`` times its padded row and column counts
        — so one launch expands every held shard, and emits each one's
        candidates as the per-owner-blocked words of the packed wire.  The frontier goes in
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
        held = self.plan.mesh.local_shards
        local = len(held)
        dev = self.plan.device
        blk = DEFAULT_BLOCK
        row_pad, col_pad = -(-n // blk) * blk, -(-shard // blk) * blk
        nbr, nbc = row_pad // blk, col_pad // blk

        def build():
            with spans.setup_span(spans.TILE_BUILD):
                bits, cmask, brs, bcs, _, _ = graph.bsr_bit_shards(
                    device=dev, shards=held)
                kmax = bits.shape[1]
                offs = torch.arange(local, device=dev,
                                    dtype=torch.int32)[:, None]
                rows = (brs + offs * nbr).reshape(-1)
                cols = (bcs + offs * nbc).reshape(-1).contiguous()
                return (bits.reshape(local * kmax, blk, blk // 32),
                        cmask.reshape(local * kmax, blk // 32),
                        block_row_ptr(rows, cols, local * nbr, local * nbc),
                        rows, cols)

        # the closure holds the arrays, not the engine: no cycle keeps a
        # dropped engine's tiles on the device
        arrays = self.kernel_arrays = cached("kernel_bits", build)
        packed = self.plan.dense_strategy.wire == "packed"
        w_in, w_out = fr.packed_words(shard), col_pad // 32
        k = arrays[0].shape[0]

        def expand_fn(frontier, words):             # (local, shard, S)
            s = frontier.shape[-1]
            if words is None:
                words = fr.pack_bits(frontier)          # (local, W, S)
            if w_out > w_in:                            # zero block columns
                words = torch.nn.functional.pad(words,
                                                (0, 0, 0, w_out - w_in))
            tiles_read = None
            if spans.on():
                # the recorder counts what the kernel reads, and of what
                tiles_read = spans.device_counter(spans.TILES_READ, dev)
                spans.count(spans.EXPAND_LAUNCHES)
                spans.count(spans.TILES_HELD, k)
            cand = bsr_expand_bits(
                *arrays, words.reshape(local * w_out, s), n_valid=n,
                n_blocks=p, rows_per_group=row_pad,
                tiles_read=tiles_read).reshape(local, p * w_in, s)
            if packed:
                return cand
            return fr.unpack_bits(cand, shard, p)     # (local, n, S) uint8

        return expand_fn, packed

    def _build_dense_expand(self, cached):
        """The packed dense level's expansion (``kernels.expand_dense``):
        the held shards' out-edges as a CSR by source, built on the device
        once (one group per mesh and axis) from the host blocks a slice at
        a time, pushed straight to the wire's per-owner-blocked words.
        Returns ``expand_fn``."""
        from repro_torch.kernels.expand_dense import edge_csr, expand_dense

        graph = self.plan.graph
        part = graph.part
        dev = self.plan.device
        held = _held(self.plan.mesh)
        row_ptr, dst = cached("edges_csr", lambda: edge_csr(
            graph.src_local[held], graph.dst_global[held], part.shard_size,
            device=dev))

        def expand_fn(frontier, words):             # (local, shard, S)
            edges_read = None
            if spans.on():
                # the recorder counts the launches and the edges pushed
                edges_read = spans.device_counter(spans.EDGES_READ, dev)
                spans.count(spans.DENSE_LAUNCHES)
            return expand_dense(frontier, row_ptr, dst, n=part.n,
                                n_blocks=part.p, edges_read=edges_read)

        return expand_fn

    def settle(self) -> None:
        """Read the host copy of this engine's last result, if that result
        is still held and unread, so the next run may reuse its buffer.

        The serving layer calls this before every run: lanes that share
        an engine within one round, and the parts of a split, each keep
        their own distances, while a caller that drives the engine
        directly keeps the plain contract (a reused result raises).
        """
        last = self._last() if self._last is not None else None
        if last is not None:
            last.dist_host

    def run_async(self, sources) -> BFSResult:
        """Run one traversal without a final device sync.

        ``sources`` may hold 1..S vertex ids; unused engine columns stay
        empty (all-INF, sliced off by ``dist_host``).  The level loop
        itself reads one or two values a level from the device (see
        ``core.bfs``), so this returns after the traversal's last level.
        """
        pl_ = self.plan
        part = pl_.graph.part
        mesh = pl_.mesh
        # the lock is taken inside bfs.init, after the sources are checked
        with span(spans.RUN), contextlib.ExitStack() as locked:
            with span(spans.INIT):
                src_arr = validate_sources(sources, part.n_logical,
                                           max_sources=pl_.num_sources)
                n_req = int(src_arr.shape[0])
                if src_arr.max() > np.iinfo(np.int32).max:
                    raise ValueError("source ids exceed int32 range; the "
                                     "engine's distance/source buffers are "
                                     "int32")
                padded = np.full((pl_.num_sources,), -1, dtype=np.int32)
                padded[:n_req] = src_arr
                _faults.fire("engine.dispatch", _faults.plan_tag(pl_))
                locked.enter_context(self._lock)
                self._generation += 1
                src_dev = torch.from_numpy(padded).to(pl_.device)
                fr.init_dist_frontier(
                    src_dev, self._dist.shape[0], part.n_logical,
                    out=(self._dist, self._frontier),
                    row0=mesh.local_shards[0] * part.shard_size)
            # the first five values: the benchmark's control
            # (gpubench/control.py) swaps in a level loop that still
            # returns a sixth, the per-level times kept no longer
            stats = BFSRunStats(*self._run_levels(self._dist, self._frontier,
                                                  pl_.max_levels)[:5])
            res = BFSResult(
                dist=self._dist, run_stats=stats,
                n_logical=part.n_logical, n_sources=n_req,
                _engine=self, _generation=self._generation)
            if len(mesh.local_shards) < mesh.p:
                # a rank holds its own rows: every rank gathers all of
                # them once, after the level loop, in shard order
                full = mesh.all_gather(self._dist[None],
                                       tuple(mesh.axis_names))
                res._dist_host = full.view(-1, self._dist.shape[1])[
                    : part.n_logical, : n_req].to("cpu", copy=True).numpy()
                del full
            self._last = weakref.ref(res)
        return res

    def run(self, sources) -> BFSResult:
        """Run one traversal to completion (syncs the device)."""
        return self.run_async(sources).block()
