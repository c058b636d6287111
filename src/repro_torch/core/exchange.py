"""Owner-exchange collectives — the port of ``repro.core.exchange``.

The paper's direct exchange (§5.1-2) sends each destination's candidates
straight to their owner instead of aggregating everything everywhere.
Every strategy is registered with ``@register_exchange(kind, name,
bytes_model, wire=...)``, which pairs the implementation with its analytic
per-chip byte model; plans resolve strategy names through this registry
(``"auto"`` picks the smallest modeled bytes), so a port plan names the
same strategies a JAX plan does.

The byte models of every kind are copied verbatim from the JAX package
(pure Python), so plan-time resolution matches it.  Every strategy runs
over a ``LocalMesh`` or a ``DistMesh`` (``impl(x, mesh, axis)``, ``x``
stacked ``(local, ...)`` over the shards held here: all p, or a rank's
one): the 1-D ``dense`` and ``queue`` kinds over the plan's axes,
the 2-D kinds over one grid axis each — ``expand_row*`` over the columns
axis (the ``c`` cells of a grid row), ``fold_col*`` over the rows axis
(the ``r`` cells of a grid column).

Packed twins (``<name>_packed``) carry int32 words holding the uint32 bit
pattern of ``frontier.pack_bits`` and merge with bitwise OR.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import frontier as _fr
from repro_torch.core.mesh import LocalMesh, own_block

#: on-wire payload layouts: raw ids / uint8 masks, packed bitset words
#: (dense phases), delta+varint compressed id streams (sparse phases)
WIRE_FORMATS = ("bytes", "packed", "compressed")


# ---------------------------------------------------------------------------
# Strategy registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExchangeStrategy:
    """A named exchange algorithm plus its analytic per-chip byte model.

    ``impl(x, mesh, axis)`` runs on stacked ``(p, ...)`` shard arrays;
    ``bytes_model`` is kind-specific: dense ``(n, p, s, itemsize,
    axes_sizes)``, queue ``(p, cap, itemsize, density)``.  Both return
    bytes *received* per chip per level.  ``wire`` is the payload layout
    the impl operates on.
    """

    name: str
    kind: str                 # see KINDS below
    impl: Callable
    bytes_model: Callable
    wire: str = "bytes"       # see WIRE_FORMATS


_REGISTRY: dict = {}          # (kind, name) -> ExchangeStrategy

KINDS = ("dense", "queue", "expand_row", "fold_col",
         "expand_row_sparse", "fold_col_sparse")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown exchange kind {kind!r}; "
                         f"expected one of: {', '.join(KINDS)}")


def register_exchange(kind: str, name: str, bytes_model: Callable,
                      wire: str = "bytes"):
    """Decorator: register an exchange impl under ``(kind, name)``.
    Re-registering a name overwrites it."""
    _check_kind(kind)
    if wire not in WIRE_FORMATS:
        raise ValueError(f"unknown wire format {wire!r}; "
                         f"expected one of: {', '.join(WIRE_FORMATS)}")

    def deco(fn):
        _REGISTRY[(kind, name)] = ExchangeStrategy(
            name=name, kind=kind, impl=fn, bytes_model=bytes_model,
            wire=wire)
        return fn

    return deco


def unregister_exchange(kind: str, name: str) -> None:
    """Remove a registered strategy; idempotent."""
    _REGISTRY.pop((kind, name), None)


def get_exchange(kind: str, name: str) -> ExchangeStrategy:
    _check_kind(kind)
    try:
        return _REGISTRY[(kind, name)]
    except KeyError:
        avail = ", ".join(sorted(n for k, n in _REGISTRY if k == kind))
        raise ValueError(
            f"unknown {kind} exchange strategy {name!r}; "
            f"registered: {avail}") from None


def select_exchange(kind: str, *model_args,
                    wire: Optional[str] = None) -> ExchangeStrategy:
    """The registered strategy with the smallest modeled bytes; ties break
    by name (which prefers a ``"bytes"`` impl over its ``_packed`` twin
    when both model to zero, e.g. at p = 1).  ``wire`` restricts the
    candidates to one wire format."""
    _check_kind(kind)
    cands = [st for (k, _), st in _REGISTRY.items()
             if k == kind and (wire is None or st.wire == wire)]
    if not cands:
        raise ValueError(f"no exchange strategies registered for {kind!r}"
                         + (f" with wire format {wire!r}" if wire else ""))
    return min(cands, key=lambda st: (st.bytes_model(*model_args), st.name))


class _StrategyNames:
    """Live tuple-like view of registered names of one kind."""

    def __init__(self, kind: str):
        self._kind = kind

    def _names(self) -> tuple:
        return tuple(n for k, n in _REGISTRY if k == self._kind)

    def __iter__(self):
        return iter(self._names())

    def __contains__(self, name) -> bool:
        return (self._kind, name) in _REGISTRY

    def __len__(self) -> int:
        return len(self._names())

    def __getitem__(self, i):
        return self._names()[i]

    def __repr__(self) -> str:
        return repr(self._names())


DENSE_STRATEGIES = _StrategyNames("dense")
QUEUE_STRATEGIES = _StrategyNames("queue")
EXPAND_ROW_STRATEGIES = _StrategyNames("expand_row")
FOLD_COL_STRATEGIES = _StrategyNames("fold_col")
EXPAND_ROW_SPARSE_STRATEGIES = _StrategyNames("expand_row_sparse")
FOLD_COL_SPARSE_STRATEGIES = _StrategyNames("fold_col_sparse")


def _or_reduce(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Bitwise-OR reduction over one dimension (packed-word merge)."""
    out = x.select(dim, 0).clone(memory_format=torch.contiguous_format)
    for k in range(1, x.shape[dim]):
        out |= x.select(dim, k)
    return out


# ---------------------------------------------------------------------------
# Dense candidate exchange: stacked (p, n, S) candidate masks -> (p, n/p, S)
# ---------------------------------------------------------------------------

def _bytes_allgather_merge(n, p, s, itemsize, axes_sizes):
    return (p - 1) * n * s * itemsize


def _bytes_alltoall_direct(n, p, s, itemsize, axes_sizes):
    return (p - 1) / p * n * s * itemsize


def _bytes_reduce_scatter(n, p, s, itemsize, axes_sizes):
    return (p - 1) / p * n * s * 2  # bf16 widening


def _bytes_hierarchical(n, p, s, itemsize, axes_sizes):
    sizes = list(axes_sizes) or [p]
    return sum((sz - 1) / sz * n * s * itemsize for sz in sizes)


@register_exchange("dense", "allgather_merge", _bytes_allgather_merge)
def _dense_allgather_merge(cand: torch.Tensor, mesh: LocalMesh,
                           axis) -> torch.Tensor:
    # [2]'s aggregate-then-scatter: every shard materializes the union of
    # all buffers, then keeps its own slice.
    shard = cand.shape[1] // mesh.axis_size(axis)
    merged = mesh.all_gather(cand, axis).amax(dim=1)     # (p, n, S)
    return own_block(merged, mesh.axis_index(axis), shard)


@register_exchange("dense", "alltoall_direct", _bytes_alltoall_direct)
def _dense_alltoall_direct(cand: torch.Tensor, mesh: LocalMesh,
                           axis) -> torch.Tensor:
    # Paper §5.1-2: send each destination's slice straight to its owner.
    g = mesh.axis_size(axis)
    recv = mesh.all_to_all(cand, axis)                   # (p, n, S)
    return recv.reshape(recv.shape[0], g, -1, *recv.shape[2:]).amax(dim=1)


@register_exchange("dense", "reduce_scatter", _bytes_reduce_scatter)
def _dense_reduce_scatter(cand: torch.Tensor, mesh: LocalMesh,
                          axis) -> torch.Tensor:
    # Let the collective merge: sum == OR for non-negative 0/1 masks; bf16
    # sums of non-negative small ints never round to zero.
    own = mesh.psum_scatter(cand.to(torch.bfloat16), axis)
    return (own > 0).to(cand.dtype)


@register_exchange("dense", "hierarchical", _bytes_hierarchical)
def _dense_hierarchical(cand: torch.Tensor, mesh: LocalMesh,
                        axis) -> torch.Tensor:
    # Two-phase exchange matched to the mesh topology, axes major-first;
    # after each hop the received blocks merge immediately.
    out = cand
    for ax in mesh.axes(axis):
        sz = mesh.axis_size(ax)
        recv = mesh.all_to_all(out, ax)
        out = recv.reshape(recv.shape[0], sz, -1, *recv.shape[2:]).amax(dim=1)
    return out


# --- packed dense strategies: int32 words (uint32 bits) on the wire -------

def _words_per_shard(n, p):
    return _fr.packed_words(n // p)


def _bytes_allgather_merge_packed(n, p, s, itemsize, axes_sizes):
    return (p - 1) * p * _words_per_shard(n, p) * 4 * s


@register_exchange("dense", "allgather_merge_packed",
                   _bytes_allgather_merge_packed, wire="packed")
def _dense_allgather_merge_packed(words: torch.Tensor, mesh: LocalMesh,
                                  axis) -> torch.Tensor:
    w = words.shape[1] // mesh.axis_size(axis)
    merged = _or_reduce(mesh.all_gather(words, axis), 1)   # (p, p*W, S)
    return own_block(merged, mesh.axis_index(axis), w)


def _bytes_alltoall_direct_packed(n, p, s, itemsize, axes_sizes):
    return (p - 1) * _words_per_shard(n, p) * 4 * s


@register_exchange("dense", "alltoall_direct_packed",
                   _bytes_alltoall_direct_packed, wire="packed")
def _dense_alltoall_direct_packed(words: torch.Tensor, mesh: LocalMesh,
                                  axis) -> torch.Tensor:
    # each owner's W-word block goes straight to it; the received partial
    # bitsets OR locally
    g = mesh.axis_size(axis)
    recv = mesh.all_to_all(words, axis)
    return _or_reduce(recv.reshape(recv.shape[0], g, -1, *recv.shape[2:]), 1)


@register_exchange("dense", "reduce_scatter_packed",
                   _bytes_alltoall_direct_packed, wire="packed")
def _dense_reduce_scatter_packed(words: torch.Tensor, mesh: LocalMesh,
                                 axis) -> torch.Tensor:
    # a sum carries across bit lanes, so the packed twin routes word blocks
    # directly and ORs locally (all-to-all bytes, kept under this name so
    # wire_format="packed" composes with every strategy name)
    return _dense_alltoall_direct_packed(words, mesh, axis)


def _bytes_hierarchical_packed(n, p, s, itemsize, axes_sizes):
    sizes = list(axes_sizes) or [p]
    w = _words_per_shard(n, p)
    return sum((sz - 1) / sz * p * w * 4 * s for sz in sizes)


@register_exchange("dense", "hierarchical_packed",
                   _bytes_hierarchical_packed, wire="packed")
def _dense_hierarchical_packed(words: torch.Tensor, mesh: LocalMesh,
                               axis) -> torch.Tensor:
    out = words
    for ax in mesh.axes(axis):
        sz = mesh.axis_size(ax)
        recv = mesh.all_to_all(out, ax)
        out = _or_reduce(recv.reshape(recv.shape[0], sz, -1, *recv.shape[2:]),
                         1)
    return out


def exchange_dense(cand: torch.Tensor, mesh: LocalMesh, axis,
                   strategy: str) -> torch.Tensor:
    """Merge stacked per-shard candidate masks; return each owner's slice.

    cand: (p, n, S) 0-1 masks over ALL global vertices, one per shard.
    Result: (p, n/p, S) of the same dtype, the OR across shards of each
    owner's slice.  Packed strategies are transparent here (pack before,
    unpack after); the engine keeps candidates packed instead.
    """
    g = mesh.axis_size(axis)
    n = cand.shape[1]
    if n % g:
        raise ValueError(f"dense exchange needs n ({n}) divisible by p ({g})")
    st = get_exchange("dense", strategy)
    if st.wire == "packed":
        own_words = st.impl(_fr.pack_bits(cand, n_blocks=g), mesh, axis)
        return _fr.unpack_bits(own_words, n // g).to(cand.dtype)
    return st.impl(cand, mesh, axis)


# ---------------------------------------------------------------------------
# Collectives of the queue and 2-D kinds (registered in their sections)
# ---------------------------------------------------------------------------

def _compressed_payload(cap, density):
    """Static byte size of one compressed id buffer (the model-side twin
    of ``frontier.compressed_capacity``)."""
    if density and density > 0:
        id_range = max(1, int(round(cap / density)))
    else:
        id_range = max(1, cap)
    return _fr.compressed_capacity(cap, id_range)


def _queue_allgather_merge(buckets: torch.Tensor, mesh: LocalMesh,
                           axis) -> torch.Tensor:
    # [2]-style aggregate-everywhere: every shard receives every buffer
    # (p^2 cap ids on the wire) and picks out the rows addressed to it.
    allb = mesh.all_gather(buckets, axis)      # (local, p_src, p_dst, cap)
    return allb[torch.arange(allb.shape[0], device=allb.device), :,
                mesh.axis_index(axis)]


def _queue_alltoall_direct(buckets: torch.Tensor, mesh: LocalMesh,
                           axis) -> torch.Tensor:
    # Paper §5.1-2 applied to queues: MPI_Alltoallv equivalent.
    return mesh.all_to_all(buckets, axis)


def allgather_frontier(frontier: torch.Tensor, mesh: LocalMesh,
                       axis) -> torch.Tensor:
    """(p, shard, S) -> (p, G*shard, S): the tiled all-gather over
    ``axis`` — the bottom-up pass's replicated frontier, and the 2-D
    expand's grid-row frontier (words, ids or payloads alike).

    The *frontier* (n bits) crosses the wire instead of the *candidate*
    set (up to E entries).  On a ``LocalMesh`` the result is one array
    seen through a stride-0 shard dimension, not p copies.
    """
    return mesh.all_gather(frontier, axis).flatten(1, 2)


# ---------------------------------------------------------------------------
# 2-D grid exchange: expand across a grid row, fold across a grid column
# ---------------------------------------------------------------------------
# Two small collectives a level instead of one over all p shards: an
# ``expand_row`` gather of the frontier among the c cells of a grid row
# (the columns axis) and a ``fold_col`` merge of transposed candidates
# among the r cells of a grid column (the rows axis).  Each is a 1-D
# collective above run over one grid axis, so the 2-D kinds register those
# implementations under their own names and byte models: dense
# ``(n, r, c, s, itemsize)`` with n the padded global vertex count, sparse
# ``(r, c, cap, itemsize, density=1.0)``.

def _bytes_expand_allgather(n, r, c, s, itemsize):
    return (c - 1) * (n // (r * c)) * s * itemsize


def _bytes_fold_alltoall(n, r, c, s, itemsize):
    return (r - 1) * (n // (r * c)) * s * itemsize


def _bytes_fold_reduce_scatter(n, r, c, s, itemsize):
    return (r - 1) * (n // (r * c)) * s * 2  # bf16 widening


def _grid_words(n, r, c):
    return _fr.packed_words(n // (r * c))


def _bytes_expand_allgather_packed(n, r, c, s, itemsize):
    return (c - 1) * _grid_words(n, r, c) * 4 * s


def _bytes_fold_alltoall_packed(n, r, c, s, itemsize):
    return (r - 1) * _grid_words(n, r, c) * 4 * s


def _bytes_expand_sparse_allgather(r, c, cap, itemsize, density=1.0):
    return (c - 1) * cap * itemsize


def _bytes_fold_sparse_alltoall(r, c, cap, itemsize, density=1.0):
    return (r - 1) * cap * itemsize


def _bytes_fold_sparse_allgather(r, c, cap, itemsize, density=1.0):
    return (r - 1) * r * cap * itemsize


def _bytes_expand_sparse_allgather_compressed(r, c, cap, itemsize,
                                              density=1.0):
    return (c - 1) * _compressed_payload(cap, density)


def _bytes_fold_sparse_alltoall_compressed(r, c, cap, itemsize, density=1.0):
    return (r - 1) * _compressed_payload(cap, density)


def _bytes_fold_sparse_allgather_compressed(r, c, cap, itemsize,
                                            density=1.0):
    return (r - 1) * r * _compressed_payload(cap, density)


# (kind, name, byte model, wire, implementation).  expand: the tiled
# gather of each cell's (b, S) chunk, W words or cap ids (or the
# compressed payload) into its grid row's, in column order.  fold: block
# rr of each column cell's (r*b, S) candidates (W words) goes to the cell
# at row rank rr, which merges the r it receives (max; OR; a bf16 sum);
# the sparse folds route (r, cap) id buckets (or payloads) by row.
for _kind, _name, _model, _wire, _impl in (
        ("expand_row", "allgather", _bytes_expand_allgather, "bytes",
         allgather_frontier),
        ("fold_col", "alltoall_reduce", _bytes_fold_alltoall, "bytes",
         _dense_alltoall_direct),
        ("fold_col", "reduce_scatter", _bytes_fold_reduce_scatter, "bytes",
         _dense_reduce_scatter),
        ("expand_row", "allgather_packed", _bytes_expand_allgather_packed,
         "packed", allgather_frontier),
        ("fold_col", "alltoall_reduce_packed", _bytes_fold_alltoall_packed,
         "packed", _dense_alltoall_direct_packed),
        ("fold_col", "reduce_scatter_packed", _bytes_fold_alltoall_packed,
         "packed", _dense_alltoall_direct_packed),
        ("expand_row_sparse", "allgather", _bytes_expand_sparse_allgather,
         "bytes", allgather_frontier),
        ("fold_col_sparse", "alltoall_direct", _bytes_fold_sparse_alltoall,
         "bytes", _queue_alltoall_direct),
        ("fold_col_sparse", "allgather_merge", _bytes_fold_sparse_allgather,
         "bytes", _queue_allgather_merge),
        ("expand_row_sparse", "allgather_compressed",
         _bytes_expand_sparse_allgather_compressed, "compressed",
         allgather_frontier),
        ("fold_col_sparse", "alltoall_direct_compressed",
         _bytes_fold_sparse_alltoall_compressed, "compressed",
         _queue_alltoall_direct),
        ("fold_col_sparse", "allgather_merge_compressed",
         _bytes_fold_sparse_allgather_compressed, "compressed",
         _queue_allgather_merge)):
    register_exchange(_kind, _name, _model, wire=_wire)(_impl)


def expand_row(frontier: torch.Tensor, mesh: LocalMesh, axis,
               strategy: str) -> torch.Tensor:
    """2-D expand phase: stacked (p, b, S) chunks -> (p, c*b, S) grid-row
    frontiers.  Packed strategies are transparent (pack before, unpack
    after); the engine keeps the words packed instead."""
    st = get_exchange("expand_row", strategy)
    if st.wire == "packed":
        c = mesh.axis_size(axis)
        words = st.impl(_fr.pack_bits(frontier), mesh, axis)
        return _fr.unpack_bits(words, frontier.shape[1],
                               n_blocks=c).to(frontier.dtype)
    return st.impl(frontier, mesh, axis)


def fold_col(cand: torch.Tensor, mesh: LocalMesh, axis,
             strategy: str) -> torch.Tensor:
    """2-D fold phase: stacked (p, r*b, S) fold-ordered candidates ->
    (p, b, S) owned.  Packed strategies are transparent here."""
    r = mesh.axis_size(axis)
    if cand.shape[1] % r:
        raise ValueError(f"fold needs len ({cand.shape[1]}) divisible by "
                         f"r ({r})")
    st = get_exchange("fold_col", strategy)
    if st.wire == "packed":
        words = st.impl(_fr.pack_bits(cand, n_blocks=r), mesh, axis)
        return _fr.unpack_bits(words, cand.shape[1] // r).to(cand.dtype)
    return st.impl(cand, mesh, axis)


# ---------------------------------------------------------------------------
# Sparse queue exchange: stacked (p, p, cap) per-destination id buffers
# ---------------------------------------------------------------------------

def _qbytes_alltoall_direct(p, cap, itemsize, density=1.0):
    return (p - 1) * cap * itemsize


def _qbytes_allgather_merge(p, cap, itemsize, density=1.0):
    return (p - 1) * p * cap * itemsize


register_exchange("queue", "allgather_merge", _qbytes_allgather_merge)(
    _queue_allgather_merge)
register_exchange("queue", "alltoall_direct", _qbytes_alltoall_direct)(
    _queue_alltoall_direct)


# --- compressed queue twins: per-destination delta+varint byte buffers.
# Bucket row j carries shard j's candidates *base-relative* (id - j*shard);
# the level loop encodes before and decodes after the collective.

def _qbytes_alltoall_direct_compressed(p, cap, itemsize, density=1.0):
    return (p - 1) * _compressed_payload(cap, density)


def _qbytes_allgather_merge_compressed(p, cap, itemsize, density=1.0):
    return (p - 1) * p * _compressed_payload(cap, density)


# the collectives move opaque rows, so the compressed (p, p, byte_cap)
# uint8 payloads route exactly as the id buffers do
register_exchange("queue", "alltoall_direct_compressed",
                  _qbytes_alltoall_direct_compressed, wire="compressed")(
    _queue_alltoall_direct)
register_exchange("queue", "allgather_merge_compressed",
                  _qbytes_allgather_merge_compressed, wire="compressed")(
    _queue_allgather_merge)


def exchange_queue(buckets: torch.Tensor, mesh: LocalMesh, axis,
                   strategy: str) -> torch.Tensor:
    """Route per-destination id buffers to their owners.

    buckets: stacked (p, p, cap); shard i's row j holds candidate global
    ids owned by shard j (-1 padded).  Returns (p, p, cap): shard i's row
    j = what shard j sent shard i.
    """
    g = mesh.axis_size(axis)
    if buckets.shape[1] != g:
        raise ValueError(f"queue exchange needs {g} buckets a shard, got "
                         f"{buckets.shape[1]}")
    return get_exchange("queue", strategy).impl(buckets, mesh, axis)


# ---------------------------------------------------------------------------
# Analytic per-chip byte models (used by plans and benchmarks)
# ---------------------------------------------------------------------------

def dense_level_bytes(strategy: str, n: int, p: int, s: int = 1,
                      itemsize: int = 1, axes_sizes: Sequence[int] = ()) -> float:
    """Bytes *received* per chip for one dense exchange."""
    return get_exchange("dense", strategy).bytes_model(
        n, p, s, itemsize, axes_sizes)


def queue_level_bytes(strategy: str, p: int, cap: int, itemsize: int = 4,
                      density: float = 1.0) -> float:
    return get_exchange("queue", strategy).bytes_model(
        p, cap, itemsize, density)


def bottomup_level_bytes(n: int, p: int, s: int = 1, itemsize: int = 1,
                         wire: str = "bytes") -> float:
    """Bytes received per chip for one bottom-up frontier allgather
    (``wire="packed"`` ships ``ceil((n/p)/32)`` words per peer)."""
    if wire == "packed":
        return (p - 1) * _words_per_shard(n, p) * 4 * s
    return (p - 1) / p * n * s * itemsize


def grid_level_bytes(expand_strategy: str, fold_strategy: str, n: int,
                     r: int, c: int, s: int = 1, itemsize: int = 1) -> float:
    """Bytes received per chip for one 2-D level (expand + fold phases)."""
    return (get_exchange("expand_row", expand_strategy).bytes_model(
                n, r, c, s, itemsize) +
            get_exchange("fold_col", fold_strategy).bytes_model(
                n, r, c, s, itemsize))


def grid_sparse_level_bytes(expand_strategy: str, fold_strategy: str,
                            r: int, c: int, cap: int, itemsize: int = 4,
                            density: float = 1.0) -> float:
    """Bytes received per chip for one sparse 2-D level."""
    return (get_exchange("expand_row_sparse", expand_strategy).bytes_model(
                r, c, cap, itemsize, density) +
            get_exchange("fold_col_sparse", fold_strategy).bytes_model(
                r, c, cap, itemsize, density))
