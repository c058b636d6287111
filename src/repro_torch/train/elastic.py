"""Elastic scaling: re-shard live state when the healthy-device set
changes — the port of ``repro.train.elastic``.

Two levels:
  * array/state level — ``reshard_state`` re-places a tree of tensors under
    a new mesh and spec assignment; this is what a trainer calls after a
    checkpoint restore onto fewer or more devices.
  * BFS/graph level — the 1-D partition is a pure function of (n, p), so
    rescaling is ``repartition`` + re-bucketing the edge blocks
    (``repartition_graph``, host numpy, bitwise JAX's); distance vectors
    re-slice (``repartition_vertex_array``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.core.partition import Partition1D
from repro_torch.graphs.formats import ShardedGraph, shard_graph


def reshard_state(state, new_mesh, new_specs):
    """Re-place every leaf of ``state`` under ``new_specs`` on
    ``new_mesh`` (a ``LocalMesh``: its shards share ``new_mesh.device``).

    Each leaf keeps its global value and lands on ``new_mesh.device`` as a
    new tensor: a leaf already there is copied on the device, a leaf from
    another device goes through the host, as JAX's ``np.asarray`` +
    ``device_put`` does.  The result never aliases the input, so an
    in-place update of the new state (``optim.adamw.apply_updates_``)
    leaves the old one as it was.  Each leaf is first checked against its
    spec on the new mesh (``launch.shardings.NamedSharding``): an unknown
    or repeated axis, or a dim its axes do not divide, raises
    ``ValueError`` before anything is copied."""
    from repro_torch.launch.shardings import to_named

    shardings = to_named(new_specs, new_mesh)
    tr.map_tree(lambda x, s: s.shard_shape(tuple(x.shape)), state,
                shardings)
    dev = new_mesh.device

    def place(x: torch.Tensor) -> torch.Tensor:
        if x.device == dev:
            return x.clone()
        host = x.detach().cpu()          # a new tensor unless x is there
        return host if dev.type == "cpu" else host.to(dev)

    return tr.map_tree(place, state)


def repartition_graph(g: ShardedGraph, new_p: int) -> ShardedGraph:
    """Rebuild the per-shard edge blocks for a new shard count."""
    src_l, dst_g, _, _ = g.flat()
    valid = dst_g >= 0
    # reconstruct the global COO from the out-edge blocks
    shard_ids = np.repeat(np.arange(g.p), g.e_cap)
    src_global = np.asarray(g.part.global_id(shard_ids, src_l))[valid]
    dst_global = np.asarray(dst_g)[valid]
    return shard_graph(src_global, dst_global, g.part.n_logical, new_p)


def repartition_vertex_array(x: np.ndarray, old: Partition1D,
                             new: Partition1D) -> np.ndarray:
    """Re-pad an ``(old.n, ...)`` vertex array for the new partition."""
    assert old.n_logical == new.n_logical
    logical = np.asarray(x)[: old.n_logical]
    return new.pad_vertex_array(logical)
