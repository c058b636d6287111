"""Owner-exchange GraphCast: the paper's §5 technique applied to GNN
message passing — the port of ``repro.models.gnn.dist_graphcast``.

The global model (``models.graphcast_forward``) gathers the FULL (N, D)
node table per gather per layer.  Here the exchange is explicit and
direct:

  * vertices 1-D partitioned (``core.partition``), edges bucketed by the
    OWNER of their destination (owner-computes aggregation);
  * each shard statically knows which of its rows every peer needs
    (``serve_ids``, deduplicated — the unique sources of the peer's
    edges); one ``all_to_all`` per layer ships exactly those rows;
  * per-edge sources then index the received buffer locally.

Bytes a shard sends a layer: p * r_cap * D * 4 (requested rows only)
against the global route's 2 * N * D * 4 of table gathers.
Locally-owned sources ride the same indexed buffer via the shard's own
all_to_all block (no wire cost), the paper's §5.1-(1) owner-local update.
Routing tables are static per graph: the request/serve handshake happens
once at build time (``build_routing``, numpy, bitwise JAX's), not per
step.

The loss runs on a mesh of the BFS engine's interface: a ``LocalMesh``
(p shards stacked on one device) or a ``DistMesh`` (a shard a rank).  It
is differentiable on both (``core.mesh``, ``core.dist_mesh``): the
gradients equal the global model's, as JAX's through ``shard_map``.
JAX's ``routing_specs`` / ``routing_batch_specs`` (dry-run specs) have no
counterpart yet.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tr
from repro_torch.configs.base import GNNConfig
from repro_torch.core.partition import Partition1D
from repro_torch.models.gnn import common as C
from repro_torch.models.gnn.models import graphcast_init

#: the batch keys ``make_loss_fn``'s loss reads, each row-sharded
BATCH_KEYS = ("node_feats", "edge_feats", "serve_ids", "src_slot",
              "dst_local", "valid_nodes", "targets")


# ---------------------------------------------------------------------------
# static routing construction (host-side, once per graph)
# ---------------------------------------------------------------------------

def build_routing(src: np.ndarray, dst: np.ndarray, n: int, p: int,
                  r_cap: int | None = None, e_cap: int | None = None):
    """Returns dict of stacked per-shard arrays:
      serve_ids (p, p, r_cap) int32 — [me, j]: MY local row ids peer j needs
      src_slot  (p, e_cap)    int32 — per edge: index into the (p*r_cap)
                                       received-row buffer
      dst_local (p, e_cap)    int32 — per edge: local destination (-1 pad)
      r_cap, e_cap, part
    """
    part = Partition1D(n, p)
    own_dst = np.asarray(part.owner(dst))
    own_src = np.asarray(part.owner(src))
    src_local_of = np.asarray(part.local_id(src))
    dst_local_of = np.asarray(part.local_id(dst))

    # per (dst-shard j, src-owner o): unique source rows requested
    requests = [[None] * p for _ in range(p)]
    max_r, max_e = 1, 1
    edge_data = []
    for j in range(p):
        sel = np.where(own_dst == j)[0]
        max_e = max(max_e, sel.shape[0])
        slot = np.zeros(sel.shape[0], np.int64)
        for o in range(p):
            esel = own_src[sel] == o
            uniq, inv = np.unique(src_local_of[sel][esel],
                                  return_inverse=True)
            max_r = max(max_r, uniq.shape[0])
            requests[j][o] = (uniq, esel, inv)
        edge_data.append((sel, slot))

    r_cap = r_cap or -(-max_r // 64) * 64
    e_cap = e_cap or -(-max_e // 64) * 64

    serve = np.zeros((p, p, r_cap), np.int32)
    src_slot = np.zeros((p, e_cap), np.int32)
    dst_loc = np.full((p, e_cap), -1, np.int32)
    for j in range(p):
        sel, slot = edge_data[j]
        for o in range(p):
            uniq, esel, inv = requests[j][o]
            if uniq.shape[0] > r_cap:
                raise ValueError(f"shard {o} serves {uniq.shape[0]} rows to "
                                 f"shard {j}, over r_cap = {r_cap}")
            serve[o, j, :uniq.shape[0]] = uniq  # shard o serves these to j
            slot[esel] = o * r_cap + inv
        k = sel.shape[0]
        if k > e_cap:
            raise ValueError(f"shard {j} owns {k} edges, over e_cap = "
                             f"{e_cap}")
        src_slot[j, :k] = slot
        dst_loc[j, :k] = dst_local_of[sel]
    return {"serve_ids": serve, "src_slot": src_slot, "dst_local": dst_loc,
            "r_cap": r_cap, "e_cap": e_cap, "part": part}


def exchange_bytes(routing: dict, d: int, itemsize: int = 4) -> dict:
    """Bytes a shard sends a layer by the exchange (p * r_cap * d) beside
    the global route's two (N, d) table gathers (the module docstring)."""
    part = routing["part"]
    return {"exchange": part.p * routing["r_cap"] * d * itemsize,
            "global_gathers": 2 * part.n * d * itemsize}


# ---------------------------------------------------------------------------
# the sharded forward (the shards of a mesh stacked on a leading dim)
# ---------------------------------------------------------------------------

def local_batch(batch: dict, mesh) -> dict:
    """The mesh's shards of a global batch (JAX's row-sharded layout,
    ``BATCH_KEYS``): each array as ``(len(local_shards), rows / p,
    ...)``."""
    shards = list(mesh.local_shards)
    out = {}
    for k in BATCH_KEYS:
        x = batch[k]
        x = x.reshape(mesh.p, x.shape[0] // mesh.p, *x.shape[1:])
        out[k] = x[shards[0]:shards[-1] + 1]
    return out


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[s][idx[s]]`` for every shard s: (S, R, D) by (S, ...) -> (S,
    ..., D), as one gather over the flattened rows."""
    s, r = x.shape[:2]
    offs = torch.arange(s, device=x.device, dtype=idx.dtype) * r
    flat = (idx + offs.view(s, *([1] * (idx.dim() - 1)))).reshape(-1)
    return x.reshape(s * r, *x.shape[2:]).index_select(0, flat).reshape(
        *idx.shape, *x.shape[2:])


def _exchange_rows(h_loc, serve_ids, mesh, axis):
    """The direct exchange: ship exactly the rows peers need (one
    all-to-all).  h_loc (S, n_loc, D), serve_ids (S, p, r_cap) -> the
    (S, p * r_cap, D) received rows."""
    rows = _rows(h_loc, serve_ids)                 # (S, p, r_cap, D) to send
    s, p, r_cap, d = rows.shape
    return mesh.all_to_all(rows.reshape(s, p * r_cap, d), axis)


def _shard_forward(params, batch_loc, cfg: GNNConfig, mesh, axis):
    h = C.apply_mlp(params["enc_h"], batch_loc["node_feats"])
    e = C.apply_mlp(params["enc_e"], batch_loc["edge_feats"])
    serve = batch_loc["serve_ids"][:, 0]           # (S, p, r_cap)
    src_slot = batch_loc["src_slot"][:, 0]         # (S, e_cap)
    dst_local = batch_loc["dst_local"][:, 0]
    s, n_loc = h.shape[:2]
    emask = (dst_local >= 0)[..., None].to(h.dtype)
    offs = torch.arange(s, device=h.device, dtype=dst_local.dtype)[:, None]
    dst_idx = (torch.where(dst_local >= 0, dst_local, n_loc)
               + offs * (n_loc + 1)).reshape(-1)
    dst_row = dst_local.clamp(0, n_loc - 1)

    def layer_fn(layer, h, e):
        h_src = _rows(_exchange_rows(h, serve, mesh, axis), src_slot)
        h_dst = _rows(h, dst_row)
        e_in = torch.cat([e, h_src, h_dst], dim=-1)
        e = e + C.apply_layer_norm(layer["ln_e"],
                                   C.apply_mlp(layer["edge_mlp"], e_in))
        agg = C.segment_sum((e * emask).reshape(-1, e.shape[-1]), dst_idx,
                            s * (n_loc + 1))
        agg = agg.reshape(s, n_loc + 1, -1)[:, :n_loc]
        h_in = torch.cat([h, agg], dim=-1)
        h = h + C.apply_layer_norm(layer["ln_h"],
                                   C.apply_mlp(layer["node_mlp"], h_in))
        return h, e

    for layer in params["layers"]:
        h, e = checkpoint(layer_fn, layer, h, e, use_reentrant=False)
    pred = C.apply_mlp(params["dec"], h)

    w = batch_loc["valid_nodes"].to(C.stat_dtype(pred.dtype))
    se = (((pred - batch_loc["targets"]) ** 2).mean(-1) * w).sum(-1)
    tot = mesh.psum(torch.stack([se, w.sum(-1)], dim=-1), axis)  # (S, 2)
    return tot[0, 0] / tot[0, 1].clamp_min(1.0)


def make_loss_fn(cfg: GNNConfig, mesh, axis):
    """Owner-exchange loss ``(params, batch) -> (loss, {"loss": loss})``
    with the same params tree as ``models.graphcast_init``; ``batch`` is
    the global row-sharded batch (``BATCH_KEYS``, node arrays padded to
    ``part.n`` by ``graphs.shard_node_array``), of which each mesh holds
    its ``local_shards``.  ``torch.autograd`` gives the global model's
    gradients on every rank."""
    def loss_fn(params, batch):
        params = tr.unflatten(params, mesh.replicate(tr.leaves(params)))
        loss = _shard_forward(params, local_batch(batch, mesh), cfg, mesh,
                              axis)
        return loss, {"loss": loss}

    return loss_fn


def init_params(cfg: GNNConfig, d_feat: int, generator: torch.Generator):
    return graphcast_init(cfg, d_feat, generator)
