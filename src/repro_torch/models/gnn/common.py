"""Shared GNN substrate — the port of ``repro.models.gnn.common``: segment-op
message passing and MLP blocks.

Message passing is an explicit gather by edge index (``index_select``)
and a scatter-add to the destination rows (``index_add``), the
owner-computes dataflow of the BFS engine over feature vectors instead of
frontier bits.  Indices stay int32, as the batches carry them.

GraphBatch (dict of tensors, padded static shapes):
  node_feats (N, F) f32      valid_nodes (N,) bool
  edge_src, edge_dst (E,) int32 (-1 padding on dst)
  edge_feats (E, Fe) f32 | None     pos (N, 3) | None
  graph_id (N,) int32 (batched mode) | None
  targets / labels per task

Padding, as in the JAX package: a source of -1 reads row 0
(``gather_src``); an edge whose destination is -1 is masked and summed
into a spare row ``n`` that is dropped (``aggregate``); an empty segment's
maximum is 0.  Statistics that JAX takes in f32 are taken in
``promote_types(dtype, float32)``: f32 for f32 and bf16 inputs, as in
JAX, and f64 for an f64 twin of a step.

MLP layers are a list of dicts ``{"w": (d_in, d_out)[, "b": (d_out,)]}``,
the JAX package's layout; DeepFM's deep branch uses ``init_mlp`` and
``apply_mlp`` at their defaults.
"""

from __future__ import annotations

import math

import torch


def stat_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype JAX's ``astype(float32)`` statistics take here: f32, or
    f64 for an f64 input."""
    return torch.promote_types(dtype, torch.float32)


def gather_src(x: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    return x.index_select(0, src.clamp_min(0))


def edge_mask(dst: torch.Tensor) -> torch.Tensor:
    return dst >= 0


def _pad_row(dst: torch.Tensor, n: int) -> torch.Tensor:
    """Each edge's segment: its destination, or the spare row ``n``."""
    return torch.where(edge_mask(dst), dst, n)


def segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.ops.segment_sum(x, idx, num_segments=n)``: (n, ...)."""
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add(0, idx, x)


def aggregate(messages: torch.Tensor, dst: torch.Tensor, n: int,
              op: str = "sum") -> torch.Tensor:
    """Scatter edge messages to destination nodes. messages: (E, D)."""
    mask = edge_mask(dst)
    m = mask[:, None].to(messages.dtype)
    idx = _pad_row(dst, n)
    summed = segment_sum(messages * m, idx, n + 1)[:n]
    if op == "sum":
        return summed
    if op == "mean":
        deg = segment_sum(m[:, 0], idx, n + 1)[:n]
        return summed / deg.clamp_min(1.0)[:, None]
    if op == "max":
        neg = torch.where(mask[:, None], messages, -math.inf)
        start = torch.full((n + 1, messages.shape[1]), -math.inf,
                           dtype=messages.dtype, device=messages.device)
        mx = start.scatter_reduce(0, idx.long()[:, None].expand_as(neg),
                                  neg, "amax")[:n]
        return torch.where(torch.isfinite(mx), mx, 0.0)
    raise ValueError(op)


def degrees(src, dst, n, dtype=torch.float32):
    """(out-degree, in-degree) of every node over the unmasked edges."""
    mask = edge_mask(dst)
    m = mask.to(dtype)
    deg_in = segment_sum(m, _pad_row(dst, n), n + 1)[:n]
    deg_out = segment_sum(m, torch.where(mask, src, n), n + 1)[:n]
    return deg_out, deg_in


# ------------------------------------------------------------------- MLPs
def init_mlp(generator: torch.Generator, dims, dtype=torch.float32,
             bias: bool = True) -> list:
    """Weights normal * fan_in ** -0.5, biases zero, on ``generator``'s
    device.  The draws differ from ``jax.random``'s; tests carry weights
    across with ``models.convert``."""
    dev = generator.device
    layers = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        w = torch.randn((d_in, d_out), generator=generator, device=dev)
        w = w.mul_(d_in ** -0.5).to(dtype)
        layers.append({"w": w, "b": torch.zeros(d_out, dtype=dtype,
                                                 device=dev)}
                      if bias else {"w": w})
    return layers


def apply_mlp(layers, x, act=torch.relu, final_act: bool = False):
    for i, layer in enumerate(layers):
        x = x @ layer["w"]
        if "b" in layer:
            x = x + layer["b"]
        if i < len(layers) - 1 or final_act:
            x = act(x)
    return x


def init_layer_norm(dim, dtype=torch.float32, device=None) -> dict:
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def apply_layer_norm(p, x, eps=1e-5):
    xf = x.to(stat_dtype(x.dtype))
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
            ).to(x.dtype)


def node_mse(pred, targets, valid):
    err = ((pred - targets) ** 2).mean(-1)
    w = valid.to(stat_dtype(pred.dtype))
    return (err * w).sum() / w.sum().clamp_min(1.0)


def graph_pool(x, graph_id, n_graphs, op="sum"):
    if op == "sum":
        return segment_sum(x, graph_id, n_graphs)
    if op == "mean":
        s = segment_sum(x, graph_id, n_graphs)
        c = segment_sum(torch.ones(graph_id.shape, dtype=stat_dtype(x.dtype),
                                   device=x.device), graph_id, n_graphs)
        return s / c.clamp_min(1.0)[:, None]
    raise ValueError(op)
