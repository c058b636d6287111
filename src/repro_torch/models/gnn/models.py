"""The four GNN architectures over the shared segment-op substrate — the
port of ``repro.models.gnn.models``.

  gcn       — Kipf-Welling spectral conv, symmetric normalization.
  gatedgcn  — Bresson-Laurent edge-gated MPNN (LayerNorm in place of
              BatchNorm, as in the JAX package).
  schnet    — continuous-filter convolution over RBF-expanded distances.
  graphcast — encoder / 16-layer interaction-network processor / decoder.

All expose ``init_params(cfg, d_feat, generator)`` and ``forward(cfg,
params, batch)``, plus the family's ``loss_fn`` that the train step
differentiates.  Params are the JAX layout: nested dicts and lists of
tensors (``repro_torch.tree`` walks them in JAX's leaf order).

Every layer runs under ``torch.utils.checkpoint`` where JAX's runs under
``jax.checkpoint``: full-graph backward otherwise keeps every (E, D) edge
tensor of every layer.  So the train step takes its gradients by
``torch.autograd`` (``launch.steps``), which can differentiate through
the checkpoint where ``torch.func`` cannot.  JAX's
``hints.constrain_rows`` is the identity unless a sharding mesh is
active, so it has no counterpart here.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import GNNConfig
from repro_torch.models.gnn import common as C


def _ckpt(fn):
    """Per-layer rematerialization (JAX's ``jax.checkpoint``)."""
    def run(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return run


def _split(generator: torch.Generator, n: int) -> list:
    """``n`` generators on ``generator``'s device, seeded from it in turn
    (the port's ``jax.random.split``)."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator,
                          device=generator.device).tolist()
    return [torch.Generator(device=generator.device).manual_seed(s)
            for s in seeds]


# ----------------------------------------------------------------- GCN
def gcn_init(cfg: GNNConfig, d_feat: int, generator):
    dims = [d_feat] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    gens = _split(generator, cfg.n_layers)
    return {"layers": [C.init_mlp(g, dims[i:i + 2])
                       for i, g in enumerate(gens)]}


def gcn_forward(cfg: GNNConfig, params, batch):
    h = batch["node_feats"]
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = h.shape[0]
    deg_out, deg_in = C.degrees(src, dst, n, C.stat_dtype(h.dtype))
    if cfg.norm == "sym":
        w = (torch.rsqrt(deg_out.clamp_min(1.0)).index_select(
                 0, src.clamp_min(0))
             * torch.rsqrt(deg_in.clamp_min(1.0)).index_select(
                 0, dst.clamp_min(0)))
    else:
        w = torch.ones(src.shape, dtype=C.stat_dtype(h.dtype),
                       device=src.device)

    def layer_fn(layer, h, last):
        h = C.apply_mlp([layer[0]], h)           # XW
        msg = C.gather_src(h, src) * w[:, None]
        h = C.aggregate(msg, dst, n, op="sum")
        if cfg.aggregator == "mean" and cfg.norm != "sym":
            h = h / deg_in.clamp_min(1.0)[:, None]
        return h if last else torch.relu(h)

    for i, layer in enumerate(params["layers"]):
        last = i == len(params["layers"]) - 1
        h = _ckpt(layer_fn)(layer, h, last)
    return h


# ------------------------------------------------------------- GatedGCN
def gatedgcn_init(cfg: GNNConfig, d_feat: int, generator, d_edge: int = 1):
    d = cfg.d_hidden
    gens = _split(generator, cfg.n_layers + 3)
    dev = generator.device
    layers = []
    for i in range(cfg.n_layers):
        kk = _split(gens[i], 6)
        layers.append({
            "U": C.init_mlp(kk[0], (d, d)), "V": C.init_mlp(kk[1], (d, d)),
            "A": C.init_mlp(kk[2], (d, d)), "B": C.init_mlp(kk[3], (d, d)),
            "E": C.init_mlp(kk[4], (d, d)),
            "ln_h": C.init_layer_norm(d, device=dev),
            "ln_e": C.init_layer_norm(d, device=dev),
        })
    return {
        "in_h": C.init_mlp(gens[-3], (d_feat, d)),
        "in_e": C.init_mlp(gens[-2], (d_edge, d)),
        "out": C.init_mlp(gens[-1], (d, cfg.d_out)),
        "layers": layers,
    }


def gatedgcn_forward(cfg: GNNConfig, params, batch):
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = batch["node_feats"].shape[0]
    h = C.apply_mlp(params["in_h"], batch["node_feats"])
    ef = batch.get("edge_feats")
    if ef is None:
        ef = torch.ones((src.shape[0], 1), dtype=h.dtype, device=h.device)
    e = C.apply_mlp(params["in_e"], ef)

    def layer_fn(layer, h, e):
        hi = C.gather_src(h, src)
        hj = h.index_select(0, dst.clamp_min(0))
        e_new = (C.apply_mlp([layer["A"][0]], e) +
                 C.apply_mlp([layer["B"][0]], hi) +
                 C.apply_mlp([layer["E"][0]], hj))
        eta = torch.sigmoid(e_new)
        num = C.aggregate(eta * C.apply_mlp([layer["V"][0]], hi), dst, n,
                          "sum")
        den = C.aggregate(eta, dst, n, "sum")
        h_new = C.apply_mlp([layer["U"][0]], h) + num / (den + 1e-6)
        h = h + torch.relu(C.apply_layer_norm(layer["ln_h"], h_new))
        e = e + torch.relu(C.apply_layer_norm(layer["ln_e"], e_new))
        return h, e

    for layer in params["layers"]:
        h, e = _ckpt(layer_fn)(layer, h, e)
    return C.apply_mlp(params["out"], h)


# --------------------------------------------------------------- SchNet
def _ssp(x):  # shifted softplus, SchNet's activation
    return F.softplus(x) - math.log(2.0)


def schnet_init(cfg: GNNConfig, d_feat: int, generator):
    d = cfg.d_hidden
    gens = _split(generator, cfg.n_layers + 2)
    inter = []
    for i in range(cfg.n_layers):
        kk = _split(gens[i], 4)
        inter.append({
            "filter": C.init_mlp(kk[0], (cfg.rbf, d, d)),
            "w_in": C.init_mlp(kk[1], (d, d), bias=False),
            "post": C.init_mlp(kk[2], (d, d, d)),
        })
    return {
        "embed": C.init_mlp(gens[-2], (d_feat, d)),
        "inter": inter,
        "out": C.init_mlp(gens[-1], (d, d // 2, cfg.d_out)),
    }


def schnet_forward(cfg: GNNConfig, params, batch):
    src, dst = batch["edge_src"], batch["edge_dst"]
    pos = batch["pos"]
    n = pos.shape[0]
    h = C.apply_mlp(params["embed"], batch["node_feats"])
    # RBF expansion of interatomic distances; the 1e-12 keeps the norm's
    # gradient finite on padding edges, whose ends are both node 0
    d_ij = torch.linalg.vector_norm(
        pos.index_select(0, src.clamp_min(0))
        - pos.index_select(0, dst.clamp_min(0)) + 1e-12, dim=-1)
    mu = torch.linspace(0.0, cfg.cutoff, cfg.rbf, dtype=pos.dtype,
                        device=pos.device)
    gamma = 10.0 / cfg.cutoff
    rbf = torch.exp(-gamma * (d_ij[:, None] - mu[None, :]) ** 2)  # (E, rbf)
    # smooth cutoff (cosine), zero past cfg.cutoff
    cut = 0.5 * (torch.cos(math.pi * (d_ij / cfg.cutoff).clamp(0, 1)) + 1.0)

    def layer_fn(blk, h):
        w = C.apply_mlp(blk["filter"], rbf, act=_ssp, final_act=True)
        w = w * cut[:, None]
        msg = C.apply_mlp(blk["w_in"], C.gather_src(h, src)) * w
        agg = C.aggregate(msg, dst, n, "sum")
        return h + C.apply_mlp(blk["post"], agg, act=_ssp)

    for blk in params["inter"]:
        h = _ckpt(layer_fn)(blk, h)
    return C.apply_mlp(params["out"], h, act=_ssp)


# ------------------------------------------------------------ GraphCast
def graphcast_init(cfg: GNNConfig, d_feat: int, generator, d_edge: int = 4):
    d = cfg.d_hidden
    gens = _split(generator, cfg.n_layers + 3)
    dev = generator.device
    layers = []
    for i in range(cfg.n_layers):
        kk = _split(gens[i], 2)
        layers.append({
            "edge_mlp": C.init_mlp(kk[0], (3 * d, d, d)),
            "node_mlp": C.init_mlp(kk[1], (2 * d, d, d)),
            "ln_e": C.init_layer_norm(d, device=dev),
            "ln_h": C.init_layer_norm(d, device=dev),
        })
    return {
        "enc_h": C.init_mlp(gens[-3], (d_feat, d, d)),
        "enc_e": C.init_mlp(gens[-2], (d_edge, d, d)),
        "dec": C.init_mlp(gens[-1], (d, d, cfg.n_vars)),
        "layers": layers,
    }


def graphcast_forward(cfg: GNNConfig, params, batch):
    src, dst = batch["edge_src"], batch["edge_dst"]
    n = batch["node_feats"].shape[0]
    h = C.apply_mlp(params["enc_h"], batch["node_feats"])
    ef = batch.get("edge_feats")
    if ef is None:
        ef = torch.ones((src.shape[0], 4), dtype=h.dtype, device=h.device)
    e = C.apply_mlp(params["enc_e"], ef)

    def layer_fn(layer, h, e):
        # interaction-network block (GraphCast processor, sum aggregation)
        e_in = torch.cat([e, C.gather_src(h, src),
                          h.index_select(0, dst.clamp_min(0))], dim=-1)
        e = e + C.apply_layer_norm(layer["ln_e"],
                                   C.apply_mlp(layer["edge_mlp"], e_in))
        agg = C.aggregate(e, dst, n, cfg.aggregator)
        h_in = torch.cat([h, agg], dim=-1)
        h = h + C.apply_layer_norm(layer["ln_h"],
                                   C.apply_mlp(layer["node_mlp"], h_in))
        return h, e

    for layer in params["layers"]:
        h, e = _ckpt(layer_fn)(layer, h, e)
    return C.apply_mlp(params["dec"], h)


# ------------------------------------------------------------- dispatch
_INIT = {"gcn": gcn_init, "gatedgcn": gatedgcn_init, "schnet": schnet_init,
         "graphcast": graphcast_init}
_FWD = {"gcn": gcn_forward, "gatedgcn": gatedgcn_forward,
        "schnet": schnet_forward, "graphcast": graphcast_forward}


def init_params(cfg: GNNConfig, d_feat: int, generator: torch.Generator):
    return _INIT[cfg.kind](cfg, d_feat, generator)


def forward(cfg: GNNConfig, params, batch):
    return _FWD[cfg.kind](cfg, params, batch)


def loss_fn(cfg: GNNConfig, params, batch):
    pred = forward(cfg, params, batch)
    valid = batch["valid_nodes"]
    if "labels" in batch:  # node classification (gcn-cora)
        logits = pred.to(C.stat_dtype(pred.dtype))
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, batch["labels"].long()[:, None])[:, 0]
        nll = lse - ll
        w = valid.to(logits.dtype)
        loss = (nll * w).sum() / w.sum().clamp_min(1.0)
        return loss, {"loss": loss}
    if batch.get("graph_id") is not None:  # graph-level regression
        pooled = C.graph_pool(pred * valid[:, None], batch["graph_id"],
                              batch["graph_targets"].shape[0], "sum")
        loss = ((pooled - batch["graph_targets"]) ** 2).mean()
        return loss, {"loss": loss}
    loss = C.node_mse(pred, batch["targets"], valid)
    return loss, {"loss": loss}
