"""Synthetic batches — the port of ``repro.data.synthetic``.

Every batch function comes in two flavours with the same tree structure:
``*_batch`` (``lm_train_batch``, ``gnn_batch`` with ``_gnn_dims``, its
padded sizes, and ``recsys_batch``) draws concrete numpy arrays from
numpy's generator (the graphs through the port's ``erdos_renyi``), so a
seed gives the JAX package's arrays bitwise; ``*_specs`` (``lm_train_specs``,
``lm_prefill_specs``, ``lm_decode_specs``, ``gnn_specs``,
``recsys_specs``) gives the abstract inputs of the dry run: tensors on
``torch.device("meta")`` with JAX's shapes and dtypes, which allocate
nothing (JAX's ``ShapeDtypeStruct``s).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (GNNConfig, GNNShape, LMShape,
                                      RecsysConfig, RecsysShape,
                                      TransformerConfig)
from repro_torch.graphs.generators import erdos_renyi

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    """An abstract input: shape and dtype on the meta device."""
    return torch.empty(shape, dtype=dtype, device=META)


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


def lm_train_batch(cfg: TransformerConfig, batch: int, seq: int, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq + 1),
                                   dtype=np.int32)}


def lm_train_specs(cfg: TransformerConfig, shape: LMShape):
    return {"tokens": _sds((shape.global_batch, shape.seq_len + 1),
                           torch.int32)}


def lm_prefill_specs(cfg: TransformerConfig, shape: LMShape):
    return {"tokens": _sds((shape.global_batch, shape.seq_len), torch.int32)}


def lm_decode_specs(cfg: TransformerConfig, shape: LMShape):
    from repro_torch.models.transformer import init_cache
    return {
        "cache": init_cache(cfg, shape.global_batch, shape.seq_len,
                            device=META),
        "pos": _sds((), torch.int32),
        "last_token": _sds((shape.global_batch,), torch.int32),
    }


# ------------------------------------------------------------------ GNN
def _gnn_dims(cfg: GNNConfig, shape: GNNShape, pad: int = 512):
    """Static padded (N, E) for the step input of each GNN mode."""
    if shape.mode == "sampled":
        n = shape.batch_nodes
        e = 0
        layer = shape.batch_nodes
        for f in shape.fanout:
            layer *= f
            n += layer
            e += layer
        return _pad_to(n, pad), _pad_to(e, pad)
    if shape.mode == "batched":
        return (_pad_to(shape.n_nodes * shape.batch_graphs, pad),
                _pad_to(shape.n_edges * shape.batch_graphs, pad))
    return _pad_to(shape.n_nodes, pad), _pad_to(shape.n_edges, pad)


def gnn_batch(cfg: GNNConfig, shape: GNNShape, seed=0, pad: int = 128):
    """A concrete batch: an Erdős–Rényi graph of average degree
    ``min(8, max(2, E // N))`` in the first edge slots (the rest padding,
    ``dst = -1``) and normal features, targets and positions."""
    rng = np.random.default_rng(seed)
    n, e = _gnn_dims(cfg, shape, pad)
    src, dst = erdos_renyi(n, avg_degree=min(8, max(2, e // max(n, 1))),
                           seed=seed)
    e_used = min(src.shape[0], e)
    es = np.zeros((e,), np.int32)
    ed = np.full((e,), -1, np.int32)
    es[:e_used] = src[:e_used]
    ed[:e_used] = dst[:e_used]
    batch = {
        "node_feats": rng.standard_normal((n, shape.d_feat)).astype(np.float32),
        "edge_src": es, "edge_dst": ed,
        "valid_nodes": np.ones((n,), bool),
    }
    if cfg.kind == "schnet":
        batch["pos"] = rng.standard_normal((n, 3)).astype(np.float32)
    if cfg.kind == "gatedgcn":
        batch["edge_feats"] = rng.standard_normal((e, 1)).astype(np.float32)
    if cfg.kind == "graphcast":
        batch["edge_feats"] = rng.standard_normal((e, 4)).astype(np.float32)
    if cfg.kind == "gcn":
        batch["labels"] = rng.integers(0, cfg.d_out, (n,)).astype(np.int32)
    elif shape.mode == "batched":
        batch["graph_id"] = np.minimum(
            np.arange(n) // max(shape.n_nodes, 1),
            shape.batch_graphs - 1).astype(np.int32)
        batch["graph_targets"] = rng.standard_normal(
            (shape.batch_graphs, cfg.d_out)).astype(np.float32)
    else:
        batch["targets"] = rng.standard_normal((n, cfg.d_out)).astype(
            np.float32)
    return batch


def gnn_specs(cfg: GNNConfig, shape: GNNShape, pad: int = 512):
    n, e = _gnn_dims(cfg, shape, pad)
    batch = {
        "node_feats": _sds((n, shape.d_feat), torch.float32),
        "edge_src": _sds((e,), torch.int32),
        "edge_dst": _sds((e,), torch.int32),
        "valid_nodes": _sds((n,), torch.bool),
    }
    if cfg.kind == "schnet":
        batch["pos"] = _sds((n, 3), torch.float32)
    if cfg.kind in ("gatedgcn", "graphcast"):
        batch["edge_feats"] = _sds((e, 4 if cfg.kind == "graphcast" else 1),
                                   torch.float32)
    if cfg.kind == "gcn":
        batch["labels"] = _sds((n,), torch.int32)
    elif shape.mode == "batched":
        batch["graph_id"] = _sds((n,), torch.int32)
        batch["graph_targets"] = _sds((shape.batch_graphs, cfg.d_out),
                                      torch.float32)
    else:
        batch["targets"] = _sds((n, cfg.d_out), torch.float32)
    return batch


# --------------------------------------------------------------- recsys
def recsys_specs(cfg: RecsysConfig, shape: RecsysShape):
    if shape.step == "retrieval":
        return {"sparse": _sds((1, cfg.n_sparse), torch.int32),
                "cand_ids": _sds((shape.n_candidates,), torch.int32)}
    batch = {"sparse": _sds((shape.batch, cfg.n_sparse), torch.int32),
             "dense": _sds((shape.batch, cfg.n_dense), torch.float32)}
    if shape.step == "train":
        batch["label"] = _sds((shape.batch,), torch.int32)
    return batch


def recsys_batch(cfg: RecsysConfig, batch_size: int, step: str = "train",
                 n_candidates: int = 0, seed=0):
    rng = np.random.default_rng(seed)
    if step == "retrieval":
        return {
            "sparse": rng.integers(0, cfg.vocab_per_field,
                                   (1, cfg.n_sparse)).astype(np.int32),
            "cand_ids": rng.integers(0, cfg.vocab_per_field,
                                     (n_candidates,)).astype(np.int32),
        }
    out = {
        "sparse": rng.integers(0, cfg.vocab_per_field,
                               (batch_size, cfg.n_sparse)).astype(np.int32),
        "dense": rng.standard_normal((batch_size, cfg.n_dense)).astype(
            np.float32),
    }
    if step == "train":
        out["label"] = rng.integers(0, 2, (batch_size,)).astype(np.int32)
    return out
