"""Synthetic batches — the port's copy of ``lm_train_batch`` and
``recsys_batch`` from ``repro.data.synthetic``.  They draw from numpy's
generator, so a seed gives the JAX package's arrays bitwise."""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import RecsysConfig, TransformerConfig


def lm_train_batch(cfg: TransformerConfig, batch: int, seq: int, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq + 1),
                                   dtype=np.int32)}


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
