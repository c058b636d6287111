"""Synthetic LM batches — the port's copy of ``lm_train_batch`` from
``repro.data.synthetic``.  Tokens come from numpy's generator, so a seed
gives the JAX package's tokens bitwise."""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import TransformerConfig


def lm_train_batch(cfg: TransformerConfig, batch: int, seq: int, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (batch, seq + 1),
                                   dtype=np.int32)}
