"""DeepFM: sparse embedding tables + FM interaction + deep MLP — the port
of ``repro.models.recsys.deepfm``: the loss (the train step's, built in
``launch/steps.py``), the serve step and the retrieval step.

All fields share one ``(n_sparse * vocab_per_field, embed_dim)`` table;
field ``f``'s ids are offset by ``f * vocab_per_field``.  Single-valued
fields are looked up with a row gather, as in the JAX package; the
EmbeddingBag kernel (A5, ``kernels/embedding_bag``) is the op for
multi-hot bags, which this model does not have.  The row gather's
gradient is dense: a ``(total_rows, D)`` tensor, zero on the rows the
batch did not touch, as JAX's scatter-add transpose gives.  Parameters are a dict of
tensors in the JAX package's layout (``models.convert`` carries them).
The FM interaction in f32 only: a config with another ``interaction`` or
``dtype`` raises ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import RecsysConfig
from repro_torch.models.gnn.common import apply_mlp, init_mlp


def _check_supported(cfg: RecsysConfig) -> None:
    if cfg.interaction != "fm":
        raise NotImplementedError(f"interaction {cfg.interaction!r}: only "
                                  f"'fm' is ported")
    if cfg.dtype != "float32":
        raise NotImplementedError(f"dtype {cfg.dtype!r}: only float32 is "
                                  f"ported")


def field_offsets(cfg: RecsysConfig, device=None) -> torch.Tensor:
    return (torch.arange(cfg.n_sparse, device=device, dtype=torch.int32)
            * cfg.vocab_per_field)


def init_params(cfg: RecsysConfig, generator: torch.Generator) -> dict:
    """Random weights on ``generator``'s device, as the JAX package draws
    them: the table normal * 0.01, the first-order weights and bias zero,
    the MLP by ``init_mlp``."""
    _check_supported(cfg)
    dev = generator.device
    rows, d = cfg.total_rows, cfg.embed_dim
    mlp_in = cfg.n_sparse * d + cfg.n_dense
    table = torch.randn((rows, d), generator=generator, device=dev)
    return {
        "table": table.mul_(0.01),
        "lin_table": torch.zeros((rows, 1), device=dev),
        "lin_dense": torch.zeros(cfg.n_dense, device=dev),
        "bias": torch.zeros((), device=dev),
        "mlp": init_mlp(generator, (mlp_in, *cfg.mlp_dims, 1)),
    }


def _embed(cfg: RecsysConfig, params, sparse_idx: torch.Tensor):
    """sparse_idx: (B, F) field-local ids -> (B, F, D) rows of the shared
    table, and the flat ids (B, F)."""
    flat = sparse_idx + field_offsets(cfg, sparse_idx.device)[None, :]
    return params["table"][flat], flat


def fm_term(emb: torch.Tensor) -> torch.Tensor:
    """FM second order over (B, F, D) rows: 0.5 * ((sum v)^2 - sum v^2)."""
    s = emb.sum(dim=1)
    return 0.5 * (s.square().sum(-1) - emb.square().sum(dim=(1, 2)))


def forward(cfg: RecsysConfig, params, batch):
    """batch: sparse (B, F) int32, dense (B, n_dense) f32 -> logits (B,)."""
    _check_supported(cfg)
    emb, flat = _embed(cfg, params, batch["sparse"])       # (B, F, D)
    b = emb.shape[0]
    # first-order term
    lin = (params["lin_table"][flat][..., 0].sum(-1)
           + batch["dense"] @ params["lin_dense"] + params["bias"])
    # deep branch
    mlp_in = torch.cat([emb.reshape(b, -1), batch["dense"]], dim=-1)
    deep = apply_mlp(params["mlp"], mlp_in)[:, 0]
    return lin + fm_term(emb) + deep


def loss_fn(cfg: RecsysConfig, params, batch):
    """Mean BCE-with-logits over the batch's ``label``, in the stable form
    ``max(x, 0) - x y + log1p(exp(-|x|))``; returns (loss, {"loss":
    loss}).  ``torch.maximum`` splits the gradient of a tie at 0 in half,
    as ``jnp.maximum`` does."""
    logits = forward(cfg, params, batch)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"loss": loss}


def serve_step(cfg: RecsysConfig, params, batch):
    return torch.sigmoid(forward(cfg, params, batch))


def retrieval_step(cfg: RecsysConfig, params, batch):
    """Score one query against n_candidates item rows (field 0 is the item
    table).  batch: sparse (1, F) for the query context, cand_ids (Ncand,).
    Returns (Ncand,) scores: one (1, D) x (D, Ncand) product plus the
    per-item first-order weight; no per-candidate loop."""
    _check_supported(cfg)
    emb, _ = _embed(cfg, params, batch["sparse"])         # (1, F, D)
    user_vec = emb[:, 1:, :].sum(dim=1)                   # context fields
    cand = params["table"][batch["cand_ids"]]             # (Ncand, D)
    cand_lin = params["lin_table"][batch["cand_ids"]][:, 0]
    return (user_vec @ cand.T)[0] + cand_lin + params["bias"]
