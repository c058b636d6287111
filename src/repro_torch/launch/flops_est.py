"""MODEL_FLOPS: analytic useful-work estimates per cell — the port of
``repro.launch.flops_est``: the same arithmetic over the port's configs
and ``data.synthetic._gnn_dims``, so the same floats.

LM follows the 6·N·D / 2·N·D convention (N = *active* params including the
tied embedding matmul, D = tokens), with explicit attention-matmul terms
added where they are first-order (long-context decode).  GNN/recsys use
per-layer matmul counts.  These are 'useful work' floors — the ratio
trace FLOPs / MODEL_FLOPS exposes remat/dispatch/padding overhead.
"""

from __future__ import annotations

from repro_torch.configs.base import (GNNConfig, GNNShape, LMShape,
                                      RecsysConfig, RecsysShape,
                                      TransformerConfig)


def lm_model_flops(cfg: TransformerConfig, shape: LMShape) -> float:
    n_act = cfg.active_param_count()
    if shape.step == "train":
        tokens = shape.global_batch * shape.seq_len
        attn = 0.0
        for i in range(cfg.n_layers):
            spec = cfg.pattern[i % len(cfg.pattern)]
            ctx = min(shape.seq_len, spec.window or shape.seq_len)
            # qk + pv, fwd+bwd(2x): 3 * 2 * 2 * tokens * ctx/2 * heads*dh
            attn += 3 * 2 * tokens * ctx * cfg.n_heads * cfg.head_dim
        return 6.0 * n_act * tokens + attn
    if shape.step == "prefill":
        tokens = shape.global_batch * shape.seq_len
        attn = 0.0
        for i in range(cfg.n_layers):
            spec = cfg.pattern[i % len(cfg.pattern)]
            ctx = min(shape.seq_len, spec.window or shape.seq_len)
            attn += 2 * tokens * ctx * cfg.n_heads * cfg.head_dim
        return 2.0 * n_act * tokens + attn
    # decode: one token per sequence, attention reads the whole cache
    b = shape.global_batch
    attn = 0.0
    for i in range(cfg.n_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        ctx = min(shape.seq_len, spec.window or shape.seq_len)
        attn += 4 * b * ctx * cfg.n_heads * cfg.head_dim
    return 2.0 * n_act * b + attn


def gnn_model_flops(cfg: GNNConfig, shape: GNNShape, n: int, e: int) -> float:
    d = cfg.d_hidden
    f = shape.d_feat
    if cfg.kind == "gcn":
        fwd = 2 * n * f * d + 2 * e * d  # first layer dominates on cora
        for _ in range(cfg.n_layers - 1):
            fwd += 2 * n * d * d + 2 * e * d
    elif cfg.kind == "gatedgcn":
        fwd = 2 * n * f * d
        fwd += cfg.n_layers * (5 * 2 * max(n, e) * d * d + 4 * e * d)
    elif cfg.kind == "schnet":
        fwd = 2 * n * f * d
        fwd += cfg.n_layers * (2 * e * cfg.rbf * d + 2 * e * d * d
                               + 2 * 2 * n * d * d + 2 * e * d)
    else:  # graphcast: edge MLP (3d->d->d) + node MLP (2d->d->d)
        fwd = 2 * n * f * d + 2 * e * 4 * d
        fwd += cfg.n_layers * (2 * e * (3 * d * d + d * d)
                               + 2 * n * (2 * d * d + d * d) + 2 * e * d)
        fwd += 2 * n * d * cfg.n_vars
    return 3.0 * fwd  # fwd + bwd ~ 3x


def recsys_model_flops(cfg: RecsysConfig, shape: RecsysShape) -> float:
    d = cfg.embed_dim
    mlp_in = cfg.n_sparse * d + cfg.n_dense
    dims = (mlp_in, *cfg.mlp_dims, 1)
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    fm = 4 * cfg.n_sparse * d
    if shape.step == "retrieval":
        return 2.0 * shape.n_candidates * d
    per_ex = mlp + fm
    mult = 3.0 if shape.step == "train" else 1.0
    return mult * shape.batch * per_ex


def model_flops(bundle) -> float:
    from repro_torch.data.synthetic import _gnn_dims
    if bundle.family == "lm":
        return lm_model_flops(bundle.cfg, bundle.shape)
    if bundle.family == "gnn":
        n, e = _gnn_dims(bundle.cfg, bundle.shape)
        return gnn_model_flops(bundle.cfg, bundle.shape, n, e)
    return recsys_model_flops(bundle.cfg, bundle.shape)
