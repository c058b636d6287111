"""LM-family transformer: the train, prefill and decode steps — the port
of ``repro.models.transformer``.

Parameters keep the JAX layout: per position of the repeating layer
pattern (Gemma-3's 5 local + 1 global), every leaf is stacked over the
``G = n_groups`` repeats of the pattern, and a leaf's dotted name in
``Transformer.named_parameters()`` (``blocks.0.attn.wq``) is its path in
the JAX tree (``["blocks"][0]["attn"]["wq"]``).  The JAX package scans
over the groups; here a Python loop walks them, in the same order.

Each layer's attention runs kernel A4 (``kernels/flash_attention``) on the
prompt's fresh ``q, k, v``: with ``q_offset = 0`` and ``kv_len = S``, the
JAX prefill's ``chunked_attention`` over the ``max_len`` cache masks every
key past the prompt, so it computes the same function.  ``decode_step``
takes one token a sequence at ``pos``, a scalar (a slice update of every
sequence's cache at ``pos``) or a (B,) tensor (each sequence's k, v row
scattered at its own depth), and attends over the whole cache through
``layers.core.chunked_attention``, as JAX's does.  Both steps write k, v
into the cache in place and run under ``torch.no_grad``.

``repro.models.sharding_hints`` is not ported: on one card every
``constrain_*`` call is the identity, so the port does not call them.  A
block's feed-forward is a dense SwiGLU (``mlp``) or, at a pattern position
with ``moe=True`` in a config with ``moe``, a Mixture-of-Experts layer
(``moe``, ``models.moe``'s local route, as JAX's with hints unset), whose
balance loss ``trunk`` averages over every layer.  ``qkv_bias`` adds
``bq`` / ``bk`` / ``bv`` to q, k and v before ``rope`` in all three
attentions; ``tie_embeddings`` drops ``unembed``, and the head (``_head``)
is then ``embed``.

The train functions (``trunk``, ``forward``, ``lm_loss``) take the
JAX-layout dict of ``init_tree`` / ``Transformer.tree()``, so a train
state is ``{"params": tree, "opt": ...}`` as JAX's is and
``Transformer.from_tree(state["params"])`` serves the trained weights.
Their attention is ``chunked_attention``'s train route (``flash_train``),
not A4, as in the JAX package; ``cfg.remat`` picks what each block keeps
for the backward, and ``lm_loss`` recomputes each loss chunk's logits in
the backward, so the (B, S, V) f32 logits never exist at once.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import LayerSpec, TransformerConfig
from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.layers.core import (chunked_attention, rms_norm, rope,
                                     scaled_normal, swiglu)
from repro_torch.models import moe as moe_lib
from repro_torch.tree import map_tree

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _dtype(cfg: TransformerConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


class _Leaves(nn.Module):
    """A set of named weight leaves (frozen parameters); a dict value is
    a nested set (``moe.shared``)."""

    def __init__(self, **leaves):
        super().__init__()
        for name, t in leaves.items():
            if isinstance(t, dict):
                setattr(self, name, _Leaves(**t))
            else:
                setattr(self, name, nn.Parameter(t, requires_grad=False))

    def tree(self) -> dict:
        return {name: getattr(self, name).tree()
                if isinstance(getattr(self, name), _Leaves)
                else getattr(self, name)
                for name in (*self._parameters, *self._modules)}


class Attention(_Leaves):
    """wq (G, D, Hq, Dh), wk and wv (G, D, Hkv, Dh), wo (G, Hq, Dh, D);
    under ``qkv_bias`` also bq (G, Hq, Dh), bk and bv (G, Hkv, Dh)."""


class MLP(_Leaves):
    """w_gate and w_up (G, D, F), w_down (G, F, D)."""


class MoE(_Leaves):
    """router (G, D, E) f32, w_gate and w_up (G, E, D, F), w_down
    (G, E, F, D); with shared experts also ``shared`` (an ``MLP``'s
    leaves at width ``F * shared_experts``)."""


class Block(nn.Module):
    """One position of the layer pattern, stacked over the groups; its
    feed-forward is ``mlp`` or ``moe``."""

    def __init__(self, attn: Attention, ffn: _Leaves, ln1: torch.Tensor,
                 ln2: torch.Tensor):
        super().__init__()
        self.attn = attn
        self.ffn_name = "moe" if isinstance(ffn, MoE) else "mlp"
        setattr(self, self.ffn_name, ffn)
        self.ln1 = nn.Parameter(ln1, requires_grad=False)
        self.ln2 = nn.Parameter(ln2, requires_grad=False)

    def tree(self) -> dict:
        return {"attn": self.attn.tree(), "ln1": self.ln1, "ln2": self.ln2,
                self.ffn_name: getattr(self, self.ffn_name).tree()}

    def group(self, g: int) -> dict:
        """The weights of group ``g`` as a JAX-style dict of views."""
        return map_tree(lambda w: w[g], self.tree())


class Transformer(nn.Module):
    """All weights of one LM: ``embed`` (V, D), ``blocks`` (one per
    pattern position), ``final_norm`` (D,) and, untied, ``unembed``
    (V, D)."""

    def __init__(self, embed: torch.Tensor, blocks: list[Block],
                 final_norm: torch.Tensor, unembed: torch.Tensor | None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        self.unembed = (None if unembed is None
                        else nn.Parameter(unembed, requires_grad=False))

    @classmethod
    def from_tree(cls, tree: dict) -> "Transformer":
        """Build from a JAX-layout dict of tensors (``init_params``'s)."""
        blocks = [Block(Attention(**b["attn"]),
                        MoE(**b["moe"]) if "moe" in b else MLP(**b["mlp"]),
                        b["ln1"], b["ln2"]) for b in tree["blocks"]]
        return cls(tree["embed"], blocks, tree["final_norm"],
                   tree.get("unembed"))

    def tree(self) -> dict:
        """The JAX-layout dict of the weights (the inverse of
        ``from_tree``)."""
        out = {"embed": self.embed,
               "blocks": [b.tree() for b in self.blocks],
               "final_norm": self.final_norm}
        if self.unembed is not None:
            out["unembed"] = self.unembed
        return out


def _head(params) -> torch.Tensor:
    """The output head, (V, D): ``unembed``, or ``embed`` when tied; of a
    JAX-layout dict or a ``Transformer``."""
    if isinstance(params, Transformer):
        return params.embed if params.unembed is None else params.unembed
    return params.get("unembed", params["embed"])


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_tree(cfg: TransformerConfig, generator: torch.Generator) -> dict:
    """Random weights on ``generator``'s device as a JAX-layout dict, drawn
    as the JAX package draws them (normal * fan_in ** -0.5 in f32, then
    cast, by ``scaled_normal``'s bounded slices; norms and q/k/v biases
    zero; an MoE block's leaves from ``moe.init_moe_params`` stacked over
    the groups).  The draws differ from ``jax.random``'s: tests carry
    weights across with ``models.convert``."""
    dt, dev = _dtype(cfg), generator.device
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = cfg.n_groups

    def dense(shape, fan_in):
        return scaled_normal(shape, fan_in ** -0.5, dt, generator)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    tree = {"blocks": []}
    for spec in cfg.pattern:
        attn = {"wq": dense((g, d, hq, dh), d),
                "wk": dense((g, d, hkv, dh), d),
                "wv": dense((g, d, hkv, dh), d),
                "wo": dense((g, hq, dh, d), hq * dh)}
        if cfg.qkv_bias:
            attn.update(bq=zeros(g, hq, dh), bk=zeros(g, hkv, dh),
                        bv=zeros(g, hkv, dh))
        block = {"attn": attn, "ln1": zeros(g, d), "ln2": zeros(g, d)}
        if spec.moe and cfg.moe is not None:
            block["moe"] = moe_lib.init_moe_params(generator, d, cfg.moe, dt,
                                                   lead=(g,))
        else:
            block["mlp"] = {"w_gate": dense((g, d, cfg.d_ff), d),
                            "w_up": dense((g, d, cfg.d_ff), d),
                            "w_down": dense((g, cfg.d_ff, d), cfg.d_ff)}
        tree["blocks"].append(block)
    tree["embed"] = dense((cfg.vocab, d), d)
    tree["final_norm"] = zeros(d)
    if not cfg.tie_embeddings:
        tree["unembed"] = dense((cfg.vocab, d), d)
    return tree


def init_params(cfg: TransformerConfig,
                generator: torch.Generator) -> Transformer:
    """``init_tree``'s weights as a ``Transformer``."""
    return Transformer.from_tree(init_tree(cfg, generator))


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _attn_apply(cfg: TransformerConfig, spec: LayerSpec, p: dict,
                h: torch.Tensor, positions: torch.Tensor, cache: dict,
                cache_pos, use_kernel: bool) -> torch.Tensor:
    """h: (B, S, D); cache: dict(k, v) of (B, Hkv, Smax, Dh) views.

    ``cache_pos=None`` (prefill): the prompt's k, v overwrite the first S
    positions and A4 attends over them.  A (B,) ``cache_pos`` (decode,
    S = 1): each sequence's row lands at its own depth.  A scalar: k, v
    land at ``[cache_pos, cache_pos + S)`` (the start clamped to fit, as
    ``lax.dynamic_update_slice`` does)."""
    q = torch.einsum("bsd,dhe->bhse", h, p["wq"])
    k = torch.einsum("bsd,dhe->bhse", h, p["wk"])
    v = torch.einsum("bsd,dhe->bhse", h, p["wv"])
    if "bq" in p:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    b, s = h.shape[:2]
    if cache_pos is None:
        cache["k"][:, :, :s] = k
        cache["v"][:, :, :s] = v
        o = attention(q, k, v, causal=True, window=spec.window,
                      use_kernel=use_kernel)
    else:
        if getattr(cache_pos, "ndim", 0) == 1:
            bidx = torch.arange(b, device=h.device)
            rows = cache_pos.long()
            cache["k"][bidx, :, rows] = k[:, :, 0, :]
            cache["v"][bidx, :, rows] = v[:, :, 0, :]
            kv_len = cache_pos + 1
        else:
            smax = cache["k"].shape[2]
            start = torch.clamp(torch.as_tensor(cache_pos, device=h.device),
                                0, smax - s)
            idx = start.long() + torch.arange(s, device=h.device)
            cache["k"].index_copy_(2, idx, k)
            cache["v"].index_copy_(2, idx, v)
            kv_len = cache_pos + s
        o = chunked_attention(q, cache["k"], cache["v"], causal=True,
                              window=spec.window, chunk=cfg.attn_chunk,
                              q_offset=cache_pos, kv_len=kv_len)
    return torch.einsum("bhse,hed->bsd", o, p["wo"])


def _ffn(cfg: TransformerConfig, p: dict, x: torch.Tensor):
    """The block's feed-forward on x (B, S, D) -> (y (B, S, D), its
    balance loss, or None for a dense block).  An MoE block routes the
    B * S tokens as one batch (JAX's ``x.reshape(b * s, d)``)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    if "moe" in p:
        y, aux = moe_lib.moe_apply(p["moe"], x2, cfg.moe)
        return y.reshape(b, s, d), aux["lb_loss"]
    mlp = p["mlp"]
    return swiglu(x2, mlp["w_gate"], mlp["w_up"],
                  mlp["w_down"]).reshape(b, s, d), None


def _block_apply(cfg: TransformerConfig, spec: LayerSpec, p: dict,
                 h: torch.Tensor, positions: torch.Tensor, cache: dict,
                 cache_pos, use_kernel: bool) -> torch.Tensor:
    a = _attn_apply(cfg, spec, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                    positions, cache, cache_pos, use_kernel)
    h = h + a
    y, _ = _ffn(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
    return h + y


def _groups(cfg: TransformerConfig, params: Transformer, cache: list, h,
            positions, cache_pos, use_kernel: bool):
    """Every layer over h, in the JAX scan's order: group by group, each
    group the pattern's positions."""
    for g in range(cfg.n_groups):
        for t, spec in enumerate(cfg.pattern):
            layer_cache = {"k": cache[t]["k"][g], "v": cache[t]["v"][g]}
            h = _block_apply(cfg, spec, params.blocks[t].group(g), h,
                             positions, layer_cache, cache_pos, use_kernel)
    return rms_norm(h, params.final_norm, cfg.norm_eps)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def _train_attn(cfg: TransformerConfig, spec: LayerSpec, p: dict,
                x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """Attention of a train call, no cache.  The weight products are 2-D
    ``matmul``s (``aten.mm``), the attention's products batched
    (``bmm``), so the ``dots`` policy can tell them apart."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)

    def heads(w, bias):                    # (D, H, Dh) -> (B, H, S, Dh)
        y = torch.matmul(x2, w.reshape(d, -1))
        y = y.reshape(b, s, w.shape[1], w.shape[2]).transpose(1, 2)
        return y if bias is None else y + bias[None, :, None, :]

    q = rope(heads(p["wq"], p.get("bq")), positions, cfg.rope_theta)
    k = rope(heads(p["wk"], p.get("bk")), positions, cfg.rope_theta)
    o = chunked_attention(q, k, heads(p["wv"], p.get("bv")), causal=True,
                          window=spec.window, chunk=cfg.attn_chunk)
    o = o.transpose(1, 2).reshape(b * s, -1)
    return torch.matmul(o, p["wo"].reshape(-1, d)).reshape(b, s, d)


def _train_body(cfg: TransformerConfig, spec: LayerSpec, p: dict,
                h: torch.Tensor, positions: torch.Tensor):
    """(the block's output, its balance loss: 0 for a dense block)."""
    a = _train_attn(cfg, spec, p["attn"], rms_norm(h, p["ln1"], cfg.norm_eps),
                    positions)
    h = h + a
    y, lb = _ffn(cfg, p, rms_norm(h, p["ln2"], cfg.norm_eps))
    if lb is None:
        lb = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + y, lb


def _keep_weight_products(ctx, op, *args, **kwargs):
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _train_block(cfg: TransformerConfig, spec: LayerSpec, p: dict,
                 h: torch.Tensor, positions: torch.Tensor):
    """One block of the train step under ``cfg.remat``, as JAX's
    ``jax.checkpoint`` policies: ``none`` keeps every activation for the
    backward; ``dots`` keeps the 2-D weight products (JAX's
    ``dots_with_no_batch_dims_saveable``: the projections, the dense
    SwiGLU, an MoE block's router and shared expert) and recomputes the
    rest, the attention's and the experts' batched products too; any other
    value (``block``, the default) keeps only the block's inputs and
    recomputes the block.  Returns (output, balance loss)."""
    if cfg.remat == "none":
        return _train_body(cfg, spec, p, h, positions)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _keep_weight_products)
    return checkpoint(_train_body, cfg, spec, p, h, positions,
                      use_reentrant=False, **kw)


def trunk(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """tokens (B, S) -> final hidden states (B, S, D) and ``{"lb_loss"}``,
    the MoE blocks' balance losses summed over every layer and divided by
    ``n_layers`` (dense layers count 0), every layer in the JAX scan's
    order."""
    h = params["embed"][tokens.long()]
    positions = torch.arange(tokens.shape[1], device=h.device)
    lb = torch.zeros((), dtype=torch.float32, device=h.device)
    for g in range(cfg.n_groups):
        for t, spec in enumerate(cfg.pattern):
            p = map_tree(lambda w: w[g], params["blocks"][t])
            h, lb_t = _train_block(cfg, spec, p, h, positions)
            lb = lb + lb_t
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, {"lb_loss": lb / max(cfg.n_layers, 1)}


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor):
    """tokens (B, S) -> logits (B, S, V) and the trunk's aux; no cache."""
    h, aux = trunk(cfg, params, tokens)
    return torch.matmul(h, _head(params).T), aux


def _chunk_nll(h_c: torch.Tensor, labels_c: torch.Tensor,
               head: torch.Tensor) -> torch.Tensor:
    logits = torch.matmul(h_c, head.T).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_c[..., None].long())[..., 0]
    return (lse - ll).sum()


def lm_loss(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            lb_coef: float = 0.01, loss_chunk: int = 512):
    """tokens (B, S + 1): next-token cross entropy plus ``lb_coef`` times
    the balance loss; returns (loss, {"ce", "lb_loss"}).  The head and the
    cross entropy run in chunks of ``loss_chunk`` positions, each chunk's
    summed in f32 and recomputed in the backward, so at most one chunk's
    (B, chunk, V) f32 logits exist at a time."""
    h, aux = trunk(cfg, params, tokens[:, :-1])
    labels = tokens[:, 1:]
    b, s, _ = h.shape
    ck = min(loss_chunk, s)
    if s % ck:
        raise ValueError(f"loss chunk {ck} does not divide {s} positions")
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, ck):
        total = total + checkpoint(_chunk_nll, h[:, i:i + ck],
                                   labels[:, i:i + ck], _head(params),
                                   use_reentrant=False)
    ce = total / (b * s)
    return ce + lb_coef * aux["lb_loss"], {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None) -> list:
    """KV cache: one (G, B, Hkv, Smax, Dh) pair per pattern position."""
    shape = (cfg.n_groups, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=_dtype(cfg), device=device),
             "v": torch.zeros(shape, dtype=_dtype(cfg), device=device)}
            for _ in cfg.pattern]


@torch.no_grad()
def prefill(cfg: TransformerConfig, params: Transformer, tokens: torch.Tensor,
            max_len: int, *, use_kernel: bool = True):
    """Run the prompt into a fresh ``max_len``-deep cache; return
    (last-token logits, cache, length).

    ``use_kernel=False`` runs the plain attention (``attention_ref``) in
    place of kernel A4, for comparison."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"a {s}-token prompt does not fit a {max_len}-token "
                         f"cache")
    h = params.embed[tokens.long()]
    positions = torch.arange(s, device=h.device)
    cache = init_cache(cfg, b, max_len, device=h.device)
    h = _groups(cfg, params, cache, h, positions, None, use_kernel)
    logits = torch.matmul(h[:, -1], _head(params).T)
    return logits, cache, s


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

@torch.no_grad()
def decode_step(cfg: TransformerConfig, params: Transformer, cache: list,
                pos, last_token: torch.Tensor):
    """One serve step: append one token a sequence.

    cache: ``init_cache``'s list, written in place; pos: the current
    length, an int, a 0-d tensor or a (B,) tensor (per sequence);
    last_token (B,).  Returns (logits (B, V), cache)."""
    h = params.embed[last_token.long()][:, None, :]          # (B, 1, D)
    dev = h.device
    if getattr(pos, "ndim", 0) == 1:
        positions = pos[:, None] + torch.arange(1, device=dev)[None, :]
    else:
        positions = pos + torch.arange(1, device=dev)
    h = _groups(cfg, params, cache, h, positions, pos, use_kernel=False)
    logits = torch.matmul(h[:, 0], _head(params).T)
    return logits, cache
