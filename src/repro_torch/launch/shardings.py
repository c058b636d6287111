"""Partition specs for every family's params, state and batches — the port
of ``repro.launch.shardings``.

Strategy (the JAX package's, rule for rule):
  * LM: Megatron-style tensor parallel over ``model`` (attention heads when
    the head count divides the axis, otherwise the contracting dim), MoE
    expert parallel over ``model``, batch over ``data`` (+``pod``),
    vocab-sharded embedding.  Optimizer moments additionally sharded over
    ``data`` (ZeRO-1) on the first divisible dimension.
  * GNN/BFS: 1-D vertex partitioning over ALL mesh axes flattened — the
    paper's partitioning, applied to node/edge arrays; model params are
    small and replicated.
  * RecSys: embedding-table rows 1-D partitioned over ``model`` (the
    owner-exchange technique), batch over data axes.

Decode caches shard batch over ``data`` when divisible and always shard the
sequence dim over ``model`` (sequence-parallel KV) — for long_500k (B=1)
the sequence dim takes every axis.

The port has no ``jax.sharding``, so it keeps its own two types:

* ``P`` — a partition spec: one entry a dim, each ``None``, an axis name
  or a tuple of axis names, normalised as JAX's ``PartitionSpec``
  normalises them (a list becomes a tuple, a one-name tuple the name, an
  empty tuple ``None``), so ``tuple(P(...))`` equals ``tuple(jax_spec)``
  entry for entry.  It is not a tuple, so ``repro_torch.tree`` holds it as
  a leaf: ``P()`` does not vanish from a spec tree.
* ``NamedSharding(mesh, spec)`` — a spec checked against a mesh (any of
  the ``MeshAxes`` interface): an unknown axis, or an axis named twice,
  raises ``ValueError`` when it is made, and ``shard_shape(shape)`` raises
  ``ValueError`` on a dim its axes do not divide, as JAX's does.  JAX
  raises a plain ``Exception`` subclass for the repeated axis; the port a
  ``ValueError`` for all three.
"""

from __future__ import annotations

import math

from repro_torch import tree as tr
from repro_torch.configs.base import TransformerConfig
from repro_torch.launch.mesh import axis_sizes, mesh_axes


class P:
    """A partition spec (JAX's ``PartitionSpec``): one entry a dim."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        norm = []
        for e in entries:
            if isinstance(e, list):
                e = tuple(e)
            if isinstance(e, tuple):
                if not all(isinstance(a, str) for a in e):
                    raise TypeError(f"a spec entry's axes are names: {e!r}")
                e = None if not e else e[0] if len(e) == 1 else e
            elif e is not None and not isinstance(e, str):
                raise TypeError(f"a spec entry is None, an axis name or a "
                                f"tuple of them, not {e!r}")
            norm.append(e)
        self._entries = tuple(norm)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self):
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other):
        if isinstance(other, P):
            return self._entries == other._entries
        if isinstance(other, tuple):
            return self._entries == other
        return NotImplemented

    def __hash__(self):
        return hash(self._entries)

    def __repr__(self):
        return f"P{self._entries!r}" if len(self) != 1 else \
            f"P({self._entries[0]!r})"

    def axes(self) -> list:
        """Every axis name the spec uses, in entry order."""
        return [a for e in self._entries if e is not None
                for a in (e if isinstance(e, tuple) else (e,))]


class NamedSharding:
    """A spec placed on a mesh; checks its axes when made."""

    def __init__(self, mesh, spec: P):
        if not isinstance(spec, P):
            raise TypeError(f"NamedSharding takes a P, not {spec!r}")
        sizes = axis_sizes(mesh)
        used = spec.axes()
        for a in used:
            if a not in sizes:
                raise ValueError(f"Resource axis: {a} of {spec!r} is not "
                                 f"found in mesh: {tuple(sizes)}.")
        if len(set(used)) != len(used):
            raise ValueError(f"A single NamedSharding spec specification can "
                             f"map every mesh axis to at most one positional "
                             f"dimension, but {spec!r} names an axis twice")
        self.mesh, self.spec, self._sizes = mesh, spec, sizes

    def __repr__(self):
        return f"NamedSharding({self._sizes}, {self.spec!r})"

    def shard_shape(self, shape) -> tuple:
        """The per-shard shape of a global ``shape`` under the spec."""
        out = []
        for i, dim in enumerate(shape):
            e = self.spec[i] if i < len(self.spec) else None
            if e is None:
                out.append(int(dim))
                continue
            n = math.prod(self._sizes[a] for a in
                          (e if isinstance(e, tuple) else (e,)))
            if dim % n:
                raise ValueError(f"{self!r} implies that array axis {i} is "
                                 f"partitioned {n} times, but the dimension "
                                 f"size is {dim} (full shape: "
                                 f"{tuple(shape)})")
            out.append(int(dim) // n)
        return tuple(out)


def _size(mesh, axes) -> int:
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def _div(n: int, mesh, axes) -> bool:
    return n % _size(mesh, axes) == 0


# ---------------------------------------------------------------------------
# LM
# ---------------------------------------------------------------------------

def lm_param_specs(cfg: TransformerConfig, mesh, mode: str = "tp") -> dict:
    """mode='tp': Megatron tensor parallel over the model axis (+FSDP
    storage added by fsdp_specs).  mode='fsdp': no tensor parallelism —
    weights replicated for compute, storage sharded over ALL axes, batch
    over all axes (pure ZeRO-3).  The tree is ``transformer.init_tree``'s:
    one block a pattern position, each leaf stacked over the groups."""
    ax = mesh_axes(mesh)
    m = ax.model
    if mode == "fsdp":
        blocks = []
        for spec in cfg.pattern:
            b = {"attn": {k: P() for k in
                          (["wq", "wk", "wv", "wo"]
                           + (["bq", "bk", "bv"] if cfg.qkv_bias else []))},
                 "ln1": P(), "ln2": P()}
            if spec.moe and cfg.moe is not None:
                moe = {"router": P(), "w_gate": P(m, None, None),
                       "w_up": P(m, None, None), "w_down": P(m, None, None)}
                if cfg.moe.shared_experts:
                    moe["shared"] = {"w_gate": P(), "w_up": P(),
                                     "w_down": P()}
                b["moe"] = moe
            else:
                b["mlp"] = {"w_gate": P(), "w_up": P(), "w_down": P()}
            blocks.append(b)
        out = {"embed": P(), "blocks": blocks, "final_norm": P()}
        if not cfg.tie_embeddings:
            out["unembed"] = P()
        return out
    hq_ok = _div(cfg.n_heads, mesh, m)
    hkv_ok = _div(cfg.n_kv_heads, mesh, m)

    def attn_specs(has_bias):
        s = {
            # heads over model when divisible, else contract D (row-parallel)
            "wq": P(None, None, m, None) if hq_ok else P(None, m, None, None),
            "wk": P(None, None, m, None) if hkv_ok else P(None, m, None, None),
            "wv": P(None, None, m, None) if hkv_ok else P(None, m, None, None),
            "wo": P(None, m, None, None) if hq_ok else P(None, None, None, m),
        }
        if has_bias:
            s["bq"] = P(None, m, None) if hq_ok else P(None, None, None)
            s["bk"] = P(None, m, None) if hkv_ok else P(None, None, None)
            s["bv"] = P(None, m, None) if hkv_ok else P(None, None, None)
        return s

    blocks = []
    for spec in cfg.pattern:
        b = {"attn": attn_specs(cfg.qkv_bias),
             "ln1": P(None, None), "ln2": P(None, None)}
        if spec.moe and cfg.moe is not None:
            moe = {
                "router": P(None, None, None),  # tiny; the route wants it whole
                "w_gate": P(None, m, None, None),
                "w_up": P(None, m, None, None),
                "w_down": P(None, m, None, None),
            }
            if cfg.moe.shared_experts:
                moe["shared"] = {"w_gate": P(None, None, m),
                                 "w_up": P(None, None, m),
                                 "w_down": P(None, m, None)}
            b["moe"] = moe
        else:
            b["mlp"] = {"w_gate": P(None, None, m), "w_up": P(None, None, m),
                        "w_down": P(None, m, None)}
        blocks.append(b)

    out = {
        # input table: D-sharded so the token gather never all-gathers V
        "embed": P(None, m) if _div(cfg.d_model, mesh, m) else P(None, None),
        "blocks": blocks,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        # output head: V-sharded so CE/logits stay vocab-partitioned
        out["unembed"] = (P(m, None) if _div(cfg.vocab, mesh, m)
                          else P(None, None))
    else:
        out["embed"] = P(m, None) if _div(cfg.vocab, mesh, m) else P(None, None)
    return out


def lm_batch_specs(cfg: TransformerConfig, shape, mesh) -> dict:
    ax = mesh_axes(mesh)
    dp = ax.dp
    if shape.step in ("train", "prefill"):
        bspec = dp if _div(shape.global_batch, mesh, dp) else None
        return {"tokens": P(bspec, None)}
    # decode: cache (G, B, Hkv, Smax, Dh)
    b_ok = _div(shape.global_batch, mesh, dp)
    seq_axes = (ax.model,) if b_ok else tuple([*dp, ax.model])
    cache_spec = P(None, dp if b_ok else None, None, seq_axes, None)
    return {
        "cache": [{"k": cache_spec, "v": cache_spec} for _ in cfg.pattern],
        "pos": P(),
        "last_token": P(dp if b_ok else None),
    }


# ---------------------------------------------------------------------------
# GNN — 1-D vertex partition over all axes (the paper's partitioning)
# ---------------------------------------------------------------------------

def gnn_param_specs(params_shape, mesh) -> dict:
    return tr.map_tree(lambda _: P(), params_shape)


def gnn_batch_specs(batch_specs: dict, mesh) -> dict:
    ax = mesh_axes(mesh)
    flat = ax.flat
    out = {}
    for k, v in batch_specs.items():
        if k == "graph_targets":
            out[k] = P(None, None)
        elif v.ndim == 1:
            out[k] = P(flat if v.shape[0] % _size(mesh, flat) == 0 else None)
        else:
            rest = (None,) * (v.ndim - 1)
            out[k] = P(flat if v.shape[0] % _size(mesh, flat) == 0 else None,
                       *rest)
    return out


# ---------------------------------------------------------------------------
# RecSys — row-partitioned tables (owner-exchange), data-parallel batch
# ---------------------------------------------------------------------------

def recsys_param_specs(cfg, mesh) -> dict:
    ax = mesh_axes(mesh)
    m = ax.model
    row = m if _div(cfg.total_rows, mesh, m) else None
    return {
        "table": P(row, None),
        "lin_table": P(row, None),
        "lin_dense": P(None),
        "bias": P(),
        "mlp": [{"w": P(None, None), "b": P(None)}
                for _ in range(len(cfg.mlp_dims) + 1)],
    }


def recsys_batch_specs(cfg, shape, mesh) -> dict:
    ax = mesh_axes(mesh)
    dp = ax.dp
    if shape.step == "retrieval":
        c_ok = _div(shape.n_candidates, mesh, dp)
        return {"sparse": P(None, None), "cand_ids": P(dp if c_ok else None)}
    b = dp if _div(shape.batch, mesh, dp) else None
    out = {"sparse": P(b, None), "dense": P(b, None)}
    if shape.step == "train":
        out["label"] = P(b)
    return out


# ---------------------------------------------------------------------------
# optimizer state: ZeRO-1 (moments extra-sharded over data)
# ---------------------------------------------------------------------------

def zero1_spec(param_spec: P, shape: tuple, mesh, dp) -> P:
    """Extend a param spec by sharding the first free divisible dim over
    the data axes (classic optimizer-state sharding).  No-op if the spec
    already uses a data axis (e.g. FSDP-sharded storage)."""
    entries = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for e in entries:
        for a in (e if isinstance(e, tuple) else (e,)):
            used.add(a)
    if any(a in used for a in dp):
        return param_spec
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % _size(mesh, dp) == 0 and dim > 0:
            entries[i] = dp
            return P(*entries)
    return param_spec


def fsdp_specs(param_specs, params_shape, mesh, min_size: int = 2 ** 20,
               dp_axes=None):
    """FSDP: shard weight *storage* over the data axes on the first free
    divisible dim (small leaves stay as-is).  Pass ``dp_axes`` to shard
    storage over a wider axis set (pure-FSDP mode).  ``params_shape`` is
    any tree of the params' structure whose leaves have ``.shape`` (meta
    tensors)."""
    ax = mesh_axes(mesh)
    dp = tuple(dp_axes) if dp_axes else ax.dp

    def one(sp, sh):
        if math.prod(sh.shape) * 2 < min_size:
            return sp
        return zero1_spec(sp, tuple(sh.shape), mesh, dp)

    return tr.map_tree(one, param_specs, params_shape)


def state_specs(param_specs, params_shape, mesh, *, zero1: bool = True,
                fsdp: bool = False):
    """Specs for the ``{'params', 'opt': {'m', 'v', 'step'}}`` train
    state."""
    ax = mesh_axes(mesh)
    if fsdp:
        param_specs = fsdp_specs(param_specs, params_shape, mesh)
    if not zero1:
        mv = param_specs
    else:
        mv = tr.map_tree(
            lambda sp, sh: zero1_spec(sp, tuple(sh.shape), mesh, ax.dp),
            param_specs, params_shape)
    return {"params": param_specs,
            "opt": {"m": mv, "v": mv, "step": P()}}


def to_named(tree_specs, mesh):
    """Each spec of the tree as a ``NamedSharding`` on ``mesh``."""
    return tr.map_tree(lambda s: NamedSharding(mesh, s), tree_specs)


def shard_bytes(tree, specs, mesh) -> int:
    """Bytes one shard holds of ``tree`` (tensors, or anything with
    ``shape`` and ``dtype``) placed under ``specs`` on ``mesh``: each
    leaf's ``shard_shape`` times its element size.  Raises ``ValueError``
    where a spec does not fit its leaf."""
    def one(x, s):
        shape = NamedSharding(mesh, s).shard_shape(tuple(x.shape))
        return math.prod(shape) * x.element_size()

    return sum(tr.leaves(tr.map_tree(one, tree, specs)))
