"""Ambient sharding hints for model code — the port of
``repro.models.sharding_hints``.

Model code is mesh-agnostic; a launcher opts in by calling
``set_hints(mesh, dp, model)`` (or entering ``hints(...)``) before it runs
a step.  Two things read the hints:

* ``models.moe.moe_apply`` takes the expert-parallel route
  (``moe_apply_sharded``) on the hinted mesh and axes, as JAX's does;
* every ``constrain_*`` is called where the JAX package calls it.  In JAX
  each pins a layout for GSPMD (``with_sharding_constraint``).  The
  port's meshes stack their shards, so there is no layout to pin: each
  returns its input unchanged.  While a ``recording()`` is active and
  hints are set, each records ``(name, shape, spec)`` — the spec JAX's
  ``_constrain`` would pin, decided by JAX's rules (divisibility,
  ``seq_shard``, pure-FSDP) — so the sharding plan a step asks for can be
  read and held to JAX's.

With hints unset every ``constrain_*`` is the identity and records
nothing.  The state is module-level: ``hints(...)`` clears it on every
exit, an exception's too.
"""

from __future__ import annotations

import contextlib
import math

from repro_torch import tree as tr
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.shardings import P

_STATE = {"mesh": None, "dp": None, "model": None, "flat": None,
          "seq_shard": True, "param_specs": None}
_SINKS: list = []


def set_hints(mesh, dp, model, flat=None, seq_shard=True, param_specs=None):
    _STATE.update(mesh=mesh, dp=tuple(dp) if dp else None, model=model,
                  flat=tuple(flat) if flat else None, seq_shard=seq_shard,
                  param_specs=param_specs)


def clear_hints():
    _STATE.update(mesh=None, dp=None, model=None, flat=None,
                  param_specs=None)


@contextlib.contextmanager
def hints(mesh, dp, model, flat=None, seq_shard=True, param_specs=None):
    set_hints(mesh, dp, model, flat, seq_shard, param_specs)
    try:
        yield
    finally:
        clear_hints()


def enabled() -> bool:
    return _STATE["mesh"] is not None


@contextlib.contextmanager
def recording():
    """Collect ``(name, shape, spec)`` for every constraint a step asks
    for while hints are set; yields the list it fills."""
    sink = []
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


def _constrain(x, spec: P, name: str):
    if not enabled():
        return x
    for sink in _SINKS:
        sink.append((name, tuple(x.shape), spec))
    return x


def _dp_ok(n: int) -> bool:
    sizes = axis_sizes(_STATE["mesh"])
    return n % math.prod(sizes[a] for a in _STATE["dp"]) == 0


def _model_size() -> int:
    return axis_sizes(_STATE["mesh"])[_STATE["model"]]


def constrain_tokens_3d(h):
    """(B, S, D) residual stream: batch over dp, sequence over model."""
    if not enabled():
        return h
    b, s, _ = h.shape
    dp, m = _STATE["dp"], _STATE["model"]
    s_ok = (_STATE["seq_shard"] and m not in dp
            and s % _model_size() == 0)
    return _constrain(h, P(dp if _dp_ok(b) else None, m if s_ok else None,
                           None), "constrain_tokens_3d")


def constrain_logits_3d(x):
    """(B, S_chunk, V) logits: batch over dp, vocab over model."""
    if not enabled():
        return x
    b, _, v = x.shape
    dp, m = _STATE["dp"], _STATE["model"]
    v_ok = m not in dp and v % _model_size() == 0
    return _constrain(x, P(dp if _dp_ok(b) else None, None,
                           m if v_ok else None), "constrain_logits_3d")


def constrain_expert_buffer(x):
    """(E, C, D) MoE buffers: experts over model."""
    if not enabled():
        return x
    e_ok = x.shape[0] % _model_size() == 0
    return _constrain(x, P(_STATE["model"] if e_ok else None, None, None),
                      "constrain_expert_buffer")


def constrain_vocab_table(w):
    """(V, D) head table inside the loss chunk: vocab over model (none
    under pure FSDP, whose dp axes hold the model axis)."""
    if not enabled():
        return w
    m = _STATE["model"]
    if m in (_STATE["dp"] or ()):
        return w
    v_ok = w.shape[0] % _model_size() == 0
    return _constrain(w, P(m if v_ok else None, None),
                      "constrain_vocab_table")


def constrain_heads_4d(x):
    """(B, H, S, Dh) attention tensors: batch over dp, heads over model
    (when divisible)."""
    if not enabled():
        return x
    b, h = x.shape[0], x.shape[1]
    h_ok = h % _model_size() == 0
    return _constrain(x, P(_STATE["dp"] if _dp_ok(b) else None,
                           _STATE["model"] if h_ok else None, None, None),
                      "constrain_heads_4d")


def constrain_rows(x):
    """(rows, ...) vertex/edge-partitioned arrays (GNN/BFS): rows over the
    flattened mesh — the paper's 1-D partitioning."""
    if not enabled() or _STATE["flat"] is None:
        return x
    flat = _STATE["flat"]
    sizes = axis_sizes(_STATE["mesh"])
    if x.shape[0] % math.prod(sizes[a] for a in flat):
        return x
    return _constrain(x, P(flat, *([None] * (x.dim() - 1))),
                      "constrain_rows")


def constrain_grads(grads):
    """Gradients pinned to the parameter *storage* specs before the
    optimizer.  ``grads`` is the params' tree or its leaves in
    ``repro_torch.tree`` order (the train step's list)."""
    specs = _STATE.get("param_specs")
    if not enabled() or specs is None:
        return grads
    for g, sp in zip(tr.leaves(grads), tr.leaves(specs), strict=True):
        _constrain(g, sp, "constrain_grads")
    return grads


def constrain_tokens_full(h):
    """(B, S, D) at block entry: batch over dp, sequence gathered."""
    if not enabled() or not _STATE["seq_shard"]:
        return h
    return _constrain(h, P(_STATE["dp"] if _dp_ok(h.shape[0]) else None,
                           None, None), "constrain_tokens_full")
