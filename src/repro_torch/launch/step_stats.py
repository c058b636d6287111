"""Roofline terms of one step, from a trace — the port's twin of
``repro.launch.hlo_stats`` and ``repro.launch.hlo_parse``.

The JAX pair reads a compiled executable: ``cost_analysis`` for FLOPs and
bytes accessed, and a parse of the optimized HLO text for the collectives'
output bytes and the dot FLOPs, each weighted by its while loop's trip
count.  The port compiles nothing and emits no HLO, so there is no text
to parse: ``trace_step`` runs the step once, eagerly (on meta tensors in
the dry run: shapes only), under three counters:

* ``torch.utils.flop_counter.FlopCounterMode`` — the matrix products'
  FLOPs, ``2 * prod(out) * prod(contracted)`` each: ``hlo_parse``'s
  ``dot_flops`` convention.  It is not ``cost_analysis``' total, which
  counts elementwise ops too and which JAX's ``analyze`` takes a ``max``
  with; the port's ``flops`` are dot FLOPs alone.  ``FlopCounterMode``
  cannot see inside a custom CUDA op, so a step whose FLOPs are checked
  on the card must launch none (the dry run's meta route takes the plain
  versions);
* ``_ByteCounter``, a ``TorchDispatchMode`` that sums each aten op's
  input and output bytes — the analog of XLA's "bytes accessed".  Every
  op is counted as if it read its inputs from and wrote its outputs to
  memory: nothing is fused, so it is an upper bound.  Views and other
  aliasing ops move nothing and count 0;
* the mesh collectives: a ``analysis.collective_audit.RecordingMesh``
  that the step runs its collectives on records each one's per-shard
  output bytes, ``collective_bytes`` sums them by JAX's keys.

An eager trace runs every layer and every loss chunk, so ``hlo_parse``'s
trip-count walk has no twin: nothing is counted once for many.  A remat
recompute runs (and is counted) as the backward runs it.

``Roofline`` keeps JAX's fields and ``row()`` keys, priced with the H100's
peaks (``launch/roofline.py``), never the TPU v5e's of ``hlo_stats``.
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.roofline import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_COLLECTIVES = ("all-reduce", "all-gather", "all-to-all", "reduce-scatter",
                "collective-permute")


def collective_bytes(ops) -> dict:
    """Sum of collective output bytes a shard, by op kind (JAX's keys,
    ``count`` and ``total``), from ``RecordingMesh.ops`` rows."""
    out = dict.fromkeys(_COLLECTIVES, 0)
    out["count"] = 0
    for op in ops:
        out[op.kind] += int(op.out_bytes)
        out["count"] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    return out


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _aliases(func) -> bool:
    """True for an op whose outputs view an input (no bytes move)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class _ByteCounter(TorchDispatchMode):
    """Sums the bytes of each aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not _aliases(func):
            self.bytes += sum(_nbytes(t) for t in
                              tree_leaves((args, kwargs or {}, out)))
        return out


@dataclasses.dataclass
class StepTrace:
    """One traced step: its outputs and the counters' readings (global:
    every shard of a stacked mesh is in them)."""
    out: object
    dot_flops: float
    bytes_accessed: float
    collectives: dict
    seconds: float


def trace_step(fn, args, mesh=None) -> StepTrace:
    """Run ``fn(*args)`` once under the FLOP and byte counters; ``mesh``
    is the ``RecordingMesh`` the step runs its collectives on, if any
    (its collectives recorded during this run are counted)."""
    first = len(mesh.ops) if mesh is not None else 0
    t0 = time.perf_counter()
    with FlopCounterMode(display=False) as flops, _ByteCounter() as nb:
        out = fn(*args)
    dt = time.perf_counter() - t0
    coll = collective_bytes(mesh.ops[first:] if mesh is not None else ())
    return StepTrace(out, float(flops.get_total_flops()), float(nb.bytes),
                     coll, dt)


@dataclasses.dataclass
class Roofline:
    flops: float              # per-device dot FLOPs
    hbm_bytes: float          # per-device bytes accessed (unfused: a bound)
    coll_bytes: float         # per-device collective bytes
    chips: int
    model_flops: float = 0.0  # 6*N*D-style useful-work estimate (global)

    @property
    def t_compute(self):
        return self.flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self):
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self):
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self):
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self):
        if self.model_flops and self.flops:
            return self.model_flops / (self.flops * self.chips)
        return float("nan")

    def row(self):
        return {
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "flops_per_chip": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "useful_flops_ratio": self.useful_ratio,
        }


def roofline(trace: StepTrace, chips: int,
             model_flops: float = 0.0) -> Roofline:
    """A trace's terms a chip: FLOPs and bytes are the whole step's
    divided by ``chips`` (a floor on GSPMD's per-device count, which
    includes replicated work); collectives are already a shard's."""
    return Roofline(flops=trace.dot_flops / chips,
                    hbm_bytes=trace.bytes_accessed / chips,
                    coll_bytes=float(trace.collectives["total"]),
                    chips=chips, model_flops=model_flops)


def analyze(fn, args, chips: int, model_flops: float = 0.0,
            mesh=None) -> Roofline:
    """Roofline terms of ``fn(*args)`` on ``chips`` chips (JAX's
    ``analyze`` over a compiled step): one traced run."""
    return roofline(trace_step(fn, args, mesh), chips, model_flops)
