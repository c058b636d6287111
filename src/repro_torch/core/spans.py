"""Named profiler ranges of the level loop, read by ``analysis.trace_model``.

The port's counterpart of the XLA op names JAX's ``trace_model``
classifies: each level runs inside ``bfs.level``, and its parts inside
``bfs.expand``, ``bfs.fold`` and ``bfs.owner_update``; every ``LocalMesh``
collective runs inside ``bfs.collective``.  A range is a
``torch.profiler.record_function`` only while a profiler records: with
none, ``span`` returns a shared no-op context after one check of the
profiler's state (about 0.1 us), where an idle ``record_function`` still
costs some microseconds a range, several percent of a host-bound level
loop.
"""

from __future__ import annotations

import contextlib

import torch

try:
    from torch._C._autograd import _profiler_enabled
except ImportError:                       # a build without the C hook
    from torch.autograd.profiler import _profiler_enabled

_IDLE = contextlib.nullcontext()

LEVEL = "bfs.level"
EXPAND = "bfs.expand"
COLLECTIVE = "bfs.collective"
FOLD = "bfs.fold"
OWNER_UPDATE = "bfs.owner_update"


def span(name: str):
    """A profiler range named ``name`` while a profiler records, else a
    no-op context."""
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _IDLE
