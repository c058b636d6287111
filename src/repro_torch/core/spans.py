"""The port's one recorder of spans and counters, and the named profiler
ranges of the level loop that ``analysis.trace_model`` reads.

The ranges are the port's counterpart of the XLA op names JAX's
``trace_model`` classifies: each level runs inside ``bfs.level``, and its
parts inside ``bfs.expand``, ``bfs.fold`` and ``bfs.owner_update``; every
``LocalMesh`` collective runs inside ``bfs.collective``.  Around them a
traversal runs inside ``bfs.run`` (``BFSEngine.run_async``), its source
upload inside ``bfs.init``, and each device read of the loop inside
``bfs.host_read`` (``mesh.host_read``).  Set-up has its own spans:
``graph.shard`` (with ``graph.shard.out_edges`` and
``graph.shard.in_edges``, the two bucketings of ``shard_graph``),
``engine.compile`` (``BFSEngine.__init__``) and ``engine.tile_build``
(the one-bit tiles of ``use_kernel``).

The recorder is on while a torch profiler records or while a
``recording()`` block is open.  With it off, ``span`` returns the shared
no-op ``_IDLE`` after one check (about 0.1 us), where an idle
``record_function`` still costs some microseconds a range, several
percent of a host-bound level loop.  While on, each span records
``(name, start, end, parent, run)`` into a bounded buffer: ``start`` and
``end`` from ``time.perf_counter_ns``, ``parent`` the index of the span
open around it on its thread (-1 for none), ``run`` the id of the
``bfs.run`` it belongs to (-1 outside every run).  Past ``CAPACITY``
spans the buffer drops new ones and counts them.  Set-up spans
(``setup_span``) run once per graph or engine and are recorded always.

While a profiler records, each span is also the ``record_function`` range
of its name, so the device trace carries the program's spans, with one
exception: ``gpubench/tracing.py`` and ``trace_model`` give a device op to
the innermost ``bfs.*`` range around its launch and know the four phases,
so a span other than the five level-loop ranges opens no profiler range
while a phase range is open (a queue level's ``bfs.host_read`` runs inside
``bfs.expand``); the recorder still records it.

Counters: ``count(name, k)`` adds on the host while the recorder is on;
``device_counter(name, device)`` is a one-element int64 tensor the
recorder owns, which a kernel adds into (``bsr_expand_bits``' tiles read,
``expand_dense``'s edges pushed).
``snapshot()`` reads the device counters once and returns the spans and
counters; nothing is written to a file.  The recorder keeps one pair of
``(time.time_ns(), time.perf_counter_ns())`` taken together, so
``snapshot(base_ns)`` gives each span's start on a chrome trace's clock:
an exported trace's ``ts`` is Unix microseconds less its
``baseTimeNanoseconds``.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple, Optional

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
RUN = "bfs.run"
INIT = "bfs.init"
HOST_READ = "bfs.host_read"
GRAPH_SHARD = "graph.shard"
SHARD_OUT_EDGES = "graph.shard.out_edges"
SHARD_IN_EDGES = "graph.shard.in_edges"
ENGINE_COMPILE = "engine.compile"
TILE_BUILD = "engine.tile_build"

#: ``bsr_expand_bits`` launches, tiles held (K a launch) and tiles read
#: (the kernel's own count) while the recorder is on
EXPAND_LAUNCHES = "bsr_expand_bits.launches"
TILES_HELD = "bsr_expand_bits.tiles_held"
TILES_READ = "bsr_expand_bits.tiles_read"
#: ``expand_dense`` launches and out-edges pushed (the kernel's own count)
#: while the recorder is on
DENSE_LAUNCHES = "expand_dense.launches"
EDGES_READ = "expand_dense.edges_read"

#: the ranges a device op is given to; no other span opens a profiler
#: range inside one of them
PHASES = frozenset((EXPAND, COLLECTIVE, FOLD, OWNER_UPDATE))
CAPACITY = 1 << 20


class Span(NamedTuple):
    name: str
    start: int                 # time.perf_counter_ns()
    end: Optional[int]         # None while the span is open
    parent: int                # index of the span open around it, or -1
    run: int                   # id of its bfs.run, or -1
    trace_us: float            # start on the trace clock of snapshot()


class Snapshot(NamedTuple):
    spans: list                # Span, in the order they opened
    counters: dict             # name -> int, device counters included
    dropped: int               # spans the full buffer did not keep


class _Thread(threading.local):
    def __init__(self):
        self.stack = []        # the open spans
        self.phases = 0        # open phase ranges
        self.run = -1


class Recorder:
    """Spans and counters of the process (see the module doc)."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.depth = 0                     # open recording() blocks
        self._lock = threading.Lock()
        self._local = _Thread()
        self._devices = {}                 # (name, device) -> (1,) int64
        self.reset()

    def reset(self) -> None:
        """Forget every span and counter and zero the device counters."""
        with self._lock:
            # the spans (_Open), appended without the lock: list.append
            # is atomic
            self._spans = []
            self._counts = {}
            self.dropped = 0
            self._run_ids = itertools.count(1)
            self.clock = (time.time_ns(), time.perf_counter_ns())
            for t in self._devices.values():
                t.zero_()

    def open(self, name: str) -> "_Open":
        return _Open(self, name)

    def count(self, name: str, k: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + int(k)

    def device_counter(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        with self._lock:
            t = self._devices.get(key)
            if t is None:
                t = self._devices[key] = torch.zeros(1, dtype=torch.int64,
                                                     device=key[1])
        return t

    def _keep(self, span: "_Open") -> None:
        # threads that meet at the bound may each keep one span past it
        spans = self._spans
        if len(spans) < self.capacity:
            spans.append(span)
        else:
            with self._lock:
                self.dropped += 1

    def snapshot(self, base_ns: int = 0) -> Snapshot:
        """The spans and counters so far.  Each span's ``trace_us`` is its
        start in Unix microseconds less ``base_ns / 1000``: with a chrome
        trace's ``baseTimeNanoseconds`` as ``base_ns``, on the trace's
        ``ts`` clock.  Reads each device counter once (a device sync)."""
        with self._lock:
            raw = list(self._spans)
            counts = dict(self._counts)
            dropped = self.dropped
            unix, perf = self.clock
            devices = list(self._devices.items())
        for (name, _), t in devices:
            counts[name] = counts.get(name, 0) + int(t.item())
        index = {id(e): i for i, e in enumerate(raw)}
        shift = unix - perf - base_ns
        spans = [Span(e.name, e.start, e.end, index.get(id(e.parent), -1),
                      e.run, (e.start + shift) / 1e3) for e in raw]
        return Snapshot(spans, counts, dropped)

    @contextlib.contextmanager
    def recording(self):
        with self._lock:
            self.depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self.depth -= 1


class _Open:
    """One span: open, recorded, and a profiler range where a profiler
    records and the phase rule allows; the recorder's buffer keeps it."""

    __slots__ = ("rec", "name", "start", "end", "parent", "run",
                 "run_before", "range", "phase")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        name, rec = self.name, self.rec
        st = rec._local
        self.phase = phase = name in PHASES
        self.range = None
        if _profiler_enabled() and (phase or name == LEVEL or not st.phases):
            # the range around the span: its own cost stays out of the span
            self.range = torch.profiler.record_function(name)
            self.range.__enter__()
        stack = st.stack
        self.parent = stack[-1] if stack else None
        self.run_before = self.run = st.run
        if name == RUN:
            st.run = self.run = next(rec._run_ids)
        self.end = None
        self.start = time.perf_counter_ns()
        rec._keep(self)
        stack.append(self)
        st.phases += phase
        return self

    def __exit__(self, *exc):
        self.end = time.perf_counter_ns()
        st = self.rec._local
        st.stack.pop()
        st.run = self.run_before
        st.phases -= self.phase
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


RECORDER = Recorder()


def span(name: str):
    """A recorded span named ``name`` (and a profiler range while a
    profiler records) while the recorder is on, else a no-op context."""
    if RECORDER.depth or _profiler_enabled():
        return _Open(RECORDER, name)
    return _IDLE


def setup_span(name: str):
    """A span of set-up work, recorded always (see the module doc)."""
    return RECORDER.open(name)


def on() -> bool:
    """Whether the recorder is on."""
    return bool(RECORDER.depth) or _profiler_enabled()


def count(name: str, k: int = 1) -> None:
    """Add ``k`` to the host counter ``name`` while the recorder is on."""
    if RECORDER.depth or _profiler_enabled():
        RECORDER.count(name, k)


def device_counter(name: str, device) -> torch.Tensor:
    """The recorder's one-element int64 counter ``name`` on ``device``,
    for a kernel to add into; ``snapshot()`` reads it."""
    return RECORDER.device_counter(name, device)


def snapshot(base_ns: int = 0) -> Snapshot:
    """``Recorder.snapshot`` of the process's recorder."""
    return RECORDER.snapshot(base_ns)


def recording():
    """A block in which the recorder is on without a profiler."""
    return RECORDER.recording()


def reset() -> None:
    """Forget what the process's recorder holds."""
    RECORDER.reset()
