"""Cross-graph engine cache + graph catalog: the multi-tenant serving core
— the port of ``repro.serve.engine_cache``.

The compile-once lifecycle (core/engine.py) amortizes one graph's
traversals; this module amortizes *across* graphs and entry points.  An
``EngineCache`` is a memory-bounded LRU of compiled ``BFSEngine``s keyed
by ``BFSPlan.plan_key()`` — graph content hash, options, mesh topology,
partition scheme, source capacity and resolved exchange strategies — so
every entry point (``BFSService`` lanes, the front end, scripts) shares
one compiled-asset pool:

  * ``get_or_compile(plan)`` is thread-safe and coalescing: concurrent
    requests for one key get the same engine object and pay one compile
    (losers wait on the winner's in-flight event instead of recompiling).
  * Eviction is LRU over ``estimated_device_bytes()`` against a byte
    budget (``max_device_bytes``) and/or an entry cap (``max_entries``);
    pinned entries are never evicted.  Evicting drops the cache's
    reference — live holders keep their engine; its device buffers free
    when the last reference dies.
  * Counters (hits / misses / evictions / compile seconds) feed the
    serving benchmarks' amortization ledger and the launchers' stats
    lines.

``GraphCatalog`` is the name -> graph registry the multi-graph
``BFSService`` routes on.  It reuses ``graphs.formats.to_2d`` for lazy
1-D -> 2-D conversion, so a graph registered once serves 1-D and 2-D
plans from the same container (same blocks, shared device-buffer cache).

A process-wide default cache (``default_engine_cache``) backs services
built without one; ``BFS_ENGINE_CACHE_ENTRIES`` / ``BFS_ENGINE_CACHE_MB``
size it from the environment.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.serve.resilience import faults as _faults


def _to_key(obj) -> tuple:
    """Accept a BFSPlan, a BFSEngine or a raw key tuple."""
    if hasattr(obj, "plan_key"):
        return obj.plan_key()
    if hasattr(obj, "plan"):
        return obj.plan.plan_key()
    return obj


@dataclass
class _Entry:
    engine: object
    device_bytes: int
    compile_s: float
    pinned: bool = False


class EngineCache:
    """Keyed LRU of compiled BFS engines with a device-byte budget.

    ``max_device_bytes=None`` / ``max_entries=None`` disable that bound;
    with both disabled the cache only deduplicates and counts.
    """

    def __init__(self, *, max_device_bytes: Optional[int] = None,
                 max_entries: Optional[int] = None):
        if max_device_bytes is not None and max_device_bytes <= 0:
            raise ValueError(f"max_device_bytes must be positive "
                             f"({max_device_bytes})")
        if max_entries is not None and max_entries <= 0:
            raise ValueError(f"max_entries must be positive ({max_entries})")
        self.max_device_bytes = max_device_bytes
        self.max_entries = max_entries
        # guarded-by(_lock): _entries, _building, hits, misses,
        # guarded-by(_lock): evictions, compile_s_total
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._building: Dict[tuple, threading.Event] = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.compile_s_total = 0.0

    # ------------------------------------------------------------- queries
    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, plan_or_key) -> bool:
        key = _to_key(plan_or_key)
        with self._lock:
            return key in self._entries

    def keys(self) -> list:
        """Current keys in LRU order (least recently used first)."""
        with self._lock:
            return list(self._entries)

    def device_bytes(self) -> int:
        with self._lock:
            return sum(e.device_bytes for e in self._entries.values())

    def stats(self) -> dict:
        with self._lock:
            total = sum(e.device_bytes for e in self._entries.values())
            return {
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "entries": len(self._entries),
                "pinned": sum(e.pinned for e in self._entries.values()),
                "device_bytes": total,
                "max_device_bytes": self.max_device_bytes,
                "max_entries": self.max_entries,
                "compile_s_total": self.compile_s_total,
                "hit_rate": (self.hits / (self.hits + self.misses)
                             if self.hits + self.misses else 0.0),
            }

    # ----------------------------------------------------------- lifecycle
    def get(self, plan_or_key):
        """Cached engine or None; a hit refreshes LRU recency."""
        key = _to_key(plan_or_key)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            return ent.engine

    def get_or_compile(self, plan, *, pin: bool = False):
        """The serving entry point: one compiled engine per plan key.

        Thread-safe with per-key coalescing — the first caller of a key
        compiles while holding no lock (compiles are seconds-long; other
        keys must proceed); late callers of the same key wait on its
        in-flight event and receive the same engine object.

        ``pin=True`` marks the entry pinned in the same locked section
        that returns it — the race-free way to pin a latency-critical
        tenant (a separate ``pin()`` call can lose the entry to an
        eviction in between).
        """
        key = plan.plan_key()
        # chaos: "storm" specs evict everything unpinned before the
        # lookup (cache-eviction storms); no-op without an active plan
        _faults.fire("cache.get", _faults.plan_tag(plan),
                     storm=self.clear_unpinned)
        while True:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    self._entries.move_to_end(key)
                    self.hits += 1
                    if pin:
                        ent.pinned = True
                    return ent.engine
                ev = self._building.get(key)
                if ev is None:
                    ev = threading.Event()
                    self._building[key] = ev
                    break
            # another thread is compiling this key; wait, then re-check
            # (if its entry was evicted before we woke, this thread
            # compiles it on the next loop)
            ev.wait()
        try:
            _faults.fire("cache.compile", _faults.plan_tag(plan))
            t0 = time.perf_counter()
            engine = plan.compile()
            dt = time.perf_counter() - t0
            with self._lock:
                self.misses += 1
                self.compile_s_total += dt
                self._entries[key] = _Entry(
                    engine=engine,
                    device_bytes=int(plan.estimated_device_bytes()),
                    compile_s=dt, pinned=pin)
                self._entries.move_to_end(key)
                self._evict_over_budget(keep=key)
            return engine
        finally:
            with self._lock:
                self._building.pop(key, None)
            ev.set()

    def put(self, plan, engine) -> None:
        """Insert an externally compiled engine (benchmarks, tests)."""
        key = plan.plan_key()
        with self._lock:
            self._entries[key] = _Entry(
                engine=engine,
                device_bytes=int(plan.estimated_device_bytes()),
                compile_s=0.0)
            self._entries.move_to_end(key)
            self._evict_over_budget(keep=key)

    # audit: allow(LK001) -- internal helper; every caller holds _lock
    def _evict_over_budget(self, keep: tuple) -> None:
        """Drop LRU unpinned entries until bounds hold (lock held).

        The just-touched ``keep`` entry is exempt: an engine the caller is
        about to receive must not be evicted out from under the in-flight
        waiters even when it alone exceeds the budget (the cache then
        temporarily runs over — the estimate is advisory for admission,
        binding for retention).
        """
        def over() -> bool:
            if (self.max_entries is not None
                    and len(self._entries) > self.max_entries):
                return True
            if self.max_device_bytes is not None:
                total = sum(e.device_bytes for e in self._entries.values())
                return total > self.max_device_bytes
            return False

        while over():
            victim = next((k for k, e in self._entries.items()
                           if not e.pinned and k != keep), None)
            if victim is None:
                return                      # only pinned/kept entries left
            del self._entries[victim]
            self.evictions += 1

    # -------------------------------------------------------------- pinning
    def pin(self, plan_or_key) -> bool:
        """Exempt a resident entry from eviction (latency-critical
        tenants); returns False if the key is not resident — e.g. it was
        evicted between a ``get_or_compile`` and this call.  For a
        race-free pin use ``get_or_compile(plan, pin=True)``."""
        key = _to_key(plan_or_key)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                return False
            ent.pinned = True
            return True

    def unpin(self, plan_or_key) -> None:
        key = _to_key(plan_or_key)
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None:
                ent.pinned = False

    def evict(self, plan_or_key) -> bool:
        """Explicitly drop one entry (pinned or not); True if it existed."""
        key = _to_key(plan_or_key)
        with self._lock:
            if key in self._entries:
                del self._entries[key]
                self.evictions += 1
                return True
            return False

    def clear(self) -> None:
        with self._lock:
            self.evictions += len(self._entries)
            self._entries.clear()

    def clear_unpinned(self) -> int:
        """Drop every unpinned entry (the eviction-storm hammer the
        chaos layer swings); returns the number dropped."""
        with self._lock:
            victims = [k for k, e in self._entries.items() if not e.pinned]
            for k in victims:
                del self._entries[k]
            self.evictions += len(victims)
            return len(victims)


# ---------------------------------------------------------------------------
# Graph catalog: the names the multi-graph service routes on
# ---------------------------------------------------------------------------

class GraphCatalog:
    """Registry of named graphs for multi-tenant serving.

    Holds 1-D ``ShardedGraph``s and/or pre-built ``ShardedGraph2D``s;
    ``get_2d`` converts a 1-D registration lazily through the cached
    ``to_2d`` so both partition schemes serve from one container.
    Re-registering a name is a no-op for the identical object and an
    error otherwise (silent replacement would orphan cached engines whose
    keys still fingerprint the old content).
    """

    def __init__(self):
        # guarded-by(_lock): _graphs
        self._graphs: Dict[str, object] = {}
        self._lock = threading.Lock()

    def register(self, name: str, graph):
        if not name:
            raise ValueError("graph name must be non-empty")
        with self._lock:
            cur = self._graphs.get(name)
            if cur is not None and cur is not graph:
                raise ValueError(
                    f"graph {name!r} is already registered with a "
                    "different object; unregister it first")
            self._graphs[name] = graph
        return graph

    def unregister(self, name: str) -> None:
        with self._lock:
            self._graphs.pop(name, None)

    def get(self, name: str):
        with self._lock:
            try:
                return self._graphs[name]
            except KeyError:
                raise KeyError(
                    f"graph {name!r} is not registered; catalog has "
                    f"{sorted(self._graphs)}") from None

    def get_2d(self, name: str, r: int, c: int):
        """The registered graph's 2-D edge blocks for an r x c grid —
        the same cached object ``plan(graph, partition='2d')`` uses."""
        from repro_torch.graphs.formats import ShardedGraph2D, to_2d

        g = self.get(name)
        if isinstance(g, ShardedGraph2D):
            if (g.part.r, g.part.c) != (r, c):
                raise ValueError(
                    f"graph {name!r} holds {g.part.r}x{g.part.c} edge "
                    f"blocks; requested grid is {r}x{c}")
            return g
        return to_2d(g, r, c)

    def names(self) -> list:
        with self._lock:
            return sorted(self._graphs)

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._graphs

    def __len__(self) -> int:
        with self._lock:
            return len(self._graphs)


# ---------------------------------------------------------------------------
# Process-wide default cache (services built without a cache)
# ---------------------------------------------------------------------------

_default_cache: Optional[EngineCache] = None
_default_lock = threading.Lock()


def _cache_from_env() -> EngineCache:
    # A small default entry cap: cache entries keep their engine -> plan
    # -> graph chain alive (host and device blocks included), so a
    # generous default would pin dropped graphs' memory for the process
    # lifetime.  Serving deployments
    # should size their own EngineCache (byte budget) explicitly.
    entries = int(os.environ.get("BFS_ENGINE_CACHE_ENTRIES", "8"))
    mb = float(os.environ.get("BFS_ENGINE_CACHE_MB", "0"))
    return EngineCache(
        max_entries=entries if entries > 0 else None,
        max_device_bytes=int(mb * 2**20) if mb > 0 else None)


def default_engine_cache() -> EngineCache:
    """The process-wide shared cache (created on first use)."""
    global _default_cache
    with _default_lock:
        if _default_cache is None:
            _default_cache = _cache_from_env()
        return _default_cache


def set_default_cache(cache: Optional[EngineCache]) -> Optional[EngineCache]:
    """Swap the process-wide cache; returns the previous one (None =
    reset, so the next ``default_engine_cache()`` re-reads the env)."""
    global _default_cache
    with _default_lock:
        prev, _default_cache = _default_cache, cache
        return prev


@contextlib.contextmanager
def use_default_cache(cache: EngineCache):
    """Temporarily install ``cache`` as the process default (tests)."""
    prev = set_default_cache(cache)
    try:
        yield cache
    finally:
        set_default_cache(prev)
