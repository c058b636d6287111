"""Serving observability: per-lane counters + latency histograms.

Three latency axes per lane, matching the request lifecycle the
dispatcher drives (server.py):

  * ``queue_wait`` — admission to dispatch (time spent behind the gate);
  * ``device``     — dispatch to result sync (engine ``run_async`` ->
    ``block``, i.e. device time plus the overlap window shared with
    other lanes);
  * ``e2e``        — admission to completion (what the client feels,
    minus transport).

Histograms use fixed log-spaced bucket bounds so snapshots are cheap,
mergeable, and stable across runs; percentile estimates are the bucket
upper bound (conservative).  All mutation is lock-guarded per lane —
handler threads and the dispatcher both record — so the counters obey
the same no-lost-updates contract the ``EngineCache`` stats do.
``FrontendMetrics.snapshot()`` is what ``GET /metrics`` returns, with
the shared cache's hit/evict counters attached by the caller.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

#: log-spaced seconds; the last open bucket catches everything slower
DEFAULT_BOUNDS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                  0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

#: per-level step times sit 1-3 decades below request latencies (a
#: traversal is levels x step), so the per-level histogram extends the
#: default bounds downward into the sub-millisecond range
PER_LEVEL_BOUNDS = (0.0001, 0.00025, 0.0005) + DEFAULT_BOUNDS


class Histogram:
    """Fixed-bound latency histogram (seconds in, ms out).

    Not self-locking: the owning ``LaneMetrics`` serializes access —
    one lock per lane instead of three per observation.
    """

    def __init__(self, bounds=DEFAULT_BOUNDS):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"histogram bounds must be strictly "
                             f"increasing ({bounds})")
        self.counts = [0] * (len(self.bounds) + 1)   # +1: overflow bucket
        self.count = 0
        self.sum_s = 0.0

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        i = 0
        for i, b in enumerate(self.bounds):
            if s <= b:
                break
        else:
            i = len(self.bounds)
        self.counts[i] += 1
        self.count += 1
        self.sum_s += s

    def quantile(self, q: float) -> Optional[float]:
        """Upper-bound estimate of the q-quantile in seconds (None when
        empty; +inf collapses to the largest finite bound)."""
        if not self.count:
            return None
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank and c:
                return (self.bounds[i] if i < len(self.bounds)
                        else self.bounds[-1])
        return self.bounds[-1]

    def snapshot(self) -> dict:
        out = {
            "count": self.count,
            "sum_ms": round(self.sum_s * 1e3, 3),
            "mean_ms": round(self.sum_s / self.count * 1e3, 3)
                        if self.count else None,
            "buckets": {},
        }
        cum = 0
        for b, c in zip(self.bounds, self.counts):
            cum += c
            out["buckets"][f"le_{b * 1e3:g}ms"] = cum
        out["buckets"]["le_inf"] = self.count
        for q, label in ((0.5, "p50_ms"), (0.95, "p95_ms"),
                         (0.99, "p99_ms")):
            v = self.quantile(q)
            out[label] = round(v * 1e3, 3) if v is not None else None
        return out


class LaneMetrics:
    """One lane's serving counters; all methods are thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        # guarded-by(_lock): queue_wait, device, per_level, e2e, completed,
        # guarded-by(_lock): failed, rejected, rejected_invalid,
        # guarded-by(_lock): bucket_counts, sources_served, wire_bytes,
        # guarded-by(_lock): _ewma_e2e_s, deadline_expired,
        # guarded-by(_lock): breaker_rejected, retries, degraded
        self.queue_wait = Histogram()
        self.device = Histogram()
        # per-level device step time: each completed run contributes one
        # observation per traversal level (device_s / levels), so deep
        # traversals weigh in proportion to the level iterations they ran
        # — the distribution the fused-tail work shortens
        self.per_level = Histogram(PER_LEVEL_BOUNDS)
        self.e2e = Histogram()
        self.completed = 0
        self.failed = 0
        self.rejected = 0              # 429s (admission)
        self.rejected_invalid = 0      # 400s (validation)
        self.bucket_counts: Dict[int, int] = {}
        self.sources_served = 0
        # cumulative modeled per-chip wire bytes by phase (resolved
        # plan's per-level pricing x levels each run spent in the phase)
        self.wire_bytes: Dict[str, float] = {}
        self._ewma_e2e_s = None
        # resilience counters (server.py's deadline / breaker / retry /
        # degradation paths record here; /metrics surfaces them)
        self.deadline_expired = 0      # 504s (reaped or expired waits)
        self.breaker_rejected = 0      # 503s shed while the circuit is open
        self.retries = 0               # transient-failure retry attempts
        self.degraded: Dict[str, int] = {}   # serves per degradation arm

    # ------------------------------------------------------------ recording
    def record_rejected(self, *, invalid: bool = False) -> None:
        with self._lock:
            if invalid:
                self.rejected_invalid += 1
            else:
                self.rejected += 1

    def record_failed(self) -> None:
        with self._lock:
            self.failed += 1

    def record_deadline_expired(self) -> None:
        with self._lock:
            self.deadline_expired += 1

    def record_breaker_rejected(self) -> None:
        with self._lock:
            self.breaker_rejected += 1

    def record_retry(self) -> None:
        with self._lock:
            self.retries += 1

    def record_degraded(self, arm: str) -> None:
        with self._lock:
            self.degraded[arm] = self.degraded.get(arm, 0) + 1

    def record_completed(self, *, queue_wait_s: float, device_s: float,
                         e2e_s: float, bucket: int, n_sources: int,
                         wire_bytes: Optional[Dict[str, float]] = None,
                         levels: int = 0) -> None:
        with self._lock:
            for phase, b in (wire_bytes or {}).items():
                self.wire_bytes[phase] = self.wire_bytes.get(phase, 0.0) + b
            self.queue_wait.observe(queue_wait_s)
            self.device.observe(device_s)
            for _ in range(int(levels)):
                self.per_level.observe(device_s / levels)
            self.e2e.observe(e2e_s)
            self.completed += 1
            self.sources_served += int(n_sources)
            b = int(bucket)
            self.bucket_counts[b] = self.bucket_counts.get(b, 0) + 1
            # EWMA of end-to-end latency: the admission gate's
            # retry-after hint (alpha=0.3: reactive but not jittery)
            prev = self._ewma_e2e_s
            self._ewma_e2e_s = (e2e_s if prev is None
                                else 0.3 * e2e_s + 0.7 * prev)

    # -------------------------------------------------------------- queries
    def ewma_e2e_s(self, default: float = 0.1) -> float:
        with self._lock:
            return self._ewma_e2e_s if self._ewma_e2e_s is not None \
                else default

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "completed": self.completed,
                "failed": self.failed,
                "rejected": self.rejected,
                "rejected_invalid": self.rejected_invalid,
                "deadline_expired": self.deadline_expired,
                "breaker_rejected": self.breaker_rejected,
                "retries": self.retries,
                "degraded": dict(sorted(self.degraded.items())),
                "sources_served": self.sources_served,
                "buckets": {str(k): v for k, v
                            in sorted(self.bucket_counts.items())},
                "wire_bytes": {k: round(v, 1) for k, v
                               in sorted(self.wire_bytes.items())},
                "queue_wait": self.queue_wait.snapshot(),
                "device": self.device.snapshot(),
                "per_level_device": self.per_level.snapshot(),
                "e2e": self.e2e.snapshot(),
                "ewma_e2e_ms": round(self._ewma_e2e_s * 1e3, 3)
                                if self._ewma_e2e_s is not None else None,
            }


class FrontendMetrics:
    """The whole front-end's metrics tree (what ``/metrics`` serves)."""

    def __init__(self, lane_names):
        self.started = time.monotonic()
        self.lanes: Dict[str, LaneMetrics] = {
            name: LaneMetrics() for name in lane_names}

    def lane(self, name: str) -> LaneMetrics:
        return self.lanes[name]

    def snapshot(self, *, cache_stats: Optional[dict] = None,
                 gates: Optional[dict] = None,
                 draining: bool = False) -> dict:
        out = {
            "uptime_s": round(time.monotonic() - self.started, 3),
            "draining": draining,
            "lanes": {name: m.snapshot() for name, m in self.lanes.items()},
        }
        if gates is not None:
            for name, gate in gates.items():
                out["lanes"][name]["admission"] = gate.snapshot()
        if cache_stats is not None:
            out["engine_cache"] = dict(cache_stats)
        return out

    def stats_line(self, *, cache_stats: Optional[dict] = None) -> str:
        """One-line digest for the ``--stats-interval`` server log."""
        parts = []
        for name, m in self.lanes.items():
            snap = m.snapshot()
            p50 = snap["e2e"]["p50_ms"]
            wire = sum(snap["wire_bytes"].values())
            parts.append(
                f"{name}: ok={snap['completed']} 429={snap['rejected']} "
                f"400={snap['rejected_invalid']} "
                f"p50={p50 if p50 is not None else '-'}ms "
                f"wire={wire:.2e}B")
        if cache_stats:
            parts.append(f"cache: hit_rate={cache_stats['hit_rate']:.2f} "
                         f"evictions={cache_stats['evictions']}")
        return "stats: " + " | ".join(parts)
