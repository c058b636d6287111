"""Stdlib HTTP client for the BFS serving front-end (+ CI smoke driver) —
a copy of ``repro.launch.bfs_client`` whose ``--verify`` regenerates the
graph and runs the oracle from the port (``repro_torch.graphs``,
``repro_torch.core.ref``).  It speaks to either package's server.

    PYTHONPATH=src python -m repro_torch.launch.bfs_client \
        --url http://127.0.0.1:8642 --graph er --requests 8 --batch 4 \
        --concurrency 2 --verify

Library use::

    from repro_torch.launch.bfs_client import BFSClient
    c = BFSClient("http://127.0.0.1:8642")
    out = c.traverse("er", [0, 17, 99])      # dict: depths/bucket/stats
    c.graphs(); c.metrics(); c.health()

The CLI fires ``--requests`` traversals of ``--batch`` random distinct
sources each, spread over ``--concurrency`` threads released together
(a synchronized burst — what the admission-control smoke needs), then
prints a latency summary and the server's cache hit rate.  ``--verify``
regenerates each lane's graph from the ``spec`` the server advertises in
``/v1/graphs`` and checks every depth row bitwise against the numpy
reference (and parent rows for validity when ``--include-parents``).
``--expect-429`` flips the contract: the run fails unless at least one
request was rejected with 429 (and 429s stop counting as errors).
``--max-retries N`` makes the client honor the server's ``Retry-After``
hint on 429/503 (capped, jittered backoff); the default 0 fails fast.

Import-light on purpose: urllib only, numpy and the port imported lazily
inside ``--verify`` so a plain round-trip works without torch.
"""

from __future__ import annotations

import argparse
import json
import random
import sys
import threading
import time
import urllib.error
import urllib.request

#: ceiling on one Retry-After-driven backoff sleep (a misbehaving or
#: draining server must not park a client thread for minutes)
MAX_BACKOFF_S = 10.0

#: statuses worth retrying when the caller opts in: admission shed (429)
#: and not-ready/breaker-open/draining (503) — both explicitly
#: retry-later states the server stamps a Retry-After on
RETRYABLE_STATUSES = (429, 503)


class HTTPStatusError(RuntimeError):
    """Non-2xx response; carries the status and decoded error payload.

    ``retry_after_s`` is the server's ``Retry-After`` header in seconds
    (None when absent) — what ``max_retries > 0`` clients sleep on.
    """

    def __init__(self, status: int, payload: dict, url: str,
                 retry_after_s=None):
        super().__init__(f"HTTP {status} from {url}: "
                         f"{payload.get('error', payload)}")
        self.status = status
        self.payload = payload
        self.retry_after_s = retry_after_s


class BFSClient:
    """Stdlib client; ``max_retries > 0`` honors ``Retry-After`` on
    429/503 with capped jittered sleeps (default 0 = fail fast, the
    pre-retry behavior exactly)."""

    def __init__(self, base_url: str, timeout_s: float = 120.0, *,
                 max_retries: int = 0, seed: int = 0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self.max_retries = int(max_retries)
        self.retries_used = 0            # cumulative, for smoke summaries
        self._rng = random.Random(seed)

    def _request_once(self, path: str, body: dict = None) -> dict:
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method="POST" if body is not None else "GET",
            headers={"Content-Type": "application/json"} if body else {})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as rsp:
                return json.loads(rsp.read().decode())
        except urllib.error.HTTPError as exc:
            try:
                payload = json.loads(exc.read().decode())
            except Exception:
                payload = {"error": str(exc)}
            retry_after = exc.headers.get("Retry-After")
            try:
                retry_after = (float(retry_after)
                               if retry_after is not None else None)
            except ValueError:
                retry_after = None
            raise HTTPStatusError(exc.code, payload, url,
                                  retry_after_s=retry_after) from None

    def _request(self, path: str, body: dict = None) -> dict:
        """One request, retried up to ``max_retries`` times on 429/503.

        Sleeps the server's Retry-After hint (default 1s when absent),
        capped at ``MAX_BACKOFF_S`` and jittered +-25% so synchronized
        clients don't re-burst on the same tick."""
        attempt = 0
        while True:
            try:
                return self._request_once(path, body)
            except HTTPStatusError as exc:
                if (exc.status not in RETRYABLE_STATUSES
                        or attempt >= self.max_retries):
                    raise
                attempt += 1
                self.retries_used += 1
                hint = exc.retry_after_s if exc.retry_after_s else 1.0
                delay = min(MAX_BACKOFF_S, hint)
                time.sleep(delay * (1.0 + 0.25 * (2 * self._rng.random()
                                                  - 1)))

    # ------------------------------------------------------------ endpoints
    def traverse(self, graph, sources, include_parents: bool = False,
                 deadline_ms=None) -> dict:
        body = {"sources": list(sources), "include_parents": include_parents}
        if graph is not None:
            body["graph"] = graph
        if deadline_ms is not None:
            body["deadline_ms"] = deadline_ms
        return self._request("/v1/traverse", body)

    def graphs(self) -> dict:
        return self._request("/v1/graphs")

    def metrics(self) -> dict:
        return self._request("/metrics")

    def health(self) -> dict:
        return self._request("/healthz")

    def ready(self) -> dict:
        return self._request("/readyz")

    def shutdown(self) -> dict:
        return self._request("/admin/shutdown", body={})


# ---------------------------------------------------------------------------
# CLI smoke driver
# ---------------------------------------------------------------------------

def _verify_depths(lane_info: dict, results: list,
                   check_parents: bool) -> int:
    """Bitwise check of every depth row against the numpy reference on a
    regenerated copy of the server's graph; returns the failure count."""
    import numpy as np

    from repro_torch.core.ref import bfs_reference
    from repro_torch.graphs import generate

    spec = lane_info.get("spec")
    if not spec:
        print(f"verify: lane {lane_info['name']!r} advertises no spec; "
              "cannot regenerate the graph client-side", file=sys.stderr)
        return 1
    src, dst = generate(spec["kind"], spec["n"], seed=spec.get("seed", 0),
                        **spec.get("gen_kwargs", {}))
    failures = 0
    for out in results:
        want = bfs_reference(src, dst, spec["n"], out["sources"])
        got = np.asarray(out["depths"], dtype=np.int64).T   # (n, S)
        if not np.array_equal(got, want):
            print(f"VERIFY FAILED: graph={out['graph']} "
                  f"sources={out['sources']}", file=sys.stderr)
            failures += 1
            continue
        if check_parents:
            parents = np.asarray(out["parents"], dtype=np.int64).T
            for j, s in enumerate(out["sources"]):
                d, par = want[:, j], parents[:, j]
                reached = d < out["unreached"]
                ok = (par[s] == s
                      and np.all(par[reached] >= 0)
                      and np.all(par[~reached] == -1)
                      and np.all(d[par[reached & (d > 0)]]
                                 == d[reached & (d > 0)] - 1))
                if not ok:
                    print(f"VERIFY FAILED (parents): graph={out['graph']} "
                          f"source={s}", file=sys.stderr)
                    failures += 1
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True,
                    help="server base url, e.g. http://127.0.0.1:8642")
    ap.add_argument("--graph", default=None,
                    help="lane name (optional on single-lane servers)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1,
                    help="distinct random sources per request")
    ap.add_argument("--concurrency", type=int, default=1,
                    help="worker threads, released simultaneously")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--include-parents", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="bitwise depth check vs the numpy reference on "
                         "the regenerated graph (needs the server spec)")
    ap.add_argument("--expect-429", action="store_true",
                    help="fail unless >= 1 request was rejected with 429")
    ap.add_argument("--max-retries", type=int, default=0,
                    help="retry 429/503 responses up to N times, sleeping "
                         "the server's Retry-After hint (capped, jittered); "
                         "0 = fail fast (default)")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--shutdown", action="store_true",
                    help="POST /admin/shutdown after the run")
    args = ap.parse_args(argv)

    client = BFSClient(args.url, timeout_s=args.timeout,
                       max_retries=args.max_retries, seed=args.seed)
    catalog = client.graphs()["graphs"]
    lanes = {g["name"]: g for g in catalog}
    if args.graph is None and len(lanes) == 1:
        args.graph = next(iter(lanes))
    if args.graph not in lanes:
        print(f"no lane {args.graph!r} on {args.url}; lanes: "
              f"{sorted(lanes)}", file=sys.stderr)
        return 2
    lane = lanes[args.graph]
    n = lane["n"]
    if args.batch > max(lane["buckets"]):
        print(f"--batch {args.batch} exceeds the lane's largest bucket "
              f"{max(lane['buckets'])}", file=sys.stderr)
        return 2

    rng = random.Random(args.seed)
    source_sets = [rng.sample(range(n), args.batch)
                   for _ in range(args.requests)]

    results, rejected, errors, latencies = [], [], [], []
    lock = threading.Lock()
    barrier = threading.Barrier(args.concurrency)

    def worker(worker_id: int):
        barrier.wait()                 # synchronized burst
        for i in range(worker_id, args.requests, args.concurrency):
            t0 = time.monotonic()
            try:
                out = client.traverse(args.graph, source_sets[i],
                                      include_parents=args.include_parents)
                with lock:
                    results.append(out)
                    latencies.append(time.monotonic() - t0)
            except HTTPStatusError as exc:
                with lock:
                    (rejected if exc.status == 429 else errors).append(exc)

    threads = [threading.Thread(target=worker, args=(w,))
               for w in range(args.concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    lat_ms = sorted(x * 1e3 for x in latencies)
    p = (lambda q: lat_ms[min(len(lat_ms) - 1,
                              int(q * len(lat_ms)))] if lat_ms else 0.0)
    print(f"{len(results)}/{args.requests} ok on lane {args.graph!r} "
          f"(batch={args.batch}, served buckets="
          f"{sorted({r['bucket'] for r in results})}), "
          f"{len(rejected)} x 429, {len(errors)} errors, "
          f"{client.retries_used} retries; "
          f"p50={p(0.5):.1f}ms p95={p(0.95):.1f}ms")
    try:
        cache = client.metrics().get("engine_cache", {})
        print(f"server cache: hit_rate={cache.get('hit_rate', 0):.2f} "
              f"evictions={cache.get('evictions', 0)} "
              f"entries={cache.get('entries', 0)}")
    except (HTTPStatusError, OSError):
        pass                           # metrics are best-effort here

    rc = 0
    for exc in errors[:3]:
        print(f"error: {exc}", file=sys.stderr)
    if errors:
        rc = 1
    if args.expect_429 and not rejected:
        print("EXPECTED at least one 429 rejection; none happened",
              file=sys.stderr)
        rc = 1
    if not args.expect_429 and rejected:
        print(f"unexpected 429s: {rejected[0]}", file=sys.stderr)
        rc = 1
    if args.verify and results:
        # what the server lane actually resolved on the wire — so a CI
        # log shows which formats the bitwise check just covered
        wires = lane.get("wire_formats")
        if wires is not None:
            fmt = " ".join(f"{k}={v}" for k, v in sorted(wires.items()))
            print(f"verify: lane {args.graph!r} wire formats: {fmt} "
                  f"sieve={lane.get('sieve')}")
        try:
            # per-level device step-time percentiles the server measured
            # for the runs just verified (the distribution the fused
            # fold/owner-update tail shortens)
            lane_m = client.metrics()["lanes"].get(args.graph, {})
            pl = lane_m.get("per_level_device") or {}
            if pl.get("count"):
                print(f"verify: lane {args.graph!r} per-level device time: "
                      f"p50={pl['p50_ms']}ms p95={pl['p95_ms']}ms "
                      f"p99={pl['p99_ms']}ms over {pl['count']} levels")
        except (HTTPStatusError, OSError):
            pass                       # metrics are best-effort here
        if _verify_depths(lane, results, args.include_parents):
            rc = 1
        else:
            print(f"verify: {len(results)} traversals match the numpy "
                  "reference bitwise")
    if args.shutdown:
        try:
            client.shutdown()
        except (HTTPStatusError, OSError):
            pass                       # server may exit before replying
    return rc


if __name__ == "__main__":
    sys.exit(main())
