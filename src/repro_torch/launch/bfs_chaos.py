"""Chaos soak: the serving stack under a randomized fault schedule — the
port of ``repro.launch.bfs_chaos``.

    PYTHONPATH=src python -m repro_torch.launch.bfs_chaos --seed 0 \
        --secs 30 --devices 4 --out BENCH_chaos.json
    PYTHONPATH=src python -m repro_torch.launch.bfs_chaos --device cpu \
        --devices 2 --secs 6 --n 300

Builds the full remote serving stack (multi-lane ``BFSService`` ->
``BFSFrontend`` -> HTTP) with every resilience feature armed — per-lane
circuit breakers, bounded retries, degradation arms, request deadlines,
the dispatcher watchdog — installs a seeded ``FaultPlan`` drawn from the
whole fault menu (compile failures, device-dispatch exceptions,
dispatcher stalls, slow collectives, cache-eviction storms, malformed
wire payloads), and hammers it with concurrent clients for ``--secs``.

The verdict (exit 0 iff all hold):

  * **typed outcomes** — every request resolves to a known status:
    200, 400/413 (the corrupt payloads we sent), 429 admission,
    503 breaker/draining, 504 deadline, 500 watchdog; anything else is
    a verdict failure.
  * **bitwise-correct survivors** — every 200's depth rows equal the
    numpy reference on the regenerated graph, bit for bit, no matter
    which bucket/split/wire degradation arm served it.
  * **no hung futures** — every client thread joins within its bound;
    the server drains clean.
  * **no leaks / no deadlock** — after the storm, admission gates are
    idle, no watchdog-abandoned round is still stuck, and ``/readyz``
    recovers to 200 once the schedule stops firing.

``--out`` writes the machine-readable ledger (``BENCH_chaos.json`` in
CI): the fault plan's firing counts next to the outcome histogram,
breaker trajectories and recovery latencies, and the watchdog snapshot —
the JAX soak's keys.  Both lanes' ``--devices N`` shards live on the one
device of ``--device`` (default ``cuda``).  The watchdog bounds each
engine run and result read, not the compiles: an eviction storm's
recompiles serve under it, and the soak prints how many 200s were
requested after the first storm.
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

import numpy as np

from repro_torch.core import BFSOptions, LocalMesh
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph
from repro_torch.launch import resolve_cli_device
from repro_torch.launch.bfs_client import BFSClient, HTTPStatusError
from repro_torch.serve.bfs_service import BFSService
from repro_torch.serve.engine_cache import EngineCache
from repro_torch.serve.frontend.server import serve_http
from repro_torch.serve.resilience import faults
from repro_torch.serve.resilience.faults import (FaultPlan, FaultSpec,
                                                 corrupt_bytes)
from repro_torch.serve.resilience.retry import RetryPolicy

#: statuses the stack is *allowed* to answer under chaos; anything else
#: (or a transport-level hang) fails the soak
EXPECTED_STATUSES = {200, 400, 404, 413, 429, 500, 503, 504}

WATCHDOG_S = 1.0
BREAKER_RESET_S = 1.0


def build_fault_plan(seed: int, secs: float) -> FaultPlan:
    """A randomized (but seeded) schedule across the whole fault menu.

    Spec counts scale with the soak length so a 30s CI run sees every
    kind fire repeatedly; ``after``/``times`` windows are drawn so
    faults start, burn out, and let the breakers recover in between.
    """
    rng = random.Random(seed)
    rounds = max(2, int(secs / 5))
    specs = []
    for _ in range(rounds):
        # compile failures: enough consecutive hits to open a breaker,
        # bounded so half-open probes eventually close it again
        specs.append(FaultSpec(site="cache.compile", kind="fail",
                               after=rng.randrange(0, 20),
                               times=rng.randrange(3, 9)))
        # device-dispatch exceptions (transient: retry fodder)
        specs.append(FaultSpec(site="engine.dispatch", kind="fail",
                               after=rng.randrange(0, 30),
                               times=rng.randrange(1, 4)))
        # dispatcher stalls + slow collectives; some block-stalls exceed
        # the watchdog bound (typed 500 + tracked abandoned round)
        specs.append(FaultSpec(site="frontend.loop", kind="stall",
                               delay_s=0.05 + 0.1 * rng.random(),
                               after=rng.randrange(0, 40),
                               times=rng.randrange(1, 4)))
        specs.append(FaultSpec(site="frontend.block", kind="stall",
                               delay_s=(WATCHDOG_S * 1.5 if rng.random()
                                        < 0.3 else 0.1),
                               after=rng.randrange(0, 40),
                               times=rng.randrange(1, 3)))
        # eviction storms: the cache drops everything unpinned
        specs.append(FaultSpec(site="cache.get", kind="storm",
                               after=rng.randrange(0, 50),
                               times=rng.randrange(1, 3)))
        # malformed wire payloads (applied by the sending client)
        specs.append(FaultSpec(site="client.payload", kind="corrupt",
                               after=rng.randrange(0, 30),
                               times=rng.randrange(1, 4)))
    return FaultPlan(specs, seed=seed)


def _post_corrupt(base_url: str, body: dict, spec, seed: int) -> int:
    """Send a deliberately mangled body; returns the HTTP status (must
    land in the 400 family — the server's door, not its dispatcher,
    absorbs malformed wire input)."""
    raw = corrupt_bytes(json.dumps(body).encode(), spec, seed=seed)
    req = urllib.request.Request(
        base_url + "/v1/traverse", data=raw, method="POST",
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30.0) as rsp:
            return rsp.status
    except urllib.error.HTTPError as exc:
        return exc.code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="randomized-fault soak of the resilient serving "
                    "stack; exits 0 iff the verdict holds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--secs", type=float, default=10.0,
                    help="fault-storm duration (recovery checks run "
                         "after)")
    ap.add_argument("--n", type=int, default=1200,
                    help="vertices per lane graph")
    ap.add_argument("--clients", type=int, default=4,
                    help="concurrent client threads")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the chaos ledger json (BENCH_chaos)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device both lanes live on (default cuda)")
    ap.add_argument("--devices", type=int, default=0,
                    help="shards of each lane's LocalMesh (default 1)")
    args = ap.parse_args(argv)

    dev = resolve_cli_device(args.device)
    p = max(1, args.devices)
    mesh = LocalMesh.flat(p, dev)
    print(f"chaos: seed={args.seed} secs={args.secs:g} p={p} "
          f"clients={args.clients} n={args.n}")

    # two lanes so breaker/degradation failures on one are observably
    # isolated from the other; small bucket ladder so the split arm and
    # bucket arm both exist
    lanes = {}
    svc = BFSService(opts=BFSOptions(mode="dense", queue_cap=1 << 14),
                     mesh=mesh, batch_buckets=(1, 4),
                     cache=EngineCache(max_entries=32))
    for name, kind in (("er", "erdos_renyi"), ("ring", "small_world")):
        src, dst = generate(kind, args.n, seed=args.seed)
        lanes[name] = (src, dst)
        svc.add_graph(name, shard_graph(src, dst, args.n, p))

    httpd, frontend = serve_http(
        svc, "127.0.0.1", 0, max_queue_depth=16,
        breaker_threshold=3, breaker_reset_s=BREAKER_RESET_S,
        retry_policy=RetryPolicy(max_attempts=3, base_s=0.02, max_s=0.2,
                                 seed=args.seed),
        watchdog_timeout_s=WATCHDOG_S, degrade=True)
    base_url = f"http://127.0.0.1:{httpd.server_address[1]}"
    accept = threading.Thread(target=httpd.serve_forever, daemon=True)
    accept.start()

    # warm both lanes' preferred rungs before the storm so the soak
    # exercises serving-time faults, not just first-compile latency
    for name in lanes:
        BFSClient(base_url).traverse(name, [0])

    plan = build_fault_plan(args.seed, args.secs)
    outcomes = {}                     # status -> count
    lock = threading.Lock()
    failures = []                     # verdict-breaking observations
    deadline = time.monotonic() + args.secs
    after_storm = [0]                 # 200s requested after a storm

    def storms() -> int:
        return plan.summary()["by_kind"].get("storm", 0)

    def record(status: int) -> None:
        with lock:
            outcomes[status] = outcomes.get(status, 0) + 1

    def worker(wid: int) -> None:
        rng = random.Random((args.seed << 8) ^ wid)
        client = BFSClient(base_url, timeout_s=60.0,
                           max_retries=rng.randrange(0, 3), seed=wid)
        while time.monotonic() < deadline:
            name = rng.choice(sorted(lanes))
            k = rng.choice((1, 2, 4))
            sources = rng.sample(range(args.n), k)
            body = {"graph": name, "sources": sources}
            spec = faults.fire("client.payload", name)
            if spec is not None and spec.kind == "corrupt":
                status = _post_corrupt(base_url, body, spec,
                                       seed=rng.randrange(1 << 30))
                record(status)
                if status not in (400, 413):
                    with lock:
                        failures.append(
                            f"corrupt payload answered {status}, "
                            "expected 400/413")
                continue
            dl_ms = (rng.choice((25, 100, 400))
                     if rng.random() < 0.25 else None)
            stormed = storms() > 0
            try:
                out = client.traverse(name, sources, deadline_ms=dl_ms)
            except HTTPStatusError as exc:
                record(exc.status)
                if exc.status not in EXPECTED_STATUSES:
                    with lock:
                        failures.append(f"unexpected status {exc.status}: "
                                        f"{exc}")
                continue
            except Exception as exc:   # transport hang/crash = verdict
                with lock:
                    failures.append(f"transport failure: {exc!r}")
                continue
            record(200)
            if stormed:
                with lock:
                    after_storm[0] += 1
            src, dst = lanes[name]
            want = bfs_reference(src, dst, args.n, sources)
            got = np.asarray(out["depths"], dtype=np.int64).T
            if not np.array_equal(got, want):
                with lock:
                    failures.append(f"BITWISE MISMATCH lane={name} "
                                    f"sources={sources}")

    with faults.active(plan):
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(args.clients)]
        for t in threads:
            t.start()
        for t in threads:
            # generous join bound: a thread that outlives it is a hung
            # future, which is exactly what the verdict must catch
            t.join(timeout=args.secs + 120.0)
        hung = [t for t in threads if t.is_alive()]
        if hung:
            failures.append(f"{len(hung)} client thread(s) hung")

    # ----------------------------------------------------- recovery phase
    # schedule uninstalled; the stack must return to fully healthy
    recovered = False
    t0 = time.monotonic()
    while time.monotonic() - t0 < 3 * BREAKER_RESET_S + 10.0:
        try:
            BFSClient(base_url).traverse("er", [1])
            if BFSClient(base_url).ready().get("ready"):
                recovered = True
                break
        except (HTTPStatusError, OSError):
            pass
        time.sleep(0.2)
    if not recovered:
        failures.append("stack did not recover to ready after the storm")
    wd = frontend.watchdog
    if wd is not None and not wd.wait_idle(timeout_s=30.0):
        failures.append(f"{wd.stuck()} watchdog round(s) still stuck "
                        "(leaked device work)")
    drained = frontend.drain(timeout_s=30.0)
    if not drained:
        failures.append("gates not idle after drain (leaked admissions)")
    httpd.shutdown()
    httpd.server_close()

    ledger = {
        "config": {"seed": args.seed, "secs": args.secs, "p": p,
                   "n": args.n, "clients": args.clients,
                   "watchdog_s": WATCHDOG_S,
                   "breaker_reset_s": BREAKER_RESET_S},
        "faults": plan.summary(),
        "outcomes": {str(k): v for k, v in sorted(outcomes.items())},
        "breakers": {name: {
            "snapshot": b.snapshot(),
            "recovery_latencies_s": [round(x, 3)
                                     for x in b.recovery_latencies_s()],
        } for name, b in frontend.breakers.items()},
        "watchdog": wd.snapshot() if wd is not None else None,
        "metrics": frontend.metrics_payload(),
        "failures": failures,
        "ok": not failures,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(ledger, f, indent=2, sort_keys=True)
        print(f"ledger -> {args.out}")

    fired = plan.summary()
    print(f"faults fired: {fired['fired_total']} {fired['by_kind']}")
    print(f"outcomes: { {k: v for k, v in sorted(outcomes.items())} }")
    st = svc.cache_stats()
    print(f"storms: {fired['by_kind'].get('storm', 0)} cache.get storm(s) "
          f"fired; {after_storm[0]} bitwise 200(s) requested after the "
          f"first; cache misses={st['misses']} evictions={st['evictions']}")
    for name, b in frontend.breakers.items():
        snap = b.snapshot()
        print(f"breaker[{name}]: state={snap['state']} "
              f"opened={snap['opened']} shed={snap['rejected_fast']}")
    if wd is not None:
        print(f"watchdog: trips={wd.snapshot()['trips']} "
              f"stuck={wd.stuck()}")
    if failures:
        for f_ in failures[:10]:
            print(f"CHAOS FAILURE: {f_}", file=sys.stderr)
        print(f"verdict: FAIL ({len(failures)} failure(s))",
              file=sys.stderr)
        return 1
    ok = outcomes.get(200, 0)
    print(f"verdict: OK — {ok} bitwise-correct responses, every fault "
          "retried/degraded/rejected with a typed status, no hung "
          "futures, no leaks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
