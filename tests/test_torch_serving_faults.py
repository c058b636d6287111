"""The two serving faults found in the port against the reference, pinned.

1. The watchdog bounds only each engine run and its result read: a
   compile that outlasts it (``engine.compile`` stalled past the bound),
   a retry's backoff longer than it, and a degradation arm's slow compile
   all serve, as the JAX front end serves them.  The probe runs over HTTP
   against both packages: 200, the oracle's depths bitwise, no trip.
2. The parents' device edge list is keyed by graph and device, shown in
   ``/metrics`` as ``engine_cache.parents_device_bytes`` and freed when
   the front end drains, or shuts down after a drain that timed out.
3. ``server_close`` waits for the thread that ``POST /admin/shutdown``
   started, so a launcher that returns next never leaves that daemon
   thread dropping the front end's tensors while the interpreter
   finalizes (the process aborted).
"""

import importlib
import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph
from repro_torch.serve.bfs_service import BFSService
from repro_torch.serve.engine_cache import EngineCache
from repro_torch.serve.frontend import derive_parents
from repro_torch.serve.frontend.server import BFSFrontend
from repro_torch.serve.resilience import faults
from repro_torch.serve.resilience.faults import FaultPlan, FaultSpec
from repro_torch.serve.resilience.retry import RetryPolicy

torch.set_num_threads(1)

N = 100
WATCHDOG_S = 0.5


def _edges(n=N, seed=0):
    return generate("erdos_renyi", n, seed=seed, avg_degree=6)


def _port_service(g, ladder=(1, 4)):
    svc = BFSService(opts=BFSOptions(), batch_buckets=ladder,
                     cache=EngineCache(), device="cpu")
    svc.add_graph("er", g)
    return svc


def _serve_probe(pkg: str, src, dst, sources):
    """POST one traversal to ``pkg``'s front end (one erdos_renyi lane,
    0.5 s watchdog) while ``engine.compile`` stalls 1.0 s once."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    g = mod("graphs").shard_graph(src, dst, N, 1)
    kw = {"device": "cpu"} if pkg == "repro_torch" else {}
    svc = mod("serve.bfs_service").BFSService(
        opts=mod("core").BFSOptions(), batch_buckets=(1, 4),
        cache=mod("serve.engine_cache").EngineCache(), **kw)
    svc.add_graph("er", g)
    fl = mod("serve.resilience.faults")
    httpd, fe = mod("serve.frontend.server").serve_http(
        svc, "127.0.0.1", 0, log=lambda *a: None,
        watchdog_timeout_s=WATCHDOG_S)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/traverse"
    req = urllib.request.Request(
        url, data=json.dumps({"graph": "er", "sources": sources}).encode(),
        headers={"Content-Type": "application/json"})
    plan_ = fl.FaultPlan([fl.FaultSpec(site="engine.compile", kind="stall",
                                       delay_s=1.0, times=1)])
    try:
        with fl.active(plan_):
            with urllib.request.urlopen(req, timeout=60) as rsp:
                status, body = rsp.status, json.loads(rsp.read())
        return status, body, fe.watchdog.snapshot(), plan_.summary()
    finally:
        fe.shutdown(timeout_s=10)
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=10)


def test_a_compile_past_the_watchdog_serves_as_in_jax():
    """Queue C 1's probe: both packages answer 200 with the oracle's
    depths and no watchdog trip."""
    src, dst = _edges()
    sources = [3, 41, 77]
    want = bfs_reference(src, dst, N, sources)
    out = {pkg: _serve_probe(pkg, src, dst, sources)
           for pkg in ("repro", "repro_torch")}
    for pkg, (status, body, wd, fired) in out.items():
        assert status == 200, pkg
        np.testing.assert_array_equal(np.asarray(body["depths"]).T, want)
        assert fired["fired_total"] == 1, pkg
        assert (wd["trips"], wd["stuck"]) == (0, 0), pkg
    assert out["repro"][1]["bucket"] == out["repro_torch"][1]["bucket"] == 4


def test_a_retry_backoff_past_the_watchdog_serves():
    """A dispatch fails once (transient); the backoff before the retry
    sleeps past the bound, outside the guard."""
    src, dst = _edges()
    policy = RetryPolicy(max_attempts=2, base_s=0.7, max_s=0.7, jitter=0.0)
    assert policy.backoffs()[0] > WATCHDOG_S
    fe = BFSFrontend(_port_service(shard_graph(src, dst, N, 1)),
                     retry_policy=policy, watchdog_timeout_s=WATCHDOG_S,
                     log=lambda *a: None)
    try:
        with faults.active(FaultPlan([FaultSpec(site="engine.dispatch",
                                                times=1)])):
            out = fe.traverse("er", [5], timeout_s=30)
        np.testing.assert_array_equal(np.asarray(out["depths"]).T,
                                      bfs_reference(src, dst, N, [5]))
        assert fe.metrics.lane("er").snapshot()["retries"] == 1
        assert fe.watchdog.snapshot()["trips"] == 0
    finally:
        fe.shutdown(timeout_s=10)


def test_a_degradation_arm_compiles_outside_the_watchdog():
    """The S = 4 rung's compile fails; the split:1 arm's compile stalls
    past the bound and then serves three guarded runs bitwise."""
    src, dst = _edges()
    fe = BFSFrontend(_port_service(shard_graph(src, dst, N, 1)),
                     retry_policy=RetryPolicy(max_attempts=1),
                     watchdog_timeout_s=WATCHDOG_S, log=lambda *a: None)
    sources = [2, 9, 60]
    try:
        with faults.active(FaultPlan([
                FaultSpec(site="cache.compile", match="S=4 "),
                FaultSpec(site="engine.compile", match="S=1 ",
                          kind="stall", delay_s=1.0, times=1)])):
            out = fe.traverse("er", sources, timeout_s=30)
        np.testing.assert_array_equal(np.asarray(out["depths"]).T,
                                      bfs_reference(src, dst, N, sources))
        assert out["bucket"] == 1
        assert fe.metrics_payload()["lanes"]["er"]["degraded"] == {
            "split:1": 1}
        assert fe.watchdog.snapshot()["trips"] == 0
    finally:
        fe.shutdown(timeout_s=10)


def test_parents_edges_are_keyed_by_graph_and_device_and_freed_on_drain():
    """Two lanes of one graph share one device edge list keyed by (graph,
    device); ``/metrics`` shows its bytes; a drain frees it."""
    src, dst = _edges()
    g = shard_graph(src, dst, N, 1)
    svc = _port_service(g)
    svc.add_graph("alias", g)
    fe = BFSFrontend(svc, log=lambda *a: None)
    try:
        assert fe.metrics_payload()["engine_cache"][
            "parents_device_bytes"] == 0
        for lane in ("er", "alias"):
            out = fe.traverse(lane, [1, 8], include_parents=True,
                              timeout_s=30)
            want = bfs_reference(src, dst, N, [1, 8])
            np.testing.assert_array_equal(np.asarray(out["parents"]).T,
                                          derive_parents(src, dst, want))
        assert list(fe._edges) == [(id(g), "cpu")]
        assert fe._edges[(id(g), "cpu")][0] is g
        nbytes = 16 * g.edge_list()[0].size
        assert fe.parents_device_bytes() == nbytes
        assert fe.metrics_payload()["engine_cache"][
            "parents_device_bytes"] == nbytes
        assert fe.drain(timeout_s=10)
        assert not fe._edges and fe.parents_device_bytes() == 0
    finally:
        fe.shutdown(timeout_s=10)


def test_parents_edges_are_freed_by_a_shutdown_whose_drain_times_out():
    """A request admitted with no dispatcher keeps a gate busy, so the
    drain times out; shutdown frees the edge list all the same."""
    src, dst = _edges()
    g = shard_graph(src, dst, N, 1)
    fe = BFSFrontend(_port_service(g), log=lambda *a: None,
                     start_dispatcher=False)
    want = bfs_reference(src, dst, N, [1, 8])
    np.testing.assert_array_equal(fe._parents("er", want),
                                  derive_parents(src, dst, want))
    assert fe.parents_device_bytes() == 16 * g.edge_list()[0].size
    fe.submit("er", [3])
    assert not fe.shutdown(timeout_s=0.05)
    assert not fe._edges and fe.parents_device_bytes() == 0


def test_server_close_waits_for_the_admin_shutdown_thread():
    """The stopping thread lingers after it stops the accept loop;
    ``server_close`` returns only once it has ended."""
    from repro_torch.serve.frontend.server import serve_http

    src, dst = _edges()
    httpd, fe = serve_http(_port_service(shard_graph(src, dst, N, 1)),
                           "127.0.0.1", 0, log=lambda *a: None)
    stop = httpd.shutdown

    def slow_stop():
        stop()
        time.sleep(0.5)

    httpd.shutdown = slow_stop
    serving = threading.Thread(target=httpd.serve_forever, daemon=True)
    serving.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/admin/shutdown"
    req = urllib.request.Request(url, data=b"{}", headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as rsp:
        assert rsp.status == 200
    serving.join(timeout=30)
    assert not serving.is_alive()
    httpd.server_close()
    assert not any(t.name == "bfs-stop" and t.is_alive()
                   for t in threading.enumerate())
    assert not fe._edges


@pytest.mark.parametrize("ladder", [(1,), (2, 4)])
def test_the_frontend_guards_the_run_not_the_compile(ladder):
    """A stall in the ``service.dispatch`` seam (inside the guarded run)
    still trips the watchdog, on a lane whose engine was not compiled
    yet: the compile ran first, unguarded."""
    src, dst = _edges()
    svc = _port_service(shard_graph(src, dst, N, 1), ladder=ladder)
    fe = BFSFrontend(svc, watchdog_timeout_s=0.25, start_dispatcher=False,
                     log=lambda *a: None)
    with faults.active(FaultPlan([FaultSpec(site="service.dispatch",
                                            kind="stall", delay_s=1.0,
                                            times=1)])):
        p = fe.submit("er", [4])
        fe._dispatch_round()
        with pytest.raises(Exception) as ei:
            fe.wait(p, timeout_s=5.0)
    assert ei.value.status == 500
    assert svc.cache.stats()["misses"] == 1
    assert fe.watchdog.wait_idle(timeout_s=5.0)
    assert fe.watchdog.snapshot()["trips"] == 1
