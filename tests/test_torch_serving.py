"""The port's traversal service and HTTP front end against the JAX
package's: the bucket helpers, ``BFSService.step()`` / ``traverse()`` on
mixed 1-D and 2-D lanes (p = 1 and 1 x 1 in this process; p = 2 and
2 x 2 in one subprocess that forces four JAX host devices), lanes that
share one engine within a round, and ``serve_http``: the same request
bodies get the same JSON from both servers (timing fields aside), the
same error statuses and ``Retry-After`` headers, and the JAX package's
own client verifies the port's server.

Every HTTP call here has a timeout of at most 30 s, and every server is
shut down in a ``finally``.
"""

import json
import os
import subprocess
import sys
import threading
import time
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions, LocalMesh
from repro_torch.core.engine import normalize_ladder, pick_bucket, plan_ladder
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph
from repro_torch.serve.bfs_service import BFSService, TraversalRequest
from repro_torch.serve.engine_cache import EngineCache
from repro_torch.serve.frontend import (AdmissionError, BFSFrontend,
                                        DrainingError, derive_parents,
                                        serve_http)
from repro_torch.serve.frontend import schema
from repro_torch.serve.resilience.errors import StrandedRequestError

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
HTTP_TIMEOUT_S = 30.0

# the lanes of the parity scenario: name -> (generator, n, kwargs, 2-D?)
LANES = {"er": ("erdos_renyi", 150, {"avg_degree": 5.0}, False),
         "rmat": ("rmat", 200, {"edge_factor": 8}, True),
         "chain": ("chain", 60, {}, False)}
STEP_REQUESTS = [("er", 3), ("rmat", 0), ("chain", 5), ("er", 3),
                 ("er", 77), ("rmat", 150), ("chain", 0), ("rmat", 7),
                 ("er", 149), ("er", 12), ("er", 40)]
TRAVERSALS = [("er", [0, 9, 77]), ("rmat", [5]), ("chain", [1, 2, 3, 4]),
              ("rmat", [199, 0]), ("er", [33])]


def _jax_ns():
    from repro.core import BFSOptions as JOptions
    from repro.graphs import generate as jgen, shard_graph as jshard
    from repro.serve.bfs_service import BFSService as JService
    from repro.serve.bfs_service import TraversalRequest as JRequest
    from repro.serve.engine_cache import EngineCache as JCache

    return types.SimpleNamespace(BFSOptions=JOptions, generate=jgen,
                                 shard_graph=jshard, BFSService=JService,
                                 TraversalRequest=JRequest,
                                 EngineCache=JCache)


def _port_ns():
    return types.SimpleNamespace(BFSOptions=BFSOptions, generate=generate,
                                 shard_graph=shard_graph,
                                 BFSService=BFSService,
                                 TraversalRequest=TraversalRequest,
                                 EngineCache=EngineCache)


def _drive(ns, p: int, lane_kw) -> dict:
    """The parity scenario on one package: a service of the three lanes
    (ladder (1, 4)), queued single-source requests drained by ``step()``,
    then ``traverse()`` calls; returns every result as lists."""
    svc = ns.BFSService(opts=ns.BFSOptions(), batch_buckets=(1, 4),
                        cache=ns.EngineCache())
    for name, (kind, n, kw, two_d) in LANES.items():
        src, dst = ns.generate(kind, n, seed=2, **kw)
        svc.add_graph(name, ns.shard_graph(src, dst, n, p),
                      **lane_kw(two_d))
    reqs = [ns.TraversalRequest(rid=i, source=s, graph=g)
            for i, (g, s) in enumerate(STEP_REQUESTS)]
    for r in reqs:
        svc.submit(r)
    steps = 0
    while not svc.drained():
        svc.step()
        steps += 1
    out = {"steps": steps,
           "step": [[r.rid, r.graph, r.source, r.dist.tolist(), r.levels,
                     r.visited] for r in reqs],
           "traverse": []}
    for name, sources in TRAVERSALS:
        res, bucket = svc.traverse(name, sources)
        out["traverse"].append([name, bucket, res.dist_host.tolist(),
                                res.run_stats.to_host()])
    out["cache"] = {k: svc.cache_stats()[k]
                    for k in ("hits", "misses", "entries", "evictions")}
    return out


def _multi_kw(p: int, flat, grid):
    """Lane keywords at p = 2 (2-D on a 1 x 2 grid) or p = 4 (2 x 2)."""
    r, c = (1, 2) if p == 2 else (2, 2)

    def kw(two_d):
        return (dict(partition="2d", mesh=grid(r, c)) if two_d
                else dict(mesh=flat(p)))
    return kw


def _jax_worker(path: str) -> None:
    """Subprocess body: the scenario on the JAX package at p = 2 and 4."""
    import jax
    from jax.sharding import Mesh

    from repro.launch.mesh import make_grid_mesh

    def flat(p):
        return Mesh(np.asarray(jax.devices()[:p]).reshape(p), ("bfs_p",))

    Path(path).write_text(json.dumps(
        {str(p): _drive(_jax_ns(), p, _multi_kw(p, flat, make_grid_mesh))
         for p in (2, 4)}))


@pytest.fixture(scope="module")
def jax_multi(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve") / "runs.json"
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from repro.launch import host_devices; host_devices(4); "
            "import test_torch_serving as t; t._jax_worker(sys.argv[3])")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT / "src"), str(ROOT / "tests"),
         str(out)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


def _assert_same_runs(got: dict, want: dict):
    assert got["steps"] == want["steps"]
    assert got["step"] == want["step"]
    assert got["traverse"] == want["traverse"]
    assert got["cache"] == want["cache"]
    # and against the oracle
    for rid, name, source, dist, levels, visited in got["step"]:
        kind, n, kw, _ = LANES[name]
        src, dst = generate(kind, n, seed=2, **kw)
        np.testing.assert_array_equal(
            dist, bfs_reference(src, dst, n, [source])[:, 0])


# ---------------------------------------------------------------------------
# the bucket helpers
# ---------------------------------------------------------------------------

LADDERS = [(8, 1, 8, 64), [4], (3, 2, 1), range(1, 5), (0, 4), (), (-1, 2),
           ("2", 1)]
PICKS = [(1, (1, 8, 64)), (2, (1, 8, 64)), (8, (1, 8, 64)), (9, (1, 8, 64)),
         (64, (64, 1)), (65, (1, 8, 64)), (0, (1, 4)), (-3, (1,)),
         (5, (5,)), (3, ())]


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:
        return (type(exc).__name__,)


@pytest.mark.parametrize("ladder", LADDERS, ids=str)
def test_normalize_ladder_equals_jax(ladder):
    from repro.core.engine import normalize_ladder as jnorm

    assert _outcome(normalize_ladder, ladder) == _outcome(jnorm, ladder)


@pytest.mark.parametrize("n,ladder", PICKS, ids=str)
def test_pick_bucket_equals_jax(n, ladder):
    from repro.core.engine import pick_bucket as jpick

    assert _outcome(pick_bucket, n, ladder) == _outcome(jpick, n, ladder)


@pytest.mark.parametrize("ladder", [(1, 8, 64), (4, 2, 4), ()], ids=str)
def test_plan_ladder_equals_jax(ladder):
    from repro.core import BFSOptions as JOptions
    from repro.core.engine import plan_ladder as jladder
    from repro.graphs import shard_graph as jshard

    src, dst = generate("erdos_renyi", 120, seed=1)
    got = _outcome(lambda: plan_ladder(shard_graph(src, dst, 120, 1),
                                       BFSOptions(), ladder=ladder,
                                       device="cpu"))
    want = _outcome(lambda: jladder(jshard(src, dst, 120, 1), JOptions(),
                                    ladder=ladder))
    assert got[0] == want[0]
    if got[0] == "ok":
        assert list(got[1]) == list(want[1])
        for s in got[1]:
            assert got[1][s].num_sources == want[1][s].num_sources == s
            assert got[1][s].describe()["dense_exchange"] == \
                want[1][s].describe()["dense_exchange"]


def test_plan_ladder_takes_the_device():
    src, dst = generate("erdos_renyi", 120, seed=1)
    g = shard_graph(src, dst, 120, 1)
    rungs = plan_ladder(g, BFSOptions(), ladder=(1, 4), device="meta")
    assert all(p.device == torch.device("meta") for p in rungs.values())
    assert rungs[1].plan_key() != plan_ladder(
        g, BFSOptions(), ladder=(1,), device="cpu")[1].plan_key()


# ---------------------------------------------------------------------------
# BFSService against the JAX service
# ---------------------------------------------------------------------------

def test_service_matches_jax_on_one_shard():
    def jax_kw(two_d):
        return dict(partition="2d", mesh=None) if two_d else dict(mesh=None)

    want = _drive(_jax_ns(), 1, jax_kw)
    got = _drive(_port_ns(), 1, lambda two_d: dict(
        partition="2d" if two_d else None, device="cpu"))
    _assert_same_runs(got, want)


@pytest.mark.parametrize("p", [2, 4])
def test_service_matches_jax_on_several_shards(jax_multi, p):
    kw = _multi_kw(p, lambda p: LocalMesh.flat(p, "cpu"),
                   lambda r, c: LocalMesh.grid(r, c, "cpu"))
    _assert_same_runs(_drive(_port_ns(), p, kw), jax_multi[str(p)])


def test_service_default_device_is_plans():
    """Without a mesh or a device a lane plans on ``plan()``'s default:
    CUDA, or a raise on a machine without it."""
    src, dst = generate("chain", 40, seed=0)
    g = shard_graph(src, dst, 40, 1)
    svc = BFSService(opts=BFSOptions(), cache=EngineCache())
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default lane plans on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        svc.add_graph("c", g)
    svc.add_graph("c", g, device="cpu")
    assert svc.lane("c").plan.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# lanes that share one engine
# ---------------------------------------------------------------------------

def _two_lane_service(ladder=(1, 4)):
    src, dst = generate("rmat", 200, seed=4, edge_factor=8)
    g = shard_graph(src, dst, 200, 2)
    twin = shard_graph(src, dst, 200, 2)       # block-identical
    svc = BFSService(opts=BFSOptions(), batch_buckets=ladder,
                     cache=EngineCache(), mesh=LocalMesh.flat(2, "cpu"))
    svc.add_graph("a", g)
    svc.add_graph("b", twin)
    return src, dst, svc


def test_two_lanes_on_one_engine_in_one_step():
    src, dst, svc = _two_lane_service()
    assert svc.lane("a").plans[1].plan_key() == \
        svc.lane("b").plans[1].plan_key()
    reqs = [TraversalRequest(rid=0, source=3, graph="a"),
            TraversalRequest(rid=1, source=150, graph="b")]
    for r in reqs:
        svc.submit(r)
    done = svc.step()
    assert len(done) == 2 and svc.cache_stats()["misses"] == 1
    for r in reqs:
        np.testing.assert_array_equal(
            r.dist, bfs_reference(src, dst, 200, [r.source])[:, 0])
    # lanes of four sources each on the S = 4 rung, one engine
    reqs = [TraversalRequest(rid=10 + i, source=s, graph=g)
            for i, (g, s) in enumerate([("a", 0), ("b", 9), ("a", 11),
                                        ("b", 0), ("a", 199)])]
    for r in reqs:
        svc.submit(r)
    done = svc.step()
    assert len(done) == 5 and svc.cache_stats()["misses"] == 2
    for r in reqs:
        np.testing.assert_array_equal(
            r.dist, bfs_reference(src, dst, 200, [r.source])[:, 0])


def test_two_lanes_on_one_engine_in_one_frontend_round():
    src, dst, svc = _two_lane_service()
    fe = BFSFrontend(svc, start_dispatcher=False, log=lambda *a: None)
    try:
        pa = fe.submit("a", [5, 17], include_parents=True)
        pb = fe.submit("b", [0, 1, 2])
        assert fe._dispatch_round() == 2
        for pend, srcs in ((pa, [5, 17]), (pb, [0, 1, 2])):
            res = fe.wait(pend, timeout_s=HTTP_TIMEOUT_S)
            want = bfs_reference(src, dst, 200, srcs)
            np.testing.assert_array_equal(res.dist_host, want)
        np.testing.assert_array_equal(
            pa.parents, derive_parents(src, dst,
                                       bfs_reference(src, dst, 200,
                                                     [5, 17])))
        assert svc.cache_stats()["misses"] == 1     # both on S = 4
        # the handler thread reads the payload after later rounds ran
        pc = fe.submit("a", [8])
        pd = fe.submit("b", [9])
        fe._dispatch_round()
        body = fe._payload(pa, fe.wait(pa, timeout_s=HTTP_TIMEOUT_S))
        np.testing.assert_array_equal(np.asarray(body["depths"]).T,
                                      bfs_reference(src, dst, 200, [5, 17]))
        for pend, s in ((pc, 8), (pd, 9)):
            np.testing.assert_array_equal(
                fe.wait(pend, timeout_s=HTTP_TIMEOUT_S).dist_host,
                bfs_reference(src, dst, 200, [s]))
    finally:
        assert fe.shutdown(timeout_s=HTTP_TIMEOUT_S)


def test_a_direct_caller_keeps_the_engine_contract():
    """The serving layer settles an engine before it runs again; a caller
    of the engine itself still gets the plain contract: a reused result
    raises, a settled one keeps its copy."""
    src, dst, svc = _two_lane_service()
    eng = svc.cache.get_or_compile(svc.lane("a").plans[1])
    r1 = eng.run([3])
    eng.settle()
    r2 = eng.run([4])
    r3 = eng.run([5])
    np.testing.assert_array_equal(r1.dist_host,
                                  bfs_reference(src, dst, 200, [3]))
    with pytest.raises(RuntimeError, match="reused"):
        r2.dist_host
    np.testing.assert_array_equal(r3.dist_host,
                                  bfs_reference(src, dst, 200, [5]))


def test_services_share_engines_through_one_cache():
    src, dst = generate("erdos_renyi", 130, seed=3)
    g = shard_graph(src, dst, 130, 1)
    cache = EngineCache()
    svc_a = BFSService(g, opts=BFSOptions(mode="dense"), batch_slots=2,
                       cache=cache, device="cpu")
    svc_b = BFSService(g, opts=BFSOptions(mode="dense"), batch_slots=2,
                       cache=cache, device="cpu")
    svc_a.submit(TraversalRequest(rid=0, source=0))
    svc_b.submit(TraversalRequest(rid=1, source=1))
    (ra,), (rb,) = svc_a.run_until_drained(), svc_b.run_until_drained()
    st = cache.stats()
    assert st["misses"] == 1 and st["entries"] == 1
    assert svc_a.engine is svc_b.engine
    np.testing.assert_array_equal(ra.dist,
                                  bfs_reference(src, dst, 130, [0])[:, 0])
    np.testing.assert_array_equal(rb.dist,
                                  bfs_reference(src, dst, 130, [1])[:, 0])


# ---------------------------------------------------------------------------
# service and front-end cases of the JAX package's suite, on the port
# ---------------------------------------------------------------------------

def _graph(kind="erdos_renyi", n=160, seed=3, p=1, **kw):
    src, dst = generate(kind, n, seed=seed, **kw)
    return src, dst, shard_graph(src, dst, n, p)


def _service(graphs, ladder=(1, 4), **kw):
    svc = BFSService(opts=BFSOptions(mode="dense"), batch_buckets=ladder,
                     cache=EngineCache(), device="cpu", **kw)
    for name, (g, part) in graphs.items():
        svc.add_graph(name, g, partition=part)
    return svc


def test_service_routes_to_smallest_fitting_bucket():
    src, dst, g = _graph(n=150)
    svc = _service({"er": (g, "1d")}, ladder=(1, 4))
    res, bucket = svc.traverse("er", [5])
    assert bucket == 1
    np.testing.assert_array_equal(res.dist_host,
                                  bfs_reference(src, dst, 150, [5]))
    res, bucket = svc.traverse("er", [0, 7, 33])
    assert bucket == 4 and res.dist_host.shape == (150, 3)
    np.testing.assert_array_equal(res.dist_host,
                                  bfs_reference(src, dst, 150, [0, 7, 33]))
    assert svc.cache_stats()["misses"] == 2
    with pytest.raises(ValueError, match="capacity"):
        svc.traverse("er", [0, 1, 2, 3, 4])
    with pytest.raises(ValueError, match="duplicate"):
        svc.traverse("er", [3, 3])
    with pytest.raises(ValueError, match="outside"):
        svc.traverse("er", [150])


def test_run_until_drained_timeout_names_pending_lanes():
    _, _, g = _graph(n=100)
    svc = _service({"er": (g, "1d")}, ladder=(1,))
    r0 = TraversalRequest(rid=0, source=0, graph="er")
    r1 = TraversalRequest(rid=1, source=1, graph="er")
    svc.submit(r0)
    svc.submit(r1)
    assert svc.pending_by_lane() == {"er": 2}
    with pytest.raises(RuntimeError, match=r"timeout_s=0.*er: 2"):
        svc.run_until_drained(timeout_s=0)
    for r in (r0, r1):
        assert r.done and isinstance(r.error, StrandedRequestError)
    svc.submit(TraversalRequest(rid=2, source=0, graph="er"))
    assert len(svc.run_until_drained()) == 1 and not svc.pending_by_lane()


def test_frontend_traverse_parity_and_metrics():
    src, dst, g = _graph(n=140)
    svc = _service({"er": (g, "1d")}, ladder=(1, 4))
    fe = BFSFrontend(svc, max_queue_depth=4, log=lambda *a: None)
    try:
        out = fe.traverse("er", [2, 77, 5], include_parents=True,
                          timeout_s=HTTP_TIMEOUT_S)
        assert out["bucket"] == 4 and out["n"] == 140
        want = bfs_reference(src, dst, 140, [2, 77, 5])
        np.testing.assert_array_equal(np.asarray(out["depths"]).T, want)
        np.testing.assert_array_equal(np.asarray(out["parents"]).T,
                                      derive_parents(src, dst, want))
        assert set(out["timing_ms"]) == {"queue_wait", "device", "total"}
        with pytest.raises(ValueError, match="duplicate"):
            fe.submit("er", [1, 1])
        with pytest.raises(KeyError, match="no serving lane"):
            fe.submit("nope", [0])
        lane = fe.metrics_payload()["lanes"]["er"]
        assert lane["completed"] == 1 and lane["rejected_invalid"] == 1
        assert lane["e2e"]["count"] == 1
    finally:
        assert fe.shutdown(timeout_s=HTTP_TIMEOUT_S)


def test_frontend_bounded_queue_and_byte_bound_reject():
    _, _, g = _graph(n=100)
    svc = _service({"er": (g, "1d")}, ladder=(1,))
    fe = BFSFrontend(svc, max_queue_depth=1, start_dispatcher=False,
                     log=lambda *a: None)
    first = fe.submit("er", [0])
    with pytest.raises(AdmissionError) as ei:
        fe.submit("er", [1])
    assert ei.value.retry_after_s > 0
    fe.start()
    fe.wait(first, timeout_s=HTTP_TIMEOUT_S)
    assert fe.shutdown(timeout_s=HTTP_TIMEOUT_S)
    fe = BFSFrontend(svc, max_queue_depth=8, max_inflight_mb=1e-6,
                     start_dispatcher=False, log=lambda *a: None)
    first = fe.submit("er", [0])
    with pytest.raises(AdmissionError, match="in-flight budget"):
        fe.submit("er", [1])
    fe.start()
    fe.wait(first, timeout_s=HTTP_TIMEOUT_S)
    assert fe.shutdown(timeout_s=HTTP_TIMEOUT_S)
    with pytest.raises(DrainingError):
        fe.submit("er", [4])


def test_frontend_requires_registered_lanes():
    with pytest.raises(ValueError, match="no lanes"):
        BFSFrontend(BFSService(opts=BFSOptions(), cache=EngineCache()))


def test_parents_on_the_device_equal_the_host_rule():
    for kind, n, kw in (("rmat", 300, {"edge_factor": 8}),
                        ("star", 200, {}), ("chain", 50, {})):
        src, dst = generate(kind, n, seed=7, **kw)
        depths = bfs_reference(src, dst, n, [0, 5, n - 1])
        got = schema.derive_parents_on_device(
            torch.as_tensor(src), torch.as_tensor(dst),
            torch.as_tensor(depths))
        np.testing.assert_array_equal(got.numpy(),
                                      derive_parents(src, dst, depths))


def test_response_rows_parse_to_the_matrix():
    rng = np.random.default_rng(0)
    for shape in ((0, 3), (2, 0), (1, 1), (3, 7), (4, 1000)):
        m = rng.choice([0, 1, -1, 9, 10, 2 ** 21 - 1, 2 ** 21,
                        schema.UNREACHED, 10 ** 12, -7], size=shape)
        assert json.loads(schema.json_int_rows(m)) == m.tolist()


# ---------------------------------------------------------------------------
# HTTP: the port's server against the JAX package's
# ---------------------------------------------------------------------------

def _call(url, path, body=None, raw=None):
    """(status, Retry-After, JSON body) of one request."""
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(
        url + path, data=data, method="GET" if data is None else "POST",
        headers={"Content-Type": "application/json"} if data else {})
    try:
        with urllib.request.urlopen(req, timeout=HTTP_TIMEOUT_S) as rsp:
            return rsp.status, rsp.headers.get("Retry-After"), json.loads(
                rsp.read())
    except urllib.error.HTTPError as exc:
        return exc.code, exc.headers.get("Retry-After"), json.loads(
            exc.read())


def _call_oversized(url):
    """A ``/v1/traverse`` whose Content-Length claims 2 MB: the server
    answers from the header, before reading a body."""
    import http.client

    host, port = url.rsplit("/", 1)[1].split(":")
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=HTTP_TIMEOUT_S)
    try:
        conn.putrequest("POST", "/v1/traverse")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(2 * 10 ** 6))
        conn.endheaders(b"{}")
        rsp = conn.getresponse()
        return rsp.status, rsp.getheader("Retry-After"), json.loads(
            rsp.read())
    finally:
        conn.close()


def _servers(**kw):
    """The same two-lane service (1-D ``er``, 2-D ``ring``) behind the
    JAX package's and the port's ``serve_http``, both on the CPU."""
    from repro.serve.frontend import serve_http as jserve

    out = {}
    for ns, serve, lane_kw in (
            (_jax_ns(), jserve, {"mesh": None}),
            (_port_ns(), serve_http, {"device": "cpu"})):
        svc = ns.BFSService(opts=ns.BFSOptions(), batch_buckets=(1, 4),
                            cache=ns.EngineCache())
        for name, kind, n, gkw, part in (
                ("er", "erdos_renyi", 140, {"avg_degree": 6}, "1d"),
                ("ring", "chain", 60, {}, "2d")):
            src, dst = ns.generate(kind, n, seed=5, **gkw)
            svc.add_graph(name, ns.shard_graph(src, dst, n, 1),
                          partition=part, **lane_kw)
        httpd, fe = serve(svc, "127.0.0.1", 0, log=lambda *a: None,
                          graph_specs={"er": {"kind": "erdos_renyi",
                                              "n": 140, "seed": 5}}, **kw)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        out["jax" if serve is jserve else "port"] = (
            f"http://127.0.0.1:{httpd.server_address[1]}", httpd, fe,
            thread)
    return out


def _stop(servers):
    for url, httpd, fe, thread in servers.values():
        fe.shutdown(timeout_s=HTTP_TIMEOUT_S)
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=HTTP_TIMEOUT_S)


def _untimed(obj):
    obj = dict(obj)
    obj.pop("timing_ms", None)
    return obj


TRAVERSE_BODIES = [
    {"graph": "er", "sources": [0, 9, 77]},
    {"graph": "er", "sources": [4], "include_parents": True},
    {"graph": "ring", "sources": [0, 30]},
    {"graph": "ring", "sources": [1, 2, 3, 59], "include_parents": True},
    {"graph": "er", "sources": [139], "deadline_ms": 60000},
]
ERROR_BODIES = [
    {"graph": "er", "sources": [1, 1]},                # 400 duplicate
    {"graph": "er", "sources": [10 ** 6]},             # 400 outside
    {"graph": "er", "sources": []},                    # 400 schema
    {"graph": "er", "sources": [0] * 5000},            # 400 per-request
    {"graph": "er", "sources": [0], "colour": 1},      # 400 unknown field
    {"graph": "nope", "sources": [0]},                 # 404 lane
    {"sources": [0]},                                  # 400 ambiguous
    {"graph": "er", "sources": [0, 1, 2, 3, 4]},       # 400 capacity
]


def test_http_traverse_bodies_answer_as_jax():
    servers = _servers()
    try:
        for body in TRAVERSE_BODIES:
            got = {k: _call(v[0], "/v1/traverse", body)
                   for k, v in servers.items()}
            assert got["port"][0] == got["jax"][0] == 200, body
            assert _untimed(got["port"][2]) == _untimed(got["jax"][2]), body
        g = {k: _call(v[0], "/v1/graphs") for k, v in servers.items()}
        assert g["port"] == g["jax"]
        h = {k: _call(v[0], "/healthz") for k, v in servers.items()}
        assert h["port"] == h["jax"]
        r = {k: _call(v[0], "/readyz") for k, v in servers.items()}
        assert r["port"] == r["jax"]
        m = {k: _call(v[0], "/metrics")[2] for k, v in servers.items()}
        assert set(m["port"]) == set(m["jax"])
        for lane in ("er", "ring"):
            for key in ("completed", "sources_served", "buckets",
                        "wire_bytes", "degraded", "rejected"):
                assert m["port"]["lanes"][lane][key] == \
                    m["jax"]["lanes"][lane][key], (lane, key)
    finally:
        _stop(servers)


def test_http_errors_map_as_jax():
    servers = _servers()
    try:
        for body in ERROR_BODIES:
            got = {k: _call(v[0], "/v1/traverse", body)
                   for k, v in servers.items()}
            assert got["port"] == got["jax"], body
            assert got["port"][0] in (400, 404)
        got = {k: _call_oversized(v[0]) for k, v in servers.items()}
        assert got["port"] == got["jax"] and got["port"][0] == 413
        for path in ("/v1/missing", "/nope"):
            got = {k: _call(v[0], path) for k, v in servers.items()}
            assert got["port"] == got["jax"] and got["port"][0] == 404
        # draining: 503 with Retry-After on both
        for v in servers.values():
            v[2].drain(timeout_s=HTTP_TIMEOUT_S)
        got = {k: _call(v[0], "/v1/traverse", {"graph": "er",
                                               "sources": [0]})
               for k, v in servers.items()}
        assert got["port"] == got["jax"]
        assert got["port"][0] == 503 and got["port"][1] == "5"
    finally:
        _stop(servers)


def test_http_overload_answers_429_as_jax():
    servers = _servers(max_queue_depth=1, start_dispatcher=False)
    firsts, threads = {}, []
    try:
        for key, (url, httpd, fe, thread) in servers.items():
            t = threading.Thread(target=lambda k=key, u=url: firsts.update(
                {k: _call(u, "/v1/traverse", {"graph": "er",
                                              "sources": [0]})}))
            t.start()
            threads.append(t)
            deadline = time.monotonic() + HTTP_TIMEOUT_S
            while fe.gates["er"].depth() == 0:
                assert time.monotonic() < deadline
                time.sleep(0.005)
        got = {k: _call(v[0], "/v1/traverse", {"graph": "er",
                                               "sources": [1]})
               for k, v in servers.items()}
        assert got["port"] == got["jax"]
        assert got["port"][0] == 429 and int(got["port"][1]) >= 1
    finally:
        for url, httpd, fe, thread in servers.values():
            fe.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        _stop(servers)
    assert firsts["port"][0] == firsts["jax"][0] == 200
    assert _untimed(firsts["port"][2]) == _untimed(firsts["jax"][2])


def test_the_jax_client_verifies_the_port_server():
    """``python -m repro.launch.bfs_client --verify --shutdown`` (the JAX
    package's client, unchanged) passes against the port's server."""
    src, dst = generate("erdos_renyi", 140, seed=5, avg_degree=6)
    svc = BFSService(opts=BFSOptions(), batch_buckets=(1, 4),
                     cache=EngineCache(), device="cpu")
    svc.add_graph("er", shard_graph(src, dst, 140, 1))
    httpd, fe = serve_http(svc, "127.0.0.1", 0, log=lambda *a: None,
                           graph_specs={"er": {
                               "kind": "erdos_renyi", "n": 140, "seed": 5,
                               "gen_kwargs": {"avg_degree": 6}}})
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        out = subprocess.run(
            [sys.executable, "-m", "repro.launch.bfs_client", "--url", url,
             "--graph", "er", "--requests", "6", "--batch", "3",
             "--concurrency", "2", "--include-parents", "--verify",
             "--timeout", str(HTTP_TIMEOUT_S), "--shutdown"],
            env=env, capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        assert "match the numpy reference bitwise" in out.stdout
        thread.join(timeout=HTTP_TIMEOUT_S)
        assert not thread.is_alive() and fe.draining
    finally:
        fe.shutdown(timeout_s=HTTP_TIMEOUT_S)
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=HTTP_TIMEOUT_S)
