"""The port's resilience layer against the JAX package's: the same seeded
``FaultPlan`` fires on the same calls in both, the breaker, deadline,
retry and watchdog primitives follow the same trajectories (the cases of
``tests/test_resilience.py``, run on both packages), and the front end
built on the port — its degradation arms (split over a smaller bucket
in five runs of one engine, the bytes wire tier), its watchdog (a wedged
sync and a wedged dispatch fail only their own round), its breaker and
deadline paths — serves bitwise the oracle's distances; with no fault
installed, results and ``plan_key`` are unchanged.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import BFSOptions, LocalMesh, plan
from repro_torch.core.ref import bfs_reference
from repro_torch.graphs import generate, shard_graph
from repro_torch.serve.bfs_service import BFSService
from repro_torch.serve.engine_cache import EngineCache
from repro_torch.serve.frontend.server import BFSFrontend
from repro_torch.serve.resilience import faults
from repro_torch.serve.resilience.degrade import degraded_traverse
from repro_torch.serve.resilience.errors import (CircuitOpenError,
                                                 DeadlineExceeded,
                                                 InjectedError,
                                                 StuckDispatchError,
                                                 TransientError)
from repro_torch.serve.resilience.faults import FaultPlan, FaultSpec
from repro_torch.serve.resilience.retry import RetryPolicy

torch.set_num_threads(1)

PACKAGES = ("repro", "repro_torch")


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.serve.resilience.{name}")


# ---------------------------------------------------------------------------
# the stdlib modules: the same behaviour in both packages
# ---------------------------------------------------------------------------

SCHEDULES = [
    dict(site="s", kind="fail", after=2, times=2),
    dict(site="s", kind="fail", p=0.3, times=50),
    dict(site="s", kind="stall", delay_s=0.0, p=0.5, after=3, times=5),
    dict(site="cache.compile", kind="fail", match="S=4", p=0.7, times=10),
    dict(site="cache.get", kind="storm", p=0.4, times=20),
]
CALLS = ([("s", "")] * 40 + [("cache.compile", f"S={s} mode=dense")
                             for s in (1, 4, 4, 8, 4) * 6]
         + [("cache.get", "x")] * 30)


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_a_seeded_fault_plan_fires_as_jax(seed):
    fired = {}
    for pkg in PACKAGES:
        f = _mod(pkg, "faults")
        plan_ = f.FaultPlan([f.FaultSpec(**spec) for spec in SCHEDULES],
                            seed=seed)
        fired[pkg] = [None if (s := plan_.arm(site, tag)) is None
                      else (s.site, s.kind) for site, tag in CALLS]
        fired[pkg + "_summary"] = plan_.summary()
    assert fired["repro"] == fired["repro_torch"]
    assert fired["repro_summary"] == fired["repro_torch_summary"]
    assert any(fired["repro_torch"]) and not all(fired["repro_torch"])


@pytest.mark.parametrize("seed", range(6))
def test_corrupt_bytes_is_jax(seed):
    body = b'{"graph": "er", "sources": [1, 2, 3]}'
    out = [_mod(pkg, "faults").corrupt_bytes(
        body, _mod(pkg, "faults").FaultSpec(site="client.payload",
                                            kind="corrupt"), seed=seed)
        for pkg in PACKAGES]
    assert out[0] == out[1] != body


@pytest.mark.parametrize("pkg", PACKAGES)
def test_fault_plan_hit_windows_tags_and_validation(pkg):
    f, errors = _mod(pkg, "faults"), _mod(pkg, "errors")
    spec = f.FaultSpec(site="s", kind="fail", after=2, times=2)
    for _ in range(2):
        p = f.FaultPlan([spec], seed=7)
        assert [p.arm("s", "") is not None for _ in range(6)] == [
            False, False, True, True, False, False]
    p = f.FaultPlan([f.FaultSpec(site="cache.compile", match="S=4")])
    assert p.arm("cache.compile", "S=1 mode=dense") is None
    assert p.arm("cache.compile", "S=4 mode=dense") is not None
    assert f.fire("cache.compile", "anything") is None
    with f.active(f.FaultPlan([f.FaultSpec(site="x", kind="fail")])):
        with pytest.raises(errors.InjectedError, match="injected"):
            f.fire("x")
    assert f.fire("x") is None
    for bad, match in ((dict(kind="explode"), "unknown fault kind"),
                       (dict(p=1.5), "p must be"), (dict(times=0), "times")):
        with pytest.raises(ValueError, match=match):
            f.FaultSpec(site="s", **bad)


def _breaker_trajectory(pkg):
    b_mod, errors = _mod(pkg, "breaker"), _mod(pkg, "errors")
    now = [0.0]
    b = b_mod.CircuitBreaker(failure_threshold=3, reset_timeout_s=10.0,
                             name="er", clock=lambda: now[0])
    seen = []
    for _ in range(2):
        b.record_failure()
    seen.append(b.state())
    b.record_failure()
    seen += [b.state(), b.opened, b.admits(), b.allow()]
    err = b.reject_error()
    assert isinstance(err, errors.CircuitOpenError) and err.status == 503
    seen.append(err.retry_after_s)
    now[0] = 10.1
    seen += [b.state(), b.allow(), b.allow()]
    b.record_success()
    seen += [b.state(), [s for s, _ in b.transitions],
             b.recovery_latencies_s(), b.snapshot()]
    # a failed probe reopens with a fresh cooldown
    b2 = b_mod.CircuitBreaker(failure_threshold=1, reset_timeout_s=5.0,
                              clock=lambda: now[0])
    now[0] = 0.0
    b2.record_failure()
    now[0] = 5.0
    seen.append(b2.allow())
    b2.record_failure()
    seen += [b2.state(), b2.opened]
    now[0] = 9.9
    seen.append(b2.state())
    now[0] = 10.0
    seen.append(b2.state())
    return seen


def test_breaker_trajectory_is_jax():
    got = _breaker_trajectory("repro_torch")
    assert got == _breaker_trajectory("repro")
    assert got[0] == "closed" and got[1:5] == ["open", 1, False, False]
    assert got[6:10] == ["half_open", True, False, "closed"]
    assert got[10] == ["closed", "open", "half_open", "closed"]
    assert got[-5:] == [True, "open", 2, "open", "half_open"]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_deadline_checks_and_bounds(pkg):
    d_mod, errors = _mod(pkg, "deadline"), _mod(pkg, "errors")
    now = [100.0]
    d = d_mod.Deadline.after_ms(250, clock=lambda: now[0])
    assert not d.expired() and d.remaining_s() == pytest.approx(0.25)
    assert d.bound(10.0) == pytest.approx(0.25)
    assert d.bound(0.1) == pytest.approx(0.1)
    d.check("queue")
    now[0] = 100.3
    assert d.expired() and d.bound(10.0) == 0.0
    with pytest.raises(errors.DeadlineExceeded, match="queue") as ei:
        d.check("queue", "lane 'er'")
    assert ei.value.status == 504 and ei.value.stage == "queue"
    with pytest.raises(ValueError, match="> 0"):
        d_mod.Deadline.after_ms(0)


def _retry_trajectory(pkg):
    r_mod, errors = _mod(pkg, "retry"), _mod(pkg, "errors")
    pol = r_mod.RetryPolicy(max_attempts=4, base_s=0.1, max_s=0.3, seed=5)
    calls, slept, retried = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise errors.TransientError("transient")
        return "ok"

    out = r_mod.call_with_retry(flaky, pol, sleep=slept.append,
                                on_retry=lambda a, e, b: retried.append(a))
    with pytest.raises(errors.TransientError):
        r_mod.call_with_retry(
            lambda: (_ for _ in ()).throw(errors.TransientError("x")),
            r_mod.RetryPolicy(max_attempts=2, base_s=0.0),
            sleep=lambda s: None)
    hard = []

    def permanent():
        hard.append(1)
        raise ValueError("permanent")

    with pytest.raises(ValueError):
        r_mod.call_with_retry(permanent, pol, sleep=lambda s: None)
    return [pol.backoffs(), out, len(calls), retried, slept, len(hard)]


def test_retry_trajectory_is_jax():
    got = _retry_trajectory("repro_torch")
    assert got == _retry_trajectory("repro")
    backoffs, out, n_calls, retried, slept, n_hard = got
    assert len(backoffs) == 3 and all(0.05 <= b <= 0.45 for b in backoffs)
    assert (out, n_calls, retried, n_hard) == ("ok", 3, [1, 2], 1)
    assert slept == backoffs[:2]


def test_watchdog_passthrough_and_trip_accounting():
    from repro_torch.serve.resilience.watchdog import DispatchWatchdog

    wd = DispatchWatchdog(timeout_s=0.2)
    assert wd.guard(lambda: 42) == 42
    with pytest.raises(ZeroDivisionError):
        wd.guard(lambda: 1 // 0)
    release = threading.Event()
    with pytest.raises(StuckDispatchError, match="watchdog"):
        wd.guard(release.wait, label="wedged")
    assert wd.stuck() == 1 and wd.snapshot()["trips"] == 1
    release.set()
    assert wd.wait_idle(timeout_s=5.0)
    assert wd.snapshot()["completed_late"] == 1 and wd.stuck() == 0


# ---------------------------------------------------------------------------
# the serving stack on the port under faults
# ---------------------------------------------------------------------------

def _graph(n=120, seed=3, p=1):
    src, dst = generate("erdos_renyi", n, seed=seed)
    return src, dst, shard_graph(src, dst, n, p)


def _service(g, ladder=(1, 4), mesh=None):
    svc = BFSService(opts=BFSOptions(mode="dense"), batch_buckets=ladder,
                     cache=EngineCache(), device="cpu")
    svc.add_graph("er", g, mesh=mesh)
    return svc


def _frontend(svc, **kw):
    kw.setdefault("start_dispatcher", False)
    kw.setdefault("max_queue_depth", 8)
    kw.setdefault("log", lambda *a: None)
    return BFSFrontend(svc, **kw)


@pytest.mark.parametrize("p", [1, 2])
def test_split_arm_in_five_runs_of_one_engine_is_bitwise(p):
    """S = 16 poisoned: 10 sources ride ``split:2``, five runs of the S = 2
    engine, each read back before the next reuses its buffer."""
    src, dst, g = _graph(n=150, p=p)
    svc = _service(g, ladder=(2, 16), mesh=LocalMesh.flat(p, "cpu"))
    srcs = [5, 9, 40, 77, 0, 149, 33, 12, 100, 61]
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match="S=16")])):
        res, bucket, arm = degraded_traverse(svc, "er", srcs)
    assert arm == "split:2" and bucket == 2
    eng = svc.cache.get(svc.lane("er").plans[2])
    assert eng._generation == 5 and len(res._parts) == 5
    np.testing.assert_array_equal(res.block().dist_host,
                                  bfs_reference(src, dst, 150, srcs))
    stats = res.run_stats.to_host()
    assert stats["levels"] >= 1
    assert stats["mode_counts"]["dense"] == sum(
        p.run_stats.levels for p in res._parts)


def test_split_arm_matches_jax():
    from repro.core import BFSOptions as JOptions
    from repro.graphs import shard_graph as jshard
    from repro.serve.bfs_service import BFSService as JService
    from repro.serve.engine_cache import EngineCache as JCache
    from repro.serve.resilience import faults as jfaults
    from repro.serve.resilience.degrade import degraded_traverse as jdeg

    src, dst, g = _graph(n=110)
    srcs = [5, 9, 40, 77]
    svc = _service(g, ladder=(1, 4))
    jsvc = JService(opts=JOptions(mode="dense"), batch_buckets=(1, 4),
                    cache=JCache())
    jsvc.add_graph("er", jshard(src, dst, 110, 1), mesh=None)
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match="S=4")])):
        res, bucket, arm = degraded_traverse(svc, "er", srcs)
    with jfaults.active(jfaults.FaultPlan([jfaults.FaultSpec(
            site="cache.compile", match="S=4")])):
        jres, jbucket, jarm = jdeg(jsvc, "er", srcs)
    assert (arm, bucket) == (jarm, jbucket) == ("split:1", 1)
    np.testing.assert_array_equal(res.block().dist_host,
                                  jres.block().dist_host)
    assert res.run_stats.to_host() == jres.run_stats.to_host()


def test_bucket_arm_serves_on_a_larger_rung():
    src, dst, g = _graph(n=100)
    svc = _service(g, ladder=(1, 2, 4))
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match="S=1 ")])):
        res, bucket, arm = degraded_traverse(svc, "er", [3])
    assert arm == "bucket:2" and bucket == 2
    np.testing.assert_array_equal(res.block().dist_host,
                                  bfs_reference(src, dst, 100, [3]))


def test_wire_tier_arm_replans_on_the_base_mesh():
    src, dst, g = _graph(n=100, p=2)
    mesh = LocalMesh.flat(2, "cpu")
    svc = _service(g, ladder=(1,), mesh=mesh)
    base = svc.lane("er").plans[1]
    assert base.opts.wire_format != "bytes"
    tag = f"wire={base.opts.wire_format}"
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match=tag)])):
        res, bucket, arm = degraded_traverse(svc, "er", [3])
    assert arm == "wire:bytes" and bucket == 1
    safe = svc.lane("er")._bytes_plans[1]
    assert safe.mesh == mesh and safe.describe()["dense_exchange"] and \
        safe.describe()["wire_formats"]["dense"] == "bytes"
    np.testing.assert_array_equal(res.block().dist_host,
                                  bfs_reference(src, dst, 100, [3]))


def test_degraded_traverse_exhausted_reraises_transient():
    _, _, g = _graph(n=100)
    svc = _service(g, ladder=(1,))
    with faults.active(FaultPlan([FaultSpec(site="cache.compile")])):
        with pytest.raises(TransientError):
            degraded_traverse(svc, "er", [3])


def test_engine_seams_fire():
    _, _, g = _graph(n=100)
    pl = plan(g, BFSOptions(), num_sources=2, device="cpu")
    with faults.active(FaultPlan([FaultSpec(site="engine.compile",
                                            match="S=2 ")])):
        with pytest.raises(InjectedError):
            pl.compile()
    eng = pl.compile()
    with faults.active(FaultPlan([FaultSpec(site="engine.dispatch",
                                            times=1)])):
        with pytest.raises(InjectedError):
            eng.run([1])
        eng.run([1])                        # the spec fired once


def test_deadline_reaped_before_device_work():
    _, _, g = _graph(n=100)
    svc = _service(g)
    fe = _frontend(svc)
    pending = fe.submit("er", [4], deadline_ms=30)
    with pytest.raises(DeadlineExceeded) as ei:
        fe.wait(pending, timeout_s=5.0)
    assert ei.value.stage == "wait"
    misses = svc.cache.stats()["misses"]
    assert fe._dispatch_round() == 0
    assert svc.cache.stats()["misses"] == misses
    assert isinstance(pending.error, DeadlineExceeded)
    assert pending.error.stage == "queue"
    assert fe.metrics.lane("er").snapshot()["deadline_expired"] == 2
    assert fe.gates["er"].idle()


def test_frontend_breaker_opens_sheds_and_recovers():
    src, dst, g = _graph(n=100)
    svc = _service(g, ladder=(1,))
    fe = _frontend(svc, breaker_threshold=2, breaker_reset_s=0.15,
                   degrade=False, retry_policy=RetryPolicy(max_attempts=1))
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            times=2)])):
        for _ in range(2):
            p = fe.submit("er", [1])
            fe._dispatch_round()
            with pytest.raises(InjectedError):
                fe.wait(p, timeout_s=5.0)
    assert fe.breakers["er"].state() == "open"
    with pytest.raises(CircuitOpenError) as ei:
        fe.submit("er", [1])
    assert ei.value.status == 503 and ei.value.retry_after_s > 0
    ok, reasons = fe.ready()
    assert not ok and "breakers open" in reasons[0]
    time.sleep(0.2)
    p = fe.submit("er", [2])
    fe._dispatch_round()
    np.testing.assert_array_equal(fe.wait(p, timeout_s=5.0).dist_host,
                                  bfs_reference(src, dst, 100, [2]))
    assert fe.breakers["er"].state() == "closed" and fe.ready()[0]


def test_frontend_retry_then_degrade_serves_bitwise():
    src, dst, g = _graph(n=100)
    svc = _service(g, ladder=(1, 4))
    fe = _frontend(svc, retry_policy=RetryPolicy(max_attempts=2,
                                                 base_s=0.0))
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match="S=4")])):
        p = fe.submit("er", [8, 33, 60], include_parents=True)
        fe._dispatch_round()
        res = fe.wait(p, timeout_s=10.0)
    want = bfs_reference(src, dst, 100, [8, 33, 60])
    np.testing.assert_array_equal(res.dist_host, want)
    body = fe._payload(p, res)
    np.testing.assert_array_equal(np.asarray(body["depths"]).T, want)
    assert p.arm == "split:1" and p.bucket == 1
    snap = fe.metrics.lane("er").snapshot()
    assert snap["retries"] == 1 and snap["degraded"] == {"split:1": 1}
    assert snap["completed"] == 1 and snap["failed"] == 0


def test_frontend_watchdog_trips_only_the_wedged_round():
    src, dst, g = _graph(n=100)
    svc = _service(g, ladder=(1,))
    fe = _frontend(svc, watchdog_timeout_s=0.25)
    with faults.active(FaultPlan([FaultSpec(site="frontend.block",
                                            kind="stall", delay_s=1.0,
                                            times=1)])):
        p1 = fe.submit("er", [5])
        fe._dispatch_round()
        with pytest.raises(StuckDispatchError) as ei:
            fe.wait(p1, timeout_s=5.0)
        assert ei.value.status == 500
    assert fe.breakers["er"].state() == "closed"
    assert fe.metrics.lane("er").snapshot()["failed"] == 1
    assert fe.watchdog.wait_idle(timeout_s=5.0)
    p2 = fe.submit("er", [6])
    fe._dispatch_round()
    np.testing.assert_array_equal(fe.wait(p2, timeout_s=5.0).dist_host,
                                  bfs_reference(src, dst, 100, [6]))
    wd = fe.watchdog.snapshot()
    assert wd["trips"] == 1 and wd["stuck"] == 0 and wd["completed_late"] == 1


def test_frontend_watchdog_guards_a_wedged_dispatch():
    """The port's ``run_async`` returns after the level loop, so a wedged
    device hangs in dispatch: the watchdog guards it too, and the wedged
    lane's round fails alone while another lane's request in the same
    round serves."""
    src, dst, g = _graph(n=100)
    src2, dst2, g2 = _graph(n=80, seed=5)
    svc = _service(g, ladder=(1,))
    svc.add_graph("alt", g2)
    fe = _frontend(svc, watchdog_timeout_s=0.25)
    with faults.active(FaultPlan([FaultSpec(site="service.dispatch",
                                            match="er", kind="stall",
                                            delay_s=1.0, times=1)])):
        p1 = fe.submit("er", [5])
        p2 = fe.submit("alt", [7])
        assert fe._dispatch_round() == 2
        with pytest.raises(StuckDispatchError) as ei:
            fe.wait(p1, timeout_s=5.0)
        assert ei.value.status == 500
        np.testing.assert_array_equal(fe.wait(p2, timeout_s=5.0).dist_host,
                                      bfs_reference(src2, dst2, 80, [7]))
    assert fe.watchdog.wait_idle(timeout_s=5.0)
    p3 = fe.submit("er", [6])
    fe._dispatch_round()
    np.testing.assert_array_equal(fe.wait(p3, timeout_s=5.0).dist_host,
                                  bfs_reference(src, dst, 100, [6]))
    assert fe.watchdog.snapshot()["trips"] == 1
    assert fe.metrics.lane("alt").snapshot()["failed"] == 0


def test_readyz_payload_and_metrics_surface_resilience():
    _, _, g = _graph(n=100)
    svc = _service(g)
    fe = _frontend(svc, watchdog_timeout_s=5.0)
    status, body = fe.readiness_payload()
    assert status == 200 and body["ready"]
    assert body["breakers"] == {"er": "closed"}
    m = fe.metrics_payload()
    assert m["lanes"]["er"]["breaker"]["state"] == "closed"
    assert m["watchdog"]["trips"] == 0
    fe.drain(timeout_s=1.0)
    status, body = fe.readiness_payload()
    assert status == 503 and body["reasons"] == ["draining"]


def test_faults_disabled_bitwise_identical_and_plan_key_unchanged():
    src, dst, g = _graph(n=100)
    opts = BFSOptions(mode="dense")
    base = plan(g, opts, num_sources=2, device="cpu")
    key = base.plan_key()
    with faults.active(FaultPlan([FaultSpec(site="nowhere")])):
        assert plan(g, opts, num_sources=2, device="cpu").plan_key() == key
    assert plan(g, opts, num_sources=2, device="cpu").plan_key() == key
    direct = base.compile().run([4, 9]).dist_host
    svc = _service(g)
    fe = _frontend(svc)
    p = fe.submit("er", [4, 9])
    fe._dispatch_round()
    np.testing.assert_array_equal(fe.wait(p, timeout_s=5.0).dist_host,
                                  direct)
    np.testing.assert_array_equal(direct,
                                  bfs_reference(src, dst, 100, [4, 9]))
    snap = fe.metrics.lane("er").snapshot()
    assert (snap["retries"], snap["breaker_rejected"],
            snap["deadline_expired"], snap["degraded"]) == (0, 0, 0, {})


def test_eviction_storm_recompiles_transparently():
    src, dst, g = _graph(n=100)
    svc = _service(g, ladder=(1,))
    fe = _frontend(svc)
    p = fe.submit("er", [3])
    fe._dispatch_round()
    fe.wait(p, timeout_s=5.0)
    with faults.active(FaultPlan([FaultSpec(site="cache.get",
                                            kind="storm", times=1)])):
        p2 = fe.submit("er", [8])
        fe._dispatch_round()
        res = fe.wait(p2, timeout_s=10.0)
    np.testing.assert_array_equal(res.dist_host,
                                  bfs_reference(src, dst, 100, [8]))
    assert svc.cache.stats()["evictions"] >= 1
    assert svc.cache.stats()["misses"] == 2
