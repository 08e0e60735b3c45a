"""The port's serving fleet (``transmogrifai_tpu_torch/fleet.py``) on the
CPU, held against the JAX package's ``fleet.py``.

The JAX oracles ``tests/test_fleet.py::test_fleet_routes_bit_identical_
and_aggregates``, ``::test_drained_restart_loses_zero_requests`` and
``::test_sigkill_failover_respawn_and_post_promote_rejoin`` fail on this
tree (the 8-device mesh), so the behaviours they hold are held here
against a fleet of two real ``python -m transmogrifai_tpu_torch serve
--device cpu`` workers (the router in this process): routing bitwise
equal to a solo score at the response's bucket, sibling failover under a
``fleet.forward`` fault, a SIGKILL under load with no failed request and
the respawned worker rejoining on the promoted pointer, a drained restart
that loses no request, and the canary routing a request the same way on
either worker. The routing functions (``_route_key``, ``_rendezvous``),
the supervisor's respawn-budget state machine, the routing rule for a
worker's answers (a 500 passes through, 429/503 and transport failures
fail over, a breaker opens on transport failures) and the tallies are
compared with the JAX functions directly. The tenants are the two-feature
logistic regressions of ``tests/_torch_server_data.py``."""
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from transmogrifai_tpu import fleet as jfleet
from transmogrifai_tpu import resilience as jresilience
from transmogrifai_tpu_torch import fleet as fleet_mod
from transmogrifai_tpu_torch import resilience, telemetry
from transmogrifai_tpu_torch.fleet import (FleetSupervisor, fleet_stats,
                                           serve_fleet_http)
from transmogrifai_tpu_torch.lifecycle import ModelRegistry
from transmogrifai_tpu_torch.server import _store_rows

from _torch_server_data import BUCKET_CAP, jax_scores, tenant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: a quick respawn schedule (the default backs off to seconds)
_FAST_BACKOFF = resilience.RetryPolicy(max_attempts=8, base_delay_s=0.05,
                                       max_delay_s=0.5, jitter=0.1, seed=3)


@pytest.fixture(scope="module")
def fleet_env(tmp_path_factory):
    """Two versions of the registry model ``churn`` (v1 promoted) and a
    second tenant ``fraud`` (v2's artifacts), each the port's export of a
    JAX-trained model, and the params file every worker starts from."""
    reg_dir = str(tmp_path_factory.mktemp("registry"))
    reg = ModelRegistry(reg_dir)
    env = {"registry": reg, "registry_dir": reg_dir}
    for tag, seed in (("v1", 11), ("v2", 12)):
        t = tenant(seed, str(tmp_path_factory.mktemp(f"model_{tag}")),
                   str(tmp_path_factory.mktemp(f"export_{tag}")))
        t["vid"] = reg.register("churn", t["model_dir"],
                                bank_dir=t["export_dir"],
                                promote=(tag == "v1"))
        t["engine"] = t["model"].scoring_engine("cpu",
                                                bucket_cap=BUCKET_CAP)
        env[tag] = t
    reg.register("fraud", env["v2"]["model_dir"],
                 bank_dir=env["v2"]["export_dir"], promote=True)
    params = tmp_path_factory.mktemp("params") / "params.json"
    params.write_text(json.dumps({"customParams": {
        "registryDir": reg_dir, "serveBucketCap": BUCKET_CAP,
        "serveBatchDeadlineMs": 1.0}}))
    env["params_path"] = str(params)
    return env


@pytest.fixture(scope="module")
def fleet2(fleet_env, tmp_path_factory):
    """One live fleet of two CPU workers behind the router, shared by the
    module's tests (starting interpreters is the expensive part)."""
    sup = FleetSupervisor(fleet_env["params_path"], workers=2,
                          respawn_max=6, probe_interval_s=0.1,
                          backoff=_FAST_BACKOFF, device="cpu",
                          log_dir=str(tmp_path_factory.mktemp("logs")))
    sup.start()
    httpd = None
    try:
        sup.wait_ready(timeout_s=240)
        httpd = serve_fleet_http(sup, port=0, retry_budget=3,
                                 forward_timeout_s=60.0)
        yield sup, httpd, httpd.server_address[1]
    finally:
        if httpd is not None:
            httpd.shutdown()
        sup.stop(drain=True)


def _call(port, method, path, doc=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, None if doc is None else json.dumps(doc),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _oracle(t, recs, bucket):
    """The solo answer a fleet response must equal value for value: the
    port's engine at the response's bucket, through the JSON the front
    end writes (a float's repr round-trips exactly)."""
    store = t["engine"].score_store(recs, bucket_min=bucket,
                                    use_cache=False)
    return json.loads(json.dumps(_store_rows(store), default=str))


def _handles(mod, n):
    return [mod.WorkerHandle(i, f"/nowhere/worker-{i}.log")
            for i in range(n)]


@pytest.mark.parametrize("n_workers", [1, 2, 3, 5])
def test_route_key_and_rendezvous_order_equal_the_jax_packages(n_workers):
    """``_route_key`` (blake2b of the model and the first record) and
    ``_rendezvous`` (highest-random-weight order) give the JAX package's
    keys and worker orders for 1,000 requests."""
    pw, jw = _handles(fleet_mod, n_workers), _handles(jfleet, n_workers)
    for i in range(1000):
        recs = [{"x1": i * 0.37, "x2": None if i % 7 else "a"}] \
            if i % 13 else []
        key = fleet_mod._route_key(f"m{i % 3}", recs)
        assert key == jfleet._route_key(f"m{i % 3}", recs)
        assert [h.wid for h in fleet_mod._rendezvous(key, pw)] == \
            [h.wid for h in jfleet._rendezvous(key, jw)]
    loop = []
    loop.append(loop)            # unserializable: keys on the name alone
    assert fleet_mod._route_key("m", [loop]) == \
        jfleet._route_key("m", [loop]) == fleet_mod._route_key("m", [[loop]])


def test_tallies_and_sites_equal_the_jax_packages():
    assert set(fleet_stats()) == set(jfleet.fleet_stats())
    for site in ("fleet.forward", "fleet.spawn"):
        assert site in resilience.FAULT_SITES
    assert resilience.UNPORTED_SITES == {}
    with pytest.raises(fleet_mod.FleetError, match="device"):
        FleetSupervisor("p.json", device="tpu")


def test_respawn_budget_state_machine_equals_the_jax_packages(tmp_path):
    """The consecutive-crash budget resets only after a sustained ready
    interval and a flicker-ready crash loop exhausts it: the JAX
    supervisor's states and counts after the same calls (no process is
    started)."""
    seen = {}
    for mod, pol, tag in ((fleet_mod, resilience, "port"),
                          (jfleet, jresilience, "jax")):
        backoff = pol.RetryPolicy(max_attempts=4, base_delay_s=0.01,
                                  max_delay_s=0.05, jitter=0.0)
        sup = mod.FleetSupervisor(str(tmp_path / "params.json"),
                                  workers=1, respawn_max=1,
                                  backoff=backoff,
                                  log_dir=str(tmp_path / tag))
        h = sup.workers[0]
        out = []
        sup._note_crash(h)
        out.append((h.state, h.restarts))
        sup._note_ready(h)
        out.append((h.state, h.restarts))
        time.sleep(backoff.max_delay_s + 0.02)
        sup._note_ready(h)
        out.append((h.state, h.restarts))
        sup._note_crash(h)
        out.append((h.state, h.restarts))
        sup._note_ready(h)
        sup._note_crash(h)
        out.append((h.state, h.restarts))
        seen[tag] = out
    assert seen["port"] == seen["jax"]
    assert seen["port"][-1] == (fleet_mod.FAILED, 2)


def test_a_spawn_fault_enters_the_backoff(tmp_path):
    """A ``fleet.spawn`` fault counts as a crash: the worker is DEAD with
    a respawn scheduled, nothing was started, and the tallies say so."""
    sup = FleetSupervisor(str(tmp_path / "params.json"), workers=1,
                          device="cpu", log_dir=str(tmp_path / "logs"),
                          backoff=resilience.RetryPolicy(
                              max_attempts=3, base_delay_s=60.0,
                              max_delay_s=60.0, jitter=0.0))
    before = fleet_stats()
    plan = resilience.FaultPlan(seed=4).on("fleet.spawn", error=OSError)
    try:
        with resilience.fault_plan(plan):
            sup.start()
        h = sup.workers[0]
        assert plan.fired("fleet.spawn") == 1
        assert h.state == fleet_mod.DEAD and h.proc is None
        assert h.restarts == 1 and h.next_spawn_at > time.monotonic()
        after = fleet_stats()
        assert after["worker_crashes"] - before["worker_crashes"] == 1
        assert after["workers_spawned"] == before["workers_spawned"]
    finally:
        sup.stop(drain=False)


class _Stub(BaseHTTPRequestHandler):
    """A worker stand-in answering every request with its server's
    ``status``."""

    def log_message(self, *a):
        pass

    def do_POST(self):
        self.server.hits += 1
        if getattr(self.server, "on_post", None):
            self.server.on_post()
        body = json.dumps({"from": self.server.name}).encode()
        self.send_response(self.server.status)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _Alive:
    def poll(self):
        return None


def test_routing_rule_for_worker_answers_and_transport_failures(tmp_path):
    """The JAX router's rule: a worker's 500 (a device failure fails its
    batch in the server) passes through and is never retried on a
    sibling; a 503 or 429 fails over without touching the breaker; a
    transport failure fails over, and three of them open that worker's
    breaker (``on_breaker_trip``), after which the router routes around
    it without trying."""
    stubs = []
    for i in range(2):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
        httpd.name, httpd.status, httpd.hits = f"w{i}", 200, 0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        stubs.append(httpd)
    sup = FleetSupervisor(str(tmp_path / "p.json"), workers=2,
                          device="cpu", log_dir=str(tmp_path / "logs"))
    for h, st in zip(sup.workers, stubs):
        h.state, h.port, h.proc = fleet_mod.READY, st.server_address[1], \
            _Alive()
    router = serve_fleet_http(sup, port=0, retry_budget=2)
    port = router.server_address[1]
    trips = []

    class L(telemetry.RunListener):
        def on_breaker_trip(self, name, failures, **_):
            trips.append((name, failures))

    listener = telemetry.add_listener(L())
    telemetry.enable()
    try:
        doc = {"records": [{"x1": 1.0, "x2": 2.0}]}
        key = fleet_mod._route_key("m", doc["records"])
        first, second = [stubs[h.wid] for h in
                         fleet_mod._rendezvous(key, sup.workers)]
        first.status = 500
        before = fleet_stats()
        status, body = _call(port, "POST", "/v1/models/m:score", doc)
        assert (status, body["from"], second.hits) == (500, first.name, 0)
        assert fleet_stats()["failovers"] == before["failovers"]
        for code in (503, 429):
            first.status = code
            status, body = _call(port, "POST", "/v1/models/m:score", doc)
            assert (status, body["from"]) == (200, second.name)
        first.status = 200
        owner = sup.workers[[s.name for s in stubs].index(first.name)]
        owner.port = second.server_address[1] + 10_000 \
            if second.server_address[1] < 50_000 else 1
        for _ in range(3):
            status, body = _call(port, "POST", "/v1/models/m:score", doc)
            assert (status, body["from"]) == (200, second.name)
        assert owner.breaker.state == resilience.CircuitBreaker.OPEN
        assert trips == [(f"fleet.worker[{owner.wid}]", 3)]
        skipped = fleet_stats()["breaker_routed_around"]
        assert _call(port, "POST", "/v1/models/m:score", doc)[0] == 200
        assert fleet_stats()["breaker_routed_around"] == skipped + 1
    finally:
        telemetry.remove_listener(listener)
        telemetry.disable()
        telemetry.reset()
        router.shutdown()
        for st in stubs:
            st.shutdown()


def test_a_failover_reads_the_ready_set_again(tmp_path):
    """A rolling restart's handover: a request arrives while the worker
    restarted last is still quiesced, so only the next worker is ready;
    that worker answers 503 because its drain began, and meanwhile the
    first is back in the ready set. The router fails over to it (the
    ready set is read again before each attempt) and the client gets 200,
    not the drained worker's 503. (The JAX router fails over only among
    the workers ready when the request came.)"""
    stubs = []
    for i in range(2):
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Stub)
        httpd.name, httpd.status, httpd.hits = f"w{i}", 200, 0
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        stubs.append(httpd)
    sup = FleetSupervisor(str(tmp_path / "p.json"), workers=2,
                          device="cpu", log_dir=str(tmp_path / "logs"))
    for h, st in zip(sup.workers, stubs):
        h.state, h.port, h.proc = fleet_mod.READY, st.server_address[1], \
            _Alive()
    back, draining = sup.workers
    sup._quiesced.add(back.wid)
    stubs[draining.wid].status = 503
    stubs[draining.wid].on_post = lambda: sup._quiesced.discard(back.wid)
    router = serve_fleet_http(sup, port=0, retry_budget=2)
    try:
        before = fleet_stats()
        status, body = _call(router.server_address[1], "POST",
                             "/v1/models/m:score",
                             {"records": [{"x1": 1.0, "x2": 2.0}]})
        assert (status, body["from"]) == (200, stubs[back.wid].name)
        assert [st.hits for st in stubs] == [1, 1]
        after = fleet_stats()
        assert after["failovers"] - before["failovers"] == 1
        assert after["routed_failed"] == before["routed_failed"]
    finally:
        router.shutdown()
        for st in stubs:
            st.shutdown()


def test_router_sheds_503_when_no_worker_is_ready(fleet_env):
    sup = FleetSupervisor(fleet_env["params_path"], workers=2, device="cpu")
    httpd = serve_fleet_http(sup, port=0)
    port = httpd.server_address[1]
    try:
        before = fleet_stats()["shed_503"]
        status, doc = _call(port, "POST", "/v1/models/churn:score",
                            {"records": [{"x1": 1.0, "x2": 2.0}]})
        assert status == 503 and "no ready worker" in doc["error"]
        assert _call(port, "GET", "/readyz")[0] == 503
        assert fleet_stats()["shed_503"] - before >= 1
    finally:
        httpd.shutdown()
        sup.stop(drain=False)


def test_fleet_routes_bitwise_and_aggregates(fleet_env, fleet2):
    """Requests over both tenants through the router: each response
    equals the solo score at its bucket and is within 1e-12 of the JAX
    package's score; the router's probes and ``/stats`` aggregate the
    workers, and the consistent hash used both."""
    sup, _httpd, port = fleet2
    before = fleet_stats()
    recs_all = fleet_env["v1"]["records"]
    for i in range(12):
        name, t = ("churn", fleet_env["v1"]) if i % 2 else \
            ("fraud", fleet_env["v2"])
        recs = recs_all[i * 5:i * 5 + 1 + i % 5]
        status, doc = _call(port, "POST", f"/v1/models/{name}:score",
                            {"records": recs})
        assert status == 200, doc
        assert doc["outputs"] == _oracle(t, recs, doc["bucket"])
        if i < 2:              # the JAX engine builds its program a call
            got = t["engine"].score_store(recs, bucket_min=doc["bucket"],
                                          use_cache=False)[t["pred"]]
            want = jax_scores(t["jax"], recs, t["pred"])
            assert np.abs(np.asarray(got.probability)
                          - np.asarray(want.probability)).max() <= 1e-12
    after = fleet_stats()
    assert after["routed_requests"] - before["routed_requests"] == 12
    assert after["routed_failed"] == before["routed_failed"]
    status, doc = _call(port, "GET", "/healthz")
    assert status == 200 and len(doc["workers"]) == 2
    assert _call(port, "GET", "/readyz")[1]["readyWorkers"] == 2
    status, doc = _call(port, "GET", "/stats")
    assert status == 200 and doc["fleet"]["ready"] == 2
    assert doc["aggregate"]["requests"] >= 12
    served = [w for w in doc["workers"].values() if w.get("server")]
    assert sum(1 for w in served if w["server"]["requests"] > 0) == 2


def test_a_forward_fault_fails_over(fleet_env, fleet2):
    _sup, _httpd, port = fleet2
    plan = resilience.FaultPlan(seed=5).on("fleet.forward", error=OSError,
                                           at=[0])
    before = fleet_stats()["failovers"]
    recs = fleet_env["v1"]["records"][:3]
    with resilience.fault_plan(plan):
        status, doc = _call(port, "POST", "/v1/models/churn:score",
                            {"records": recs})
    assert status == 200 and doc["outputs"] == _oracle(
        fleet_env["v1"], recs, doc["bucket"])
    assert plan.fired("fleet.forward") == 1
    assert fleet_stats()["failovers"] - before == 1


def test_the_canary_routes_a_request_the_same_way_on_either_worker(
        fleet_env, fleet2):
    """A canary of v2 deployed on both workers: each request is sent to
    the candidate by both or by neither, and answered bitwise by that
    version (the server's deterministic hash routing; the router needs
    no part in it)."""
    sup, _httpd, _port = fleet2
    v1, v2 = fleet_env["v1"], fleet_env["v2"]
    ports = [h.port for h in sup.ready_workers()]
    assert len(ports) == 2
    for p in ports:
        status, doc = _call(p, "POST", "/v1/models/churn:deploy",
                            {"version": v2["vid"], "mode": "canary",
                             "fraction": 0.5, "windowRequests": 10_000})
        assert status == 200, doc
    try:
        flags = []
        for i in range(16):
            recs = v1["records"][40 + 3 * i:43 + 3 * i]
            seen = [_call(p, "POST", "/v1/models/churn:score",
                          {"records": recs})[1] for p in ports]
            assert seen[0]["canary"] == seen[1]["canary"]
            flags.append(seen[0]["canary"])
            t = v2 if seen[0]["canary"] else v1
            for doc in seen:
                assert doc["outputs"] == _oracle(t, recs, doc["bucket"])
        assert any(flags) and not all(flags)
    finally:
        for p in ports:
            assert _call(p, "POST", "/v1/models/churn:rollback")[0] == 200
    assert fleet_env["registry"].current("churn") == v1["vid"]


def _load(port, recs_all, results, lock, stop, k, names=("churn",)):
    i = 0
    while not stop.is_set():
        lo = (k * 53 + i * 17) % (len(recs_all) - 6)
        recs = recs_all[lo:lo + 2 + i % 4]
        name = names[(k + i) % len(names)]
        status, doc = _call(port, "POST", f"/v1/models/{name}:score",
                            {"records": recs})
        with lock:
            results.append((name, status, recs, doc))
        i += 1
        time.sleep(0.01)


def _under_load(port, fleet_env, action, names=("churn",)):
    results, lock, stop = [], threading.Lock(), threading.Event()
    threads = [threading.Thread(target=_load, args=(
        port, fleet_env["v1"]["records"], results, lock, stop, k, names),
        daemon=True, name=f"fleet-client-{k}") for k in range(2)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.3)
        action()
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=240)
    return results


def test_a_drained_restart_loses_zero_requests(fleet_env, fleet2):
    sup, _httpd, port = fleet2
    before = fleet_stats()["drained_restarts"]
    results = _under_load(port, fleet_env, lambda: sup.restart_worker(
        sup.workers[1], ready_timeout_s=240))
    assert fleet_stats()["drained_restarts"] - before == 1
    assert results and not [r for r in results if r[1] != 200]
    for _name, _status, recs, doc in results:
        assert doc["outputs"] == _oracle(fleet_env["v1"], recs,
                                         doc["bucket"])
    assert len(sup.ready_workers()) == 2


#: a restarted worker's first load of each tenant, stretched past the
#: forward timeout of the router in the test below
_SLOW_LOAD_S = 6.0
_SLOW_SITE = f'''\
import time
from transmogrifai_tpu_torch import server as _server
_load = _server.ModelServer._ensure_loaded


def _slow_load(self, entry):
    if entry.model is None:
        time.sleep({_SLOW_LOAD_S})
    return _load(self, entry)


_server.ModelServer._ensure_loaded = _slow_load
'''


def test_a_rolling_restart_of_slow_loading_workers_loses_zero_requests(
        fleet_env, fleet2, tmp_path):
    """A restarted worker loads its tenants before it answers ``/readyz``
    (the supervisor starts ``serve --preload``), so while a rolling
    restart quiesces its sibling the router never sends it a request that
    would wait for a load. Here every load of the restarted workers takes
    ``_SLOW_LOAD_S`` (a ``sitecustomize`` on their ``PYTHONPATH``) and the
    router's forward timeout is half of that: no request fails, each is
    bitwise solo, and each restarted worker reports both tenants loaded,
    ``fraud`` too, which the load never asks for. (The JAX
    ``rolling_restart`` restarts one worker at a time the same way; its
    workers load on the first request.)"""
    sup, _httpd, _port = fleet2
    (tmp_path / "sitecustomize.py").write_text(_SLOW_SITE)
    router = serve_fleet_http(sup, port=0, retry_budget=3,
                              forward_timeout_s=_SLOW_LOAD_S / 2)
    before = fleet_stats()["drained_restarts"]
    sup.spawn_env = {"PYTHONPATH": str(tmp_path)}
    try:
        results = _under_load(router.server_address[1], fleet_env,
                              lambda: sup.rolling_restart(
                                  ready_timeout_s=240))
    finally:
        sup.spawn_env = None
        router.shutdown()
    assert fleet_stats()["drained_restarts"] - before == 2
    assert results and not [r[1] for r in results if r[1] != 200]
    for _name, _status, recs, doc in results:
        assert doc["outputs"] == _oracle(fleet_env["v1"], recs,
                                         doc["bucket"])
    assert len(sup.ready_workers()) == 2
    for h in sup.workers:
        ready = _call(h.port, "GET", "/readyz")[1]
        assert sorted(ready["loadedModels"]) == ["churn", "fraud"], ready


def test_sigkill_fails_over_respawns_and_rejoins_on_the_promoted_pointer(
        fleet_env, fleet2):
    """SIGKILL one worker under load: no client request fails (the
    sibling takes them), the supervisor respawns it, the pointer promoted
    during the outage is intact and promotable by a new handle, and the
    respawned worker serves the promoted version bitwise. (A fresh
    interpreter reading the pointer after a holder's SIGKILL is
    ``tests/test_torch_lifecycle.py``'s.)"""
    sup, _httpd, port = fleet2
    reg, v1, v2 = fleet_env["registry"], fleet_env["v1"], fleet_env["v2"]
    # every worker loads both tenants first, so the survivors keep
    # serving the version they loaded across the promote
    for h in sup.ready_workers():
        for name in ("churn", "fraud"):
            assert _call(h.port, "POST", f"/v1/models/{name}:score",
                         {"records": v1["records"][:2]})[0] == 200
    victim = sup.workers[0]
    spawns, respawned = victim.spawns, fleet_stats()["workers_respawned"]

    def kill_and_promote():
        victim.proc.send_signal(signal.SIGKILL)
        reg.promote("churn", v2["vid"])
        time.sleep(1.0)

    try:
        results = _under_load(port, fleet_env, kill_and_promote,
                              names=("churn", "fraud"))
        assert len(results) >= 20
        assert not [r for r in results if r[1] != 200]
        for name, _status, recs, doc in results:
            t = v1 if name == "churn" else v2
            assert doc["outputs"] == _oracle(t, recs, doc["bucket"])
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline and not (
                victim.spawns > spawns and victim.state == fleet_mod.READY):
            time.sleep(0.05)
        assert victim.state == fleet_mod.READY, victim.status()
        assert fleet_stats()["workers_respawned"] - respawned >= 1
        fresh = ModelRegistry(fleet_env["registry_dir"])
        assert fresh.current("churn") == v2["vid"]
        assert fresh.promote("churn", v2["vid"])["current"] == v2["vid"]
        recs = v1["records"][:5]
        status, doc = _call(victim.port, "POST", "/v1/models/churn:score",
                            {"records": recs})
        assert status == 200
        assert doc["outputs"] == _oracle(v2, recs, doc["bucket"])
        assert doc["outputs"] != _oracle(v1, recs, doc["bucket"])
    finally:
        reg.promote("churn", v1["vid"])


@pytest.mark.parametrize("key,val", [
    ("fleetWorkers", 0), ("fleetWorkers", 2.5),
    ("fleetBasePort", "ephemeral"), ("workerRespawnMax", -1),
    ("routerRetryBudget", "lots")])
def test_the_fleet_command_refuses_bad_knobs_as_the_jax_one(
        tmp_path, capsys, key, val):
    """``fleet`` and ``check`` name a malformed fleet knob and exit 1, as
    the JAX command line does, before any worker starts."""
    from transmogrifai_tpu import cli as jcli
    from transmogrifai_tpu_torch import cli as pcli
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"customParams": {key: val}}))
    for cli in (pcli, jcli):
        assert cli.run_check(str(p)) == 1
        assert "TMG001" in capsys.readouterr().out
        assert cli.run_fleet(str(p)) == 1
        assert key in capsys.readouterr().out
    assert pcli.run_fleet(None) == 1
    p.write_text("{}")
    assert pcli.run_fleet(str(p), workers=0) == 1
    assert pcli.run_fleet(str(p), device="tpu") == 1
    out = capsys.readouterr().out
    assert "--workers must be >= 1" in out and "--device" in out


def test_the_fleet_command_serves_records_and_traces(fleet_env, tmp_path):
    """``python -m transmogrifai_tpu_torch fleet --workers 1 --device
    cpu`` as a user runs it, with ``workloadDir`` and ``traceDir``: the
    router answers bitwise, SIGHUP restarts the worker (drained) and it
    answers again, SIGTERM drains the fleet, ``workload merge``
    combines the router's record and the worker's into one (the routing
    decision beside the payload), and ``trace analyze`` finds the
    request rooted at the router's ``fleet:route`` span."""
    from transmogrifai_tpu_torch import workload
    from transmogrifai_tpu_torch.cli import main
    wdir, tdir = tmp_path / "wl", tmp_path / "traces"
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"customParams": {
        "registryDir": fleet_env["registry_dir"],
        "serveBucketCap": BUCKET_CAP, "workloadDir": str(wdir),
        "traceDir": str(tdir)}}))
    port_file = tmp_path / "port.txt"
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "fleet",
         str(params), "--workers", "1", "--device", "cpu", "--port", "0",
         "--port-file", str(port_file)], cwd=str(tmp_path), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 240
        while not port_file.exists() and proc.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert port_file.exists(), proc.communicate(timeout=60)[0][-3000:]
        port = int(port_file.read_text())
        recs = fleet_env["v1"]["records"][:4]
        status, doc = _call(port, "POST", "/v1/models/churn:score",
                            {"records": recs})
        assert status == 200
        assert doc["outputs"] == _oracle(fleet_env["v1"], recs,
                                         doc["bucket"])
        # SIGHUP: a rolling restart (one drained restart a worker)
        proc.send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 240
        while time.monotonic() < deadline:
            fleet = _call(port, "GET", "/stats")[1]["fleet"]
            if fleet["fleet"]["drained_restarts"] == 1 and \
                    fleet["ready"] == 1:
                break
            time.sleep(0.1)
        assert fleet["workers"][0]["spawns"] == 2, fleet
        status, doc = _call(port, "POST", "/v1/models/churn:score",
                            {"records": recs})
        assert status == 200 and doc["outputs"] == _oracle(
            fleet_env["v1"], recs, doc["bucket"])
        proc.send_signal(signal.SIGTERM)
        out = proc.communicate(timeout=120)[0]
        assert proc.returncode == 0, out[-3000:]
        assert "on cpu" in out and "draining" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    merged = workload.merge_workload_shards(str(wdir))
    assert merged["mergedShards"] == 3 and merged["requests"] == 2
    for rec in merged["records"]:
        assert rec["sources"] == ["router", "worker"]
        assert rec["route"]["worker"] == 0 and rec["payload"] == recs
    assert main(["trace", "analyze", str(tdir)]) == 0
    a = workload.analyze_trace(str(tdir))
    assert a["requests"] == 2
    assert a["slowest"][0]["path"][0]["name"] == "fleet:route"
