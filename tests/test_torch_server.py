"""The port's model server (``transmogrifai_tpu_torch/server.py``) on the
CPU, held against the JAX package's server behaviour and scores.

The tenants are the two-feature logistic regressions of
``tests/test_server.py`` (``tests/_torch_server_data.py``): trained by the
JAX package on one device, loaded into the port, exported with a program
bank by the port. Merged responses are bitwise equal to the port's solo
``score_store(bucket_min=)`` and within 1e-12 of the JAX package's scores.
The JAX oracle tests ``test_server.py::test_roundtrip_coalescing_and_bank_
cold_start`` and ``::test_lru_evicts_and_reloads`` fail on this tree (the
8-device mesh), so the JAX behaviours they hold are held here against the
JAX server's functions and tallies instead: admission control (429), an
unknown model (404), a closed server (503), a timeout (504), the draining
shutdown, LRU eviction mid-dispatch, the HTTP routes, and the key sets of
``server_stats()`` and ``readiness()``. The port has no host tier: a
device-marked failure fails its batch and never reaches
``WorkflowModel.score(engine=False)``."""
import http.client
import json
import os
import threading
import time

import numpy as np
import pytest

from transmogrifai_tpu import server as jserver
from transmogrifai_tpu_torch import resilience, telemetry
from transmogrifai_tpu_torch import server as server_mod
from transmogrifai_tpu_torch.server import (ModelNotFound, ModelServer,
                                            ServerBusy, ServerClosed,
                                            serve_http, server_stats)
from transmogrifai_tpu_torch.workflow import WorkflowModel

from _torch_server_data import (BUCKET_CAP, assert_bitwise, jax_scores,
                                tenant)


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    out = {}
    for name, seed in (("A", 11), ("B", 12)):
        out[name] = tenant(seed,
                           str(tmp_path_factory.mktemp(f"model{name}")),
                           str(tmp_path_factory.mktemp(f"export{name}")))
    return out


def _server(tenants, **kw):
    kw.setdefault("bucket_cap", BUCKET_CAP)
    kw.setdefault("batch_deadline_s", 0.02)
    kw.setdefault("device", "cpu")
    srv = ModelServer(**kw)
    for name, t in tenants.items():
        srv.register(name, model_dir=t["model_dir"],
                     bank_dir=t["export_dir"])
    return srv


class _Held(ModelServer):
    """The first dispatch of tenant A waits on ``gate`` (``released`` is
    set when it starts), so what is queued is deterministic."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.gate = threading.Event()
        self.released = threading.Event()

    def _hold(self, entry):
        if entry.name == "A":
            self.released.set()
            self.gate.wait(timeout=60)

    def _dispatch(self, entry, batch):
        self._hold(entry)
        super()._dispatch(entry, batch)


class _HeldLoaded(_Held):
    """Holds A's dispatch after its model and engine were loaded and
    captured, just before it scores."""

    def _dispatch(self, entry, batch):
        ModelServer._dispatch(self, entry, batch)

    def _dispatch_group(self, entry, batch, *a, **kw):
        self._hold(entry)
        return super()._dispatch_group(entry, batch, *a, **kw)


def _held(cls=_Held, **kw):
    kw.setdefault("bucket_cap", BUCKET_CAP)
    kw.setdefault("batch_deadline_s", 0.0)
    kw.setdefault("device", "cpu")
    return cls(**kw)


# ---------------------------------------------------------------------------
# merged batches: bitwise to solo, within 1e-12 of the JAX package
# ---------------------------------------------------------------------------


def test_merged_responses_are_bitwise_solo_and_match_the_jax_package(
        tenants):
    """Four client threads of mixed-tenant traffic: every response equals
    the port's solo ``score_store(bucket_min=bucket)`` bitwise and the JAX
    package's engine within 1e-12; the banks answer every bucket (no
    program built) and requests merge."""
    srv = _server(tenants, slo_ms=5000)
    results, lock = [], threading.Lock()
    before = server_stats()

    def client(k):
        rng = np.random.default_rng(100 + k)
        for i in range(6):
            nm = "A" if (k + i) % 2 == 0 else "B"
            lo = int(rng.integers(0, 150))
            recs = tenants[nm]["records"][lo:lo + int(rng.integers(1, 9))]
            fut = srv.submit(nm, recs)
            with lock:
                results.append((nm, recs, fut))

    try:
        threads = [threading.Thread(target=client, args=(k,),
                                    name=f"client-{k}", daemon=True)
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        done = [(nm, recs, f.result(timeout=60)) for nm, recs, f in results]
    finally:
        srv.shutdown(drain=True)
    for nm, recs, res in done:
        assert res.rows == len(recs) and res.engine_tier
        t = tenants[nm]
        solo = srv._entries[nm].engine.score_store(recs,
                                                   bucket_min=res.bucket)
        assert_bitwise(res.store[t["pred"]], solo[t["pred"]])
        want = jax_scores(t["jax"], recs, t["pred"])
        got = res.store[t["pred"]]
        np.testing.assert_array_equal(got.prediction, want.prediction)
        np.testing.assert_allclose(got.probability, want.probability,
                                   rtol=0, atol=1e-12)
    after = server_stats()
    d = {k: after[k] - before[k] for k in
         ("requests", "batches", "bank_hit_batches", "model_loads",
          "bank_loads", "slo_met")}
    assert d["requests"] == len(done) == d["slo_met"]
    assert 0 < d["batches"] < len(done)
    assert d["bank_hit_batches"] == d["batches"]
    assert d["model_loads"] == 2 and d["bank_loads"] == 2
    assert all(e.engine.compile_count == 0 for e in srv._entries.values())
    doc = srv.stats()
    assert doc["models"]["A"]["bankBuckets"] == [8, 16, 32, 64]
    assert set(doc["models"]["A"]["latency"]) == {
        "e2e", "queueWait", "coalesceHold", "deviceDispatch", "scatter"}


def test_tally_and_readiness_keys_equal_the_jax_servers(tenants):
    """``server_stats()``, ``readiness()`` and the per-model stats carry
    the JAX server's keys."""
    assert set(server_stats()) == set(jserver.server_stats())
    srv = _server(tenants)
    try:
        srv.score("A", tenants["A"]["records"][:2], timeout_s=60)
        doc = srv.readiness()
        assert doc["ready"] and doc["models"] == 2 and not doc["reasons"]
        jsrv = jserver.ModelServer()
        try:
            assert set(doc) == set(jsrv.readiness())
            assert set(srv.stats()) == set(jsrv.stats())
        finally:
            jsrv.shutdown(drain=True)
        jentry = jserver._ModelEntry("A", None, None, None, 1)
        jentry.latencies.append(0.01)
        assert set(srv.stats()["models"]["A"]) == set(jentry.stats())
    finally:
        srv.shutdown(drain=True)


# ---------------------------------------------------------------------------
# admission control, shutdown, LRU
# ---------------------------------------------------------------------------


def test_unknown_model_closed_server_and_backpressure(tenants):
    srv = _held(max_queue=2)
    srv.register("A", model_dir=tenants["A"]["model_dir"])
    recs = tenants["A"]["records"]
    try:
        with pytest.raises(ModelNotFound):
            srv.submit("nope", [{"x1": 1.0}])
        before = server_stats()["rejected"]
        f0 = srv.submit("A", recs[:2])          # the worker takes it
        assert srv.released.wait(timeout=60)    # and is held
        f1, f2 = srv.submit("A", recs[2:4]), srv.submit("A", recs[4:6])
        with pytest.raises(ServerBusy):
            srv.submit("A", recs[6:8])          # the queue holds two
        assert server_stats()["rejected"] - before == 1
        assert not srv.readiness()["ready"]     # no headroom left
        srv.gate.set()
        assert [f.result(timeout=60).rows for f in (f0, f1, f2)] == [2] * 3
    finally:
        srv.gate.set()
        srv.shutdown(drain=True)
    with pytest.raises(ServerClosed):
        srv.submit("A", recs[:1])
    srv.shutdown(drain=True)                    # idempotent


def test_draining_shutdown_scores_every_queued_request(tenants):
    """A long hold leaves requests queued when shutdown lands; the drain
    scores every one, bitwise as solo."""
    srv = _server(tenants, batch_deadline_s=30.0)
    futs = [(nm, tenants[nm]["records"][i * 2:(i + 1) * 2],
             srv.submit(nm, tenants[nm]["records"][i * 2:(i + 1) * 2]))
            for i in range(3) for nm in ("A", "B")]
    t0 = time.perf_counter()
    srv.shutdown(drain=True, timeout_s=120)
    assert time.perf_counter() - t0 < 30
    for nm, recs, f in futs:
        res = f.result(timeout=1)
        solo = srv._entries[nm].engine.score_store(recs,
                                                   bucket_min=res.bucket)
        assert_bitwise(res.store[tenants[nm]["pred"]],
                       solo[tenants[nm]["pred"]])


def test_no_drain_fails_queued_requests(tenants):
    srv = _held()
    srv.register("A", model_dir=tenants["A"]["model_dir"])
    recs = tenants["A"]["records"]
    try:
        f0 = srv.submit("A", recs[:2])
        assert srv.released.wait(timeout=60)
        queued = [srv.submit("A", recs[:2]) for _ in range(2)]
        stopper = threading.Thread(
            target=lambda: srv.shutdown(drain=False, timeout_s=120),
            name="test-stopper", daemon=True)
        stopper.start()
        for f in queued:
            with pytest.raises(ServerClosed):
                f.result(timeout=60)
        srv.gate.set()
        stopper.join(timeout=120)
        assert f0.result(timeout=60).rows == 2
    finally:
        srv.gate.set()
        srv.shutdown(drain=False)


def test_lru_eviction_in_the_middle_of_a_dispatch(tenants):
    """An eviction that lands while A's dispatch is in flight does not
    pull the engine from under it: the batch scores through the captured
    engine, the worker lives, A reloads (its bank again, no program
    built) and scores bitwise; the LRU weight is the bank's bytes with a
    1 MiB floor."""
    from transmogrifai_tpu_torch import aot
    srv = _held(_HeldLoaded, max_models=1)
    srv.register("A", model_dir=tenants["A"]["model_dir"],
                 bank_dir=tenants["A"]["export_dir"])
    srv.register("B", model_dir=tenants["B"]["model_dir"],
                 bank_dir=tenants["B"]["export_dir"])
    recs = tenants["A"]["records"][:3]
    before = server_stats()
    try:
        fa = srv.submit("A", recs)
        assert srv.released.wait(timeout=60)    # A's dispatch in flight
        srv.score("B", tenants["B"]["records"][:3], timeout_s=60)
        assert srv._entries["A"].model is None  # evicted mid-dispatch
        srv.gate.set()
        first = fa.result(timeout=60)
        again = srv.score("A", recs, timeout_s=60)
        entry = srv._entries["A"]
        solo = entry.engine.score_store(recs, bucket_min=again.bucket)
        pred = tenants["A"]["pred"]
        assert_bitwise(first.store[pred], solo[pred])
        assert_bitwise(again.store[pred], solo[pred])
        assert entry.engine.compile_count == 0
        d = server_stats()
        assert d["model_evictions"] - before["model_evictions"] >= 2
        assert d["model_loads"] - before["model_loads"] >= 3
        manifest, _ = aot.read_manifest(tenants["A"]["export_dir"])
        assert entry.weight_bytes == max(aot.bank_bytes(manifest), 1 << 20)
    finally:
        srv.gate.set()
        srv.shutdown(drain=True)


def test_a_live_model_is_pinned(tenants):
    srv = ModelServer(max_models=1, batch_deadline_s=0.0,
                      bucket_cap=BUCKET_CAP, device="cpu")
    srv.register("live", model=tenants["A"]["model"])
    srv.register("B", model_dir=tenants["B"]["model_dir"])
    try:
        srv.score("B", tenants["B"]["records"][:3], timeout_s=60)
        assert srv._entries["live"].model is not None
        assert srv.score("live", tenants["A"]["records"][:3],
                         timeout_s=60).rows == 3
    finally:
        srv.shutdown(drain=True)


# ---------------------------------------------------------------------------
# the dispatch rule: no host tier
# ---------------------------------------------------------------------------


@pytest.mark.chaos
def test_server_dispatch_fault_quarantines_the_poisoned_request_only(
        tenants):
    """A ``server.dispatch`` fault on a merged batch (call 1; call 0 is a
    held request's own dispatch) and on the first request's retry alone
    (call 2): that request is quarantined
    with the error on its future; its co-riders are scored one at a time
    through the same engine, bitwise as solo at the dispatch's bucket;
    the worker serves on."""
    srv = _held(batch_deadline_s=0.05)
    srv.register("A", model_dir=tenants["A"]["model_dir"],
                 bank_dir=tenants["A"]["export_dir"])
    recs = tenants["A"]["records"]
    reqs = [recs[0:3], recs[3:5], recs[5:9]]
    plan = resilience.FaultPlan(seed=5).on("server.dispatch",
                                           error=RuntimeError, at=[1, 2])
    q0 = resilience.resilience_stats()["quarantined_batches"]
    s0 = server_stats()
    try:
        with resilience.fault_plan(plan):
            first = srv.submit("A", recs[20:21])     # held alone
            assert srv.released.wait(timeout=60)
            futs = [srv.submit("A", r) for r in reqs]
            srv.gate.set()
            assert first.result(timeout=60).rows == 1
            with pytest.raises(RuntimeError):
                futs[0].result(timeout=60)
            res = [f.result(timeout=60) for f in futs[1:]]
        assert plan.fired("server.dispatch") == 2
        engine = srv._entries["A"].engine
        pred = tenants["A"]["pred"]
        for r, got in zip(reqs[1:], res):
            assert got.engine_tier and got.coalesced == 3
            assert_bitwise(got.store[pred], engine.score_store(
                r, bucket_min=got.bucket)[pred])
        assert resilience.resilience_stats()["quarantined_batches"] \
            - q0 == 1
        d = server_stats()
        assert d["quarantined_requests"] - s0["quarantined_requests"] == 1
        assert srv.score("A", recs[:2], timeout_s=60).rows == 2
    finally:
        srv.gate.set()
        srv.shutdown(drain=True)


@pytest.mark.chaos
def test_a_device_failure_fails_its_batch_and_scores_nothing_on_the_host(
        tenants, monkeypatch):
    """A device-marked failure at dispatch (``scoring.device_dispatch``)
    fails every future of its batch with that error: nothing is
    quarantined, nothing is retried, and ``WorkflowModel.score`` is never
    called with ``engine=False`` (the spy)."""
    layer_calls = []
    real = WorkflowModel.score

    def spy(self, data, *a, **kw):
        if kw.get("engine") is False:
            layer_calls.append(kw)
        return real(self, data, *a, **kw)

    monkeypatch.setattr(WorkflowModel, "score", spy)
    srv = _held(batch_deadline_s=0.05)
    srv.register("A", model_dir=tenants["A"]["model_dir"],
                 bank_dir=tenants["A"]["export_dir"])
    recs = tenants["A"]["records"]
    plan = resilience.FaultPlan(seed=3).on("scoring.device_dispatch",
                                           error=RuntimeError, at=[1])
    q0 = resilience.resilience_stats()
    s0 = server_stats()
    try:
        with resilience.fault_plan(plan):
            first = srv.submit("A", recs[:1])
            assert srv.released.wait(timeout=60)
            futs = [srv.submit("A", recs[i:i + 2]) for i in (2, 4, 6)]
            srv.gate.set()
            assert first.result(timeout=60).rows == 1
            errs = []
            for f in futs:
                with pytest.raises(RuntimeError) as ei:
                    f.result(timeout=60)
                errs.append(ei.value)
        assert all(resilience.is_device_failure(e) for e in errs)
        assert len({id(e) for e in errs}) == 1     # the one device error
        assert plan.fired("scoring.device_dispatch") == 1
        q1 = resilience.resilience_stats()
        assert q1["quarantined_batches"] == q0["quarantined_batches"]
        d = server_stats()
        assert d["requests_failed"] - s0["requests_failed"] == 3
        assert d["quarantined_requests"] == s0["quarantined_requests"]
        assert layer_calls == []
        # the worker lives; the next batch scores through the engine
        assert srv.score("A", recs[:2], timeout_s=60).engine_tier
    finally:
        srv.gate.set()
        srv.shutdown(drain=True)


def test_a_tenant_whose_engine_fuses_nothing_scores_by_layers(
        tenants, monkeypatch):
    """Routing, not a fallback: a tenant whose engine fuses nothing is
    scored by layers on the server's device (``engine_tier`` False), the
    rows equal to ``model.score(engine=False)`` on that device."""
    from transmogrifai_tpu_torch.scoring import ScoringEngine
    monkeypatch.setattr(ScoringEngine, "enabled", lambda self: False)
    srv = ModelServer(device="cpu", bucket_cap=BUCKET_CAP,
                      batch_deadline_s=0.0)
    srv.register("A", model_dir=tenants["A"]["model_dir"],
                 bank_dir=tenants["A"]["export_dir"])
    recs = tenants["A"]["records"][:5]
    try:
        res = srv.score("A", recs, timeout_s=60)
        assert res.engine_tier is False and srv._entries["A"].engine is None
        pred = tenants["A"]["pred"]
        assert_bitwise(res.store[pred], tenants["A"]["model"].score(
            recs, device="cpu", engine=False)[pred])
    finally:
        srv.shutdown(drain=True)


# ---------------------------------------------------------------------------
# telemetry, HTTP
# ---------------------------------------------------------------------------


def test_on_request_listener_and_instruments(tenants):
    telemetry.enable()
    try:
        collector = telemetry.add_listener(
            telemetry.CollectingRunListener())
        srv = _server(tenants, slo_ms=5000)
        try:
            srv.score("A", tenants["A"]["records"][:4], timeout_s=60)
        finally:
            srv.shutdown(drain=True)
        summary = collector.summary()
        assert summary["requests"] == 1 and summary["requestRows"] == 4
        assert summary["requestsFailed"] == 0
        doc = telemetry.metrics_json()
        assert doc["server.requests"] >= 1
        assert "server.request_seconds.A" in doc
        assert "server.device_dispatch_seconds.A" in doc
    finally:
        telemetry.disable()
        telemetry.reset()


def _call(host, port, method, path, body=None, headers=None, timeout=60):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json",
                      **(headers or {})})
        r = conn.getresponse()
        raw = r.read()
        ctype = r.getheader("Content-Type", "")
        doc = (json.loads(raw or b"{}") if "json" in ctype
               else raw.decode())
        return r.status, doc, dict(r.getheaders())
    finally:
        conn.close()


def test_http_routes(tenants):
    """The front end's routes and status codes: score (the echoed trace
    header, the outputs bitwise as the in-process response), 400, 404,
    /healthz, /readyz, /stats with the latency decomposition, /v1/models,
    /metrics, and 503 once shutdown began."""
    srv = _server(tenants, slo_ms=5000)
    httpd = serve_http(srv, port=0)
    host, port = httpd.server_address
    try:
        status, doc, _ = _call(host, port, "GET", "/healthz")
        assert status == 200 and sorted(doc["models"]) == ["A", "B"]
        status, doc, _ = _call(host, port, "GET", "/readyz")
        assert status == 200 and doc["ready"] is True
        hdr = telemetry.format_traceparent(*telemetry.mint_trace())
        recs = tenants["A"]["records"][:3]
        status, doc, headers = _call(
            host, port, "POST", "/v1/models/A:score", {"records": recs},
            {telemetry.TRACE_HEADER: hdr})
        assert status == 200 and doc["rows"] == 3
        assert headers.get(telemetry.TRACE_HEADER) == hdr
        assert doc["engineTier"] is True and doc["canary"] is False
        assert set(doc["phases"]) >= {"e2e", "queueWait",
                                      "deviceDispatch"}
        pred = tenants["A"]["pred"]
        solo = srv._entries["A"].engine.score_store(
            recs, bucket_min=doc["bucket"])[pred]
        assert [o[pred]["prediction"] for o in doc["outputs"]] == \
            [solo.get_raw(i)["prediction"] for i in range(3)]
        for path, body in (("/v1/models/nope:score", {"records": [{}]}),
                           ("/v1/models/A:nothing", {}),
                           ("/elsewhere", {})):
            assert _call(host, port, "POST", path, body)[0] == 404
        assert _call(host, port, "POST", "/v1/models/A:score",
                     {"records": []})[0] == 400
        assert _call(host, port, "GET", "/nothing")[0] == 404
        status, doc, _ = _call(host, port, "GET", "/stats")
        assert status == 200 and "A" in doc["models"]
        assert doc["models"]["A"]["latency"]["deviceDispatch"]
        status, doc, _ = _call(host, port, "GET", "/v1/models")
        assert status == 200 and set(doc["models"]) == {"A", "B"}
        status, text, _ = _call(host, port, "GET", "/metrics")
        assert status == 200
        parsed = telemetry.parse_prometheus(text)
        assert "server_tally_requests" in parsed
        status, _, _ = _call(host, port, "GET", "/v1/models/ghost/versions")
        assert status == 404
        srv.shutdown(drain=True)
        status, doc, _ = _call(host, port, "GET", "/healthz")
        assert status == 503 and doc["status"] == "draining"
        status, doc, _ = _call(host, port, "GET", "/readyz")
        assert status == 503 and "closing" in doc["reasons"]
        assert _call(host, port, "POST", "/v1/models/A:score",
                     {"records": recs})[0] == 503
    finally:
        httpd.shutdown()
        srv.shutdown(drain=True)


def test_http_backpressure_429_and_timeout_504(tenants):
    """A held dispatch: a request that outlives the timeout answers 504
    (tallied; its future is cancelled or its late completion counted),
    and a full queue answers 429."""
    srv = _held(max_queue=1)
    srv.register("A", model_dir=tenants["A"]["model_dir"])
    httpd = serve_http(srv, port=0, request_timeout_s=0.3)
    host, port = httpd.server_address
    recs = tenants["A"]["records"][:2]
    before = server_stats()
    try:
        status, doc, _ = _call(host, port, "POST", "/v1/models/A:score",
                               {"records": recs})
        assert status == 504 and "timed out after 0.3s" in doc["error"]
        assert srv.released.wait(timeout=60)
        srv.submit("A", recs)                   # fills the queue
        assert _call(host, port, "POST", "/v1/models/A:score",
                     {"records": recs})[0] == 429
        d = server_stats()
        assert d["requests_timed_out"] - before["requests_timed_out"] == 1
        assert d["rejected"] - before["rejected"] == 1
        srv.gate.set()
        srv.shutdown(drain=True, timeout_s=120)
        assert server_stats()["timed_out_completions"] \
            - before["timed_out_completions"] in (0, 1)
    finally:
        srv.gate.set()
        httpd.shutdown()
        srv.shutdown(drain=True)


# ---------------------------------------------------------------------------
# params-file construction (cli)
# ---------------------------------------------------------------------------


def test_build_server_from_params(tenants):
    from transmogrifai_tpu_torch.cli import build_server_from_params
    from transmogrifai_tpu_torch.runner import OpParams
    params = OpParams(
        model_location=tenants["A"]["model_dir"],
        custom_params={
            "serveModels": {"B": {"model": tenants["B"]["model_dir"],
                                  "bank": tenants["B"]["export_dir"]}},
            "serveBank": tenants["A"]["export_dir"],
            "serveBatchDeadlineMs": 1, "serveMaxQueue": 16,
            "serveMaxModels": 2, "serveSloMs": 5000,
            "serveBucketCap": BUCKET_CAP})
    srv = build_server_from_params(params, device="cpu")
    try:
        assert sorted(srv.models()) == ["B", "default"]
        assert srv.slo_ms == 5000 and srv.max_queue == 16
        assert srv.batch_deadline_s == pytest.approx(0.001)
        res = srv.score("default", tenants["A"]["records"][:3],
                        timeout_s=60)
        assert res.rows == 3
        assert srv._entries["default"].engine.compile_count == 0
    finally:
        srv.shutdown(drain=True)


@pytest.mark.parametrize("key,val", [
    ("serveBatchDeadlineMs", "soon"), ("serveMaxQueue", 2.5),
    ("serveMaxModels", 0), ("serveSloMs", float("nan")),
    ("serveBucketCap", 4), ("canaryFraction", 1.5),
])
def test_serve_knob_validation_names_the_key(tenants, key, val):
    """A malformed knob names its key before any model loads, as the JAX
    package's ``build_server_from_params`` does."""
    from transmogrifai_tpu.cli import build_server_from_params as jbuild
    from transmogrifai_tpu.runner import OpParams as JOpParams
    from transmogrifai_tpu_torch.cli import build_server_from_params
    from transmogrifai_tpu_torch.runner import OpParams
    for build, P, kw in ((build_server_from_params, OpParams,
                          {"device": "cpu"}), (jbuild, JOpParams, {})):
        params = P(model_location=tenants["A"]["model_dir"],
                   custom_params={key: val})
        with pytest.raises(ValueError, match=key):
            build(params, **kw)


@pytest.mark.parametrize("key,val,module", [
    ("workloadDir", "/nowhere", "workload.py"),
    ("retrainOnDrift", True, "continual.py")])
def test_unported_serve_knobs_raise_naming_their_item(tenants, key, val,
                                                      module, tmp_path):
    """The two knobs that raised before ``workload.py`` and
    ``continual.py`` were ported (the name is kept from then), each wired
    into its module: the server builds with either (``serve`` wires them,
    not the server), ``workloadDir`` (here under ``tmp_path``) installs
    ``workload``'s flight recorder there, and ``retrainOnDrift`` without a
    trainer command fails loudly naming ``retrainCmd`` with
    ``continual.validate_retrain_cmd``'s reason, as in the JAX package's
    ``build_retrain_controllers``."""
    import importlib
    from transmogrifai_tpu_torch import workload
    from transmogrifai_tpu_torch.cli import (_start_workload_recorder,
                                             build_retrain_controllers,
                                             build_server_from_params)
    from transmogrifai_tpu_torch.runner import OpParams
    if key == "workloadDir":
        val = str(tmp_path / val.strip("/"))
    params = OpParams(model_location=tenants["A"]["model_dir"],
                      custom_params={key: val, "registryDir":
                                     str(tmp_path / "reg"),
                                     "driftWindow": 64})
    mod = importlib.import_module(
        "transmogrifai_tpu_torch." + module[:-len(".py")])
    srv = build_server_from_params(params, device="cpu")
    try:
        assert srv.models() == ["default"]
        if key == "workloadDir":
            assert _start_workload_recorder(params, "worker") == val
            assert mod.recording_enabled()
            assert mod.recorder().dir == val and os.path.isdir(val)
            mod.stop_recorder()
        else:
            with pytest.raises(mod.ContinualError) as why:
                mod.validate_retrain_cmd(None)
            with pytest.raises(ValueError, match="retrainCmd") as e:
                build_retrain_controllers(params, srv)
            assert str(why.value) in str(e.value)
    finally:
        workload.stop_recorder()
        srv.shutdown(drain=False)


def test_run_serve_answers_traces_and_drains_on_sigterm(tenants, tmp_path,
                                                        capsys):
    """``run_serve`` on the CPU as the command runs it: the port file holds
    the bound port, a request with a minted trace header is answered
    bitwise as solo, SIGTERM drains, the trace shard lands in
    ``traceDir`` and ``trace merge`` finds ``server:request`` and
    ``server:dispatch`` under the minted trace id; bad params exit 1
    naming the key."""
    import os
    import signal

    from transmogrifai_tpu_torch.cli import main, run_serve
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"customParams": {"serveMaxQueue": "lots"}}))
    assert run_serve(str(p), device="cpu") == 1
    assert "serveMaxQueue" in capsys.readouterr().out
    p.write_text(json.dumps({}))
    assert run_serve(str(p), device="cpu") == 1
    assert "no models" in capsys.readouterr().out

    trace_dir, port_file = tmp_path / "traces", tmp_path / "port.txt"
    p.write_text(json.dumps({"customParams": {
        "serveModels": {"A": {"model": tenants["A"]["model_dir"],
                              "bank": tenants["A"]["export_dir"]}},
        "serveBucketCap": BUCKET_CAP, "serveMetrics": True,
        "traceDir": str(trace_dir)}}))
    trace_id, span_id = telemetry.mint_trace()
    recs = tenants["A"]["records"][:5]
    seen = {}

    def client():
        try:
            for _ in range(600):
                if port_file.exists():
                    break
                time.sleep(0.05)
            port = int(port_file.read_text())
            seen["score"] = _call("127.0.0.1", port, "POST",
                                  "/v1/models/A:score", {"records": recs},
                                  {telemetry.TRACE_HEADER: telemetry.
                                   format_traceparent(trace_id, span_id)})
        finally:
            os.kill(os.getpid(), signal.SIGTERM)

    prev = signal.getsignal(signal.SIGTERM)
    t = threading.Thread(target=client, name="test-serve-client",
                         daemon=True)
    try:
        t.start()
        assert run_serve(str(p), port=0, port_file=str(port_file),
                         device="cpu") == 0
        t.join(timeout=60)
    finally:
        signal.signal(signal.SIGTERM, prev)
        telemetry.disable()
        telemetry.reset()
    status, doc, _ = seen["score"]
    assert status == 200 and doc["rows"] == 5
    assert "draining" in capsys.readouterr().out
    assert main(["trace", "merge", str(trace_dir)]) == 0
    merged = json.loads((trace_dir / "merged.trace.json").read_text())
    names = {ev["name"] for ev in merged["traceEvents"]
             if isinstance(ev.get("args"), dict)
             and ev["args"].get("trace_id") == trace_id}
    assert {"server:request", "server:dispatch"} <= names
