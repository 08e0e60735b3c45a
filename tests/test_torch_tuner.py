"""The port's offline autotuner (``transmogrifai_tpu_torch/tuner.py``),
its online deadline controller (``server.ModelServer._adapt_deadline``)
and the Score run's cost-database drain, held against the JAX package's
``tuner.py``, ``server.py`` and ``runner.py`` on the CPU (the JAX side on
one device).

The search runs with one deterministic fake replay leg monkeypatched into
both packages' ``_boot_and_replay``, so their parity gate, descent,
incumbent and report are compared byte for byte; one live in-process leg
boots a port server on the CPU and replays a workload it recorded; the
fleet branch runs with the supervisor substituted, so no worker process
starts."""
import hashlib
import http.client
import json
import os
import time

import numpy as np
import pytest

from transmogrifai_tpu import config as jconfig
from transmogrifai_tpu import lint as jlint
from transmogrifai_tpu import planner as jplanner
from transmogrifai_tpu import server as jserver
from transmogrifai_tpu import tuner as jtuner
from transmogrifai_tpu.runner import OpParams as JOpParams
from transmogrifai_tpu_torch import config, lint, planner, server, tuner
from transmogrifai_tpu_torch import workload
from transmogrifai_tpu_torch.runner import OpParams

from _torch_server_data import BUCKET_CAP, tenant

PKGS = {"jax": (jtuner, jconfig), "port": (tuner, config)}


@pytest.fixture(autouse=True)
def _fresh_tallies():
    for tu, _cfg in PKGS.values():
        tu.reset_tuner_stats()
    yield


def _fake_replay(p99_ms, rows=64, duration_s=1.0, parity_failures=0,
                 failed=0):
    """One leg's replay result, as ``tests/test_tuner.py`` fakes it."""
    return {"sent": 8, "failed": failed, "lateSends": 0,
            "skippedNoPayload": 0, "truncated": 0, "requests": 8,
            "parityChecked": 8, "parityFailures": parity_failures,
            "parityMaxAbsDelta": 0.0, "durationS": duration_s,
            "client": {"e2e": {"n": 8, "p50Ms": p99_ms / 2,
                               "p95Ms": p99_ms, "p99Ms": p99_ms}},
            "models": {"m": {"rows": rows}}}


def _workload(tmp_path, n=4):
    doc = {"records": [
        {"tS": i * 0.01, "model": "m", "rows": 2,
         "payload": [{"x": 1.0}, {"x": 2.0}]} for i in range(n)]}
    p = tmp_path / "wl.json"
    p.write_text(json.dumps(doc))
    return str(p), doc


def _params(tmp_path, **custom):
    p = tmp_path / "params.json"
    p.write_text(json.dumps({"customParams": custom}))
    return str(p)


# -- the leg's score, the probes and the priors -------------------------------

@pytest.mark.parametrize("replay", [
    _fake_replay(12.5, rows=100, duration_s=2.0),
    _fake_replay(3.25, rows=0),
    {"client": {}, "models": {}},
    {"client": {"e2e": {"p99Ms": None}}, "models": {"a": {"rows": 3},
                                                    "b": {"rows": 5}},
     "durationS": 0.5}], ids=["both", "no-rows", "empty", "no-p99"])
@pytest.mark.parametrize("objective", ["p99", "throughput"])
def test_objective_score_equals_the_jax_packages(replay, objective):
    """``_objective_score``: client e2e p99, or replayed rows/s negated
    (the search minimizes), None when the leg measured nothing."""
    assert tuner._objective_score(replay, objective) == \
        jtuner._objective_score(replay, objective)


@pytest.mark.parametrize("name", sorted(k.name for k in
                                         config.tunable_knobs()))
@pytest.mark.parametrize("cur", [None, 0.0, 2.0, 49.0, 1e9])
def test_probe_values_equal_the_jax_packages(name, cur):
    """``_probe_values``: the probe factors and the declared edges around
    the incumbent, clamped to the knob's bounds, typed and deduplicated."""
    got = tuner._probe_values(config.knob(name), cur)
    want = jtuner._probe_values(jconfig.knob(name), cur)
    assert got == want and [type(v) for v in got] == \
        [type(v) for v in want]
    lo, hi = config.knob_bounds(name)
    assert all(lo <= v <= hi for v in got)


def test_tunable_knobs_equal_the_jax_registrys():
    """The search space: the same tunable knobs with the same bounds."""
    got = {k.name: config.knob_bounds(k.name)
           for k in config.tunable_knobs()}
    assert got == {k.name: jconfig.knob_bounds(k.name)
                   for k in jconfig.tunable_knobs()}
    assert "serveBatchDeadlineMs" in got


@pytest.mark.parametrize("per_krow", [None, 0.25, 1e-6, 50.0])
def test_prior_seeds_equal_the_jax_packages(per_krow, tmp_path):
    """``_prior_seeds`` over the same cost database file: the deadline
    seeded from the measured transform cost of a 32-row micro-batch and
    clamped to its bounds; nothing without a database or a cost."""
    db_path = str(tmp_path / "cost.json")
    db = planner.CostDatabase(db_path)
    if per_krow is not None:
        db.record_stage("phase:transform", "host", per_krow * 20.0, 20_000)
    db.save()
    names = ["serveBatchDeadlineMs", "pipelineWorkers"]
    for custom in ({"costDb": db_path}, {}):
        got = tuner._prior_seeds(OpParams(custom_params=custom), names)
        want = jtuner._prior_seeds(JOpParams(custom_params=custom), names)
        assert got == want
    assert jtuner.tuner_stats()["prior_seeds"] == \
        tuner.tuner_stats()["prior_seeds"] == (per_krow is not None)
    bad = str(tmp_path / "garbage.json")
    with open(bad, "w") as fh:
        fh.write("{not json")
    assert tuner._prior_seeds(OpParams(custom_params={"costDb": bad}),
                              names) == \
        jtuner._prior_seeds(JOpParams(custom_params={"costDb": bad}), names)


# -- the search with one fake leg in both packages ----------------------------

def _both(monkeypatch, fake):
    """The same fake leg patched into both packages; the device each
    package passes is recorded."""
    seen = []

    def leg(params_doc, workload_doc, **kw):
        seen.append(kw.get("device"))
        return fake(params_doc, workload_doc, **kw)
    for tu, _cfg in PKGS.values():
        monkeypatch.setattr(tu, "_boot_and_replay", leg)
    return seen


def _search(pf, doc, **kw):
    """Both packages' ``tune`` on the same inputs: (port, jax) results."""
    return (tuner.tune(pf, doc, device="cpu", **kw), jtuner.tune(pf, doc,
                                                                 **kw))


def _deadline(params_doc, default):
    dl = (params_doc.get("customParams") or {}).get("serveBatchDeadlineMs",
                                                    default)
    return default if dl is None else float(dl)


def test_the_parity_gate_refuses_a_broken_baseline(tmp_path, monkeypatch):
    """JAX ``test_tune_refuses_parity_broken_baseline``: a baseline leg
    with parity failures ends the search before anything is ranked."""
    _both(monkeypatch, lambda *a, **kw: _fake_replay(5.0, parity_failures=1))
    _wl, doc = _workload(tmp_path)
    for tu in (tuner, jtuner):
        with pytest.raises(tu.TunerError, match="baseline"):
            tu.tune(_params(tmp_path), doc,
                    knobs=["serveBatchDeadlineMs"], budget_s=5.0)
        assert tu.tuner_stats()["candidates_rejected_parity"] == 1


def test_the_parity_gate_rejects_a_broken_candidate(tmp_path, monkeypatch):
    """JAX ``test_tune_rejects_parity_breaking_candidate_not_ranked``: the
    fastest legs broke parity and are listed rejected, never the winner;
    the reports are byte-equal."""
    def fake(params_doc, workload_doc, **kw):
        dl = _deadline(params_doc, 8.0)
        if dl < 1.0:
            return _fake_replay(0.1, parity_failures=3)
        return _fake_replay(10.0 + dl)
    seen = _both(monkeypatch, fake)
    _wl, doc = _workload(tmp_path)
    got, want = _search(_params(tmp_path, serveBatchDeadlineMs=8.0), doc,
                        knobs=["serveBatchDeadlineMs"], budget_s=30.0)
    rep = got["report"]
    assert json.dumps(rep, sort_keys=True) == \
        json.dumps(want["report"], sort_keys=True)
    assert (rep["winner"].get("serveBatchDeadlineMs") or 1.0) >= 1.0
    rejected = [leg for leg in rep["legs"]
                if leg["rejected"] == "score parity"]
    assert rejected and all(leg["values"] != rep["winner"]
                            for leg in rejected)
    assert tuner.tuner_stats() == jtuner.tuner_stats()
    assert "cpu" in seen and None in seen    # the port's legs name it


def test_the_search_descends_and_its_files_equal_the_jax_packages(
        tmp_path, monkeypatch):
    """JAX ``test_tune_descends_to_better_deadline_and_report_is_byte_
    stable``: the deadline descends to the declared floor; the report
    (digest included) and the tuned params are byte-equal to the JAX
    package's, and stable from one search to the next. No field names a
    package."""
    _both(monkeypatch, lambda d, w, **kw: _fake_replay(
        5.0 + _deadline(d, 8.0)))
    _wl, doc = _workload(tmp_path)
    pf = _params(tmp_path, serveBatchDeadlineMs=8.0, serveBucketCap=64)
    got, want = _search(pf, doc, knobs=["serveBatchDeadlineMs"],
                        budget_s=30.0)
    again = tuner.tune(pf, doc, knobs=["serveBatchDeadlineMs"],
                       budget_s=30.0, device="cpu")
    for key in ("report", "tunedParams"):
        a = json.dumps(got[key], indent=1, sort_keys=True)
        assert a == json.dumps(want[key], indent=1, sort_keys=True)
        assert a == json.dumps(again[key], indent=1, sort_keys=True)
    rep = got["report"]
    assert rep["winner"] == {"serveBatchDeadlineMs": 0.0}
    assert rep["winnerScore"] < rep["baselineScore"]
    assert rep["digest"].startswith("blake2b:")
    assert got["tunedParams"]["customParams"] == {
        "serveBatchDeadlineMs": 0.0, "serveBucketCap": 64}
    assert config.check_custom_params(
        got["tunedParams"]["customParams"]) == []
    assert "jax" not in json.dumps(got).lower()
    st = tuner.tuner_stats()
    assert st["searches"] == 2 and st["candidates_improved"] >= 2
    assert st["legs_replayed"] == 2 * rep["legsMeasured"]


def test_the_baseline_is_kept_when_nothing_beats_it(tmp_path, monkeypatch):
    """JAX ``test_tune_keeps_baseline_when_nothing_beats_it``: a flat
    objective keeps the baseline (no winner) in both packages."""
    _both(monkeypatch, lambda *a, **kw: _fake_replay(10.0))
    _wl, doc = _workload(tmp_path)
    got, want = _search(_params(tmp_path, serveBatchDeadlineMs=2), doc,
                        knobs=["serveBatchDeadlineMs"], budget_s=30.0)
    assert got["report"]["winner"] == {} == want["report"]["winner"]
    assert got["tunedParams"] == want["tunedParams"]
    assert got["tunedParams"]["customParams"]["serveBatchDeadlineMs"] == 2


@pytest.mark.parametrize("case", ["objective", "knob", "params"])
def test_bad_inputs_raise_as_in_the_jax_package(case, tmp_path):
    """JAX ``test_tune_validates_inputs``: the same misuse raises
    ``TunerError`` with the same message in both packages."""
    _wl, doc = _workload(tmp_path)
    kw, pf = {}, _params(tmp_path)
    if case == "objective":
        kw["objective"] = "p42"
    elif case == "knob":
        kw["knobs"] = ["validate"]
    else:
        pf = _params(tmp_path, serveBatchDeadlineMs="soon")
    msgs = []
    for tu in (tuner, jtuner):
        with pytest.raises(tu.TunerError) as e:
            tu.tune(pf, doc, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_run_tune_writes_the_jax_packages_files(tmp_path, monkeypatch,
                                                capsys):
    """JAX ``test_run_tune_writes_validated_tuned_params_and_report``:
    ``params.tuned.json`` and the report beside it, byte-equal to the
    JAX command's files, and the same lines printed."""
    _both(monkeypatch, lambda d, w, **kw: _fake_replay(
        5.0 + _deadline(d, 4.0)))
    wl_path, _doc = _workload(tmp_path)
    out = {}
    for name, tu in (("port", tuner), ("jax", jtuner)):
        d = tmp_path / name
        d.mkdir()
        pf = _params(d, serveBatchDeadlineMs=4.0)
        kw = {"device": "cpu"} if tu is tuner else {}
        assert tu.run_tune(pf, wl_path, budget_s=30.0,
                           knobs="serveBatchDeadlineMs", **kw) == 0
        printed = capsys.readouterr().out.replace(str(d), "<dir>")
        tuned = os.path.splitext(pf)[0] + ".tuned.json"
        report = os.path.splitext(tuned)[0] + ".tuning-report.json"
        out[name] = (printed, open(tuned).read(), open(report).read())
    assert out["port"] == out["jax"]
    tuned = json.loads(out["port"][1])
    assert config.check_custom_params(tuned["customParams"]) == []
    rep = json.loads(out["port"][2])
    assert rep["legsMeasured"] == len(rep["legs"])
    assert rep["bounds"]["serveBatchDeadlineMs"] == [0.0, 50.0]


def test_run_tune_exits_1_on_a_missing_workload(tmp_path, capsys):
    """JAX ``test_run_tune_missing_workload_is_exit_1``."""
    for tu in (tuner, jtuner):
        assert tu.run_tune(_params(tmp_path),
                           str(tmp_path / "nope.json")) == 1
        assert "cannot load workload" in capsys.readouterr().out


# -- live legs ----------------------------------------------------------------

@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """A port tenant served on the CPU and 12 requests recorded through
    the flight recorder, merged; the params file of a server of it."""
    t = tenant(11, str(tmp_path_factory.mktemp("model")),
               str(tmp_path_factory.mktemp("export")))
    srv = server.ModelServer(device="cpu", bucket_cap=BUCKET_CAP,
                             batch_deadline_s=0.002)
    srv.register("A", model_dir=t["model_dir"], bank_dir=t["export_dir"])
    httpd = server.serve_http(srv, port=0)
    wdir = str(tmp_path_factory.mktemp("workload"))
    workload.start_recorder(wdir, role="worker")
    try:
        for i in range(12):
            conn = http.client.HTTPConnection("127.0.0.1",
                                              httpd.server_address[1],
                                              timeout=60)
            conn.request("POST", "/v1/models/A:score", json.dumps(
                {"records": t["records"][i:i + 1 + i % 4]}),
                {"Content-Type": "application/json"})
            assert conn.getresponse().status == 200
            conn.close()
            time.sleep(0.01)
    finally:
        workload.stop_recorder()
        srv.shutdown(drain=True)
        httpd.shutdown()
    pdir = tmp_path_factory.mktemp("params")
    pf = str(pdir / "params.json")
    with open(pf, "w") as fh:
        json.dump({"customParams": {
            "serveModels": {"A": {"model": t["model_dir"],
                                  "bank": t["export_dir"]}},
            "serveBucketCap": BUCKET_CAP, "serveBatchDeadlineMs": 2}}, fh)
    return {"params": pf, "doc": workload.merge_workload_shards(wdir),
            "dir": wdir, "tenant": t}


def test_one_live_leg_on_the_cpu_has_no_parity_failure(recorded, tmp_path):
    """A live in-process leg through the command line (``tune params.json
    --workload <dir> --device cpu``): ``build_server_from_params`` on the
    CPU and ``serve_http``, the recorded shards merged and replayed (8
    requests) with every response held against its recording; the
    search keeps to its budget of a few seconds and writes tuned params
    that pass validation and a report whose digest is its bytes'."""
    from transmogrifai_tpu_torch import cli
    out = str(tmp_path / "tuned.json")
    t0 = time.monotonic()
    rc = cli.main(["tune", recorded["params"], "--workload", recorded["dir"],
                   "--knobs", "serveBatchDeadlineMs", "--budget-s", "2",
                   "--max-requests", "8", "--speed", "4", "-o", out,
                   "--device", "cpu"])
    assert rc == 0 and time.monotonic() - t0 < 60.0
    rep = json.load(open(str(tmp_path / "tuned.tuning-report.json")))
    base = rep["legs"][0]
    assert base["label"] == "baseline" and base["rejected"] is None
    assert base["sent"] == 8 and base["parityFailures"] == 0
    assert base["parityChecked"] == 8 and base["failed"] == 0
    assert all(leg["parityFailures"] == 0 for leg in rep["legs"]
               if leg["rejected"] is None)
    assert not rep["fleet"] and rep["winnerScore"] <= rep["baselineScore"]
    digest = rep.pop("digest")
    assert digest == "blake2b:" + hashlib.blake2b(json.dumps(
        rep, sort_keys=True, separators=(",", ":")).encode(),
        digest_size=16).hexdigest()
    assert config.check_custom_params(
        json.load(open(out))["customParams"]) == []


def test_the_fleet_leg_boots_a_supervisor_on_the_device(recorded,
                                                        monkeypatch):
    """``fleetWorkers`` in the params boots the fleet branch: a
    ``FleetSupervisor`` of that many workers on the leg's device (here a
    substitute, so no worker process starts) behind ``serve_fleet_http``
    (here an in-process server of the same tenant), stopped with a
    drain after the replay; the report says ``fleet``."""
    from transmogrifai_tpu_torch import fleet
    from transmogrifai_tpu_torch.cli import build_server_from_params
    calls = []

    class Supervisor:
        def __init__(self, params_path, workers, probe_interval_s, device):
            calls.append(("init", workers, device))
            self.params = OpParams.from_file(params_path)

        def start(self):
            calls.append(("start",))

        def stop(self, drain=True):
            calls.append(("stop", drain))

    servers = []

    def serve_fleet_http(sup, port=0):
        srv = build_server_from_params(sup.params, device="cpu")
        servers.append(srv)
        return server.serve_http(srv, port=port)
    monkeypatch.setattr(fleet, "FleetSupervisor", Supervisor)
    monkeypatch.setattr(fleet, "serve_fleet_http", serve_fleet_http)
    with open(recorded["params"]) as fh:
        doc = json.load(fh)
    doc["customParams"]["fleetWorkers"] = 3
    pf = recorded["params"].replace(".json", ".fleet.json")
    with open(pf, "w") as fh:
        json.dump(doc, fh)
    replay = tuner._boot_and_replay(
        doc, recorded["doc"], speed=4.0, parity_tol=1e-4, timeout_s=30.0,
        duration_s=None, max_requests=4, use_fleet=True, device="cpu")
    for srv in servers:
        srv.shutdown(drain=True)
    assert calls == [("init", 3, "cpu"), ("start",), ("stop", True)]
    assert replay["sent"] == 4 and replay["parityFailures"] == 0
    monkeypatch.setattr(tuner, "_boot_and_replay",
                        lambda *a, **kw: _fake_replay(4.0))
    out = tuner.tune(pf, recorded["doc"], knobs=["serveBatchDeadlineMs"],
                     budget_s=5.0, device="cpu")
    assert out["report"]["fleet"] is True


# -- the online deadline controller (JAX tests/test_tuner.py:228-376) ----------

def _entry(pkg, srv, qw_s, ch_s, n=None):
    """A tenant entry with a full window of (queue wait, coalesce hold)."""
    mod = server if pkg == "port" else jserver
    n = n or mod.ADAPT_WINDOW_REQUESTS
    entry = mod._ModelEntry("t", None, None, None, srv.max_queue)
    entry.requests = n
    for _ in range(n):
        entry.decomp["queueWait"].append(qw_s)
        entry.decomp["coalesceHold"].append(ch_s)
    return entry


def _servers(deadline_s, **kw):
    return {"port": server.ModelServer(batch_deadline_s=deadline_s,
                                       device="cpu", **kw),
            "jax": jserver.ModelServer(batch_deadline_s=deadline_s, **kw)}


def _state(entry):
    return (entry.deadline_s, entry.adapt_increases, entry.adapt_decreases,
            entry.adapt_clamped, entry.deadline_advised, entry.adapt_seen)


_ADAPT_COUNTERS = ("deadline_adapt_windows", "deadline_increases",
                   "deadline_decreases", "deadline_holds",
                   "deadline_clamped", "deadline_advisories")


def _steps(deadline_s, windows, n=None):
    """Both controllers over the same windows ((queue wait, coalesce hold)
    each): the entries' states and the tallies' moves after each."""
    out = {}
    for pkg, srv in _servers(deadline_s, adapt_deadline=True).items():
        mod = server if pkg == "port" else jserver
        try:
            entry = None
            states = []
            for qw, ch in windows:
                if entry is None:
                    entry = _entry(pkg, srv, qw, ch, n)
                else:
                    entry.requests += mod.ADAPT_WINDOW_REQUESTS
                    for _ in range(mod.ADAPT_WINDOW_REQUESTS):
                        entry.decomp["queueWait"].append(qw)
                        entry.decomp["coalesceHold"].append(ch)
                before = mod.server_stats()
                srv._adapt_deadline(entry)
                after = mod.server_stats()
                states.append((_state(entry), {k: after[k] - before[k]
                                               for k in _ADAPT_COUNTERS}))
            out[pkg] = states
        finally:
            srv.shutdown(drain=True)
    return out


@pytest.mark.parametrize("deadline_s,windows,n", [
    (0.004, [(0.010, 0.001), (0.010, 0.001)], None),   # decrease, hold
    (0.004, [(0.0001, 0.004)], None),                   # increase
    (0.050, [(0.0001, 0.02)], None),                    # clamped at the top
    (0.0, [(0.02, 0.0001)], None),                      # at the floor
    (0.004, [(0.002, 0.002)], None),                    # the deadband
    (0.004, [(0.02, 0.0001)], 63),                      # below a window
    (0.008, [(0.05, 0.0001)] * 3, None),                # TMG406 once
], ids=["decrease", "increase", "ceiling", "floor", "deadband",
        "short-window", "advisory"])
def test_adapt_deadline_steps_as_the_jax_controller(deadline_s, windows, n,
                                                    monkeypatch):
    """JAX ``test_adapt_*``: the bounded AIMD controller moves the same
    way on the same windows (deadline, increases, decreases, clamps,
    advisory, the server tallies' moves), and TMG406 fires once in
    both."""
    findings = {"port": [], "jax": []}
    monkeypatch.setattr(lint, "emit_findings",
                        lambda fs, *a, **k: findings["port"].extend(fs))
    monkeypatch.setattr(jlint, "emit_findings",
                        lambda fs, *a, **k: findings["jax"].extend(fs))
    got = _steps(deadline_s, windows, n)
    assert got["port"] == got["jax"]
    assert [f.rule for f in findings["port"]] == \
        [f.rule for f in findings["jax"]]
    if len(windows) == 3:
        assert [f.rule for f in findings["port"]] == ["TMG406"]
    lo, hi = config.knob_bounds("serveBatchDeadlineMs")
    for (dl, *_rest), _moves in got["port"]:
        assert dl is None or lo / 1e3 <= dl <= hi / 1e3


def test_adapt_off_is_inert_and_the_kill_switch_wins(monkeypatch):
    """JAX ``test_adapt_disabled_is_bit_inert``: off by default (the
    stats say so, the entry's deadline stays None); ``TMOG_ADAPT=0``
    turns a requested controller off; the stats keys are the JAX
    package's."""
    for pkg, srv in _servers(0.004).items():
        try:
            assert srv.adapt_deadline is False
            assert srv.stats()["adaptDeadline"] is False
            entry = _entry(pkg, srv, 0.05, 0.0001)
            assert entry.stats()["adaptiveDeadlineMs"] is None
        finally:
            srv.shutdown(drain=True)
    monkeypatch.setenv("TMOG_ADAPT", "0")
    for srv in _servers(0.004, adapt_deadline=True).values():
        try:
            assert srv.adapt_deadline is False
        finally:
            srv.shutdown(drain=True)
    assert set(_ADAPT_COUNTERS) <= set(server.server_stats())
    from transmogrifai_tpu import fleet as jfleet
    from transmogrifai_tpu_torch import fleet
    keys = {k for k in jfleet.fleet_stats() if k.startswith("worker_dead")}
    assert keys and keys <= set(fleet.fleet_stats())


# -- the Score run's cost-database drain (JAX tests/test_tuner.py:378-420) -----

def _score_run(pkg, tmp_path, records):
    """Train (costDb set), seed one transform observation, Score: the
    database's stage keys and observation count before and after, and
    the Score's metrics."""
    if pkg == "port":
        from transmogrifai_tpu_torch import FeatureBuilder, Workflow
        from transmogrifai_tpu_torch.dsl import transmogrify
        from transmogrifai_tpu_torch.models import (
            BinaryClassificationModelSelector, LogisticRegressionFamily)
        from transmogrifai_tpu_torch.runner import (OpWorkflowRunner,
                                                    RunType)
        pl, Params, kw = planner, OpParams, {"device": "cpu"}
    else:
        from transmogrifai_tpu import FeatureBuilder, Workflow
        from transmogrifai_tpu.models.linear import LogisticRegressionFamily
        from transmogrifai_tpu.models.selector import \
            BinaryClassificationModelSelector
        from transmogrifai_tpu.ops.transmogrifier import transmogrify
        from transmogrifai_tpu.runner import OpWorkflowRunner, RunType
        pl, Params, kw = jplanner, JOpParams, {}

    class Reader:
        def read_records(self):
            return list(records)

    label = FeatureBuilder.RealNN("label").from_column().as_response()
    fx = FeatureBuilder.Real("x").from_column().as_predictor()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily()],
        splitter=None, seed=3)
    wf = Workflow().set_result_features(
        label.transform_with(sel, transmogrify([fx])))
    if pkg == "jax":
        wf = wf.set_mesh(False)
    runner = OpWorkflowRunner(wf, training_reader=Reader(),
                              scoring_reader=Reader(), **kw)
    db_path = str(tmp_path / f"{pkg}-cost.json")
    params = Params(model_location=str(tmp_path / f"{pkg}-model"),
                    write_location=str(tmp_path / f"{pkg}-scores.csv"),
                    custom_params={"costDb": db_path})
    runner.run(RunType.TRAIN, params)

    def seen():
        doc = json.load(open(db_path))
        return sorted(doc.get("stages", {})), sum(
            slot.get("n", 0) for tiers in doc.get("stages", {}).values()
            for slot in tiers.values() if isinstance(slot, dict))
    before = seen()
    pl.observe_phase("transform", "host", 0.5, 25_000)
    out = runner.run(RunType.SCORE, params)
    return before, seen(), out.metrics


def test_the_score_run_drains_into_the_cost_db_as_the_jax_runner(tmp_path):
    """JAX ``test_score_run_grows_cost_db``: a Score run drains the phase
    observations into the cost database (``phase:transform`` appears,
    the observation count grows) and stamps ``effectiveConfig.costDb``,
    in both packages alike."""
    rng = np.random.default_rng(0)
    y = rng.integers(0, 2, 120).astype(float)
    x = rng.normal(size=120) + y
    records = [{"label": float(y[i]), "x": float(x[i])} for i in range(120)]
    got = {pkg: _score_run(pkg, tmp_path, records) for pkg in ("port", "jax")}
    for pkg, (before, after, metrics) in got.items():
        assert "phase:transform" in after[0], pkg
        assert after[1] > before[1], pkg
        assert metrics["rowsScored"] == 120, pkg
        assert metrics["effectiveConfig"]["costDb"].endswith(
            f"{pkg}-cost.json")
    assert "phase:transform" in got["jax"][1][0]
    assert got["port"][1][1] - got["port"][0][1] >= 1
