"""The port's model lifecycle (``transmogrifai_tpu_torch/lifecycle.py``) and
the model server's rollouts (``server.py``) on the CPU, held against the
JAX package.

The drift sentinel's findings (rule, feature, message) and its JS and
fill values agree within 1e-12 with the JAX sentinel's on the same
baseline and live records; the same ``register`` / ``promote`` /
``rollback`` / misuse sequence gives the same pointer documents and
version records in both registries (but for timestamps; the version ids
are explicit, since the port's state digest is not the JAX package's); a
promote that dies leaves the pointer intact for a fresh interpreter that
imports only the port. Five JAX oracle tests of ``tests/test_lifecycle.py``
(its shadow and canary rollouts) fail on this tree (the 8-device mesh),
so the rollouts are held against the JAX server's own rules instead: the
canary routing decisions equal ``transmogrifai_tpu.server.ModelServer.
_canaried``'s request for request, non-canaried traffic is bitwise the
stable version's solo score, a clean canary promotes and moves the
pointer, a ``lifecycle.promote`` fault rolls back with no request
dropped, a shadow of the same weights counts parity with no mismatch, a
shadow of other weights never promotes."""
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import lifecycle as jlc
from transmogrifai_tpu import server as jserver
from transmogrifai_tpu.filters import distribution as JD
from transmogrifai_tpu.workflow import _generate_raw_store
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import lifecycle, resilience, telemetry
from transmogrifai_tpu_torch.filters import distribution as PD
from transmogrifai_tpu_torch.lifecycle import (DriftSentinel, ModelRegistry,
                                               RegistryError,
                                               version_of_export)
from transmogrifai_tpu_torch.server import (ModelNotFound, ModelServer,
                                            RolloutError, serve_http)
from transmogrifai_tpu_torch.workflow import _raw_store

from _torch_server_data import BUCKET_CAP, assert_bitwise, tenant

ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Two versions of one model (a RawFeatureFilter attached, so the
    training distributions persist), exported by the port and registered
    in the port's registry with v1 promoted."""
    reg_dir = str(tmp_path_factory.mktemp("registry"))
    reg = ModelRegistry(reg_dir)
    out = {"registry": reg, "registry_dir": reg_dir}
    for tag, seed in (("v1", 11), ("v2", 12)):
        t = tenant(seed, str(tmp_path_factory.mktemp(f"model_{tag}")),
                   str(tmp_path_factory.mktemp(f"export_{tag}")),
                   rff_bins=20)
        t["vid"] = reg.register("churn", t["model_dir"],
                                bank_dir=t["export_dir"],
                                train_metrics={"seed": seed},
                                promote=(tag == "v1"))
        out[tag] = t
    return out


@pytest.fixture()
def fresh_pointer(fleet):
    """The tests move the shared pointer; v1 is current again after."""
    reg = fleet["registry"]
    yield reg
    reg.promote("churn", fleet["v1"]["vid"])


def _server(fleet, **kw):
    kw.setdefault("bucket_cap", BUCKET_CAP)
    kw.setdefault("batch_deadline_s", 0.0)
    kw.setdefault("registry", fleet["registry"])
    kw.setdefault("device", "cpu")
    srv = ModelServer(**kw)
    srv.register_from_registry("churn")
    return srv


def _solo(t, records, bucket):
    """``t``'s solo score of ``records`` at ``bucket`` through a fresh
    engine of its own model."""
    eng = t["model"].scoring_engine(device="cpu", bucket_cap=BUCKET_CAP)
    return eng.score_store(records, bucket_min=bucket)[t["pred"]]


# ---------------------------------------------------------------------------
# DriftSentinel against the JAX package's
# ---------------------------------------------------------------------------


def _sentinels(seed, n=256, bins=20, **kw):
    """The JAX test's synthetic sentinel in both packages over the same
    baseline records; returns (jax, port, rng for the live stream)."""
    rng = np.random.default_rng(seed)
    recs = [{"x1": float(rng.normal()), "x2": float(rng.normal())}
            for _ in range(n)]
    out = []
    for FB, D, raw in ((JFB, JD, _generate_raw_store), (PFB, PD, _raw_store)):
        feats = [FB.Real("x1").from_column().as_predictor(),
                 FB.Real("x2").from_column().as_predictor()]
        store = raw(recs, feats)
        summaries, baseline = {}, []
        for f in feats:
            summaries[(f.name, None)] = D.Summary.of_values(
                np.asarray([r[f.name] for r in recs]))
            baseline += D.distributions_of_column(f.name, store[f.name],
                                                  bins, summaries)
        out.append(baseline)
    jbase, pbase = out
    jfeats = [JFB.Real(n).from_column().as_predictor() for n in ("x1", "x2")]
    pfeats = [PFB.Real(n).from_column().as_predictor() for n in ("x1", "x2")]
    return (jlc.DriftSentinel(jbase, jfeats, **kw),
            DriftSentinel(pbase, pfeats, **kw), rng)


def _live(case, rng, i):
    if case == "in_distribution":
        return [{"x1": float(rng.normal()), "x2": float(rng.normal())}
                for _ in range(8)]
    if case == "shift":
        return [{"x1": float(rng.normal()),
                 "x2": float(rng.normal() * 0.05 + 2.5)} for _ in range(8)]
    if case in ("out_of_support", "suppressed"):
        return [{"x1": float(1000.0 + 8 * i + k),
                 "x2": float(rng.normal())} for k in range(8)]
    return [{"x1": float(rng.normal())} for _ in range(8)]   # fill_shift


def _findings(fs):
    return [(f.rule, f.feature, f.message, f.severity) for f in fs]


@pytest.mark.parametrize("case", ["in_distribution", "shift",
                                  "out_of_support", "fill_shift",
                                  "suppressed"])
def test_sentinel_findings_equal_the_jax_sentinels(case):
    """The same baseline and live batches through both sentinels: after
    each batch the findings (rule, feature, message, severity), the
    window reports and the stats are equal, and every merged window's JS
    divergence and fill deltas agree within 1e-12."""
    kw = dict(window_rows=64, subwindows=4)
    if case == "suppressed":
        kw["suppress"] = ("TMG601", "TMG602")
    js, ps, rng = _sentinels(3, **kw)
    fired = 0
    for i in range(16):
        batch = _live(case, rng, i)
        got, want = ps.observe(batch), js.observe(batch)
        assert _findings(got) == _findings(want)
        assert ps.last_report == js.last_report
        fired += len(got)
        with ps._lock:
            pm = ps._merged_locked()
        with js._lock:
            jm = js._merged_locked()
        assert set(pm) == set(jm)
        for k in pm:
            for fn in ("js_divergence", "relative_fill_rate",
                       "relative_fill_ratio"):
                a = getattr(ps._baseline[k], fn)(pm[k])
                b = getattr(js._baseline[k], fn)(jm[k])
                assert a == pytest.approx(b, abs=1e-12), (k, fn)
    assert ps.stats() == js.stats()
    assert ps.stats()["windowsCompared"] == 5     # at 64, 80, ..., 128 rows
    assert (fired > 0) == (case in ("shift", "out_of_support",
                                    "fill_shift"))


def test_sentinel_telemetry_hooks_and_tmg603():
    """Unsuppressed findings reach the ``on_drift`` hook and the
    ``drift.*`` gauges; a model with no baseline gets None and a TMG603
    advisory."""
    from types import SimpleNamespace
    telemetry.enable()
    try:
        listener = telemetry.add_listener(telemetry.CollectingRunListener())
        _, s, _ = _sentinels(7, window_rows=32, subwindows=4,
                             model_name="churn")
        s.observe([{"x1": 1000.0, "x2": 0.1} for _ in range(32)])
        assert listener.drift_advisories.get("TMG601", 0) >= 1
        doc = telemetry.metrics_json()
        assert doc.get("drift.js_divergence.x1") == 1.0
        assert "lifecycle.drift_advisories" in doc
        bare = SimpleNamespace(rff_results=None, result_features=[])
        assert DriftSentinel.for_model(bare, model_name="bare") is None
        assert listener.lint_findings.get("info", 0) == 1
    finally:
        telemetry.disable()
        telemetry.reset()


# ---------------------------------------------------------------------------
# ModelRegistry against the JAX package's
# ---------------------------------------------------------------------------


def _registry_run(Registry, Error, root, dirs):
    """One register / promote / rollback / misuse sequence; returns what
    each step gave (errors by class name), the pointer documents and the
    version records without their timestamps."""
    reg = Registry(root)
    steps = []

    def step(fn, *a, **kw):
        try:
            out = fn(*a, **kw)
        except Error as e:
            out = ("error", type(e).__name__)
        if isinstance(out, dict):
            out = {k: v for k, v in out.items() if k != "updatedAt"}
        steps.append(out)

    step(reg.register, "m", dirs["a"], version="va")
    step(reg.register, "m", dirs["b"], version="vb",
         train_metrics={"auPR": 0.5})
    step(reg.current, "m")
    step(reg.resolve, "m")                   # nothing promoted yet
    step(reg.rollback, "m")                  # no previous
    step(reg.promote, "ghost", "v0")         # never registered
    step(reg.promote, "m", "nope")           # unknown version
    step(reg.register, "bad/name", dirs["a"], version="v")
    step(reg.register, "m", dirs["a"], version="../escape")
    step(reg.promote, "m", "va")
    step(reg.promote, "m", "va")             # idempotent
    step(reg.promote, "m", "vb")
    step(reg.rollback, "m")
    step(reg.rollback, "m")                  # its own undo
    step(reg.register, "m", dirs["c"], version="vb")   # in place
    step(reg.previous, "m")
    docs = [{k: v for k, v in reg.status("m").items() if k != "versions"},
            reg.models()]
    recs = [{k: v for k, v in r.items() if k != "registeredAt"}
            for r in reg.versions("m")]
    resolved = {k: v for k, v in reg.resolve("m").items()
                if k != "registeredAt"}
    return steps, docs, recs, resolved


def test_registry_sequence_equals_the_jax_registrys(tmp_path):
    dirs = {k: str(tmp_path / k) for k in "abc"}
    got = _registry_run(ModelRegistry, RegistryError,
                        str(tmp_path / "port"), dirs)
    want = _registry_run(jlc.ModelRegistry, jlc.RegistryError,
                         str(tmp_path / "jax"), dirs)
    assert got == want
    steps = got[0]
    assert steps[3] == ("error", "RegistryError")
    assert got[1][0] == {"name": "m", "current": "vb", "previous": "va"}
    assert [r["version"] for r in got[2]] == ["va", "vb"]
    assert got[2][1]["modelDir"] == dirs["c"]


def test_concurrent_registry_handles_never_lose_records(tmp_path):
    a = ModelRegistry(str(tmp_path / "reg"))
    b = ModelRegistry(str(tmp_path / "reg"))
    a.register("m", "/tmp/a", version="va")
    b.register("m", "/tmp/b", version="vb")
    a.register("m", "/tmp/c", version="vc")
    for reg in (a, b):
        assert [r["version"] for r in reg.versions("m")] == \
            ["va", "vb", "vc"]


@pytest.mark.chaos
def test_crash_mid_promote_leaves_the_pointer_for_a_fresh_interpreter(
        tmp_path):
    """A promote killed by a ``lifecycle.promote`` fault leaves the old
    pointer, read by a fresh interpreter that imports only the port (the
    JAX package and ``jax`` blocked); the registry is not wedged."""
    reg_dir = str(tmp_path / "reg")
    block = ("import sys\n"
             "for name in ('jax', 'jaxlib', 'transmogrifai_tpu'):\n"
             "    sys.modules[name] = None\n")
    crash = block + textwrap.dedent(f"""
        from transmogrifai_tpu_torch import resilience
        from transmogrifai_tpu_torch.lifecycle import ModelRegistry
        reg = ModelRegistry({reg_dir!r})
        reg.register("m", "/tmp/a", version="va", promote=True)
        reg.register("m", "/tmp/b", version="vb")
        plan = resilience.FaultPlan(seed=7).on("lifecycle.promote",
                                               error=OSError)
        with resilience.fault_plan(plan):
            try:
                reg.promote("m", "vb")
            except OSError:
                sys.exit(41)
        sys.exit(1)
    """)
    proc = subprocess.run([sys.executable, "-c", crash], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 41, proc.stderr[-800:]
    probe = block + textwrap.dedent(f"""
        from transmogrifai_tpu_torch.lifecycle import ModelRegistry
        reg = ModelRegistry({reg_dir!r})
        assert reg.current("m") == "va", reg.current("m")
        assert reg.resolve("m")["modelDir"] == "/tmp/a"
        reg.promote("m", "vb")
        assert reg.current("m") == "vb"
        sys.exit(0)
    """)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-800:]


def test_version_id_is_the_banks_state_digest(fleet):
    """A version names the served weights: the id is the bank manifest's
    ``stateDigest`` (the port engine's ``state_digest()``); a save without
    a bank is named by its bytes, stable and distinct."""
    from transmogrifai_tpu_torch import aot
    t = fleet["v1"]
    manifest, _ = aot.read_manifest(t["export_dir"])
    eng = t["model"].scoring_engine(device="cpu", bucket_cap=BUCKET_CAP)
    assert t["vid"] == manifest["stateDigest"] == eng.state_digest()
    assert version_of_export(t["model_dir"], t["export_dir"]) == t["vid"]
    a = version_of_export(t["model_dir"])
    assert a == version_of_export(t["model_dir"])
    assert a != version_of_export(fleet["v2"]["model_dir"])
    assert set(lifecycle.lifecycle_stats()) == set(jlc.lifecycle_stats())


# ---------------------------------------------------------------------------
# the server's registry tenants and rollouts
# ---------------------------------------------------------------------------


def test_registry_tenant_serves_current_and_resolves_it_on_reload(
        fleet, fresh_pointer):
    srv = _server(fleet)
    try:
        t1, t2 = fleet["v1"], fleet["v2"]
        recs = t1["records"][:4]
        res = srv.score("churn", recs, timeout_s=120)
        assert_bitwise(res.store[t1["pred"]], _solo(t1, recs, res.bucket))
        fresh_pointer.promote("churn", t2["vid"])
        entry = srv._entries["churn"]
        with entry.lock:
            entry.model = entry.engine = entry.sentinel = None
            entry.bank_buckets = []
        res = srv.score("churn", recs, timeout_s=120)
        assert_bitwise(res.store[t2["pred"]], _solo(t2, recs, res.bucket))
        assert srv.stats()["models"]["churn"]["viaRegistry"] is True
        assert entry.engine.compile_count == 0
    finally:
        srv.shutdown(drain=True)
    with pytest.raises(RolloutError):
        ModelServer(device="cpu").register_from_registry("churn")


def test_shadow_of_the_same_weights_counts_parity_and_promotes(
        fleet, fresh_pointer):
    t1 = fleet["v1"]
    srv = _server(fleet)
    before = lifecycle.lifecycle_stats()
    try:
        srv.deploy("churn", t1["vid"], mode="shadow", window_requests=4,
                   promote_windows=2)
        with pytest.raises(RolloutError):         # one rollout at a time
            srv.deploy("churn", t1["vid"], mode="shadow")
        for i in range(10):
            recs = t1["records"][i * 3:(i + 1) * 3]
            res = srv.score("churn", recs, timeout_s=120)
            assert res.canary is False
            assert_bitwise(res.store[t1["pred"]],
                           _solo(t1, recs, res.bucket))
        after = lifecycle.lifecycle_stats()
        assert after["deploys"] - before["deploys"] == 1
        assert after["auto_promotions"] - before["auto_promotions"] == 1
        assert after["shadow_parity_ok"] - before["shadow_parity_ok"] >= 8
        assert after["shadow_parity_mismatch"] == \
            before["shadow_parity_mismatch"]
        assert srv._entries["churn"].rollout is None
        assert fresh_pointer.current("churn") == t1["vid"]
    finally:
        srv.shutdown(drain=True)


def test_shadow_of_other_weights_never_promotes(fleet, fresh_pointer):
    t1, t2 = fleet["v1"], fleet["v2"]
    srv = _server(fleet)
    try:
        srv.deploy("churn", t2["vid"], mode="shadow", window_requests=2,
                   promote_windows=1)
        for i in range(8):
            srv.score("churn", t1["records"][i:i + 2], timeout_s=120)
        status = srv.lifecycle_status("churn")
        assert status["rollout"]["parityMismatch"] >= 1
        assert status["rollout"]["cleanWindows"] == 0
        assert status["rollout"]["shadowLatencyDeltaMs"] is not None
        assert fresh_pointer.current("churn") == t1["vid"]
        assert srv.rollback("churn")["aborted"] == t2["vid"]
        assert srv._entries["churn"].rollout is None
    finally:
        srv.shutdown(drain=True)


def test_canary_routes_as_the_jax_server_and_keeps_stable_traffic_bitwise(
        fleet, fresh_pointer):
    """Each one-record request takes the canary exactly when the JAX
    server's ``_canaried`` sends it there; the others are bitwise the
    stable version's solo score, the canaried ones v2's."""
    t1, t2 = fleet["v1"], fleet["v2"]
    srv = _server(fleet)
    try:
        srv.deploy("churn", t2["vid"], mode="canary", fraction=0.5,
                   window_requests=10_000, promote_windows=100)
        flags = []
        for i in range(24):
            recs = [t1["records"][i]]
            res = srv.score("churn", recs, timeout_s=120)
            want = jserver.ModelServer._canaried(jserver._Request(recs),
                                                 0.5)
            assert res.canary == want
            flags.append(res.canary)
            t = t2 if res.canary else t1
            assert_bitwise(res.store[t["pred"]], _solo(t, recs, res.bucket))
        assert any(flags) and not all(flags)
    finally:
        srv.shutdown(drain=True)


def test_canary_promotes_after_clean_windows(fleet, fresh_pointer):
    t1, t2 = fleet["v1"], fleet["v2"]
    srv = _server(fleet)
    before = lifecycle.lifecycle_stats()
    try:
        srv.deploy("churn", t2["vid"], mode="canary", fraction=0.5,
                   window_requests=4, promote_windows=2)
        n = 0
        while fresh_pointer.current("churn") != t2["vid"] and n < 64:
            assert srv.score("churn", [t1["records"][n % 100]],
                             timeout_s=120).rows == 1
            n += 1
        assert fresh_pointer.current("churn") == t2["vid"]
        assert srv._entries["churn"].rollout is None
        after = lifecycle.lifecycle_stats()
        assert after["auto_promotions"] - before["auto_promotions"] == 1
        assert after["canary_requests"] > before["canary_requests"]
        recs = t1["records"][:4]
        res = srv.score("churn", recs, timeout_s=120)
        assert_bitwise(res.store[t2["pred"]], _solo(t2, recs, res.bucket))
    finally:
        srv.shutdown(drain=True)


@pytest.mark.chaos
def test_a_lifecycle_promote_fault_rolls_back_with_no_request_dropped(
        fleet, fresh_pointer):
    """A ``lifecycle.promote`` fault during a canary: the promotion
    fails, the rollout rolls back, every request is answered (nothing
    quarantined), the pointer stays, and v1 serves bitwise."""
    t1, t2 = fleet["v1"], fleet["v2"]
    srv = _server(fleet)
    before = lifecycle.lifecycle_stats()
    q_before = resilience.resilience_stats()
    plan = resilience.FaultPlan(seed=9).on("lifecycle.promote",
                                           error=RuntimeError)
    try:
        srv.deploy("churn", t2["vid"], mode="canary", fraction=1.0,
                   window_requests=2, promote_windows=1)
        with resilience.fault_plan(plan):
            answered = sum(
                srv.score("churn", [t1["records"][i]],
                          timeout_s=120).rows for i in range(12))
        assert answered == 12
        assert plan.fired("lifecycle.promote") == 1
        after = lifecycle.lifecycle_stats()
        assert after["auto_rollbacks"] - before["auto_rollbacks"] == 1
        assert after["auto_promotions"] == before["auto_promotions"]
        assert srv._entries["churn"].rollout is None
        assert fresh_pointer.current("churn") == t1["vid"]
        q_after = resilience.resilience_stats()
        for k in ("quarantined_batches", "quarantined_records"):
            assert q_after[k] == q_before[k]
        recs = t1["records"][:4]
        res = srv.score("churn", recs, timeout_s=120)
        assert_bitwise(res.store[t1["pred"]], _solo(t1, recs, res.bucket))
    finally:
        srv.shutdown(drain=True)


def test_rollout_windows_evidence_races_and_poison(fleet, fresh_pointer):
    """A window without candidate evidence neither promotes nor resets; a
    manual rollback wins over a racing promote; a request whose record
    cannot be hashed for routing takes the stable path and the worker
    lives."""
    t1, t2 = fleet["v1"], fleet["v2"]
    srv = _server(fleet)
    try:
        srv.deploy("churn", t1["vid"], mode="shadow", window_requests=1,
                   promote_windows=1)
        entry = srv._entries["churn"]
        rollout = entry.rollout
        srv._rollout_tick(entry, rollout, 1)
        assert entry.rollout is rollout
        assert rollout.windows == 1 and rollout.clean_windows == 0
        rollout.win_evidence = 2
        srv._rollout_tick(entry, rollout, 1)
        assert entry.rollout is None             # promoted

        srv.deploy("churn", t2["vid"], mode="shadow",
                   window_requests=10 ** 6)
        rollout = entry.rollout
        assert srv.rollback("churn")["aborted"] == t2["vid"]
        before = lifecycle.lifecycle_stats()
        srv._promote_rollout(entry, rollout)     # the racing worker
        assert lifecycle.lifecycle_stats()["auto_promotions"] == \
            before["auto_promotions"]
        assert fresh_pointer.current("churn") == t1["vid"]

        srv.deploy("churn", t2["vid"], mode="canary", fraction=1.0,
                   window_requests=10 ** 6)
        res = srv.score("churn", [{(1, 2): "unroutable"}], timeout_s=120)
        assert res.rows == 1 and res.canary is False
        assert srv.score("churn", t1["records"][:2], timeout_s=120).rows == 2
    finally:
        srv.shutdown(drain=True)


def test_deploy_misuse_errors(fleet):
    srv = _server(fleet)
    try:
        with pytest.raises(RolloutError):
            srv.deploy("churn", fleet["v1"]["vid"], mode="blue-green")
        with pytest.raises(RegistryError):
            srv.deploy("churn", "no-such-version")
        with pytest.raises(RolloutError):
            srv.deploy("churn", fleet["v2"]["vid"], mode="canary",
                       fraction=1.5)
        with pytest.raises(ModelNotFound):
            srv.deploy("ghost", fleet["v1"]["vid"])
        no_reg = ModelServer(device="cpu")
        try:
            no_reg.register("m", model_dir=fleet["v1"]["model_dir"])
            with pytest.raises(RolloutError):
                no_reg.deploy("m", "v")
            with pytest.raises(RolloutError):
                no_reg.rollback("m")
        finally:
            no_reg.shutdown(drain=True)
    finally:
        srv.shutdown(drain=True)


def test_the_server_sentinel_flags_shifted_traffic_and_scores_stay_bitwise(
        fleet):
    """In-distribution traffic raises nothing; x1 shifted far out of its
    training range raises TMG601 within one window, and the shifted
    requests' scores are bitwise the solo ones."""
    t1 = fleet["v1"]
    srv = _server(fleet, drift_window=64)
    try:
        for lo in range(0, 64, 8):
            srv.score("churn", t1["records"][lo:lo + 8], timeout_s=120)
        srv.drain_drift()
        st = srv.stats()["models"]["churn"]["drift"]
        assert st["windowsCompared"] >= 1 and st["advisories"] == 0
        shifted = [dict(r, x1=r["x1"] + 40.0) for r in t1["records"][:64]]
        for lo in range(0, 64, 8):
            res = srv.score("churn", shifted[lo:lo + 8], timeout_s=120)
            assert_bitwise(res.store[t1["pred"]],
                           _solo(t1, shifted[lo:lo + 8], res.bucket))
        srv.drain_drift()
        st = srv.stats()["models"]["churn"]["drift"]
        assert st["advisories"] >= 1
        last = srv._entries["churn"].sentinel.last_findings
        assert any(f.rule == "TMG601" and f.feature == "x1" for f in last)
        assert srv.lifecycle_status("churn")["drift"] == st
    finally:
        srv.shutdown(drain=True)


def _call(host, port, method, path, body=None):
    import http.client
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def test_http_lifecycle_endpoints(fleet, fresh_pointer):
    t1, t2 = fleet["v1"], fleet["v2"]
    srv = _server(fleet)
    httpd = serve_http(srv, port=0)
    host, port = httpd.server_address
    try:
        status, doc = _call(host, port, "GET", "/v1/models/churn/versions")
        assert status == 200
        assert doc["current"] == t1["vid"] and doc["rollout"] is None
        assert {r["version"] for r in doc["versions"]} == \
            {t1["vid"], t2["vid"]}
        status, doc = _call(host, port, "POST", "/v1/models/churn:deploy",
                            {"version": t2["vid"], "mode": "shadow",
                             "windowRequests": 1000})
        assert status == 200 and doc["rollout"]["mode"] == "shadow"
        status, doc = _call(host, port, "POST", "/v1/models/churn:score",
                            {"records": t1["records"][:2]})
        assert status == 200 and doc["rows"] == 2 and not doc["canary"]
        status, doc = _call(host, port, "POST",
                            "/v1/models/churn:rollback", {})
        assert status == 200 and doc["aborted"] == t2["vid"]
        assert _call(host, port, "POST", "/v1/models/churn:deploy",
                     {"version": t2["vid"], "mode": "blue-green"})[0] == 400
        assert _call(host, port, "GET", "/v1/models/ghost/versions")[0] \
            == 404
    finally:
        httpd.shutdown()
        srv.shutdown(drain=True)


def test_cli_registry_subcommand(fleet, tmp_path, capsys):
    from transmogrifai_tpu_torch.cli import main
    reg_dir = str(tmp_path / "reg")
    t1, t2 = fleet["v1"], fleet["v2"]
    assert main(["registry", "register", "--registry", reg_dir,
                 "--model", "churn", "--model-dir", t1["model_dir"],
                 "--bank", t1["export_dir"], "--promote"]) == 0
    assert t1["vid"] in capsys.readouterr().out
    assert main(["registry", "register", "--registry", reg_dir,
                 "--model", "churn", "--model-dir", t2["model_dir"],
                 "--bank", t2["export_dir"]]) == 0
    assert t2["vid"] in capsys.readouterr().out
    assert main(["registry", "list", "--registry", reg_dir, "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["churn"]["current"] == t1["vid"]
    assert len(doc["churn"]["versions"]) == 2
    assert main(["registry", "promote", "--registry", reg_dir,
                 "--model", "churn", "--version", t2["vid"]]) == 0
    capsys.readouterr()
    assert main(["registry", "current", "--registry", reg_dir,
                 "--model", "churn"]) == 0
    assert capsys.readouterr().out.strip() == t2["vid"]
    assert main(["registry", "rollback", "--registry", reg_dir,
                 "--model", "churn"]) == 0
    assert t1["vid"] in capsys.readouterr().out
    assert main(["registry", "promote", "--registry", reg_dir,
                 "--model", "churn", "--version", "nope"]) == 1
    assert main(["registry", "list", "--registry", reg_dir]) == 0
    out = capsys.readouterr().out
    assert f"* {t1['vid']}" in out
