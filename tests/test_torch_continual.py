"""The port's continuous training (``transmogrifai_tpu_torch/continual.py``)
on the CPU, held against the JAX package's ``continual.py``.

Both packages' ``RetrainController``s run the same scenario side by side
with the same ``python`` trainers, each over its own package's registry
holding the same stable version: the hysteresis streak and the cooldown,
the failure budget that ends in a loud TMG605 and ``rearm``, the
``continual.retrain`` and ``continual.register`` faults, the ACTIVE-slot
flock shared by two controllers, the holdout gate, the timeout and
heartbeat kills, a registered job with no server and one handed to a
server's canary. Each scenario compares what the controllers observed,
their job records (but ids, times, pids and paths), ``status()`` and the
tally deltas. A real SIGKILL of a port controller in the middle of a job
leaves the pointer on the stable version and a record that ``recover``
repairs (the orphan trainer killed, the storm controls restored), and
``recover`` then ``replay`` of a job whose trainer finished gives the JAX
package's records. ``load_warm_stats`` reads the JAX package's persisted
statistics as the JAX function does, with TMG604 on a missing or corrupt
block; ``build_retrain_controllers`` wires a ``ModelServer``'s drift
windows, and a drifted stream on a CPU server arms a job whose candidate
the canary promotes. The JAX oracle ``tests/test_continual.py::
test_self_healing_loop_end_to_end`` fails on this tree (the 8-device
mesh), so its loop is held here on the port's CPU server."""
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import pytest

from transmogrifai_tpu import continual as jcontinual
from transmogrifai_tpu import lifecycle as jlifecycle
from transmogrifai_tpu import resilience as jresilience
from transmogrifai_tpu_torch import continual, lifecycle, lint, resilience
from transmogrifai_tpu_torch import telemetry

from _torch_server_data import BUCKET_CAP, tenant

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jcontinual, jlifecycle, jresilience),
        "port": (continual, lifecycle, resilience)}

#: a trainer that saves the stable model as its candidate, with a holdout
#: AuPR from its argument; with a second argument it also ships that
#: directory as its program bank
TRAINER = textwrap.dedent("""
    import json, os, shutil, sys
    out = os.environ["TMOG_RETRAIN_OUT"]
    shutil.copytree(sys.argv[3] if len(sys.argv) > 3
                    else os.environ["TMOG_RETRAIN_STABLE"],
                    os.path.join(out, "model"))
    if len(sys.argv) > 2:
        shutil.copytree(sys.argv[2], os.path.join(out, "export"))
    with open(os.path.join(out, "metrics.json"), "w") as fh:
        json.dump({"holdoutEvaluation": {"AuPR": float(sys.argv[1])}}, fh)
""")


def _fail_cmd(code=3):
    return [sys.executable, "-c", f"import sys; sys.exit({code})"]


def _sleep_cmd(s, code=0):
    return [sys.executable, "-c",
            f"import sys, time; time.sleep({s}); sys.exit({code})"]


def _drifted():
    return [SimpleNamespace(rule="TMG601", feature="x1")]


@pytest.fixture(scope="module")
def tenants(tmp_path_factory):
    """The stable model (v1) and a candidate (v2), JAX-trained with a
    RawFeatureFilter (the drift sentinel's distributions), exported by
    the port."""
    return {tag: tenant(seed, str(tmp_path_factory.mktemp(f"model_{tag}")),
                        str(tmp_path_factory.mktemp(f"export_{tag}")),
                        rff_bins=20)
            for tag, seed in (("v1", 11), ("v2", 12))}


@pytest.fixture()
def trainer(tmp_path):
    path = tmp_path / "trainer.py"
    path.write_text(TRAINER)
    return str(path)


def _registry(pkg, root, t1):
    reg = PKGS[pkg][1].ModelRegistry(root)
    reg.register("churn", t1["model_dir"], version="stable",
                 train_metrics={"holdoutEvaluation": {"AuPR": 0.9}},
                 promote=True)
    return reg


class _Server:
    """What a controller asks of a server: the drift subscription and
    ``deploy``."""

    def __init__(self):
        self.deploys, self.subs = [], []

    def subscribe_drift(self, name, fn):
        self.subs.append((name, fn))

    def deploy(self, name, version, **kw):
        self.deploys.append((name, version, kw))
        return {}


def _norm(obj, roots):
    s = json.dumps(obj, default=str, sort_keys=True)
    for r in roots:
        s = s.replace(r, "<root>")
    return json.loads(re.sub(r"job-\d+-\d+", "job-<id>", s))


_VOLATILE = ("jobId", "createdAt", "startedAt", "finishedAt",
             "controllerPid", "pid", "outDir", "log", "traceparent")


def _jobs(c, roots):
    return [_norm({k: v for k, v in j.items() if k not in _VOLATILE},
                  roots) for j in c.jobs()]


def _status(c, roots):
    st = dict(c.status())
    st.pop("jobDir")
    st["cooldown"] = st.pop("cooldownRemainingS") > 0
    if st["lastJob"]:
        st["lastJob"] = {k: v for k, v in st["lastJob"].items()
                         if k != "jobId"}
    return _norm(st, roots)


def _hysteresis(c, ctx):
    seen = []
    c.on_window(_drifted(), {})
    seen.append(c.status()["streak"])
    c.on_window([], {})
    seen.append(c.status()["streak"])
    c.on_window(_drifted(), {})
    c.on_window(_drifted(), {"window": 2})
    seen.append(c.wait_idle(60))
    c.on_window(_drifted(), {})
    c.on_window(_drifted(), {})
    seen.append(len(c.jobs()))
    return seen


def _budget(c, ctx):
    seen = []
    for _ in range(2):
        c.on_window(_drifted(), {})
        seen.append((c.wait_idle(60), c.status()["disarmed"]))
    c.on_window(_drifted(), {})
    seen.append(len(c.jobs()))
    c.rearm()
    c.on_window(_drifted(), {})
    seen.append((c.wait_idle(60), len(c.jobs())))
    return seen


def _one_job(c, ctx):
    with resilience.fault_plan(ctx["plans"]["port"]), \
            jresilience.fault_plan(ctx["plans"]["jax"]):
        job = c.trigger("manual")
        done = c.wait_idle(60)
    site = ctx["site"]
    return [job is not None, done,
            ctx["plans"][ctx["pkg"]].fired(site) if site else None]


def _flock(c, ctx):
    twin = ctx["twin"]
    assert c.trigger() is not None
    deadline = time.monotonic() + 30
    while not c.jobs() and time.monotonic() < deadline:
        time.sleep(0.02)
    seen = [twin.trigger() is not None]
    seen.append((c.wait_idle(60), twin.wait_idle(60), len(c.jobs())))
    return seen


#: scenario: (controller keywords, command, driver, fault site)
SCENARIOS = {
    "hysteresis-cooldown": (dict(arm_windows=2, cooldown_s=60.0,
                                 max_failures=10), "fail", _hysteresis,
                            None),
    "failure-budget": (dict(arm_windows=1, cooldown_s=0.0, max_failures=2),
                       "fail", _budget, None),
    "retrain-fault": (dict(arm_windows=1, cooldown_s=0.0), "good",
                      _one_job, "continual.retrain"),
    "register-fault": (dict(arm_windows=1, cooldown_s=0.0), "good",
                       _one_job, "continual.register"),
    "holdout-gate": (dict(arm_windows=1, cooldown_s=0.0), "worse",
                     _one_job, None),
    "registered": (dict(arm_windows=1, cooldown_s=0.0), "good", _one_job,
                   None),
    "deployed": (dict(arm_windows=1, cooldown_s=0.0, canary_fraction=0.25,
                      window_requests=8, promote_windows=2), "good",
                 _one_job, None),
    "timeout": (dict(arm_windows=1, cooldown_s=0.0, timeout_s=0.5),
                "sleep", _one_job, None),
    "heartbeat": (dict(arm_windows=1, cooldown_s=0.0,
                       heartbeat_timeout_s=0.3), "sleep", _one_job, None),
    "active-flock": (dict(arm_windows=1, cooldown_s=0.0), "slow", _flock,
                     None),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_controller_state_machine_equals_the_jax_packages(name, tenants,
                                                          trainer,
                                                          tmp_path):
    kw, cmd_kind, drive, site = SCENARIOS[name]
    cmd = {"fail": _fail_cmd(),
           "good": [sys.executable, trainer, "0.95"],
           "worse": [sys.executable, trainer, "0.05"],
           "sleep": _sleep_cmd(30),
           "slow": _sleep_cmd(1.0, code=4)}[cmd_kind]
    out, roots = {}, [str(tmp_path / p) for p in PKGS]
    for pkg, (C, _LC, R) in PKGS.items():
        reg = _registry(pkg, str(tmp_path / pkg / "registry"),
                        tenants["v1"])
        backoff = R.RetryPolicy(max_attempts=4, base_delay_s=0.0,
                                max_delay_s=0.0, jitter=0.0)
        srv = _Server() if name == "deployed" else None
        c = C.RetrainController("churn", reg, cmd, server=srv,
                                job_dir=str(tmp_path / pkg / "jobs"),
                                backoff=backoff, **kw)
        twin = C.RetrainController("churn", reg, cmd,
                                   job_dir=str(tmp_path / pkg / "jobs"),
                                   backoff=backoff, **kw)
        plans = {"port": resilience.FaultPlan(seed=7),
                 "jax": jresilience.FaultPlan(seed=7)}
        if site:
            plans[pkg].on(site, error=OSError)
        before = C.continual_stats()
        seen = drive(c, {"plans": plans, "site": site, "pkg": pkg,
                         "twin": twin})
        after = C.continual_stats()
        out[pkg] = {"seen": seen, "jobs": _jobs(c, roots),
                    "status": _status(c, roots),
                    "tallies": {k: after[k] - before[k] for k in after},
                    "current": reg.current("churn"),
                    "versions": len(reg.versions("churn")),
                    "deploys": srv.deploys if srv else None}
    assert out["port"] == out["jax"]
    states = [j["state"] for j in out["port"]["jobs"]]
    want = {"hysteresis-cooldown": ["failed"],
            "failure-budget": ["failed"] * 3,
            "retrain-fault": ["failed"], "register-fault": ["failed"],
            "holdout-gate": ["rejected"], "registered": ["succeeded"],
            "deployed": ["deployed"], "timeout": ["killed"],
            "heartbeat": ["killed"], "active-flock": ["failed"]}[name]
    assert states == want
    if name == "deployed":
        assert out["port"]["deploys"] == [
            ("churn", out["port"]["jobs"][0]["version"],
             {"mode": "canary", "drift_gate": False, "fraction": 0.25,
              "window_requests": 8, "promote_windows": 2})]


def test_the_failure_budget_emits_tmg605_loudly(tenants, tmp_path):
    seen = []

    class L(telemetry.RunListener):
        def on_lint(self, rule, severity, message="", **_):
            seen.append((rule, severity))

        def on_retrain(self, model, action, job=None, version=None, **_):
            seen.append(("retrain", action))

    listener = telemetry.add_listener(L())
    telemetry.enable()
    try:
        reg = _registry("port", str(tmp_path / "reg"), tenants["v1"])
        c = continual.RetrainController(
            "churn", reg, _fail_cmd(), job_dir=str(tmp_path / "jobs"),
            arm_windows=1, cooldown_s=0.0, max_failures=1,
            backoff=resilience.RetryPolicy(max_attempts=2,
                                           base_delay_s=0.0,
                                           max_delay_s=0.0, jitter=0.0))
        c.on_window(_drifted(), {})
        assert c.wait_idle(60) and c.status()["disarmed"]
    finally:
        telemetry.remove_listener(listener)
        telemetry.disable()
        telemetry.reset()
    assert ("TMG605", "error") in seen
    assert [a for k, a in seen if k == "retrain"] == \
        ["trigger", "start", "failed", "gave_up"]
    assert lint.RULES["TMG605"][0] == "error"


def _stale_record(job_dir, out_dir, finished):
    os.makedirs(os.path.join(job_dir, "jobs"), exist_ok=True)
    record = {"jobId": "job-x", "model": "churn", "state": "running",
              "trigger": None, "cmd": ["true"], "outDir": out_dir,
              "log": os.path.join(job_dir, "jobs", "job-x.log"),
              "createdAt": 0.0, "controllerPid": 2 ** 22 + os.getpid(),
              "pid": None, "exitCode": 0 if finished else None,
              "version": None, "error": None, "replayable": False}
    with open(os.path.join(job_dir, "jobs", "job-x.json"), "w") as fh:
        json.dump(record, fh)


@pytest.mark.parametrize("finished", [True, False])
def test_recover_and_replay_equal_the_jax_packages(finished, tenants,
                                                   tmp_path):
    """A record left ``running`` by a dead controller: ``recover`` marks
    it interrupted (replayable once the trainer's save is on disk) and
    restores the failure budget; ``replay`` registers without training
    and leaves the pointer alone; a job that is not replayable raises.
    The JAX controller's records, status and tallies."""
    out, roots = {}, [str(tmp_path / p) for p in PKGS]
    for pkg, (C, _LC, R) in PKGS.items():
        root = str(tmp_path / pkg)
        reg = _registry(pkg, os.path.join(root, "registry"), tenants["v1"])
        jd = os.path.join(root, "jobs")
        out_dir = os.path.join(jd, "jobs", "job-x.out")
        if finished:
            shutil.copytree(tenants["v2"]["model_dir"],
                            os.path.join(out_dir, "model"))
            with open(os.path.join(out_dir, "metrics.json"), "w") as fh:
                json.dump({"AuPR": 0.99}, fh)
        _stale_record(jd, out_dir, finished)
        c = C.RetrainController("churn", reg, _fail_cmd(), job_dir=jd,
                                cooldown_s=0.0, max_failures=3)
        before = C.continual_stats()
        seen = [len(c.recover())]
        if finished:
            seen.append(c.replay("job-x")["state"])
        with pytest.raises(C.ContinualError, match="not replayable"):
            c.replay("job-x")
        after = C.continual_stats()
        out[pkg] = {"seen": seen, "jobs": _jobs(c, roots),
                    "status": _status(c, roots),
                    "tallies": {k: after[k] - before[k] for k in after},
                    "current": reg.current("churn"),
                    "versions": len(reg.versions("churn"))}
    assert out["port"] == out["jax"]
    assert out["port"]["current"] == "stable"
    assert out["port"]["versions"] == (2 if finished else 1)


def test_sigkill_in_the_middle_of_a_job_leaves_the_pointer_and_a_record(
        tenants, tmp_path):
    """A real controller process is SIGKILLed while its trainer runs: the
    stable version stays current, the record says ``running``, a fresh
    controller's ``recover`` marks it interrupted (not replayable: the
    trainer never saved), kills the orphan trainer and restores the
    cooldown, so a trigger right after is suppressed."""
    reg_dir = str(tmp_path / "registry")
    reg = _registry("port", reg_dir, tenants["v1"])
    jd = str(tmp_path / "jobs")
    child = textwrap.dedent(f"""
        import sys, time
        from transmogrifai_tpu_torch.continual import RetrainController
        from transmogrifai_tpu_torch.lifecycle import ModelRegistry
        c = RetrainController(
            "churn", ModelRegistry({reg_dir!r}),
            [sys.executable, "-c", "import time; time.sleep(120)"],
            job_dir={jd!r}, arm_windows=1, cooldown_s=300.0,
            max_failures=3)
        assert c.trigger() is not None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            jobs = c.jobs()
            if jobs and jobs[-1]["state"] == "running":
                print("RUNNING", jobs[-1]["pid"], flush=True)
                break
            time.sleep(0.05)
        time.sleep(300)
    """)
    proc = subprocess.Popen([sys.executable, "-c", child], cwd=ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith("RUNNING"), line + proc.stdout.read()[-2000:]
        trainer_pid = int(line.split()[1])
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert reg.current("churn") == "stable"
    probe = continual.RetrainController(
        "churn", reg, _fail_cmd(), job_dir=jd, arm_windows=1,
        cooldown_s=300.0, max_failures=3)
    assert probe.jobs()[-1]["state"] == "running"
    assert continual._pid_alive(trainer_pid)
    killed = continual.continual_stats()["orphans_killed"]
    assert len(probe.recover()) == 1
    job = probe.jobs()[-1]
    assert job["state"] == "interrupted" and job["replayable"] is False
    assert continual.continual_stats()["orphans_killed"] == killed + 1
    deadline = time.monotonic() + 10
    while continual._pid_alive(trainer_pid) and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    assert not continual._pid_alive(trainer_pid)
    st = probe.status()
    assert st["failures"] == 1 and st["cooldownRemainingS"] > 0
    assert probe.trigger() is None
    assert reg.current("churn") == "stable"


def test_load_warm_stats_equals_the_jax_packages(tenants, tmp_path):
    """The persisted statistics of a JAX-trained model load as the JAX
    function loads them; a missing directory or a corrupt block gives
    None, a TMG604 advisory and a full-refit tally in both."""
    mdir = tenants["v1"]["model_dir"]
    warm = continual.load_warm_stats(mdir)
    jwarm = jcontinual.load_warm_stats(mdir)
    assert warm and {k: v.to_json() for k, v in warm.items()} == \
        {k: v.to_json() for k, v in jwarm.items()}
    broken = tmp_path / "broken"
    shutil.copytree(mdir, broken)
    doc = json.loads((broken / "model.json").read_text())
    doc["fitSufficientStats"] = {"0:x1": {"count": "NOT A NUMBER"}}
    (broken / "model.json").write_text(json.dumps(doc))
    for C in (continual, jcontinual):
        for d in (str(broken), str(tmp_path / "none"), None):
            before = C.continual_stats()["full_refit_fallbacks"]
            assert C.load_warm_stats(d) is None
            assert C.continual_stats()["full_refit_fallbacks"] == before + 1
    assert continual._metric_of({"a": [{"b": {"AuPR": 0.5}}]}, "AuPR") == \
        jcontinual._metric_of({"a": [{"b": {"AuPR": 0.5}}]}, "AuPR") == 0.5
    for cmd in ([], "python train.py", ["python", 3], None):
        with pytest.raises(continual.ContinualError):
            continual.validate_retrain_cmd(cmd)
    assert set(continual.continual_stats()) == \
        set(jcontinual.continual_stats())


def test_retrain_wiring_on_a_server_and_the_drift_loop(tenants, trainer,
                                                       tmp_path):
    """``build_retrain_controllers`` refuses what the JAX one refuses
    (naming ``retrainCmd`` and ``driftWindow``) and attaches a recovered
    controller to each promoted tenant's drift windows. On a CPU server,
    traffic with x1 shifted by 40 raises TMG601 for two windows, the job
    registers the trainer's candidate (v2's artifacts) and the canary
    promotes it: the pointer moves, and every request is answered."""
    from transmogrifai_tpu_torch.cli import build_retrain_controllers
    from transmogrifai_tpu_torch.runner import OpParams
    from transmogrifai_tpu_torch.server import ModelServer
    t1, t2 = tenants["v1"], tenants["v2"]
    reg = lifecycle.ModelRegistry(str(tmp_path / "registry"))
    reg.register("churn", t1["model_dir"], bank_dir=t1["export_dir"],
                 train_metrics={"AuPR": 0.5}, promote=True)
    stable = reg.current("churn")
    nodrift = ModelServer(device="cpu", bucket_cap=BUCKET_CAP, registry=reg)
    try:
        nodrift.register_from_registry("churn")
        with pytest.raises(ValueError, match="driftWindow"):
            build_retrain_controllers(OpParams(custom_params={
                "retrainOnDrift": True, "retrainCmd": _fail_cmd()}),
                nodrift)
    finally:
        nodrift.shutdown(drain=False)
    srv = ModelServer(device="cpu", bucket_cap=BUCKET_CAP, registry=reg,
                      batch_deadline_s=0.0, drift_window=64)
    try:
        srv.register_from_registry("churn")
        assert build_retrain_controllers(OpParams(), srv) == []
        with pytest.raises(ValueError, match="retrainCmd"):
            build_retrain_controllers(OpParams(custom_params={
                "retrainOnDrift": True}), srv)
        ctrls = build_retrain_controllers(OpParams(custom_params={
            "retrainOnDrift": True, "retrainArmWindows": 2,
            "retrainCooldownS": 600.0, "retrainMaxFailures": 2,
            "retrainTimeoutS": 120.0, "canaryFraction": 0.5,
            "retrainCmd": [sys.executable, trainer, "0.9",
                           t2["export_dir"], t2["model_dir"]]}), srv)
        assert len(ctrls) == 1
        c = ctrls[0]
        assert (c.arm_windows, c.max_failures, c.canary_fraction) == \
            (2, 2, 0.5)
        c.window_requests, c.promote_windows = 8, 1
        shifted = [dict(r, x1=r["x1"] + 40.0) for r in t1["records"]]
        answered, lo = 0, 0
        deadline = time.monotonic() + 120
        while reg.current("churn") == stable and \
                time.monotonic() < deadline:
            for _ in range(8):           # one drift window, then its fold
                recs = shifted[lo % 192:lo % 192 + 8]
                assert srv.score("churn", recs, timeout_s=60).rows == 8
                answered += 1
                lo += 8
            srv.drain_drift()
        job = c.jobs()[-1]
        assert job["state"] == "deployed", (job, c.status())
        assert reg.current("churn") == job["version"] != stable
        assert continual.continual_stats()["triggers"] >= 1
        assert answered >= 16
    finally:
        srv.shutdown(drain=True)
