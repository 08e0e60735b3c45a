"""The port's resilience layer (``transmogrifai_tpu_torch/resilience.py``)
against the JAX package's on the CPU: ``FaultPlan`` firing sequences,
``RetryPolicy`` delays, quarantine JSONL lines and the breaker's states
equal; the fault sites the port carries (CSV and Avro decode, the join's
retried build and its dead-letter sink, checkpoint write and rename, the
resumed fit) behaving as the JAX package's do; every ``inject`` of the
port naming a catalog site; and a fault at a device site
(``fitstats.device_pass``, ``scoring.device_dispatch``,
``pipeline.upload``, ``temporal.aggregate``) raising to the caller, never
quarantined and never served by a host tier (the JAX package degrades
there; its tests of those sites are not oracles for the port)."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from transmogrifai_tpu import resilience as J
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import resilience as P
from transmogrifai_tpu_torch.dsl import transmogrify
from transmogrifai_tpu_torch.models import (BinaryClassificationModelSelector,
                                            LogisticRegressionFamily)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "transmogrifai_tpu_torch"


@pytest.fixture(autouse=True)
def _clean():
    """Both packages' plan, sink and tallies clean before and after."""
    saved = []
    for m in (J, P):
        m.clear_plan()
        saved.append(m.set_quarantine(None))
        m.reset_resilience_stats()
    yield
    for m, prev in zip((J, P), saved):
        m.clear_plan()
        m.set_quarantine(prev)
        m.reset_resilience_stats()


def _fires(mod, make, n=40):
    plan = make(mod.FaultPlan(seed=77))
    out = []
    for _ in range(n):
        e = plan.check("s")
        out.append(None if e is None else (type(e).__name__, str(e)))
    return out, plan.calls("s"), plan.fired("s")


@pytest.mark.parametrize("case", ["at", "probability", "times", "every"])
def test_fault_plan_firing_sequences_equal_the_jax_packages(case):
    make = {
        "at": lambda p: p.on("s", error=ValueError, at=[0, 3, 17]),
        "probability": lambda p: p.on("s", probability=0.37),
        "times": lambda p: p.on("s", probability=0.9, times=4),
        "every": lambda p: p.on("s", error=KeyError),
    }[case]
    got = _fires(P, make)
    assert got == _fires(J, make)
    assert got[2] == sum(f is not None for f in got[0]) > 0


def test_inject_raises_counts_and_marks_device_sites():
    plan = P.FaultPlan().on("csv.decode", at=[1]).on(
        "scoring.device_dispatch", at=[0])
    with P.fault_plan(plan):
        P.inject("csv.decode")
        with pytest.raises(OSError, match="csv.decode") as host:
            P.inject("csv.decode")
        with pytest.raises(OSError) as dev:
            P.inject("scoring.device_dispatch")
        P.inject("stream.poll")            # an unarmed site
    assert not P.is_device_failure(host.value)
    assert P.is_device_failure(dev.value)
    assert P.resilience_stats()["faults_injected"] == 2
    P.inject("csv.decode")                 # no plan: a no-op
    assert plan.calls("csv.decode") == 2
    assert P.DEVICE_SITES <= P.FAULT_SITES
    assert P.FAULT_SITES == J.FAULT_SITES


@pytest.mark.parametrize("seed", [None, 11])
def test_retry_delays_and_tallies_equal_the_jax_packages(seed):
    def run(mod):
        sleeps = []
        pol = mod.RetryPolicy(max_attempts=5, base_delay_s=0.1,
                              max_delay_s=0.9, multiplier=2.0,
                              jitter=0.5 if seed is not None else 0.0,
                              seed=seed, sleep=sleeps.append)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 4:
                raise OSError("transient")
            return "ok"

        assert pol.call("t", flaky) == "ok"
        with pytest.raises(OSError, match="always"):
            pol.call("t", lambda: (_ for _ in ()).throw(OSError("always")))
        with pytest.raises(ValueError):         # not retryable: one call
            pol.call("t", lambda: (_ for _ in ()).throw(ValueError("x")))
        return sleeps, [pol.delay_s(a) for a in range(6)], \
            mod.resilience_stats()

    assert run(P) == run(J)


def test_quarantine_lines_equal_the_jax_packages(tmp_path):
    """The same quarantines in both packages write the same JSONL lines
    (but the wall-clock ``ts``) and the same tallies."""
    lines = {}
    for name, mod in (("jax", J), ("port", P)):
        path = str(tmp_path / name / "dead.jsonl")
        mod.set_quarantine(path)
        mod.quarantine("stream.read_file", "AvroDecodeError('x')",
                       kind="files", path="/data/b.avro")
        mod.quarantine("temporal.join", "overflow", key="'k'",
                       records=[{"a": 1}])
        mod.quarantine_batch_or_raise("quarantine", 3, ValueError("bad"),
                                      [{"x": 1.5}, {"x": None}])
        with pytest.raises(ValueError):
            mod.quarantine_batch_or_raise("quarantine", 0,
                                          ValueError("head"), [{"x": 1}])
        with pytest.raises(ValueError):
            mod.quarantine_batch_or_raise("raise", 4, ValueError("loud"),
                                          [{"x": 1}])
        entries = mod.Quarantine(path).entries()
        for e in entries:
            assert isinstance(e.pop("ts"), float)
        lines[name] = (entries, mod.resilience_stats())
        mod.set_quarantine(None)
    assert lines["port"] == lines["jax"]
    assert [e["kind"] for e in lines["port"][0]] \
        == ["files", "records", "batches"]


def test_resolve_on_error_follows_the_sink(tmp_path):
    for mod in (J, P):
        assert mod.resolve_on_error(None) == "raise"
        mod.set_quarantine(str(tmp_path / "q.jsonl"))
        assert mod.resolve_on_error(None) == "quarantine"
        assert mod.resolve_on_error("raise") == "raise"
        with pytest.raises(ValueError, match="on_error"):
            mod.resolve_on_error("drop")
        mod.set_quarantine(None)


def test_device_failures_are_never_quarantined(tmp_path):
    P.set_quarantine(str(tmp_path / "q.jsonl"))
    err = P.mark_device_failure(RuntimeError("card"))
    with pytest.raises(RuntimeError, match="card"):
        P.quarantine_batch_or_raise("quarantine", 5, err, [{"x": 1}])
    assert P.resilience_stats()["quarantined_batches"] == 0


def test_breaker_states_equal_the_jax_packages():
    def run(mod):
        b = mod.CircuitBreaker("t", failure_threshold=2,
                               reset_timeout_s=0.0)
        out = [b.state]
        b.record_failure()
        out.append(b.state)
        b.record_failure()
        out += [b.state, b.allow(), b.state]
        b.record_failure()
        out.append(b.state)
        out.append(b.allow())
        b.record_success()
        out += [b.state, b.consecutive_failures]
        return out, mod.resilience_stats()["breaker_trips"]

    assert run(P) == run(J)


def test_every_inject_names_a_catalog_site():
    """The port's counterpart of the JAX tree's TMG303: every literal
    ``resilience.inject("...")`` under ``transmogrifai_tpu_torch/`` names
    a ``FAULT_SITES`` entry (a misspelled site never fires)."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Call) \
                    and getattr(node.func, "attr", None) == "inject" \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant):
                found.append((path.name, node.args[0].value))
    bad = [f for f in found if f[1] not in P.FAULT_SITES]
    assert not bad, bad
    sites = {s for _p, s in found}
    assert P.DEVICE_SITES <= sites
    assert {"stream.poll", "stream.read_file", "stream.score_batch",
            "avro.decode", "csv.decode", "temporal.join",
            "checkpoint.write", "checkpoint.rename",
            "continual.merge_stats"} <= sites


def test_decode_sites_fire_and_retry(tmp_path):
    """``csv.decode`` and ``avro.decode`` fire inside the readers; the
    directory reader's READER_RETRY rides a transient one."""
    from transmogrifai_tpu_torch.readers import (DataReaders,
                                                 DirectoryStreamReader)
    from transmogrifai_tpu_torch.readers.avro import write_avro_records
    fp = tmp_path / "a.csv"
    fp.write_text("x,y\n1,2\n")
    with P.fault_plan(P.FaultPlan().on("csv.decode", at=[0])):
        with pytest.raises(OSError, match="csv.decode"):
            DataReaders.simple.csv_auto(str(fp)).read_records()
    d = tmp_path / "in"
    d.mkdir()
    write_avro_records(str(d / "p.avro"), [{"v": 1.0}])
    plan = P.FaultPlan().on("avro.decode", at=[0])
    with P.fault_plan(plan):
        got = [[dict(r) for r in b] for b in DirectoryStreamReader(
            str(d), settle_s=0.0).stream(passes=1)]
    assert got == [[{"v": 1.0}]]
    assert plan.fired("avro.decode") == 1
    assert P.resilience_stats()["retries"] == 1


def _join_readers(pkg_readers, lefts, rights, cap):
    return pkg_readers.TemporalJoinReader(
        pkg_readers.DataReaders.simple.records(lefts),
        pkg_readers.DataReaders.simple.records(rights),
        key_field="id", partitions=2, table_max_rows=cap)


def test_join_overflow_goes_to_the_dead_letter_sink(tmp_path):
    """The rows a bounded build table drops go to the quarantine with
    their records, as in the JAX package: the same entries and joined
    rows; a transient build fault rides READER_RETRY."""
    from transmogrifai_tpu.readers import data_readers as JR
    from transmogrifai_tpu_torch.readers import data_readers as PR
    rights = [{"id": f"k{i}", "w": float(i)} for i in range(12)]
    lefts = [{"id": f"k{i % 14}", "x": i} for i in range(20)]
    out = {}
    for name, mod, R in (("jax", J, JR), ("port", P, PR)):
        path = str(tmp_path / name / "q.jsonl")
        mod.set_quarantine(path)
        plan = mod.FaultPlan().on("temporal.join", at=[0])
        with mod.fault_plan(plan):
            joined = _join_readers(R, lefts, rights, 3).read_records()
        entries = mod.Quarantine(path).entries()
        for e in entries:
            e.pop("ts")
        out[name] = (joined, entries, mod.resilience_stats())
        mod.set_quarantine(None)
    assert out["port"] == out["jax"]
    assert out["port"][2]["quarantined_records"] == 12 - 2 * 3
    assert out["port"][2]["retries"] == 1


def _small_model(n=300):
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, n).astype(float)
    x = rng.normal(size=n) + y
    recs = [{"label": float(y[i]), "x": float(x[i])} for i in range(n)]
    label = PFB.RealNN("label").from_column().as_response()
    fx = PFB.Real("x").from_column().as_predictor()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily()], splitter=None,
        seed=7)
    pred = label.transform_with(sel, transmogrify([fx]))
    wf = PWorkflow().set_input_records(recs).set_result_features(pred)
    return wf, recs, pred


def test_checkpoint_sites_and_the_resumed_fit(tmp_path):
    """``checkpoint.write`` rides CHECKPOINT_RETRY; a fault at
    ``checkpoint.rename`` leaves a loadable checkpoint that
    ``fit(resume_from=)`` resumes from (counted in ``resumed_fits``)."""
    from transmogrifai_tpu_torch.model_io import _atomic_checkpoint
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    wf, recs, pred = _small_model()
    model = wf.train(device="cpu")
    ck = str(tmp_path / "ck")
    saved = P.CHECKPOINT_RETRY._sleep
    P.CHECKPOINT_RETRY._sleep = lambda _d: None
    try:
        with P.fault_plan(P.FaultPlan().on("checkpoint.write", at=[0])):
            _atomic_checkpoint(model, ck)
        assert P.resilience_stats()["retries"] == 1
        with P.fault_plan(P.FaultPlan().on("checkpoint.rename", at=[0])):
            with pytest.raises(OSError, match="checkpoint.rename"):
                _atomic_checkpoint(model, ck)
    finally:
        P.CHECKPOINT_RETRY._sleep = saved
    assert WorkflowModel.load(ck).fitted_stages
    resumed = wf.fit(resume_from=ck, device="cpu")
    assert P.resilience_stats()["resumed_fits"] == 1
    assert np.array_equal(resumed.score(recs, device="cpu")[pred.name]
                          .probability,
                          model.score(recs, device="cpu")[pred.name]
                          .probability)


@pytest.mark.parametrize("site", ["scoring.device_dispatch",
                                  "pipeline.upload"])
@pytest.mark.parametrize("overlap", [False, True])
def test_scoring_device_faults_raise_out_of_the_stream(site, overlap,
                                                       tmp_path):
    """A fault at a scoring device site raises out of ``stream_score``
    with a sink installed and ``on_error="quarantine"``, on the plain
    path (batches past ``SCORING_MIN_ROWS`` take the engine) and the
    overlapped one: nothing is quarantined."""
    from transmogrifai_tpu_torch.readers import stream_score
    wf, _recs, _pred = _small_model()
    model = wf.train(device="cpu")
    rng = np.random.default_rng(3)
    batches = [[{"label": 0.0, "x": float(v)} for v in rng.normal(size=2100)]
               for _ in range(3)]
    P.set_quarantine(str(tmp_path / "q.jsonl"))
    with P.fault_plan(P.FaultPlan().on(site, at=[1])):
        with pytest.raises(OSError, match=site) as ei:
            list(stream_score(model, batches, overlap=overlap,
                              on_error="quarantine", device="cpu"))
    assert P.is_device_failure(ei.value)
    assert P.resilience_stats()["quarantined_batches"] == 0


_CARD_ERRORS = {
    "oom": lambda: torch.OutOfMemoryError("CUDA out of memory."),
    "accelerator": lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
    "cuda-text": lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"),
    "kernel-launch": lambda: RuntimeError(
        "level_epilogue kernel launch failed: CUDA error 700"),
}


@pytest.mark.parametrize("kind", sorted(_CARD_ERRORS) + ["poison"])
@pytest.mark.parametrize("route", ["stream_score", "disabled_engine"])
def test_card_errors_on_the_layer_path_raise(kind, route, tmp_path):
    """The layer-by-layer path (batches under ``SCORING_MIN_ROWS``,
    ``overlap=False``; or ``stream_score_overlapped`` with an engine that
    fuses nothing) reaches the card without the engine's tagging: a card
    error there still raises out of the stream with a sink installed,
    and only a host error (``poison``) is quarantined."""
    from transmogrifai_tpu_torch.readers import stream_score
    from transmogrifai_tpu_torch.scoring import stream_score_overlapped
    wf, _recs, _pred = _small_model()
    model = wf.train(device="cpu")
    batches = [[{"label": 0.0, "x": float(i + b)} for i in range(50)]
               for b in range(3)]
    real_score = model.score
    calls = []

    def score(data, **kw):
        calls.append(len(calls))
        if len(calls) == 2:
            raise (_CARD_ERRORS[kind]() if kind != "poison"
                   else ValueError("a bad record"))
        return real_score(data, **kw)

    model.score = score
    P.set_quarantine(str(tmp_path / "q.jsonl"))
    if route == "stream_score":
        run = stream_score(model, batches, overlap=False,
                           on_error="quarantine", device="cpu")
    else:
        class Fuses:
            device = torch.device("cpu")

            def enabled(self):
                return False

        run = stream_score_overlapped(model, batches, engine=Fuses(),
                                      on_error="quarantine")
    if kind == "poison":
        assert len(list(run)) == 2
        assert P.resilience_stats()["quarantined_batches"] == 1
        return
    with pytest.raises(RuntimeError) as ei:
        list(run)
    assert P.is_device_failure(ei.value)
    assert P.resilience_stats()["quarantined_batches"] == 0


def test_fitstats_device_fault_raises():
    """A fault at ``fitstats.device_pass`` raises out of the statistics
    pass and out of the streamed fold; no host tier takes it over."""
    from transmogrifai_tpu_torch import fitstats as PF
    from transmogrifai_tpu_torch.columns import ColumnStore, NumericColumn
    from transmogrifai_tpu_torch.types import feature_types as ft
    n = 300
    store = ColumnStore({"x": NumericColumn(
        ft.Real, np.arange(n, dtype=float), np.ones(n, bool))}, n)
    plan = PF.LayerStatsPlan([PF.StatRequest("mean", "x")], n_stages=1)
    with P.fault_plan(P.FaultPlan().on("fitstats.device_pass")):
        with pytest.raises(OSError, match="fitstats.device_pass"):
            plan.run(store, device=True, workflow_device="cpu",
                     dtype=torch.float64)
        fold = PF.StreamingMomentFold(["x"], device="cpu")
        fold.update(store)
        with pytest.raises(OSError, match="fitstats.device_pass"):
            fold.finalize()
    assert plan.run(store, device=True, workflow_device="cpu",
                    dtype=torch.float64).value("mean", "x") == 149.5


def test_temporal_aggregate_fault_raises():
    """A fault at ``temporal.aggregate`` raises out of the columnar route
    and the directory tier instead of folding row-wise."""
    from transmogrifai_tpu_torch import temporal
    from transmogrifai_tpu_torch.readers import data_readers as PR
    from transmogrifai_tpu_torch.utils import aggregators as PA
    table = temporal.table_from_records(
        [{"id": f"u{i % 3}", "ts": float(i), "x": float(i)}
         for i in range(12)])
    x = PFB.Real("x").extract(temporal.field("x"), "x").aggregate(
        PA.SumAggregator()).as_predictor()
    class Source:                       # hands the columnar batch over
        key_fn = staticmethod(temporal.field("id"))

        def read_records(self):
            return table

    reader = PR.AggregateReader(Source(), temporal.field("ts"),
                                key_fn=temporal.field("id"))
    before = temporal.temporal_stats()["rowwise_aggregates"]
    with P.fault_plan(P.FaultPlan().on("temporal.aggregate")):
        with pytest.raises(OSError, match="temporal.aggregate"):
            reader.generate_store([x])
        with pytest.raises(OSError, match="temporal.aggregate"):
            temporal.aggregate_tables([table], [x], "ts", "id")
    assert temporal.temporal_stats()["rowwise_aggregates"] == before
    assert temporal.aggregate_tables([table], [x], "ts", "id").n_rows == 3
