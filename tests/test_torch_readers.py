"""The port's readers (``transmogrifai_tpu_torch/readers/data_readers.py``)
against the JAX package's on the same files and records: the
header-inferring CSV reader, Parquet, Avro, the time filter and the
filtered reader, the joined readers and the factories; ``stream_score``
equal to scoring each batch on its own, and its poison batches
quarantined; and the dataprep walkthrough's
rows equal to ``examples/dataprep.py``'s."""
import os
import sys

import numpy as np
import pytest

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu.readers import data_readers as JR
from transmogrifai_tpu.utils import aggregators as JA
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import dataprep
from transmogrifai_tpu_torch.dsl import transmogrify
from transmogrifai_tpu_torch.models import (BinaryClassificationModelSelector,
                                            LogisticRegressionFamily)
from transmogrifai_tpu_torch.readers import data_readers as PR
from transmogrifai_tpu_torch.utils import aggregators as PA

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _records(n=60, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": f"u{int(rng.integers(0, 9))}", "ts": int(t),
             "x": float(rng.normal()) if i % 7 else None,
             "tag": ["a", "b", "c"][i % 3]}
            for i, t in enumerate(rng.integers(0, 1000, n))]


def _write_csv(path, recs, header=True):
    names = list(recs[0])
    lines = [",".join(names)] if header else []
    for r in recs:
        lines.append(",".join("" if r[k] is None else str(r[k])
                              for k in names))
    path.write_text("\n".join(lines) + "\n")
    return names


def test_csv_auto_reader_infers_the_header(tmp_path):
    recs = _records()
    fp = tmp_path / "a.csv"
    _write_csv(fp, recs)
    got = PR.DataReaders.simple.csv_auto(str(fp)).read_records()
    assert got == JR.DataReaders.simple.csv_auto(str(fp)).read_records()
    assert len(got) == len(recs) and list(got[0]) == list(recs[0])
    assert [r["x"] is None for r in got] == [r["x"] is None for r in recs]


def test_parquet_reader(tmp_path):
    pd = pytest.importorskip(
        "pandas", reason="ParquetReader reads through pandas")
    pytest.importorskip("pyarrow", reason="pandas reads Parquet by pyarrow")
    recs = _records()
    fp = str(tmp_path / "a.parquet")
    pd.DataFrame(recs).to_parquet(fp)
    got = PR.DataReaders.simple.parquet(fp).read_records()
    want = JR.DataReaders.simple.parquet(fp).read_records()
    assert got == want
    assert [r["x"] for r in got] == [r["x"] for r in recs]


def test_avro_reader(tmp_path):
    from transmogrifai_tpu_torch.readers.avro import write_avro_records
    recs = _records()
    fp = str(tmp_path / "a.avro")
    write_avro_records(fp, recs)
    got = PR.DataReaders.simple.avro(fp).read_records()
    assert got == JR.AvroReader(fp).read_records() == recs


def test_time_based_filter_and_the_filtered_reader():
    recs = _records(200, seed=1)
    pf = PR.TimeBasedFilter(lambda r: r["ts"], cutoff_ms=700,
                            duration_ms=250)
    jf = JR.TimeBasedFilter(lambda r: r["ts"], cutoff_ms=700,
                            duration_ms=250)
    assert [pf.keep(r) for r in recs] == [jf.keep(r) for r in recs]
    assert pf.keep({"ts": 450}) and not pf.keep({"ts": 700}) \
        and not pf.keep({"ts": 449})
    got = PR.FilteredReader(PR.DataReaders.simple.records(recs),
                            pf.keep).read_records()
    want = JR.FilteredReader(JR.DataReaders.simple.records(recs),
                             jf.keep).read_records()
    assert got == want and 0 < len(got) < len(recs)


@pytest.mark.parametrize("join_type", ["left_outer", "inner"])
def test_joined_data_reader(join_type):
    left = _records(80, seed=2)
    right = [{"id": f"u{u}", "region": f"r{u % 3}", "x": -1.0}
             for u in range(6)]

    def join(R):
        key = (lambda r: r["id"])
        return R.JoinedDataReader(R.DataReaders.simple.records(left, key),
                                  R.DataReaders.simple.records(right, key),
                                  join_type).read_records()
    got, want = join(PR), join(JR)
    assert got == want
    assert all(r["x"] != -1.0 for r in got)     # left wins shared names


def test_joined_aggregate_reader_with_a_time_filter():
    """Profiles joined to events, a time filter, then the per-key folds:
    the JAX package's store (``JoinedDataReader.scala`` windows)."""
    profiles = [{"id": "a", "region": "west"}, {"id": "b", "region": "east"}]
    events = [{"id": "a", "ts": 100, "spend": 1.0},
              {"id": "a", "ts": 500, "spend": 2.0},
              {"id": "a", "ts": 900, "spend": 100.0},
              {"id": "b", "ts": 650, "spend": 5.0}]
    stores = {}
    for pkg, (R, A, FB) in {"port": (PR, PA, PFB),
                            "jax": (JR, JA, JFB)}.items():
        key = (lambda r: r["id"])
        reader = R.JoinedAggregateDataReader(
            R.DataReaders.simple.records(events, key),
            R.DataReaders.simple.records(profiles, key),
            timestamp_fn=lambda r: r["ts"], cutoff=R.CutOffTime(800),
            time_filter=R.TimeBasedFilter(lambda r: r["ts"], 800, 600))
        stores[pkg] = reader.generate_store([
            FB.PickList("region").from_column().as_predictor(),
            FB.Real("spend").from_column().aggregate(A.SumAggregator())
            .as_predictor()])
    for name in ("region", "spend"):
        assert stores["port"][name].to_list() == stores["jax"][name].to_list()
    assert stores["port"]["spend"].to_list() == [2.0, 5.0]


@pytest.mark.parametrize("factory", ["aggregate_records", "aggregate_csv",
                                     "conditional_records"])
def test_the_aggregating_factories(factory, tmp_path):
    recs = [{"id": r["id"], "ts": r["ts"], "x": r["x"] or 0.0}
            for r in _records(120, seed=3)]
    fp = tmp_path / "e.csv"
    _write_csv(fp, recs, header=False)

    def make(R):
        key, ts = (lambda r: r["id"]), (lambda r: float(r["ts"]))
        if factory == "aggregate_records":
            return R.DataReaders.aggregate.records(
                recs, ts, R.CutOffTime.at(600), key_fn=key)
        if factory == "aggregate_csv":
            return R.DataReaders.aggregate.csv(
                str(fp), ["id", "ts", "x"], ts, R.CutOffTime.at(600),
                key_fn=key)
        return R.DataReaders.conditional.records(
            recs, ts, lambda r: float(r["x"]) > 1.0, key_fn=key)
    got = make(PR).generate_store([
        PFB.Real("x").extract(lambda r: float(r["x"]), "x")
        .aggregate(PA.SumAggregator()).as_predictor()])
    want = make(JR).generate_store([
        JFB.Real("x").extract(lambda r: float(r["x"]), "x")
        .aggregate(JA.SumAggregator()).as_predictor()])
    assert got.n_rows == want.n_rows > 0
    assert got["x"].values.tobytes() == want["x"].values.tobytes()
    assert np.array_equal(got["x"].mask, want["x"].mask)


@pytest.fixture(scope="module")
def small_model():
    rng = np.random.default_rng(9)
    n = 300
    y = rng.integers(0, 2, n).astype(float)
    x = rng.normal(size=n) + y
    recs = [{"label": float(y[i]), "x": float(x[i])} for i in range(n)]
    label = PFB.RealNN("label").from_column().as_response()
    fx = PFB.Real("x").from_column().as_predictor()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily()], splitter=None,
        seed=7)
    pred = label.transform_with(sel, transmogrify([fx]))
    model = (PWorkflow().set_input_records(recs).set_result_features(pred)
             .train(device="cpu"))
    return model, recs, pred


@pytest.mark.parametrize("overlap", [False, True, "auto"])
def test_stream_score_equals_scoring_each_batch(small_model, overlap):
    model, recs, pred = small_model
    batches = [recs[i:i + 70] for i in range(0, len(recs), 70)]
    got = list(PR.stream_score(model, batches, overlap=overlap,
                               device="cpu"))
    assert len(got) == len(batches)
    for store, batch in zip(got, batches):
        want = model.score(batch, device="cpu")
        assert store.names() == want.names() == [pred.name]
        for col in ("prediction", "probability", "raw_prediction"):
            assert np.array_equal(getattr(store[pred.name], col),
                                  getattr(want[pred.name], col))


def test_stream_score_quarantine_waits_for_its_module(small_model,
                                                     tmp_path):
    """``on_error="quarantine"`` (its module, ``resilience.py``, is
    ported) sends a failing batch past the first to the dead-letter sink
    with its records and the stream goes on; the first batch raises; an
    empty stream yields nothing."""
    from transmogrifai_tpu_torch import resilience
    model, recs, pred = small_model
    batches = [recs[:100], recs[100:200], recs[200:]]
    sink = str(tmp_path / "dead.jsonl")
    prev = resilience.set_quarantine(sink)
    plan = resilience.FaultPlan().on("stream.score_batch", at=[1])
    try:
        with resilience.fault_plan(plan):
            got = list(PR.stream_score(model, batches, overlap=False,
                                       on_error="quarantine", device="cpu"))
        with resilience.fault_plan(
                resilience.FaultPlan().on("stream.score_batch", at=[0])), \
                pytest.raises(OSError, match="injected"):
            list(PR.stream_score(model, batches, overlap=False,
                                 on_error="quarantine", device="cpu"))
    finally:
        resilience.set_quarantine(prev)
    assert len(got) == 2
    for store, batch in zip(got, (batches[0], batches[2])):
        want = model.score(batch, device="cpu")
        assert np.array_equal(store[pred.name].probability,
                              want[pred.name].probability)
    (entry,) = resilience.Quarantine(sink).entries()
    assert (entry["site"], entry["kind"], entry["index"], entry["rows"]) \
        == ("stream.score_batch", "batches", 1, 100)
    assert entry["records"] == batches[1]
    assert list(PR.stream_score(model, [], device="cpu")) == []


def test_the_dataprep_walkthrough_gives_the_examples_rows():
    sys.path.insert(0, EXAMPLES)
    try:
        import dataprep as example
    finally:
        sys.path.remove(EXAMPLES)
    want_store, want = example.run()
    store, rows = dataprep.run()
    assert rows == want
    assert rows == {0: {"minutes": 10.0, "purchase": False},
                    1: {"minutes": None, "purchase": True}}
    assert store.names() == want_store.names()
