"""The port's out-of-core ingest against the JAX package's on the CPU: the
directory stream reader's batches (Avro and CSV, passes, rescan, a
poison file quarantined once, 1 and 4 decode workers), the streamed fit
at 20,000 rows (the same model as the JAX package's; bitwise the same at
1 and 2 passes and 1 and 4 workers; its save scoring alike in the JAX
package), and the temporal directory tier's stores
(``aggregate_directory``, ``aggregate_tables``,
``join_aggregate_directory``) bitwise equal to the JAX package's and to
the serial readers'."""
import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu_torch as P
from transmogrifai_tpu import resilience as JRes
from transmogrifai_tpu import temporal as JT
from transmogrifai_tpu import workflow as JW
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JSel
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.readers import DirectoryStreamReader as JDir
from transmogrifai_tpu.readers import data_readers as JR
from transmogrifai_tpu.readers.avro import write_avro_records
from transmogrifai_tpu.utils import aggregators as JA
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import resilience as PRes
from transmogrifai_tpu_torch import temporal as PT
from transmogrifai_tpu_torch import workflow as PW
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.models import (BinaryClassificationModelSelector
                                            as PSel)
from transmogrifai_tpu_torch.models import LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.readers import DirectoryStreamReader as PDir
from transmogrifai_tpu_torch.readers import data_readers as PR
from transmogrifai_tpu_torch.utils import aggregators as PA
from transmogrifai_tpu_torch.utils import uid as puid


def _batches(reader, **kw):
    return [[dict(r) for r in b] for b in reader.stream(**kw)]


@pytest.mark.parametrize("workers", [1, 4])
def test_directory_reader_batches_equal_the_jax_readers(tmp_path, workers):
    d = tmp_path / "in"
    d.mkdir()
    (d / "a.csv").write_text("x,y\n1,one\n2,\n")
    rng = np.random.default_rng(2)
    for i in range(4):
        write_avro_records(str(d / f"b{i}.avro"),
                           [{"x": float(v), "y": None if v < 0 else "p",
                             "k": int(i)} for v in rng.normal(size=50)])
    (d / "c.avro").write_bytes(b"not an avro container")
    got = {}
    for name, Dir, res in (("jax", JDir, JRes), ("port", PDir, PRes)):
        res.reset_resilience_stats()
        r = Dir(str(d), settle_s=0.0)
        two = _batches(r, passes=2, workers=workers)
        r.rescan()
        again = _batches(r, passes=1)
        got[name] = (two, again, res.resilience_stats()["quarantined_files"],
                     Dir(str(d), settle_s=0.0).read_records())
        res.reset_resilience_stats()
    assert got["port"] == got["jax"]
    two, again, quarantined, _ = got["port"]
    assert len(two) == 10 and two[:5] == two[5:] == again
    assert quarantined == 1                     # once, across the passes
    assert two[0] == [{"x": "1", "y": "one"}, {"x": "2", "y": None}]


def test_directory_reader_max_batches_and_new_files(tmp_path):
    d = tmp_path / "in"
    d.mkdir()
    for i in range(3):
        write_avro_records(str(d / f"p{i}.avro"), [{"v": float(i)}])
    r = PDir(str(d), settle_s=0.0)
    assert _batches(r, max_batches=2, workers=2) == [[{"v": 0.0}],
                                                     [{"v": 1.0}]]
    assert _batches(r, max_batches=5, timeout_s=0.05, workers=2) == [
        [{"v": 2.0}]]
    r2 = PDir(str(d), new_files_only=True, settle_s=0.0)
    assert r2.poll_once() == []
    write_avro_records(str(d / "p9.avro"), [{"v": 9.0}])
    assert r2.read_records() == [{"v": 9.0}]
    with pytest.raises(ValueError, match="passes"):
        list(PDir(str(d), settle_s=0.0).stream(passes=0))


N_FIT = 20_000
SAMPLE = 4096


def _fit_records(n=N_FIT, seed=17):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    x0 = rng.normal(size=n) + y
    x1 = rng.normal(size=n) * 3 - y
    cats = ["a", "b", "c", "d"]
    return [{"label": float(y[i]), "x0": float(x0[i]),
             "x1": None if i % 11 == 0 else float(x1[i]),
             "c": None if i % 13 == 0 else cats[(i + int(y[i])) % 4]}
            for i in range(n)]


@pytest.fixture(scope="module")
def fit_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("fit")
    recs = _fit_records()
    for i in range(5):
        write_avro_records(str(d / f"part{i}.avro"),
                           recs[i * 4000:(i + 1) * 4000])
    return str(d), recs


def _flow(FB, transmogrify, Sel, LR):
    label = FB.RealNN("label").from_column().as_response()
    feats = [FB.Real("x0").from_column().as_predictor(),
             FB.Real("x1").from_column().as_predictor(),
             FB.PickList("c").from_column().as_predictor()]
    sel = Sel.with_cross_validation(
        num_folds=2, splitter=None, seed=3,
        families=[LR(grid=[{"regParam": 0.01, "elasticNetParam": 0.0}])])
    return label.transform_with(sel, transmogrify(feats))


def _port_fit(d, passes, workers):
    """The port's streamed fit, its decode on ``workers``."""
    puid.reset()
    pred = _flow(P.FeatureBuilder, ptransmogrify, PSel, PLR)
    wf = P.Workflow().set_result_features(pred)
    wf.set_reader(PDir(d, settle_s=0.0))
    prev = PW.set_stream_fit(stream=True, passes=passes,
                             sample_rows=SAMPLE)
    prev_workers = PW.STREAM_FIT_WORKERS
    PW.STREAM_FIT_WORKERS = workers
    try:
        model = wf.train(device="cpu", dtype=torch.float64)
    finally:
        PW.STREAM_FIT_WORKERS = prev_workers
        PW.set_stream_fit(**prev)
    return wf, model, pred


@pytest.fixture(scope="module")
def port_fits(fit_dir):
    d, _recs = fit_dir
    return {(p, w): _port_fit(d, p, w) for p, w in ((2, 1), (1, 1), (2, 4))}


def _probs(model, pred, recs):
    return np.asarray(model.score(recs, device="cpu")[pred.name]
                      .probability, np.float64)


def test_streamed_fit_is_pass_and_worker_invariant(fit_dir, port_fits):
    """Bitwise the same model at 1 and 2 passes and 1 and 4 decode
    workers; the subsample holds SAMPLE rows and the streamed states
    cover every row."""
    _d, recs = fit_dir
    wf, model, pred = port_fits[(2, 1)]
    assert model.train_rows == SAMPLE
    assert wf._stream_state is not None
    assert {st.count for st in wf._stream_state.values()} >= {
        float(N_FIT), float(N_FIT - len(range(0, N_FIT, 11)))}
    want = _probs(model, pred, recs[:2000])
    digest = model.scoring_engine("cpu", plan=None).state_digest()
    for key in ((1, 1), (2, 4)):
        _wf, other, opred = port_fits[key]
        assert other.scoring_engine("cpu", plan=None).state_digest() \
            == digest, key
        assert np.array_equal(_probs(other, opred, recs[:2000]), want)


def test_streamed_fit_equals_the_jax_packages(fit_dir, port_fits,
                                              tmp_path):
    """The JAX package's streamed fit (one device) over the same
    directory: the same subsample, the same best model, probabilities
    within 1e-9 and streamed states within rtol 1e-12; the port's save
    loads in the JAX package and scores as the port does."""
    d, recs = fit_dir
    juid.reset()
    jpred = _flow(J.FeatureBuilder, jtransmogrify, JSel, JLR)
    jwf = J.Workflow().set_result_features(jpred).set_mesh(False)
    jwf.set_reader(JDir(d, settle_s=0.0))
    prev = JW.set_stream_fit(stream=True, passes=2, sample_rows=SAMPLE)
    try:
        jmodel = jwf.train()
    finally:
        JW.set_stream_fit(**prev)
    wf, model, pred = port_fits[(2, 1)]
    assert jmodel.train_rows == model.train_rows == SAMPLE
    assert sorted(jwf._stream_state) == sorted(wf._stream_state)
    for nm, a in jwf._stream_state.items():
        b = wf._stream_state[nm]
        assert (a.count, a.min, a.max) == (b.count, b.min, b.max)
        np.testing.assert_allclose([b.mean, b.m2], [a.mean, a.m2],
                                   rtol=1e-12)
    jprob = np.asarray(jmodel.score(recs[:2000])[jpred.name].probability,
                       np.float64)
    pprob = _probs(model, pred, recs[:2000])
    np.testing.assert_allclose(pprob, jprob, rtol=0, atol=1e-9)
    path = str(tmp_path / "model")
    model.save(path)
    loaded = J.WorkflowModel.load(path)
    lprob = np.asarray(loaded.score(recs[:2000])[pred.name].probability,
                       np.float64)
    np.testing.assert_allclose(lprob, pprob, rtol=0, atol=1e-9)


def test_auto_mode_follows_the_hint_and_the_cap(fit_dir):
    """``streamFit`` null streams a directory reader unless the planner
    measured materializing cheaper; a declared memory cap streams anyway;
    a non-directory reader never streams."""
    d, recs = fit_dir
    wf = P.Workflow().set_reader(PDir(d, settle_s=0.0))
    prev = PW.set_stream_fit(stream=None, ingest_hint=None, rss_cap_mb=None)
    try:
        assert wf._use_stream_fit()
        PW.set_stream_fit(ingest_hint="materialize")
        assert not wf._use_stream_fit()
        PW.set_stream_fit(rss_cap_mb=512.0)
        assert wf._use_stream_fit()
        PW.set_stream_fit(stream=False)
        assert not wf._use_stream_fit()
        wf.set_reader(PR.DataReaders.simple.records(recs[:10]))
        PW.set_stream_fit(stream=True)
        assert not wf._use_stream_fit()
    finally:
        PW.set_stream_fit(**prev)


def _events(rng, n, n_keys):
    return [{"user": float(rng.integers(0, n_keys)),
             "ts": float(rng.uniform(0, 1000.0)),
             "amount": float(rng.gamma(2.0, 10.0)),
             "flag": bool(rng.random() < 0.2)} for _ in range(n)]


def _feats(FB, T, A):
    return [FB.Real("s").extract(T.field("amount"), "amount")
            .aggregate(A.SumAggregator()).as_predictor(),
            FB.Real("w").extract(T.field("amount"), "amount")
            .aggregate(A.MeanAggregator()).window(250).as_predictor(),
            FB.Real("seg_f").extract(T.field("seg"), "seg")
            .aggregate(A.MaxAggregator()).as_predictor(),
            FB.Binary("r").extract(T.field("flag"), "flag")
            .aggregate(A.LogicalOrAggregator()).as_response()]


def _same_store(a, b, names):
    assert a.n_rows == b.n_rows
    for nm in names:
        ca, cb = a[nm], b[nm]
        assert np.array_equal(np.asarray(ca.values), np.asarray(cb.values),
                              equal_nan=True), nm
        assert np.array_equal(ca.mask, cb.mask), nm


def test_directory_tier_stores_equal_the_jax_packages(tmp_path):
    """``aggregate_directory`` and ``join_aggregate_directory`` at 1 and 3
    workers, and ``aggregate_tables``: every store bitwise the JAX
    package's and the serial readers'."""
    rng = np.random.default_rng(47)
    recs = []
    for i in range(4):
        part = _events(rng, 700, 30)
        recs.extend(part)
        write_avro_records(str(tmp_path / f"e{i:02d}.avro"), part)
    right = [{"user": float(u), "seg": float(u % 5)} for u in range(26)]
    out = {}
    for name, FB, T, R, A in (("jax", J.FeatureBuilder, JT, JR, JA),
                              ("port", P.FeatureBuilder, PT, PR, PA)):
        feats = _feats(FB, T, A)
        names = [f.name for f in feats]
        key, ts = T.field("user"), T.field("ts")
        serial = R.JoinedAggregateDataReader(
            R.DataReaders.simple.records(recs, key_fn=key),
            R.DataReaders.simple.records(right, key_fn=key),
            ts, R.CutOffTime.at(600)).generate_store(feats)
        stores = [serial]
        for w in (1, 3):
            stores.append(T.join_aggregate_directory(
                str(tmp_path), feats, T.table_from_records(right), ts, key,
                cutoff_ms=600, workers=w))
        plain = feats[:2] + feats[3:]
        tabs = [T.table_from_records(recs[i:i + 700])
                for i in range(0, len(recs), 700)]
        agg = [R.AggregateReader(R.DataReaders.simple.records(recs), ts,
                                 R.CutOffTime.at(600),
                                 key_fn=key).generate_store(plain)]
        for w in (1, 3):
            agg.append(T.aggregate_directory(str(tmp_path), plain, ts, key,
                                             cutoff_ms=600, workers=w))
        agg.append(T.aggregate_tables(tabs, plain, ts, key, cutoff_ms=600,
                                      workers=2))
        for s in stores[1:]:
            _same_store(serial, s, names)
        for s in agg[1:]:
            _same_store(agg[0], s, [f.name for f in plain])
        out[name] = (stores[1], agg[1], names)
    for i in (0, 1):
        names = out["port"][2] if i == 0 else [
            n for n in out["port"][2] if n != "seg_f"]
        _same_store(out["jax"][i], out["port"][i], names)
    with pytest.raises(PT.TemporalError, match="column-keyed"):
        PT.aggregate_directory(str(tmp_path), [], lambda r: r["ts"],
                               "user")


def test_binarize_in_row_chunks_equals_one_piece(monkeypatch):
    """The tree engine bins a million-row vector in row chunks (the
    comparison block of one piece would not fit on the card): the bins
    equal one piece's, NaN and ties at the edges included."""
    from transmogrifai_tpu_torch.models import _treefit as TF
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.normal(size=(1001, 7)).astype(np.float32))
    X[3, 2] = float("nan")
    edges = TF.quantile_bin_edges(X, 32)
    X[10, 4] = edges[4, 5]
    whole = TF.binarize(X, edges)
    monkeypatch.setattr(TF, "BINARIZE_CHUNK_BYTES", 4 * 7 * 31 * 64 + 5)
    assert torch.equal(TF.binarize(X, edges), whole)
    assert int(whole[3, 2]) == 0
