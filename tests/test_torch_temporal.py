"""The port's temporal tier (``transmogrifai_tpu_torch/temporal.py`` and
the aggregating and joining readers) against the JAX package's: on the
same seeded events, every store the port's columnar engine and its
row-wise fold build is bitwise equal to the JAX package's, across the
monoids, at a cutoff and with none, for text and mode, at ``ts ==
cutoff``, with NaN timestamps and under the conditional reader; an
unroutable extractor and ``aggregateColumnar`` false take the row-wise
fold; a failing columnar pass raises; the joins (left-outer and inner,
columnar and dict, mixed int and float keys, a bounded table that
spills) equal the JAX package's."""
import logging

import numpy as np
import pytest

import transmogrifai_tpu as J
import transmogrifai_tpu_torch as P
from transmogrifai_tpu import temporal as JT
from transmogrifai_tpu.readers import data_readers as JR
from transmogrifai_tpu.utils import aggregators as JA
from transmogrifai_tpu_torch import temporal as PT
from transmogrifai_tpu_torch.readers import data_readers as PR
from transmogrifai_tpu_torch.utils import aggregators as PA

#: each package's modules, for building the same readers and features
PKGS = {"jax": (J.FeatureBuilder, JT, JR, JA),
        "port": (P.FeatureBuilder, PT, PR, PA)}


class _Source:
    """Reader handing a prebuilt batch (records or a Table) over."""

    def __init__(self, data, key_fn):
        self._data = data
        self.key_fn = key_fn

    def read_records(self):
        return self._data


def _events(rng, n=1500, n_keys=37, text=False):
    recs = []
    for _ in range(n):
        r = {"user": float(rng.integers(0, n_keys)),
             "ts": float(rng.uniform(0, 1000.0)),
             "amount": float(rng.gamma(2.0, 10.0)),
             "flag": bool(rng.random() < 0.2)}
        if text:
            r["word"] = f"w{int(rng.integers(0, 5))}"
        recs.append(r)
    return recs


def _amount(FB, T, name, agg, window=None, response=False):
    b = FB.Real(name).extract(T.field("amount"), "amount").aggregate(agg)
    if window is not None:
        b = b.window(window)
    return b.as_response() if response else b.as_predictor()


def _monoid_features(FB, T, A):
    return [_amount(FB, T, "s", A.SumAggregator()),
            _amount(FB, T, "m", A.MeanAggregator()),
            _amount(FB, T, "mx", A.MaxAggregator()),
            _amount(FB, T, "mn", A.MinAggregator()),
            _amount(FB, T, "first", A.FirstAggregator()),
            _amount(FB, T, "last", A.LastAggregator()),
            _amount(FB, T, "w", A.MeanAggregator(), window=150),
            _amount(FB, T, "after", A.SumAggregator(), response=True),
            FB.Binary("or").extract(T.field("flag"), "flag")
            .aggregate(A.LogicalOrAggregator()).as_response()]


def assert_stores_equal(a, b, names):
    """Same rows; each column's values and mask bitwise equal (text
    columns value for value)."""
    assert a.n_rows == b.n_rows
    for name in names:
        ca, cb = a[name], b[name]
        assert type(ca).__name__ == type(cb).__name__, name
        va, vb = getattr(ca, "values", None), getattr(cb, "values", None)
        if isinstance(va, np.ndarray) and va.dtype != object:
            assert va.dtype == vb.dtype and va.tobytes() == vb.tobytes(), \
                name
        else:
            assert ca.to_list() == cb.to_list(), name
        if isinstance(getattr(ca, "mask", None), np.ndarray):
            assert np.array_equal(ca.mask, cb.mask), name


def _aggregate(pkg, recs, features, cutoff, columnar, reader="aggregate",
               **kw):
    """One package's store of ``recs`` under an AggregateReader (or a
    ConditionalReader on ``flag``) over a list source or its Table."""
    FB, T, R, A = PKGS[pkg]
    key, ts = T.field("user"), T.field("ts")
    data = T.table_from_records(recs) if columnar else recs
    src = _Source(data, key)
    feats = features(FB, T, A)
    if reader == "conditional":
        rd = R.ConditionalReader(src, ts, lambda r: bool(r["flag"]),
                                 key_fn=key, **kw)
    else:
        rd = R.AggregateReader(src, ts, cutoff(R), key_fn=key)
    return rd.generate_store(feats), [f.name for f in feats]


def _all_four(recs, features, cutoff=lambda R: R.CutOffTime.at(700),
              **kw):
    """The port's columnar and row-wise stores and the JAX package's
    row-wise one, each bitwise equal to the JAX package's columnar
    store; returns the port's columnar store."""
    before = PT.temporal_stats()
    col, names = _aggregate("port", recs, features, cutoff, True, **kw)
    mid = PT.temporal_stats()
    assert mid["columnar_aggregates"] == before["columnar_aggregates"] + 1
    row, _ = _aggregate("port", recs, features, cutoff, False, **kw)
    assert PT.temporal_stats()["rowwise_aggregates"] == \
        mid["rowwise_aggregates"] + 1
    want, _ = _aggregate("jax", recs, features, cutoff, True, **kw)
    jrow, _ = _aggregate("jax", recs, features, cutoff, False, **kw)
    for got in (col, row, jrow):
        assert_stores_equal(got, want, names)
    return col


@pytest.mark.parametrize("cutoff", ["at_700", "none"])
def test_columnar_equals_rowwise_and_the_jax_package_across_monoids(cutoff):
    recs = _events(np.random.default_rng(1))
    if cutoff == "none":
        _all_four(recs, _monoid_features,
                  cutoff=lambda R: R.CutOffTime.no_cutoff())
    else:
        _all_four(recs, _monoid_features)


def test_text_and_mode_monoids():
    def feats(FB, T, A):
        return [FB.Text("cat").extract(T.field("word"), "word")
                .aggregate(A.ConcatTextAggregator()).as_predictor(),
                FB.PickList("pick").extract(T.field("word"), "word")
                .aggregate(A.ModeAggregator()).as_predictor(),
                # no explicit aggregator: the type default (concat)
                FB.Text("word").from_column().as_predictor()]
    recs = _events(np.random.default_rng(2), n=600, n_keys=9, text=True)
    _all_four(recs, feats, cutoff=lambda R: R.CutOffTime.at(500))


def test_an_event_at_the_cutoff_folds_on_neither_side():
    recs = [{"user": 1.0, "ts": 99.0, "amount": 2.0, "flag": False},
            {"user": 1.0, "ts": 100.0, "amount": 5.0, "flag": True},
            {"user": 1.0, "ts": 101.0, "amount": 11.0, "flag": False}]

    def feats(FB, T, A):
        return [_amount(FB, T, "spend", A.SumAggregator()),
                FB.Binary("out").extract(T.field("flag"), "flag")
                .aggregate(A.LogicalOrAggregator()).as_response(),
                _amount(FB, T, "after", A.SumAggregator(), response=True)]
    store = _all_four(recs, feats, cutoff=lambda R: R.CutOffTime.at(100))
    assert store["spend"].get_raw(0) == 2.0
    assert store["out"].get_raw(0) is False
    assert store["after"].get_raw(0) == 11.0


def test_nan_timestamps_fold_on_both_sides_and_bypass_windows():
    recs = [{"user": 1.0, "ts": float("nan"), "amount": 5.0, "flag": True},
            {"user": 1.0, "ts": 50.0, "amount": 1.0, "flag": False},
            {"user": 1.0, "ts": 150.0, "amount": 2.0, "flag": False},
            {"user": 2.0, "ts": float("nan"), "amount": 3.0, "flag": False}]

    def feats(FB, T, A):
        return [_amount(FB, T, "pred", A.SumAggregator()),
                _amount(FB, T, "win", A.SumAggregator(), window=20),
                _amount(FB, T, "resp", A.SumAggregator(), response=True)]
    store = _all_four(recs, feats, cutoff=lambda R: R.CutOffTime.at(100))
    assert [store[n].get_raw(0) for n in ("pred", "win", "resp")] == \
        [6.0, 5.0, 7.0]


@pytest.mark.parametrize("drop", [True, False])
def test_conditional_reader(drop):
    """Per-key cutoffs at each user's first flagged event; users with
    none dropped or kept (folding everything on both sides)."""
    def feats(FB, T, A):
        return [_amount(FB, T, "s", A.SumAggregator()),
                _amount(FB, T, "w", A.MaxAggregator(), window=100),
                _amount(FB, T, "resp", A.SumAggregator(), response=True)]
    recs = _events(np.random.default_rng(3), n=800, n_keys=25)
    # a user flagged at its first event (empty predictor fold) and one
    # never flagged
    recs += [{"user": 90.0, "ts": 5.0, "amount": 1.0, "flag": True},
             {"user": 90.0, "ts": 9.0, "amount": 2.0, "flag": False},
             {"user": 91.0, "ts": 7.0, "amount": 4.0, "flag": False}]
    store = _all_four(recs, feats, reader="conditional",
                      drop_if_no_condition=drop)
    assert store.n_rows == (26 if drop else 27)


def test_an_unroutable_extractor_declines_to_the_rowwise_fold():
    def feats(FB, T, A):
        return [FB.Real("double_amt")
                .extract(lambda r: (r.get("amount") or 0.0) * 2, "amount")
                .aggregate(A.SumAggregator()).as_predictor()]
    recs = _events(np.random.default_rng(4), n=400, n_keys=7)
    before = PT.temporal_stats()
    got, names = _aggregate("port", recs, feats,
                            lambda R: R.CutOffTime.at(600), True)
    after = PT.temporal_stats()
    assert not PT.last_route_contested()
    assert after["rowwise_aggregates"] == before["rowwise_aggregates"] + 1
    assert after["columnar_aggregates"] == before["columnar_aggregates"]
    want, _ = _aggregate("jax", recs, feats,
                         lambda R: R.CutOffTime.at(600), False)
    assert_stores_equal(got, want, names)


@pytest.mark.parametrize("mode", [False, True])
def test_aggregate_columnar_knob(mode):
    """``aggregateColumnar`` false folds a columnar batch row-wise; true
    over a list source folds row-wise too, counted as a fallback."""
    def feats(FB, T, A):
        return [_amount(FB, T, "s", A.SumAggregator())]
    recs = _events(np.random.default_rng(5), n=300, n_keys=5)
    prev = PT.set_run_defaults(columnar=mode)
    try:
        before = PT.temporal_stats()
        got, names = _aggregate("port", recs, feats,
                                lambda R: R.CutOffTime.at(500),
                                columnar=not mode)
        after = PT.temporal_stats()
    finally:
        PT.set_run_defaults(**prev)
    assert PT.columnar_mode() == "auto"
    assert after["columnar_aggregates"] == before["columnar_aggregates"]
    assert after["rowwise_aggregates"] == before["rowwise_aggregates"] + 1
    assert after["columnar_fallbacks"] == before["columnar_fallbacks"] + mode
    want, _ = _aggregate("jax", recs, feats,
                         lambda R: R.CutOffTime.at(500), True)
    assert_stores_equal(got, want, names)


def test_a_failing_columnar_pass_raises():
    """No fallback hides a columnar failure: it reaches the caller."""
    class Boom(PA.SumAggregator):
        def fold(self, values):
            raise RuntimeError("boom")

    def feats(FB, T, A):
        return [_amount(FB, T, "s", Boom())]
    recs = _events(np.random.default_rng(6), n=100, n_keys=5)
    before = PT.temporal_stats()
    with pytest.raises(RuntimeError, match="boom"):
        _aggregate("port", recs, feats, lambda R: R.CutOffTime.at(500), True)
    assert PT.temporal_stats()["rowwise_aggregates"] == \
        before["rowwise_aggregates"]


def test_tables_equal_the_jax_packages():
    """``table_from_records`` and ``concat_tables``: the same columns,
    masks and null fields, and the same dicts back."""
    recs = _events(np.random.default_rng(7), n=50, n_keys=4, text=True)
    recs[3]["amount"] = None
    recs[5]["word"] = None
    for r in recs:
        r["gone"] = None
    parts = {pkg: [T.table_from_records(recs[:20]),
                   T.table_from_records(recs[20:])]
             for pkg, (_fb, T, _r, _a) in PKGS.items()}
    for pkg, (_fb, T, _r, _a) in PKGS.items():
        parts[pkg].append(T.concat_tables(parts[pkg]))
    for pt, jt in zip(parts["port"], parts["jax"]):
        assert pt._names == jt._names and pt.null_fields == jt.null_fields
        for nm, col in jt.columns.items():
            assert pt.columns[nm].dtype == col.dtype
            assert np.array_equal(pt.columns[nm], col)
        for nm, (vals, mask) in jt.masked_columns.items():
            assert np.array_equal(pt.masked_columns[nm][1], mask)
            assert list(pt.masked_columns[nm][0][mask]) == list(vals[mask])
        assert list(pt) == list(jt)
    assert list(parts["port"][2]) == recs


def _join_fixture(rng, n=1500, n_keys=40, missing=6):
    left = _events(rng, n=n, n_keys=n_keys)
    right = [{"user": float(u), "seg": float(u % 7)}
             for u in range(n_keys - missing)]
    return left, right


@pytest.mark.parametrize("columnar", [True, False])
@pytest.mark.parametrize("join_type", ["left_outer", "inner"])
def test_joins_and_the_joined_aggregate(join_type, columnar):
    """The port's TemporalJoinReader (columnar build and probe, or the
    partitioned dict tables) gives the JAX package's JoinedDataReader
    rows, and the joined-then-aggregated store equals the JAX package's
    bitwise."""
    left, right = _join_fixture(np.random.default_rng(8))
    key = PT.field("user")

    def sources(T):
        if columnar:
            return (_Source(T.table_from_records(left), key),
                    _Source(T.table_from_records(right), key))
        return _Source(left, key), _Source(right, key)
    before = PT.temporal_stats()
    rows = PR.TemporalJoinReader(*sources(PT), join_type).read_records()
    after = PT.temporal_stats()
    assert after["columnar_joins"] - before["columnar_joins"] == columnar
    assert isinstance(rows, PT.Table) == columnar
    want = JR.JoinedDataReader(_Source(left, key), _Source(right, key),
                               join_type).read_records()
    assert len(rows) == len(want)
    for a, b in zip(rows, want):
        assert {k: v for k, v in a.items() if v is not None} == \
            {k: v for k, v in b.items() if v is not None}

    def feats(FB, T, A):
        return [_amount(FB, T, "s", A.SumAggregator()),
                FB.Real("seg_f").extract(T.field("seg"), "seg")
                .aggregate(A.MaxAggregator()).as_predictor(),
                FB.Binary("r").extract(T.field("flag"), "flag")
                .aggregate(A.LogicalOrAggregator()).as_response()]
    stores = {}
    for pkg, (FB, T, R, A) in PKGS.items():
        fs = feats(FB, T, A)
        stores[pkg] = R.JoinedAggregateDataReader(
            *sources(T), T.field("ts"), R.CutOffTime.at(700),
            join_type).generate_store(fs)
    assert_stores_equal(stores["port"], stores["jax"],
                        [f.name for f in fs])


def test_mixed_int_and_float_keys_meet_like_a_dict_join():
    left = [{"user": float(u % 6), "ts": 1.0, "amount": 1.0}
            for u in range(24)]
    right = [{"user": int(u), "seg": float(u * 10)} for u in range(6)]
    key = PT.field("user")
    want = JR.JoinedDataReader(_Source(left, key),
                               _Source(right, key)).read_records()
    for partitions in (1, 4, 7):
        got = PR.TemporalJoinReader(_Source(left, key), _Source(right, key),
                                    partitions=partitions).read_records()
        assert [r["seg"] for r in got] == [r["seg"] for r in want]
        assert None not in [r["seg"] for r in got]
    for k in (1, 1.0, True, np.float64(1.0), 3, "u7", -2.5):
        assert PT.partition_of(k, 7) == JT.partition_of(k, 7)
    assert PT.partition_of(1, 7) == PT.partition_of(1.0, 7) \
        == PT.partition_of(True, 7) == PT.partition_of(np.float64(1.0), 7)


@pytest.mark.parametrize("columnar", [True, False])
def test_a_bounded_build_table_drops_and_counts_its_overflow(columnar,
                                                            caplog):
    """Past ``joinTableMaxRows`` keys in a partition, new keys' rows are
    dropped (counted, with a warning); their probe rows come back
    unmatched. A columnar build over the bound takes the dict tables."""
    right = [{"user": float(u), "seg": float(u)} for u in range(10)]
    left = [{"user": float(u), "ts": 1.0, "amount": 1.0} for u in range(10)]
    key = PT.field("user")
    if columnar:
        src = (_Source(PT.table_from_records(left), key),
               _Source(PT.table_from_records(right), key))
    else:
        src = (_Source(left, key), _Source(right, key))
    before = PT.temporal_stats()
    prev = PT.set_run_defaults(join_partitions=1, join_table_max_rows=4)
    try:
        with caplog.at_level(logging.WARNING):
            out = PR.TemporalJoinReader(*src).read_records()
    finally:
        PT.set_run_defaults(**prev)
    after = PT.temporal_stats()
    assert len(out) == 10
    assert after["join_spilled_rows"] - before["join_spilled_rows"] == 6
    assert after["columnar_joins"] == before["columnar_joins"]
    assert [r.get("seg") for r in out] == [0.0, 1.0, 2.0, 3.0] + [None] * 6
    assert "6 row(s) of new keys dropped" in caplog.text
