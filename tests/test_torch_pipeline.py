"""The port's input pipeline (``transmogrifai_tpu_torch/pipeline.py``) and
its consumers against the JAX package's on the CPU: ``map_ordered``'s
order, exceptions, named threads, backpressure and starvation rules; the
``SeededRowSample`` indices bitwise; ``BufferPool``'s padding and reuse;
the autotuner's depth sequence; ``stream_score_overlapped`` bitwise equal
to scoring each batch alone at 1 and 4 workers, with its tallies; and
``fitstats.StreamingMomentFold`` bitwise against the port's materialized
device pass (several chunks at a small ``FITSTATS_CHUNK_ROWS``, any
re-batching) and within rtol 1e-12 of the JAX package's fold in f64."""
import threading
import time

import numpy as np
import pytest
import torch

from transmogrifai_tpu import fitstats as JF
from transmogrifai_tpu import pipeline as JP
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.columns import column_from_values as jcol
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import fitstats as PF
from transmogrifai_tpu_torch import pipeline as PP
from transmogrifai_tpu_torch.columns import ColumnStore as PStore
from transmogrifai_tpu_torch.columns import column_from_values as pcol
from transmogrifai_tpu_torch.dsl import transmogrify
from transmogrifai_tpu_torch.models import (BinaryClassificationModelSelector,
                                            LogisticRegressionFamily)
from transmogrifai_tpu_torch.scoring import stream_score_overlapped
from transmogrifai_tpu_torch.types import feature_types as pft


def test_map_ordered_is_deterministic_across_worker_counts():
    items = list(range(32))

    def slow_square(i):
        # later items finish first on a pool
        time.sleep(0.002 * (32 - i) / 32)
        return i * i

    serial = [(i, i * i, None) for i in items]
    for workers in (1, 2, 4):
        assert list(PP.map_ordered(slow_square, items,
                                   workers=workers)) == serial
        assert list(PP.map_ordered(slow_square, iter(items),
                                   workers=workers)) == serial


def test_map_ordered_exceptions_ride_in_order_on_named_threads():
    names = set()

    def boom(i):
        names.add(threading.current_thread().name)
        if i == 3:
            raise ValueError("poison")
        return i

    got = list(PP.map_ordered(boom, range(6), workers=3, name="dec-test"))
    assert [g[0] for g in got] == list(range(6))
    assert [g[1] for g in got] == [0, 1, 2, None, 4, 5]
    assert isinstance(got[3][2], ValueError)
    assert names and all(n.startswith("dec-test") for n in names)


def test_map_ordered_backpressure_and_tuner_depth():
    """An abandoned consumer stops the feeder; a depth-1 tuner keeps one
    item in flight ahead."""
    pulled = []

    def gen():
        for i in range(1000):
            pulled.append(i)
            yield i

    it = PP.map_ordered(lambda x: x, gen(), workers=2)
    for _ in range(3):
        next(it)
    it.close()
    assert len(pulled) < 50
    pulled.clear()
    tuner = PP.PrefetchAutotuner(max_depth=1)
    seen = []
    for item, _res, _exc in PP.map_ordered(lambda x: x, gen(), workers=4,
                                           tuner=tuner):
        seen.append(len(pulled) - item)
        if item == 20:
            break
    assert max(seen) <= 2


def test_starvation_counts_slow_workers_not_a_slow_source():
    tuner = PP.PrefetchAutotuner(max_depth=8)
    d0 = tuner.depth()

    def slow_source():
        for i in range(6):
            time.sleep(0.02)
            yield i

    got = list(PP.map_ordered(lambda i: i, slow_source(), workers=2,
                              tuner=tuner))
    assert [g[0] for g in got] == list(range(6))
    assert (tuner.starvations, tuner.depth()) == (0, d0)

    def slow_work(i):
        time.sleep(0.03)
        return i

    tuner = PP.PrefetchAutotuner(max_depth=8)
    list(PP.map_ordered(slow_work, iter(range(6)), workers=1, tuner=tuner))
    assert tuner.starvations >= 1


def test_resolve_workers_and_the_switch(monkeypatch):
    assert PP.resolve_workers(3) == 3
    assert PP.resolve_workers(0) == 1
    assert PP.resolve_workers(None) == PP.DEFAULT_WORKERS \
        == JP.DEFAULT_WORKERS
    monkeypatch.setattr(PP, "PIPELINE_ENABLED", False)
    assert PP.resolve_workers(8) == 1


def _autotune_trace(mod):
    t = mod.PrefetchAutotuner(min_depth=2, max_depth=4, window=2)
    rng = np.random.default_rng(5)
    trace = [t.depth()]
    for _ in range(60):
        if rng.random() < 0.3:
            t.record_starvation()
        t.on_batch()
        trace.append(t.depth())
    capped = mod.PrefetchAutotuner(max_depth=1)
    capped.record_starvation()
    capped.on_batch()
    return trace, t.grows, t.shrinks, t.starvations, capped.depth()


def test_autotuner_depth_sequence_equals_the_jax_packages():
    got = _autotune_trace(PP)
    assert got == _autotune_trace(JP)
    assert got[1] > 0 and got[2] > 0 and got[4] == 1


@pytest.mark.parametrize("seed", [0, 0x51EED, 2 ** 40 + 7])
@pytest.mark.parametrize("k", [1, 64, 1000])
def test_seeded_row_sample_indices_equal_the_jax_packages(seed, k):
    """The same kept global indices, bit for bit, under any batching."""
    sizes = [1, 700, 33, 2048, 5, 1500]

    def run(mod, sizes):
        s = mod.SeededRowSample(k, seed=seed)
        g = 0
        for n in sizes:
            loc = s.offer(n)
            s.keep([g + int(i) for i in loc])
            g += n
        return s.result(), s.total_rows

    got = run(PP, sizes)
    assert got == run(JP, sizes)
    assert got == run(PP, [sum(sizes)])          # batching-invariant
    assert len(got[0]) == min(k, sum(sizes))
    assert got[0] == sorted(got[0])


def test_buffer_pool_pads_like_the_jax_packages_and_reuses():
    rng = np.random.default_rng(1)
    for mod in (PP, JP):
        pool = mod.BufferPool(max_per_key=2)
        taken = []
        a = rng.normal(size=(5, 3)).astype(np.float32)
        out = pool.pad_rows(a, 5, 8, taken)
        want = np.concatenate([a, np.zeros((3, 3), np.float32)])
        assert np.array_equal(out, want) and out.dtype == a.dtype
        const = np.arange(4.0)
        assert pool.pad_rows(const, 5, 8, taken) is const
        for buf in taken:
            pool.give(buf)
        again = []
        out2 = pool.pad_rows(a[::-1].copy(), 5, 8, again)
        assert out2 is out and np.array_equal(out2[5:], np.zeros((3, 3)))
        assert (pool.reuses, pool.allocs) == (1, 1)


def test_probe_sustained_mbps_is_tallied():
    mbps = PP.probe_sustained_mbps(n_transfers=2, buf_mb=1, device="cpu")
    assert mbps > 0
    assert PP.pipeline_stats()["sustained_mbps"] == round(mbps, 1)


def _model(n=400):
    rng = np.random.default_rng(9)
    y = rng.integers(0, 2, n).astype(float)
    x = rng.normal(size=n) + y
    z = rng.normal(size=n)
    recs = [{"label": float(y[i]), "x": float(x[i]),
             "z": None if i % 9 == 0 else float(z[i]),
             "c": ["a", "b", "c"][i % 3]} for i in range(n)]
    label = PFB.RealNN("label").from_column().as_response()
    feats = [PFB.Real("x").from_column().as_predictor(),
             PFB.Real("z").from_column().as_predictor(),
             PFB.PickList("c").from_column().as_predictor()]
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily()], splitter=None,
        seed=7)
    pred = label.transform_with(sel, transmogrify(feats))
    model = (PWorkflow().set_input_records(recs).set_result_features(pred)
             .train(device="cpu"))
    return model, pred


def test_overlapped_stream_is_bitwise_at_any_worker_count():
    """The pipelined stream (pooled padding, ordered workers) gives each
    batch's store bitwise as scoring it alone, at 1 and 4 workers, and
    records the stream in the tallies."""
    model, pred = _model()
    rng = np.random.default_rng(4)
    batches = []
    for n in (37, 300, 8, 129, 64, 300):
        batches.append([{"label": 0.0, "x": float(a), "z": float(b),
                         "c": "abc"[int(c)]}
                        for a, b, c in zip(rng.normal(size=n),
                                           rng.normal(size=n),
                                           rng.integers(0, 3, n))])
    want = [model.score(b, device="cpu", engine=True)[pred.name]
            for b in batches]
    for workers in (1, 4):
        before = PP.pipeline_stats()
        got = list(stream_score_overlapped(model, batches, device="cpu",
                                           workers=workers, prefetch=3))
        after = PP.pipeline_stats()
        assert len(got) == len(batches)
        for g, w in zip(got, want):
            for col in ("prediction", "probability", "raw_prediction"):
                assert np.array_equal(getattr(g[pred.name], col),
                                      getattr(w, col))
        assert after["streams"] == before["streams"] + 1
        assert after["batches"] == before["batches"] + len(batches)
        assert after["last_workers"] == workers
        assert 1 <= after["last_prefetch_depth"] <= 3
    assert after["buffer_reuses"] > before["buffer_reuses"]


def _stores(n, seed=3):
    rng = np.random.default_rng(seed)
    cols = {}
    for j, nm in enumerate(("x0", "x1", "x2")):
        v = rng.normal(size=n) * 10 ** j + j
        cols[nm] = [None if rng.random() < 0.15 else float(x) for x in v]
    return (JStore({k: jcol(jft.Real, v) for k, v in cols.items()}, n),
            PStore({k: pcol(pft.Real, v) for k, v in cols.items()}, n))


def _batches(store, sizes):
    out, i = [], 0
    for s in sizes:
        j = min(store.n_rows, i + s)
        if j > i:
            out.append(store.take(np.arange(i, j)))
        i = j
    return out


NAMES = ["x0", "x1", "x2"]
KINDS = {nm: {"mean": [()], "count": [()]} for nm in NAMES}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("sizes", [[400], [128, 128, 128, 16],
                                   [37] * 10 + [30], [1] * 5 + [395]])
def test_streaming_fold_bitwise_against_the_materialized_pass(
        monkeypatch, sizes, dtype):
    """Several 128-row chunks and a padded tail, and one padded chunk:
    the streamed states equal the materialized device pass's bit for
    bit, whatever the batching."""
    _js, ps = _stores(400)
    for chunk in (128, 1024):
        monkeypatch.setattr(PF, "FITSTATS_CHUNK_ROWS", chunk)
        _b, want = PF._device_moment_bundles(ps, KINDS,
                                             torch.device("cpu"), dtype)
        fold = PF.StreamingMomentFold(NAMES, device="cpu", dtype=dtype)
        for b in _batches(ps, sizes):
            fold.update(b)
        assert fold.n_rows == 400
        got = fold.finalize()
        for nm in NAMES:
            g, w = got[nm], want[nm]
            assert (g.count, g.mean, g.m2, g.min, g.max) \
                == (w.count, w.mean, w.m2, w.min, w.max), (nm, chunk)


def test_streaming_fold_against_the_jax_packages(monkeypatch):
    """In f64 the port's fold and the JAX package's (one device): counts,
    minima and maxima exact, mean and M2 within rtol 1e-12."""
    monkeypatch.setattr(PF, "FITSTATS_CHUNK_ROWS", 128)
    monkeypatch.setattr(JF, "FITSTATS_CHUNK_ROWS", 128)
    js, ps = _stores(400)
    jfold = JF.StreamingMomentFold(NAMES, mesh=False)
    pfold = PF.StreamingMomentFold(NAMES, device="cpu", dtype=torch.float64)
    for jb, pb in zip(_batches(js, [150, 150, 100]),
                      _batches(ps, [150, 150, 100])):
        jfold.update(jb)
        pfold.update(pb)
    jst, pst = jfold.finalize(), pfold.finalize()
    for nm in NAMES:
        a, b = jst[nm], pst[nm]
        assert (a.count, a.min, a.max) == (b.count, b.min, b.max)
        np.testing.assert_allclose([b.mean, b.m2], [a.mean, a.m2],
                                   rtol=1e-12)


def test_streamed_states_feed_the_statistics_pass():
    """A moment request on a streamed column finalizes from the streamed
    state; the other columns scan the store."""
    _js, ps = _stores(400)
    fake = PF.SufficientStats(1000.0, 7.5, 12.0, -3.0, 99.0)
    plan = PF.LayerStatsPlan([PF.StatRequest("mean", "x1"),
                              PF.StatRequest("count", "x1"),
                              PF.StatRequest("max", "x1"),
                              PF.StatRequest("mean", "x0")], n_stages=2)
    state = {}
    stats = plan.run(ps, device=False, stream_state={"x1": fake},
                     state_out=state)
    assert stats.value("mean", "x1") == 7.5
    assert stats.value("count", "x1") == 1000
    assert stats.value("max", "x1") == 99.0
    x0 = ps["x0"].values[ps["x0"].mask]
    assert stats.value("mean", "x0") == float(x0.mean())
    assert state["x1"] is fake
