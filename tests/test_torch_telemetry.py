"""The port's telemetry (``transmogrifai_tpu_torch/telemetry.py``) beside the
JAX package's.

Module level: the cases of ``tests/test_telemetry.py`` and the host-only
cases of ``tests/test_observability.py`` against the port's copy; the same
registry contents render byte-equal Prometheus text in both packages, the
same shard files merge equal, traceparents round-trip between them and
histogram buckets are equal. The device timer: CPU seconds, a pair of
CUDA events read only after the caller's synchronisation (held with a
fake event class here), nothing made while telemetry is off.

Runner parity: a few hundred records through transmogrify, the
SanityChecker and a selector over one LR point and GBT at depth 2 with 2
rounds, run through both packages' runners (Train, Score, Evaluate) with
``telemetry: true`` and a ``traceLocation``. Span names, nesting depth and
order per track, counter values and the listener summary's counts are
equal, but for what the port does not have (``EXCLUDED``). The JAX
package runs on one device (``set_mesh(False)``), so it emits no
``mesh`` event. Telemetry changes no result: models, metrics and scores
are bitwise equal with it on and off."""
import json
import math
import os
import re
import threading

import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import telemetry as jtel
from transmogrifai_tpu.evaluators import Evaluators as JEv
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JS
from transmogrifai_tpu.models.trees import GBTFamily as JG
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.runner import OpParams as JOpParams
from transmogrifai_tpu.runner import OpWorkflowRunner as JRunner
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import telemetry
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.evaluators import Evaluators as PEv
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PS
from transmogrifai_tpu_torch.models.trees import GBTFamily as PG
from transmogrifai_tpu_torch.runner import (OpParams, OpWorkflowRunner,
                                            RunType)
from transmogrifai_tpu_torch.utils import uid as puid

#: what the JAX package emits on this workflow and the port does not,
#: with the reason; every other span, counter and summary count is equal
EXCLUDED = {
    # spans
    "telemetry:bandwidth_probe": "the link probe is not carried over",
    "pipeline:sustained_probe": "the link probe is not carried over",
    # counters and gauges
    "device.roundtrip_mbps": "the link probe is not carried over",
    "device.sustained_mbps": "the link probe is not carried over",
    "xla.compile_events": "the port compiles nothing (no XLA)",
    "xla.compile_seconds": "the port compiles nothing (no XLA)",
    "fusion.cache_hits": "the fused layer transform is eager torch: "
                         "no compiled program to cache",
    "fusion.cache_misses": "the fused layer transform is eager torch: "
                           "no compiled program to cache",
    # CollectingRunListener.summary() keys
    "compileEvents": "the port compiles nothing (no compile event)",
    "compileSeconds": "the port compiles nothing (no compile event)",
    "appSeconds": "a duration",
    "stages": "per-stage seconds (durations); their uids and names are "
              "compared",
    "plan.engineTier": "the JAX package's model plan takes its engine "
                       "tier from the link probe; with the priors alone "
                       "the port's stays None",
}

RUNS = (RunType.TRAIN, RunType.SCORE, RunType.EVALUATE)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    for m in (telemetry, jtel):
        m.disable()
        m.reset()
    yield
    for m in (telemetry, jtel):
        m.disable()
        m.reset()
    telemetry.reset_device_cost()


# -- span tracer -------------------------------------------------------------

def test_span_nesting_and_chrome_trace_validity(tmp_path):
    telemetry.enable()
    with telemetry.span("outer", kind="test"):
        assert telemetry.current_span_stack() == ("outer",)
        with telemetry.span("inner", depth=2):
            assert telemetry.current_span_stack() == ("outer", "inner")
    assert telemetry.current_span_stack() == ()
    events = [e for e in telemetry.trace_events() if e["ph"] == "X"]
    by_name = {e["name"]: e for e in events}
    assert set(by_name) == {"outer", "inner"}
    inner, outer = by_name["inner"], by_name["outer"]
    assert inner["tid"] == outer["tid"]
    assert inner["ts"] >= outer["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
    assert inner["args"] == {"depth": 2}
    p = tmp_path / "trace.json"
    assert telemetry.write_trace(str(p))
    doc = json.load(open(p))
    assert doc["displayTimeUnit"] == "ms"
    for e in doc["traceEvents"]:
        assert {"name", "ph", "pid", "tid"} <= set(e)
        if e["ph"] == "X":
            assert e["dur"] >= 0 and e["ts"] >= 0


def test_span_thread_safety_and_per_thread_tracks():
    telemetry.enable()
    n_threads, n_spans = 4, 50
    barrier = threading.Barrier(n_threads)

    def work(k):
        barrier.wait()
        for i in range(n_spans):
            with telemetry.span("worker", thread=k, i=i):
                pass

    threads = [threading.Thread(target=work, args=(k,), name=f"w{k}")
               for k in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    spans = [e for e in telemetry.trace_events()
             if e["ph"] == "X" and e["name"] == "worker"]
    assert len(spans) == n_threads * n_spans
    assert len({e["tid"] for e in spans}) == n_threads
    names = {e["args"]["name"] for e in telemetry.trace_events()
             if e["ph"] == "M"}
    assert {f"w{k}" for k in range(n_threads)} <= names


class _CountingEvent:
    """Stands in for ``torch.cuda.Event``: counts what is made, and
    completes when the test says so."""

    made = 0
    done = False

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = len(_EVENT_LOG)
        _EVENT_LOG.append(("record", stream))

    def query(self):
        _EVENT_LOG.append(("query", None))
        return type(self).done

    def synchronize(self):
        _EVENT_LOG.append(("synchronize", None))

    def elapsed_time(self, other):
        return 1000.0 * (other.t - self.t)      # ms: one second a record


_EVENT_LOG = []


@pytest.fixture
def fake_cuda_events(monkeypatch):
    _EVENT_LOG.clear()
    _CountingEvent.made = 0
    _CountingEvent.done = False
    monkeypatch.setattr(torch.cuda, "Event", _CountingEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: "s0")
    yield _CountingEvent


def test_disabled_path_records_nothing(fake_cuda_events):
    """Off means free: shared no-op singletons, no span, no listener, no
    metric, and no CUDA event for a device timer."""
    assert not telemetry.enabled()
    s = telemetry.span("x", big=list(range(3)))
    assert s is telemetry.span("y")
    with s:
        pass
    c = telemetry.counter("scoring.cache_hits")
    assert c is telemetry.gauge("g") is telemetry.histogram("h")
    c.inc()
    telemetry.gauge("g").set(5)
    telemetry.emit("run_start", run_type="Train")
    timer = telemetry.device_timer("scoring", "cuda", flops=1.0)
    assert timer is telemetry.device_timer("fitstats", "cpu")
    with timer:
        pass
    assert fake_cuda_events.made == 0 and _EVENT_LOG == []
    assert telemetry.trace_events() == []
    assert telemetry.metrics_json() == {}
    assert telemetry.listeners() == []
    assert telemetry.device_cost_stats()["phases"] == {}


def test_device_timer_reads_events_only_after_a_sync(fake_cuda_events):
    """On the card a timer records one event at entry and one at exit on
    the current stream and neither waits nor reads them: ``settle``
    reads only completed pairs (a query, no synchronisation), and the
    mfu block drains the rest."""
    telemetry.enable()
    telemetry.reset_device_cost()
    with telemetry.device_timer("scoring", "cuda", flops=2e12):
        _EVENT_LOG.append(("work", None))
    assert fake_cuda_events.made == 2
    assert [k for k, _ in _EVENT_LOG] == ["record", "work", "record"]
    assert all(s == "s0" for k, s in _EVENT_LOG if k == "record")
    telemetry.settle_device_timers()             # not complete yet
    assert "synchronize" not in [k for k, _ in _EVENT_LOG]
    assert telemetry._DEVICE_COST == {}
    fake_cuda_events.done = True
    telemetry.settle_device_timers()
    st = telemetry._DEVICE_COST["scoring"]
    assert st == {"flops": 2e12, "seconds": 2.0, "dispatches": 1}
    assert "synchronize" not in [k for k, _ in _EVENT_LOG]
    # an unsettled pair waits for the mfu block, which drains it
    fake_cuda_events.done = False
    with telemetry.device_timer("fitstats", "cuda", flops=1e12):
        pass
    block = telemetry.device_cost_stats()
    assert ("synchronize", None) in _EVENT_LOG
    assert block["phases"]["fitstats"]["dispatches"] == 1
    assert block["phases"]["scoring"]["achieved_tflops"] == 1.0
    # work that raises records nothing
    with pytest.raises(RuntimeError):
        with telemetry.device_timer("scoring", "cuda"):
            raise RuntimeError("kernel failed")
    assert telemetry._PENDING_TIMERS == []


def test_device_timer_on_the_cpu_uses_the_host_clock():
    telemetry.enable()
    telemetry.reset_device_cost()
    with telemetry.device_timer("scoring", "cpu", flops=10.0):
        sum(range(1000))
    st = telemetry.device_cost_stats()
    assert st["device_kind"] == "cpu" and st["devices"] == 1
    assert st["phases"]["scoring"]["dispatches"] == 1
    assert st["phases"]["scoring"]["seconds"] > 0
    assert st["mfu_f32_pct"] is None and st["mfu_bf16_pct"] is None


def test_peak_table_holds_the_h100_alone(monkeypatch):
    assert telemetry.PEAK_FLOPS == {"h100": {"bf16": 989.4e12,
                                             "f32": 66.9e12}}
    assert telemetry._peak_flops_for("NVIDIA H100 80GB HBM3") \
        == telemetry.PEAK_FLOPS["h100"]
    assert telemetry._peak_flops_for("cpu") is None
    assert telemetry._peak_flops_for("TPU v5 lite") is None
    monkeypatch.setenv("TMOG_PEAK_FLOPS", "1e12")
    assert telemetry._peak_flops_for("cpu") == {"bf16": 1e12, "f32": 1e12}


def test_compile_clock_and_peak_rss():
    assert telemetry.compile_clock_s() == 0.0
    rss = telemetry.peak_rss_mb()
    assert rss is None or rss > 0
    assert not hasattr(telemetry, "probe_device_roundtrip_mbps")
    assert not hasattr(telemetry, "_ensure_compile_listener")


def test_public_names_are_the_jax_packages():
    """Every public name of the JAX module but the two it does not carry
    over (the compile listener and the link probe) is the port's."""
    missing = set(jtel.__all__) - set(telemetry.__all__)
    assert missing == {"probe_device_roundtrip_mbps"}
    for name in ("current_span_stack", "device_timer",
                 "settle_device_timers", "TMOG_TRACE_DIR"):
        assert name in telemetry.__all__
    assert telemetry.DEFAULT_BUCKETS == jtel.DEFAULT_BUCKETS
    assert (telemetry.TRACE_HEADER, telemetry.TRACE_ENV,
            telemetry.TRACE_ROLE_ENV) == (jtel.TRACE_HEADER, jtel.TRACE_ENV,
                                          jtel.TRACE_ROLE_ENV)


# -- metrics registry --------------------------------------------------------

def test_counter_gauge_histogram_math():
    telemetry.enable()
    c = telemetry.counter("scoring.cache_hits")
    c.inc()
    c.inc(4)
    assert c.value == 5
    assert telemetry.counter("scoring.cache_hits") is c
    g = telemetry.gauge("stream.queue_depth")
    g.set(3)
    g.inc()
    g.dec(2)
    assert g.value == 2
    h = telemetry.histogram("lat", buckets=(0.001, 0.01, 1.0))
    for v in (0.0004, 0.005, 0.5, 30.0):
        h.observe(v)
    assert h.count == 4
    assert h.sum == pytest.approx(30.5054)
    assert h.bucket_counts() == {0.001: 1, 0.01: 2, 1.0: 3}
    doc = telemetry.metrics_json()
    assert doc["scoring.cache_hits"] == 5
    assert doc["stream.queue_depth"] == 2
    assert doc["lat"]["count"] == 4
    assert doc["lat"]["buckets"]["0.01"] == 2
    with pytest.raises(TypeError):
        telemetry.gauge("scoring.cache_hits")


def _fill(mod):
    """The same registry contents through either package."""
    mod.enable()
    mod.counter("scoring.cache_hits").inc(3)
    mod.counter("fitstats.bytes_scanned").inc(7800)
    mod.gauge("stream.overlap_efficiency").set(0.75)
    h = mod.histogram("scoring.batch_seconds", buckets=(0.01, 1.0))
    h.observe(0.005)
    h.observe(2.0)
    d = mod.histogram("scoring.default_ladder")
    for v in (0.0005, 0.003, 0.2, 7.0, 100.0):
        d.observe(v)
    return mod.render_prometheus(extra={"run_appSeconds": 1.5,
                                        "run_rowsScored": 300})


def test_prometheus_text_is_byte_equal_to_the_jax_packages():
    text = _fill(telemetry)
    assert text == _fill(jtel)
    lines = text.splitlines()
    assert "# TYPE scoring_cache_hits counter" in lines
    assert "scoring_cache_hits 3" in lines
    assert 'scoring_batch_seconds_bucket{le="+Inf"} 2' in lines
    assert "run_appSeconds 1.5" in lines and "run_rowsScored 300" in lines
    assert text.endswith("\n")
    assert telemetry.parse_prometheus(text) == jtel.parse_prometheus(text)
    assert json.dumps(telemetry.metrics_json(), sort_keys=True) \
        == json.dumps(jtel.metrics_json(), sort_keys=True)


def test_histogram_bucket_semantics_equal_the_jax_packages():
    got = []
    for mod in (telemetry, jtel):
        mod.enable()
        h = mod.histogram("exact.seconds", buckets=(0.1, 1.0, 10.0))
        for v in (0.05, 0.1, 0.5, 1.0, 5.0, 100.0):
            h.observe(v)
        got.append((h.snapshot(), h.bucket_counts(), h.to_json()))
    assert got[0] == got[1]
    (counts, total, count), buckets, _ = got[0]
    assert counts == (2, 4, 5) and count == 6
    assert abs(total - 106.65) < 1e-9
    assert buckets == {0.1: 2, 1.0: 4, 10.0: 5}


def _parse_prom(text):
    fams = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, fam, kind = line.split()
            assert fam not in fams, f"duplicate TYPE for {fam}"
            fams[fam] = {"type": kind, "samples": {}}
            continue
        m = re.match(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$",
                     line)
        assert m, line
        name, labels, v = m.group(1), m.group(2) or "", float(m.group(3))
        fam = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and \
                    fams.get(name[:-len(suffix)], {}).get("type") \
                    == "histogram":
                fam = name[:-len(suffix)]
        fams[fam]["samples"][(name, labels)] = v
    return fams


def _assert_histograms_valid(fams):
    for fam, doc in fams.items():
        if doc["type"] != "histogram":
            continue
        buckets, inf, total = [], None, None
        for (name, labels), v in doc["samples"].items():
            if name == fam + "_bucket":
                le = labels.split('le="')[1].split('"')[0]
                if le == "+Inf":
                    inf = v
                else:
                    buckets.append((float(le), v))
            elif name == fam + "_count":
                total = v
        buckets.sort()
        prev = 0.0
        for _le, v in buckets:
            assert v >= prev
            prev = v
        assert inf is not None and inf == total
        if buckets:
            assert buckets[-1][1] <= inf


def test_histogram_scrape_hammer_never_tears():
    telemetry.enable()
    h = telemetry.histogram("hammer.seconds")
    stop = threading.Event()
    values = np.random.default_rng(7).exponential(0.05, 4096).tolist()

    def hammer():
        i = 0
        while not stop.is_set():
            h.observe(values[i % len(values)])
            i += 1

    threads = [threading.Thread(target=hammer, name=f"hammer-{i}",
                                daemon=True) for i in range(4)]
    for t in threads:
        t.start()
    try:
        for _ in range(300):
            _assert_histograms_valid(_parse_prom(
                telemetry.render_prometheus()))
            doc = telemetry.metrics_json()["hammer.seconds"]
            buckets = sorted((float(k), v)
                             for k, v in doc["buckets"].items())
            prev = 0
            for _le, v in buckets:
                assert v >= prev
                prev = v
            assert buckets[-1][1] <= doc["count"]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)


def test_render_prometheus_sum_equals_the_jax_packages():
    telemetry.enable()
    telemetry.counter("w.requests").inc(3)
    telemetry.histogram("w.lat", buckets=(0.1, 1.0)).observe(0.05)
    text1 = telemetry.render_prometheus()
    telemetry.counter("w.requests").inc(2)
    telemetry.histogram("w.lat", buckets=(0.1, 1.0)).observe(0.5)
    text2 = telemetry.render_prometheus()
    merged = telemetry.render_prometheus_sum([text1, text2])
    assert merged == jtel.render_prometheus_sum([text1, text2])
    fams = _parse_prom(merged)
    _assert_histograms_valid(fams)
    f1, f2 = _parse_prom(text1), _parse_prom(text2)
    for fam, doc in fams.items():
        for key, v in doc["samples"].items():
            assert v == (f1.get(fam, {}).get("samples", {}).get(key, 0)
                         + f2.get(fam, {}).get("samples", {}).get(key, 0))
    assert telemetry.merge_parsed_prometheus(
        [telemetry.parse_prometheus(t) for t in (text1, text2)]) == merged


def test_parse_prometheus_rejects_garbage():
    with pytest.raises(ValueError):
        telemetry.parse_prometheus("what even is this line\n")
    with pytest.raises(ValueError):
        telemetry.parse_prometheus("x{le=\"0.1\"} notanumber\n")


def test_write_metrics_atomic_in_both_formats(tmp_path):
    telemetry.enable()
    telemetry.counter("a.b").inc(2)
    p = str(tmp_path / "m" / "metrics.prom")
    assert telemetry.write_metrics(p, fmt="prometheus",
                                   extra={"run_x": 1.0})
    assert open(p).read() == telemetry.render_prometheus({"run_x": 1.0})
    j = str(tmp_path / "metrics.json")
    assert telemetry.write_metrics(j, extra={"run_x": 1.0})
    assert json.load(open(j)) == {"a.b": 2.0, "run_x": 1.0}
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path))
    with pytest.raises(ValueError):
        telemetry.write_metrics(j, fmt="xml")


# -- listeners ---------------------------------------------------------------

class _Recorder(telemetry.RunListener):
    def __init__(self):
        self.events = []

    def on_layer_start(self, index, n_stages, **_):
        self.events.append(("layer_start", index))


def test_listener_exceptions_do_not_break_the_run():
    telemetry.enable()

    class _Bomb(telemetry.RunListener):
        def on_layer_start(self, index, n_stages, **_):
            raise RuntimeError("boom")

    rec = _Recorder()
    telemetry.add_listener(_Bomb())
    telemetry.add_listener(rec)
    telemetry.emit("layer_start", index=0, n_stages=1)
    assert rec.events == [("layer_start", 0)]


def test_collecting_listener_summary_keys_are_the_jax_packages():
    p, j = telemetry.CollectingRunListener(), jtel.CollectingRunListener()
    for lst in (p, j):
        lst.on_run_start("Train")
        lst.on_layer_start(0, 2)
        lst.on_stage_fit("u1", "S", 0.5)
        lst.on_stats_pass(0, 2, 3, 1)
        lst.on_score_batch(10, 16, 0.1, compiled=True)
        lst.on_lint("TMG106", "warning")
        lst.on_plan(5, None, 3, 0)
        lst.on_run_end("Train", seconds=1.0)
    assert p.summary() == j.summary()
    assert p.events == j.events


# -- cross-process traces ----------------------------------------------------

def test_traceparent_round_trips_between_the_packages():
    for mint, parse in ((telemetry.mint_trace, jtel.parse_traceparent),
                        (jtel.mint_trace, telemetry.parse_traceparent)):
        ctx = mint()
        tp = telemetry.format_traceparent(*ctx)
        assert tp == jtel.format_traceparent(*ctx)
        assert parse(tp) == ctx
        assert len(ctx[0]) == 32 and len(ctx[1]) == 16
    for bad in (None, "", "zz", "00-short-short-01",
                "00-" + "g" * 32 + "-" + "0" * 16 + "-01"):
        assert telemetry.parse_traceparent(bad) is None \
            is jtel.parse_traceparent(bad)
    assert telemetry.mint_trace()[0] != telemetry.mint_trace()[0]


def test_span_trace_identity_and_nesting():
    telemetry.enable()
    ctx = telemetry.mint_trace()
    with telemetry.trace_scope(telemetry.format_traceparent(*ctx)):
        with telemetry.span("outer") as outer:
            assert outer.trace_id == ctx[0]
            assert outer.parent_id == ctx[1]
            with telemetry.span("inner") as inner:
                assert inner.trace_id == ctx[0]
                assert inner.parent_id == outer.span_id
    with telemetry.span("plain") as sp:
        assert sp.trace_id is None
    evs = {e["name"]: e for e in telemetry.trace_events()
           if e.get("ph") == "X"}
    assert evs["outer"]["args"]["trace_id"] == ctx[0]
    assert evs["inner"]["args"]["parent_span_id"] \
        == evs["outer"]["args"]["span_id"]
    assert "trace_id" not in evs["plain"]["args"]
    with telemetry.trace_scope(None):
        assert telemetry.current_trace() is None
    telemetry.disable()
    sp = telemetry.span("x")
    assert sp.trace_id is None and sp.span_id is None


def test_the_same_shards_merge_equal_in_both_packages(tmp_path):
    """A shard of each package (and a later-epoch one written by hand)
    under one directory: both mergers give the same document, aligned on
    the earliest epoch, a torn shard skipped with a note."""
    d = str(tmp_path / "shards")
    assert telemetry.write_trace_shard(d) is None    # nothing recorded
    paths = []
    for mod, role in ((telemetry, "port"), (jtel, "jax")):
        mod.enable()
        with mod.trace_scope(mod.mint_trace()):
            with mod.span("a"):
                pass
        paths.append(mod.write_trace_shard(d, role=role))
    # both processes share this pid: rename the JAX shard to another
    with open(paths[1]) as fh:
        doc = json.load(fh)
    doc["pid"] += 1
    os.remove(paths[1])
    with open(os.path.join(d, f"shard-jax-{doc['pid']}.trace.json"),
              "w") as fh:
        json.dump(doc, fh)
    mine = json.load(open(paths[0]))
    other = {"role": "router", "pid": mine["pid"] + 2,
             "epochUnixS": mine["epochUnixS"] + 2.0,
             "traceEvents": [{"name": "r", "ph": "X", "pid": 0, "tid": 0,
                              "ts": 10.0, "dur": 5.0, "args": {}}]}
    with open(os.path.join(d, "shard-router-9.trace.json"), "w") as fh:
        json.dump(other, fh)
    with open(os.path.join(d, "shard-torn-1.trace.json"), "w") as fh:
        fh.write("{not json")
    merged = telemetry.merge_trace_shards(d)
    assert merged == jtel.merge_trace_shards(d)
    assert merged["mergedShards"] == 3 and merged["mergeErrors"]
    t0 = min(mine["epochUnixS"], doc["epochUnixS"])
    r_ev = [e for e in merged["traceEvents"] if e["name"] == "r"][0]
    assert math.isclose(r_ev["ts"], 10.0 + (other["epochUnixS"] - t0) * 1e6,
                        rel_tol=1e-9)
    out = str(tmp_path / "merged.trace.json")
    assert telemetry.write_merged_trace(d, out) == json.load(open(out))
    st = telemetry.telemetry_stats()
    assert st["shards_written"] >= 1 and st["shards_merged"] >= 3


# -- runner parity -----------------------------------------------------------

def _records(n=300, seed=42):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(float)
    return [{"label": float(y[i]), "x": float(rng.normal() + y[i]),
             "z": None if i % 7 == 0 else float(rng.normal()),
             "c": ["a", "b", "c"][i % 3]} for i in range(n)]


class _ListReader:
    def __init__(self, records):
        self._records = records

    def read_records(self):
        return list(self._records)


def _flow(FB, transmogrify, S, LR, G, W):
    label = FB.RealNN("label").from_column().as_response()
    feats = [FB.Real("x").from_column().as_predictor(),
             FB.Real("z").from_column().as_predictor(),
             FB.PickList("c").from_column().as_predictor()]
    vec = label.sanity_check(transmogrify(feats))
    sel = S.with_cross_validation(
        num_folds=2, splitter=None, seed=5, families=[
            LR(grid=[{"regParam": 0.01, "elasticNetParam": 0.1}]),
            G(grid=[{"maxDepth": 2, "minInstancesPerNode": 10,
                     "minInfoGain": 0.001}], max_iter=2)])
    pred = label.transform_with(sel, vec)
    return W().set_result_features(pred), label, pred


def _runner(pkg, records):
    if pkg == "jax":
        juid.reset()
        wf, label, pred = _flow(JFB, jtransmogrify, JS, JLR, JG, JWorkflow)
        wf.set_mesh(False)
        return JRunner(wf, training_reader=_ListReader(records),
                       scoring_reader=_ListReader(records),
                       evaluator=JEv.BinaryClassification.auPR()
                       .set_columns(label, pred)), JOpParams, pred
    puid.reset()
    wf, label, pred = _flow(PFB, ptransmogrify, PS, PLR, PG, PWorkflow)
    return OpWorkflowRunner(
        wf, training_reader=_ListReader(records),
        scoring_reader=_ListReader(records),
        evaluator=PEv.BinaryClassification.auPR().set_columns(label, pred),
        device="cpu", dtype=torch.float64), OpParams, pred


def _run_all(pkg, root, telemetry_on):
    runner, Params, pred = _runner(pkg, _records())
    outs = {}
    for rt in RUNS:
        custom = {"telemetry": True} if telemetry_on else {}
        params = Params(
            model_location=os.path.join(root, "model"),
            metrics_location=os.path.join(root, f"{rt}.json"),
            trace_location=(os.path.join(root, f"{rt}.trace.json")
                            if telemetry_on else None),
            custom_params=custom)
        out = runner.run(rt, params)
        trace = (json.load(open(params.trace_location))
                 if telemetry_on else None)
        outs[rt] = (out, trace)
    return outs, pred, root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Train, Score and Evaluate through both runners with telemetry on,
    and through the port's with it off."""
    root = tmp_path_factory.mktemp("telemetry_runs")
    out = {}
    for pkg, on in (("jax", True), ("port", True), ("port-off", False)):
        out[pkg] = _run_all(pkg.split("-")[0], str(root / pkg), on)
    for m in (telemetry, jtel):
        m.disable()
        m.reset()
    return out


def _structure(trace):
    """Per track, each span's (name, depth) in start order: depth by
    interval containment; names excluded above dropped."""
    spans = [e for e in trace["traceEvents"] if e["ph"] == "X"
             and e["name"] not in EXCLUDED]
    tracks = {}
    for e in sorted(spans, key=lambda e: (e["tid"], e["ts"], -e["dur"])):
        tracks.setdefault(e["tid"], []).append(e)
    out = {}
    for tid, evs in tracks.items():
        stack, rows = [], []
        for e in evs:
            while stack and e["ts"] >= stack[-1]["ts"] + stack[-1]["dur"]:
                stack.pop()
            rows.append((e["name"], len(stack)))
            stack.append(e)
        out[tid] = rows
    return out


@pytest.mark.parametrize("run_type", RUNS)
def test_trace_structure_equals_the_jax_packages(runs, run_type):
    (jout, jtrace), (pout, ptrace) = (runs["jax"][0][run_type],
                                      runs["port"][0][run_type])
    assert _structure(ptrace) == _structure(jtrace)
    names = [n for rows in _structure(ptrace).values() for n, _ in rows]
    assert names[0] == f"run:{run_type}"
    assert {"run:preflight", "run:plan"} <= set(names)
    if run_type == RunType.TRAIN:
        rows = _structure(ptrace)[0]
        assert ("workflow:train", 1) in rows
        assert {("fit:layer", 2), ("fit:stats_pass", 3), ("fit:stage", 3),
                ("fit:transform_layer", 3)} <= set(rows)
        # the stage spans name the same stages
        pst = [e["args"]["uid"] for e in ptrace["traceEvents"]
               if e["name"] == "fit:stage"]
        jst = [e["args"]["uid"] for e in jtrace["traceEvents"]
               if e["name"] == "fit:stage"]
        assert pst == jst and len(pst) == 4


@pytest.mark.parametrize("run_type", RUNS)
def test_counters_and_listener_summary_equal_the_jax_packages(runs,
                                                              run_type):
    jm = runs["jax"][0][run_type][0].metrics
    pm = runs["port"][0][run_type][0].metrics

    def counters(m):
        return {k: v for k, v in m["telemetryMetrics"].items()
                if k not in EXCLUDED}

    assert counters(pm) == counters(jm)
    if run_type == RunType.TRAIN:
        assert counters(pm)["fitstats.bytes_scanned"] == 7800
        assert counters(pm)["fitstats.layers_fused"] == 1

    def summary(m):
        s = {k: v for k, v in m["telemetry"].items() if k not in EXCLUDED}
        if s["plan"]:
            s["plan"] = {k: v for k, v in s["plan"].items()
                         if f"plan.{k}" not in EXCLUDED}
        return s

    assert summary(pm) == summary(jm)
    assert sorted(pm["telemetry"]["stages"]) \
        == sorted(jm["telemetry"]["stages"])
    assert pm["telemetry"]["runType"] == run_type
    assert pm["telemetry"]["compileEvents"] == 0


def test_metrics_documents_hold_the_telemetry_blocks(runs):
    for rt in RUNS:
        on = runs["port"][0][rt][0].metrics
        off = runs["port-off"][0][rt][0].metrics
        for k in ("mfu", "telemetry", "telemetryMetrics", "peak_rss_mb"):
            assert k in on, (rt, k)
        assert "telemetry" not in off and "telemetryMetrics" not in off
        assert set(on["mfu"]) >= {"device_kind", "devices", "phases",
                                  "achieved_tflops", "mfu_f32_pct",
                                  "mfu_bf16_pct"}
        assert on["mfu"]["device_kind"] == "cpu"
        assert on["peak_rss_mb"] > 0
        written = json.load(open(os.path.join(runs["port"][2],
                                              f"{rt}.json")))
        assert set(written) == set(on)


def test_telemetry_changes_no_result(runs):
    """Models, metrics and scores bitwise equal with telemetry on and
    off; the metric equals the JAX package's."""
    on, off = runs["port"][0], runs["port-off"][0]
    m_on, m_off = on[RunType.TRAIN][0].model, off[RunType.TRAIN][0].model
    assert m_on.scoring_engine("cpu", plan=None).state_digest() \
        == m_off.scoring_engine("cpu", plan=None).state_digest()
    pred = runs["port"][1]
    for name in ("prediction", "raw_prediction", "probability"):
        a = getattr(on[RunType.SCORE][0].scores[pred.name], name)
        b = getattr(off[RunType.SCORE][0].scores[pred.name], name)
        assert np.array_equal(a, b), name
    ev_on, ev_off = on[RunType.EVALUATE][0].metrics, \
        off[RunType.EVALUATE][0].metrics
    for k in ("AuPR", "AuROC", "F1", "Error"):
        assert ev_on[k] == ev_off[k], k
    assert abs(ev_on["AuPR"]
               - runs["jax"][0][RunType.EVALUATE][0].metrics["AuPR"]) < 1e-9


def test_a_telemetry_off_train_makes_no_event_and_records_nothing(
        fake_cuda_events, tmp_path):
    runner, Params, _pred = _runner("port", _records(n=120))
    runner.run(RunType.TRAIN, Params(model_location=str(tmp_path / "m")))
    assert fake_cuda_events.made == 0
    assert telemetry.trace_events() == [] and telemetry.metrics_json() == {}
    assert telemetry.device_cost_stats()["phases"] == {}


def test_engine_spans_and_counters_equal_the_jax_packages(runs):
    """The scoring engine (forced on a small batch) under telemetry in
    both packages: score:prepare, score:bucket, the cache tallies, rows
    scored and the score_batch events; the port's engine times its warm
    dispatches in the mfu block."""
    records = _records(n=40, seed=3)
    got = {}
    for pkg, mod in (("jax", jtel), ("port", telemetry)):
        mod.enable()
        if pkg == "jax":
            from transmogrifai_tpu.workflow import WorkflowModel
            model = WorkflowModel.load(os.path.join(runs["jax"][2],
                                                    "model"))
            kw = {"engine": True}
        else:
            model = runs["port"][0][RunType.TRAIN][0].model
            kw = {"engine": True, "device": "cpu"}
        lst = mod.add_listener(mod.CollectingRunListener())
        for _ in range(3):
            model.score(records, **kw)
        spans = [(e["name"], e["args"].get("rows"), e["args"].get("bucket"),
                  e["args"].get("compiled"))
                 for e in mod.trace_events() if e["ph"] == "X"]
        metrics = {k: v for k, v in mod.metrics_json().items()
                   if k not in EXCLUDED and k != "scoring.batch_seconds"
                   and k != "device.bytes_h2d"}
        s = lst.summary()
        got[pkg] = (spans, metrics, {k: s[k] for k in (
            "scoreBatches", "rowsScored", "compiledBatches")},
            mod.metrics_json()["scoring.batch_seconds"]["count"])
        mod.remove_listener(lst)
        mod.disable()
    assert got["port"] == got["jax"]
    assert got["port"][2] == {"scoreBatches": 3, "rowsScored": 120,
                              "compiledBatches": 1}
    st = telemetry.device_cost_stats()["phases"]["scoring"]
    assert st["dispatches"] == 2 and st["flops"] > 0 and st["seconds"] > 0


def test_prometheus_sink_and_trace_shards(tmp_path, monkeypatch):
    """``metricsFormat: "prometheus"`` writes the registry with run_*
    gauges (one TYPE per family); ``traceDir`` and ``TMOG_TRACE_DIR``
    drop one shard each, which merges; the run leaves telemetry off."""
    runner, Params, _pred = _runner("port", _records(n=120))
    runner.run(RunType.TRAIN, Params(model_location=str(tmp_path / "m")))
    prom = str(tmp_path / "score.prom")
    shards = str(tmp_path / "shards")
    out = runner.run(RunType.SCORE, Params(
        model_location=str(tmp_path / "m"), metrics_location=prom,
        metrics_format="prometheus", custom_params={"traceDir": shards}))
    text = open(prom).read()
    fams = _parse_prom(text)
    assert fams["run_rowsScored"]["samples"][("run_rowsScored", "")] == 120
    assert fams["lint_info"]["type"] == "counter"
    assert telemetry.parse_prometheus(text)
    assert out.metrics["telemetry"]["runType"] == RunType.SCORE
    monkeypatch.setenv("TMOG_TRACE_DIR", shards)
    runner.run(RunType.EVALUATE, Params(model_location=str(tmp_path / "m")))
    names = sorted(os.listdir(shards))
    assert [n.rsplit("-", 1)[0] for n in names] == [
        "shard-run-evaluate", "shard-run-score"], names
    merged = telemetry.merge_trace_shards(shards)
    spans = {e["name"] for e in merged["traceEvents"] if e["ph"] == "X"}
    assert {"run:Score", "run:Evaluate"} <= spans
    assert not telemetry.enabled() and telemetry.metrics_json() == {}


def test_run_scoped_enablement_leaves_a_users_telemetry_on(tmp_path):
    runner, Params, _pred = _runner("port", _records(n=120))
    telemetry.enable()
    out = runner.run(RunType.TRAIN, Params(
        model_location=str(tmp_path / "m"),
        custom_params={"telemetry": True}))
    assert telemetry.enabled()
    assert out.metrics["telemetry"]["fittedStages"] == 4
    names = {e["name"] for e in telemetry.trace_events() if e["ph"] == "X"}
    assert "run:Train" in names


def test_a_failed_run_flushes_its_trace_and_raises_its_own_error(tmp_path):
    runner, Params, _pred = _runner("port", _records(n=120))
    trace = str(tmp_path / "t.json")

    class _Broken:
        def read_records(self):
            raise OSError("the reader failed")

    runner.workflow.set_reader(None)
    runner.training_reader = _Broken()
    with pytest.raises(OSError, match="the reader failed"):
        runner.run(RunType.TRAIN, Params(trace_location=trace))
    spans = {e["name"] for e in json.load(open(trace))["traceEvents"]
             if e["ph"] == "X"}
    assert {"run:Train", "run:preflight", "run:plan"} <= spans
    assert not telemetry.enabled()
