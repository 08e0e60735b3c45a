"""The port's knob registry (``transmogrifai_tpu_torch/config.py``) against
the JAX package's ``config.py``: the declarations, the scaffolded
``customParams``, ``check_custom_params`` and ``effective_config`` on the
defaults and on malformed values; the same malformed values raising in
both runners, naming the key; and the port's ``OpApp`` flags, with the
metrics document's ``effectiveConfig`` equal to the JAX runner's."""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import config as jconfig
from transmogrifai_tpu.models.linear import LogisticRegressionFamily as JLR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.runner import OpParams as JOpParams
from transmogrifai_tpu.runner import OpWorkflowRunner as JRunner
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import config as pconfig
from transmogrifai_tpu_torch import planner
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.models.linear import \
    LogisticRegressionFamily as PLR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PS
from transmogrifai_tpu_torch.runner import (OpApp, OpParams,
                                            OpWorkflowRunner, RunType)
from transmogrifai_tpu_torch.utils import uid as puid

#: malformed values of every kind the registry checks: an int's float,
#: bool, string and bound; a number's NaN, infinity and bound; a
#: tri-state's and a boolean's strings; enum choices; path strings;
#: dicts and lists; the extra validators (canaryFraction, retrainCmd)
MALFORMED = [
    ("batchSize", 2.5), ("batchSize", 0), ("batchSize", True),
    ("batchSize", "many"), ("maxBatches", -3), ("pipelineWorkers", 1e400),
    ("joinPartitions", float("inf")), ("streamFitPasses", "two"),
    ("timeoutS", -1), ("timeoutS", float("nan")), ("rssCapMb", 0.5),
    ("workloadMaxMb", 0), ("serveBatchDeadlineMs", "soon"),
    ("overlap", "yes"), ("streamFit", 0), ("aggregateColumnar", "maybe"),
    ("pipeline", "auto"), ("validate", "no"), ("telemetry", 1),
    ("failOn", "fatal"), ("onBatchError", "drop"), ("costDb", 3),
    ("traceDir", ["a"]), ("serveModels", ["m"]), ("lintSuppress", 5),
    ("canaryFraction", 1.5), ("canaryFraction", 0),
    ("retrainCmd", "python train.py"), ("retrainCmd", []),
    ("retrainCmd", ["python", 3]), ("meshDevices", 0),
]
#: well-formed values: strings the coercions accept, and bounds
WELL_FORMED = {"batchSize": 4096.0, "overlap": "AUTO", "pipeline": "false",
               "timeoutS": 0, "canaryFraction": 1, "lintSuppress": "TMG301",
               "retrainCmd": ["python", "train.py"], "failOn": "warning",
               "serveModels": {"a": "/m"}, "unknownPrivateKey": [1, 2]}


def _fields(knob):
    return {f.name: getattr(knob, f.name) for f in dataclasses.fields(knob)
            if f.name != "validator"}


def test_the_declarations_equal_the_jax_packages():
    """Every knob with the JAX package's name, type, default, owner,
    bounds, choices, tri-state and tuning bounds, in its order, and the
    lookups over them."""
    assert list(pconfig.REGISTRY) == list(jconfig.REGISTRY)
    for name, jk in jconfig.REGISTRY.items():
        pk = pconfig.knob(name)
        want, got = _fields(jk), _fields(pk)
        want.pop("doc"), got.pop("doc")
        assert got == want, name
        assert (pk.validator is None) == (jk.validator is None), name
        assert pconfig.knob_bounds(name) == jconfig.knob_bounds(name)
    assert [k.name for k in pconfig.tunable_knobs()] == \
        [k.name for k in jconfig.tunable_knobs()]
    assert [k.name for k in pconfig.iter_knobs()] == list(jconfig.REGISTRY)
    with pytest.raises(KeyError, match="undeclared customParams knob"):
        pconfig.knob("noSuchKnob")


def test_defaults_equal_the_jax_packages():
    assert pconfig.default_custom_params() == jconfig.default_custom_params()
    assert list(pconfig.default_custom_params()) == \
        list(jconfig.default_custom_params())
    assert pconfig.effective_config({}) == jconfig.effective_config({})
    assert pconfig.check_custom_params({}) == []
    assert pconfig.check_custom_params(WELL_FORMED) == \
        jconfig.check_custom_params(WELL_FORMED) == []
    assert pconfig.effective_config(WELL_FORMED) == \
        jconfig.effective_config(WELL_FORMED)
    params = pconfig.default_custom_params()
    assert pconfig.check_custom_params(params) == []
    assert pconfig.effective_config(params) == jconfig.effective_config(
        params)


@pytest.mark.parametrize("key,value", MALFORMED,
                         ids=[f"{k}={v!r}" for k, v in MALFORMED])
def test_malformed_values_are_reported_as_the_jax_package_reports_them(
        key, value):
    """``check_custom_params`` finds the same (key, message) pairs, word
    for word, and ``effective_config`` stamps the same ``invalid``
    record; each accessor of the knob's type raises the JAX message."""
    cp = {key: value}
    want = jconfig.check_custom_params(cp)
    assert want, (key, value)
    assert pconfig.check_custom_params(cp) == want
    assert pconfig.effective_config(cp) == jconfig.effective_config(cp)
    kind = jconfig.knob(key).type
    accessor = {"int": "numeric_param", "float": "numeric_param",
                "bool": "bool_param", "str": "string_param"}.get(kind)
    if accessor is None or jconfig.knob(key).validator is not None:
        return      # a shape its owner checks, or an extra validator's
    with pytest.raises(ValueError) as jerr:
        getattr(jconfig, accessor)(cp, key)
    with pytest.raises(ValueError) as perr:
        getattr(pconfig, accessor)(cp, key)
    assert str(perr.value) == str(jerr.value)
    assert f"customParams.{key}" in str(perr.value)


@pytest.mark.parametrize("raw,cast", [(3, int), ("7", int), (2.0, int),
                                      (0.25, float), ("1e3", float)])
def test_coercions_equal_the_jax_packages(raw, cast):
    assert pconfig.coerce_numeric(raw, "k", cast) == \
        jconfig.coerce_numeric(raw, "k", cast)
    for b in (True, "True", " false "):
        assert pconfig.coerce_bool(b, "k") == jconfig.coerce_bool(b, "k")
    assert pconfig.coerce_bool("auto", "k", allow_auto=True) == "auto"


# ---------------------------------------------------------------------------
# the runners: the same malformed values raise in both, naming the key
# ---------------------------------------------------------------------------

class _ListReader:
    def __init__(self, records):
        self._records = records

    def read_records(self):
        return list(self._records)


def _records(n=60, seed=42):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(float)
    x = rng.normal(size=n) + y
    return [{"label": float(y[i]), "x": float(x[i])} for i in range(n)]


def _flow(FB, transmogrify, S, LR, W):
    label = FB.RealNN("label").from_column().as_response()
    fx = FB.Real("x").from_column().as_predictor()
    sel = S.with_cross_validation(num_folds=2, families=[LR()],
                                  splitter=None, seed=5)
    pred = label.transform_with(sel, transmogrify([fx]))
    return W().set_result_features(pred), label, pred


def _runners(records):
    puid.reset()
    pwf, _pl, _pp = _flow(PFB, ptransmogrify, PS, PLR, PWorkflow)
    port = OpWorkflowRunner(pwf, training_reader=_ListReader(records),
                            scoring_reader=_ListReader(records),
                            device="cpu", dtype=torch.float64)
    juid.reset()
    jwf, _jl, _jp = _flow(JFB, jtransmogrify, JS, JLR, JWorkflow)
    jax = JRunner(jwf.set_mesh(False), training_reader=_ListReader(records),
                  scoring_reader=_ListReader(records))
    return port, jax


#: knobs a Train reads, each with a malformed value
TRAIN_KNOBS = [("aggregateColumnar", "maybe"), ("joinPartitions", 2.5),
               ("joinTableMaxRows", 0), ("traceDir", 5)]
#: knobs StreamingScore reads, each with a malformed value
STREAM_KNOBS = [("batchSize", 0), ("maxBatches", 2.5), ("timeoutS", -1),
                ("overlap", "yes"), ("pipeline", "auto"),
                ("pipelineWorkers", 0), ("pipelineDepth", "x")]


@pytest.mark.parametrize("key,value", TRAIN_KNOBS,
                         ids=[k for k, _ in TRAIN_KNOBS])
def test_train_knobs_raise_naming_the_key_in_both_runners(key, value):
    port, jax = _runners(_records())
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        port.run(RunType.TRAIN, OpParams(custom_params={key: value}))
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        jax.run(RunType.TRAIN, JOpParams(custom_params={key: value}))


@pytest.fixture(scope="module")
def saved_models(tmp_path_factory):
    """One small model a package, saved, for StreamingScore."""
    root = tmp_path_factory.mktemp("stream_knobs")
    port, jax = _runners(_records())
    port.run(RunType.TRAIN, OpParams(model_location=str(root / "p")))
    jax.run(RunType.TRAIN, JOpParams(model_location=str(root / "j")))
    return port, jax, root


@pytest.mark.parametrize("key,value", STREAM_KNOBS,
                         ids=[k for k, _ in STREAM_KNOBS])
def test_streaming_knobs_raise_naming_the_key_in_both_runners(
        key, value, saved_models):
    port, jax, root = saved_models
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        port.run(RunType.STREAMING_SCORE, OpParams(
            model_location=str(root / "p"), custom_params={key: value}))
    with pytest.raises(ValueError, match=f"customParams.{key}"):
        jax.run(RunType.STREAMING_SCORE, JOpParams(
            model_location=str(root / "j"), custom_params={key: value}))


class _App(OpApp):
    def __init__(self, runner):
        self._runner = runner

    def runner(self, params):
        return self._runner


def test_op_app_flags_reach_the_run_and_effective_config_is_the_jax_one(
        tmp_path):
    """``--trace-out``, ``--metrics-format``, ``--quarantine-out`` and
    ``--compile-cache-dir`` set what the JAX package's flags set; the
    metrics document's ``effectiveConfig`` equals the JAX runner's for
    the same ``customParams`` and ``compileCacheDir`` names the
    directory, where the cost database is written."""
    custom = {"batchSize": 512, "overlap": "false", "failOn": "warning",
              "joinPartitions": 4}
    (tmp_path / "p.json").write_text(json.dumps({"customParams": custom}))
    port, jax = _runners(_records())
    cache = tmp_path / "cache"
    out = _App(port).main([
        "--run-type", "Train", "--quiet", "--params",
        str(tmp_path / "p.json"), "--model-location", str(tmp_path / "m"),
        "--metrics-location", str(tmp_path / "met.json"),
        "--trace-out", str(tmp_path / "run.trace.json"),
        "--quarantine-out", str(tmp_path / "q.jsonl"),
        "--compile-cache-dir", str(cache)])
    want = jax.run(RunType.TRAIN, JOpParams(
        custom_params=dict(custom, compileCacheDir=str(cache)))).metrics
    assert out.metrics["effectiveConfig"] == want["effectiveConfig"]
    assert out.metrics["effectiveConfig"]["batchSize"] == 512
    assert out.metrics["effectiveConfig"]["overlap"] is False
    assert out.metrics["compileCacheDir"] == want["compileCacheDir"] \
        == str(cache)
    assert os.path.exists(planner.default_cost_db_path(str(cache)))
    trace = json.load(open(tmp_path / "run.trace.json"))
    assert any(ev.get("name") == "run:Train" for ev in trace["traceEvents"])
    doc = json.load(open(tmp_path / "met.json"))
    assert doc["effectiveConfig"] == want["effectiveConfig"]
    out = _App(port).main([
        "--run-type", "Score", "--quiet", "--model-location",
        str(tmp_path / "m"), "--metrics-location",
        str(tmp_path / "met.prom"), "--metrics-format", "prometheus"])
    assert out.metrics["rowsScored"] == 60
    assert out.metrics["effectiveConfig"] == pconfig.effective_config({})
    text = (tmp_path / "met.prom").read_text()
    assert "# TYPE" in text and "run_rowsScored" in text
    assert not math.isnan(out.metrics["appSeconds"])
