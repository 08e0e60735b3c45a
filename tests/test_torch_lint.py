"""The port's pre-flight (``transmogrifai_tpu_torch/lint.py``, the
temporal rules in ``temporal.check_temporal`` and the runner's pre-flight
step) beside the JAX package's: the same mis-wired workflows built in
both packages give the same findings (rule id, severity, stage and
feature, the port's uids mapped to the JAX package's by their place in
the DAG), for the graph rules TMG101–106, the device rules TMG201–206
(the port's shapes on the meta device, the JAX package's by
``jax.eval_shape``), the temporal rules TMG701–703, suppression,
``enforce`` and the runner's ``failOn``; a pre-flight launches no kernel;
``summary_pretty``'s table is the JAX package's."""
import json
import types

import numpy as np
import pytest
import torch

import transmogrifai_tpu.runner as _jrunner  # noqa: F401
import transmogrifai_tpu_torch.runner as _prunner  # noqa: F401
import transmogrifai_tpu as J
import transmogrifai_tpu_torch as P
from transmogrifai_tpu import lint as jlint
from transmogrifai_tpu import temporal as jtemporal
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import lint as plint
from transmogrifai_tpu_torch import temporal as ptemporal
from transmogrifai_tpu_torch.models import _hist
from transmogrifai_tpu_torch.utils import uid as puid


def _ns(pkg):
    """The names a fixture needs, from one package."""
    import importlib
    m = {}
    for name, mod, attr in (
            ("FB", "", "FeatureBuilder"), ("Workflow", "", "Workflow"),
            ("WorkflowModel", ".workflow", "WorkflowModel"),
            ("lint", ".lint", None), ("temporal", ".temporal", None),
            ("LR", ".models.linear", "LogisticRegressionFamily"),
            ("Selector", ".models.selector",
             "BinaryClassificationModelSelector"),
            ("SmartText", ".ops.smart_text", "SmartTextVectorizer"),
            ("RealVectorizer", ".ops.numeric", "RealVectorizer"),
            ("SanityChecker", ".ops.sanity_checker", "SanityChecker"),
            ("VectorizerModel", ".ops.vectorizer_base", "VectorizerModel"),
            ("base", ".stages.base", None),
            ("ft", ".types.feature_types", None),
            ("vm", ".vector_metadata", None),
            ("readers", ".readers", None),
            ("aggregators", ".utils.aggregators", None),
            ("transmogrify", (".ops.transmogrifier"
                              if pkg == "transmogrifai_tpu" else ".dsl"),
             "transmogrify")):
        module = importlib.import_module(pkg + mod)
        m[name] = module if attr is None else getattr(module, attr)
    m["port"] = pkg == "transmogrifai_tpu_torch"
    m["uid"] = puid if m["port"] else juid
    return types.SimpleNamespace(**m)


JX, PT = _ns("transmogrifai_tpu"), _ns("transmogrifai_tpu_torch")


def _both(build):
    """``build(ns)`` in the JAX package, then in the port, each from
    uid 1."""
    out = []
    for ns in (JX, PT):
        ns.uid.reset()
        out.append(build(ns))
    return out


def _uid_map(jfeats, pfeats):
    """{port uid or feature name: the JAX package's}, by the place of
    each stage and feature in the two DAGs' identity walks."""
    jf, js, _ = jlint._walk_features(tuple(jfeats))
    pf, ps, _ = plint._walk_features(tuple(pfeats))
    assert len(jf) == len(pf) and len(js) == len(ps)
    out = {}
    for a, b in zip(js, ps):
        out[b.uid] = a.uid
    for a, b in zip(jf, pf):
        out[b.name] = a.name
        out[b.uid] = a.uid
    return out


def _key(f, mapping=None):
    m = mapping or {}
    return (f.rule, f.severity, m.get(f.stage, f.stage),
            m.get(f.feature, f.feature))


def _same_findings(jfindings, pfindings, jfeats, pfeats):
    mapping = _uid_map(jfeats, pfeats)
    want = sorted(_key(f) for f in jfindings)
    got = sorted(_key(f, mapping) for f in pfindings)
    assert got == want
    return got


def _records(n=200, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n).astype(float)
    x = rng.normal(size=n) + y
    return [{"label": float(y[i]), "x": float(x[i])} for i in range(n)]


def _binary_flow(ns):
    label = ns.FB.RealNN("label").from_column().as_response()
    fx = ns.FB.Real("x").from_column().as_predictor()
    vec = ns.transmogrify([fx])
    sel = ns.Selector.with_cross_validation(
        num_folds=2, families=[ns.LR()], splitter=None, seed=5)
    pred = label.transform_with(sel, vec)
    return ns.Workflow().set_result_features(pred), label, fx, vec, pred


def _train(ns, wf):
    wf.set_input_records(_records())
    if ns.port:
        return wf.train(device="cpu", dtype=torch.float64)
    return wf.train()


def _mistyped(ns):
    """A text vectorizer fed an OPVector by direct wiring (bypassing
    set_input)."""
    fx = ns.FB.Real("x").from_column().as_predictor()
    vec = ns.transmogrify([fx])
    tv = ns.SmartText()
    tv.input_features = (vec,)
    return ns.Workflow().set_result_features(tv.get_output()), tv, vec


# ---------------------------------------------------------------------------
# the catalog and the finding records
# ---------------------------------------------------------------------------


def test_rule_catalog_ids_and_severities_are_the_jax_packages():
    assert set(plint.RULES) == set(jlint.RULES)
    for rule, (severity, _what) in jlint.RULES.items():
        assert plint.RULES[rule][0] == severity, rule


def test_finding_format_and_json_equal_the_jax_packages():
    for kw in ({}, {"stage": "S_000000000001"},
               {"stage": "S_000000000001", "feature": "f"},
               {"feature": "f"}, {"location": "a.py:3"}):
        a = jlint.Finding("TMG104", "dead", **kw)
        b = plint.Finding("TMG104", "dead", **kw)
        assert a.format() == b.format() and a.to_json() == b.to_json()
    assert plint.max_severity([plint.Finding("TMG402", "x"),
                               plint.Finding("TMG401", "y")]) == "warning"
    assert plint.max_severity([]) is None


def test_no_tpu_figure_in_the_port_catalog():
    text = " ".join(what for _sev, what in plint.RULES.values())
    assert "VMEM envelope" not in text and "per-chip" not in text
    assert "XLA" not in plint.RULES["TMG203"][1]


# ---------------------------------------------------------------------------
# graph rules (TMG1xx)
# ---------------------------------------------------------------------------


def test_tmg101_mistyped_edge_in_both():
    (jwf, jtv, jvec), (pwf, ptv, pvec) = _both(_mistyped)
    jf, pf = jlint.check_workflow(jwf), plint.check_workflow(pwf)
    _same_findings(jf, pf, jwf.result_features, pwf.result_features)
    f = next(f for f in pf if f.rule == "TMG101")
    assert f.stage == ptv.uid and pvec.name in f.message
    assert "OPVector" in f.message and "SmartTextVectorizer" in f.message


def test_tmg101_clean_binary_workflow_and_workflow_check():
    (jwf, *_), (pwf, *_) = _both(_binary_flow)
    assert jlint.check_workflow(jwf) == [] == plint.check_workflow(pwf)
    assert pwf.check() == []


def test_tmg102_duplicate_uid_in_both():
    def build(ns):
        a = ns.FB.Real("a").from_column().as_predictor()
        b = ns.FB.Real("b").from_column().as_predictor()
        dup = "RealVectorizer_00000000beef"
        f1 = ns.RealVectorizer(uid=dup).set_input(a).get_output()
        f2 = ns.RealVectorizer(uid=dup).set_input(b).get_output()
        return [f1, f2]
    jfeats, pfeats = _both(build)
    pf = plint.check_workflow(pfeats)
    _same_findings(jlint.check_workflow(jfeats), pf, jfeats, pfeats)
    assert any(f.rule == "TMG102" and f.stage == "RealVectorizer_00000000beef"
               for f in pf)
    with pytest.raises(P.workflow.WorkflowError, match="duplicate"):
        P.Workflow().set_result_features(*pfeats)


def test_tmg103_cycle_reported_in_both():
    def build(ns):
        fx = ns.FB.Real("x").from_column().as_predictor()
        vec = ns.transmogrify([fx])
        vec.parents = (vec,)
        return [vec]
    jfeats, pfeats = _both(build)
    pf = plint.check_workflow(pfeats)
    _same_findings(jlint.check_workflow(jfeats), pf, jfeats, pfeats)
    assert any(f.rule == "TMG103" and f.severity == "error" for f in pf)


def test_tmg104_dead_fitted_stage_in_both():
    def build(ns):
        wf, *_ = _binary_flow(ns)
        model = _train(ns, wf)
        model.fitted_stages["Ghost_00000000dead"] = object()
        return model
    jm, pm = _both(build)
    pf = plint.check_model(pm, device=False)
    _same_findings(jlint.check_model(jm, device=False), pf,
                   jm.result_features, pm.result_features)
    f = next(f for f in pf if f.rule == "TMG104")
    assert "Ghost_00000000dead" in f.message and f.severity == "warning"


def test_tmg105_laundered_label_in_both_and_sanctioned_consumers_clean():
    def build(ns):
        label = ns.FB.RealNN("label").from_column().as_response()
        fx = ns.FB.Real("x").from_column().as_predictor()
        leak = ns.base.LambdaTransformer("leak", lambda a, b: a,
                                         [ns.ft.Real, ns.ft.Real],
                                         ns.ft.Real)
        leak.input_features = (label, fx)
        return [ns.transmogrify([leak.get_output()])], leak
    (jfeats, _), (pfeats, pleak) = _both(build)
    pf = plint.check_workflow(pfeats)
    _same_findings(jlint.check_workflow(jfeats), pf, jfeats, pfeats)
    f = next(f for f in pf if f.rule == "TMG105")
    assert f.stage == pleak.uid and "label" in f.message

    def sanctioned(ns):
        wf, label, _fx, vec, pred = _binary_flow(ns)
        return [label.transform_with(ns.SanityChecker(), vec), pred]
    jfeats, pfeats = _both(sanctioned)
    assert plint.check_workflow(pfeats) == [] \
        == jlint.check_workflow(jfeats)


class _AnyInput:
    """An estimator over any input type (the TMG106 fixture), made for
    one package."""

    @staticmethod
    def make(ns):
        class AnyInputEstimator(ns.base.Estimator):
            operation_name = "dummyEst"
            output_type = ns.ft.OPVector

            @property
            def input_spec(self):
                return ns.base.VarArity(ns.ft.FeatureType)

            def fit_columns(self, store):          # pragma: no cover
                raise NotImplementedError
        return AnyInputEstimator


def test_tmg106_estimator_after_model_in_both():
    def build(ns):
        p = ns.FB.of(ns.ft.Prediction, "p").from_column().as_predictor()
        est = _AnyInput.make(ns)().set_input(p)
        return [est.get_output()]
    jfeats, pfeats = _both(build)
    pf = plint.check_workflow(pfeats)
    _same_findings(jlint.check_workflow(jfeats), pf, jfeats, pfeats)
    assert [f.severity for f in pf if f.rule == "TMG106"] == ["warning"]

    def unfitted(ns):
        _wf, _label, _fx, _vec, pred = _binary_flow(ns)
        return ns.WorkflowModel(result_features=[pred], fitted_stages={})
    jm, pm = _both(unfitted)
    pf = plint.check_model(pm, device=False)
    _same_findings(jlint.check_model(jm, device=False), pf,
                   jm.result_features, pm.result_features)
    assert any(f.rule == "TMG106" and f.severity == "error"
               and "unfitted estimator" in f.message for f in pf)


# ---------------------------------------------------------------------------
# device rules (TMG2xx)
# ---------------------------------------------------------------------------


def _bad_vec(ns):
    """Deliberately broken vectorizer: width 3 against metadata of 2
    (TMG201), f64 output (TMG202), a bare scalar block and a signature
    that flaps with the batch (TMG203)."""
    np_ = np

    class BadVec(ns.VectorizerModel):
        operation_name = "badVec"
        seq_type = ns.ft.Real

        def host_prepare(self, store):
            col = store[self.input_features[0].name]
            n = len(col)
            out = {"x": np_.nan_to_num(col.astype_float()), "n": float(n)}
            if n % 2 == 0:
                out["pad"] = np_.zeros(3, dtype=np_.float32)
            return out

        if ns.port:
            def device_compute(self, prepared):
                x = prepared["x"].to(torch.float64)
                return torch.stack([x, x, x], dim=1)
        else:
            def device_compute(self, xp, prepared):
                x = xp.asarray(prepared["x"], dtype=xp.float64)
                return xp.stack([x, x, x], axis=1)

        def vector_metadata(self):
            c = ns.vm.VectorColumnMetadata
            return ns.vm.VectorMetadata("bad", [c("x", "Real"),
                                                c("x", "Real")])
    return BadVec


def _row_vec(ns, safe: bool):
    """Row dimension baked into the program (TMG205) unless ``safe``."""
    np_ = np

    class RowVec(ns.VectorizerModel):
        operation_name = "rowVec"
        seq_type = ns.ft.Real

        def host_prepare(self, store):
            col = store[self.input_features[0].name]
            return {"x": np_.nan_to_num(col.astype_float())}

        if ns.port:
            def device_compute(self, prepared):
                x = prepared["x"].to(torch.float32)
                out = torch.stack([x, x], dim=1)
                return out if safe else out[:8]
        else:
            def device_compute(self, xp, prepared):
                x = xp.asarray(prepared["x"], dtype=xp.float32)
                out = xp.stack([x, x], axis=1)
                return out if safe else out[:8]

        def vector_metadata(self):
            c = ns.vm.VectorColumnMetadata
            return ns.vm.VectorMetadata("rv", [c("x", "Real"),
                                               c("x", "Real")])
    return RowVec


def _device_model(ns, make):
    fx = ns.FB.Real("x").from_column().as_predictor()
    out = make(ns)().set_input(fx).get_output()
    return ns.WorkflowModel(result_features=[out], fitted_stages={})


def _device_findings(make, **kw):
    jm, pm = _both(lambda ns: _device_model(ns, make))
    before = dict(_hist.KERNEL_LAUNCHES)
    pf = plint.preflight_device(pm, **kw)
    assert dict(_hist.KERNEL_LAUNCHES) == before
    _same_findings(jlint.preflight_device(jm), pf, jm.result_features,
                   pm.result_features)
    return pf


def test_tmg201_202_203_seeded_violations_in_both():
    pf = _device_findings(_bad_vec)
    assert {"TMG201", "TMG202", "TMG203"} <= {f.rule for f in pf}
    shape = next(f for f in pf if f.rule == "TMG201")
    assert "(8, 3)" in shape.message and "(8, 2)" in shape.message
    scalar = [f for f in pf if f.rule == "TMG203"]
    assert any("'n'" in f.message for f in scalar)
    assert any("graphs_captured" in f.message for f in scalar)


def test_tmg205_row_unsafe_stage_in_both():
    pf = _device_findings(lambda ns: _row_vec(ns, safe=False))
    f = next(f for f in pf if f.rule == "TMG205")
    assert f.severity == "error" and "does not track the batch" in f.message
    assert _device_findings(lambda ns: _row_vec(ns, safe=True)) == []


def test_tmg206_under_the_envelope_override(monkeypatch):
    make = lambda ns: _row_vec(ns, safe=True)    # noqa: E731
    monkeypatch.setattr(jlint, "VMEM_ENVELOPE_BYTES", 64)
    monkeypatch.setattr(plint, "VMEM_ENVELOPE_BYTES", 64)
    pf = _device_findings(make)
    f = next(f for f in pf if f.rule == "TMG206")
    assert f.severity == "warning" and "featureShards" in f.message
    assert "TMOG_VMEM_BYTES" in f.message and "VMEM envelope" not in \
        f.message
    # with no override and no card the rule does not run (the envelope is
    # the card's memory, read at run time)
    monkeypatch.setattr(plint, "VMEM_ENVELOPE_BYTES", None)
    if not torch.cuda.is_available():
        jm, pm = _both(lambda ns: _device_model(ns, make))
        assert plint.preflight_device(pm) == []


def test_tmg204_host_stage_without_static_form_in_both():
    def build(ns):
        fx = ns.FB.Real("x").from_column().as_predictor()

        def boom(col):
            raise RuntimeError("no static form")
        t = ns.base.LambdaTransformer("boom", boom, [ns.ft.Real],
                                      ns.ft.Real).set_input(fx)
        return ns.WorkflowModel(result_features=[t.get_output()],
                                fitted_stages={})
    jm, pm = _both(build)
    pf = plint.preflight_device(pm)
    _same_findings(jlint.preflight_device(jm), pf, jm.result_features,
                   pm.result_features)
    f = next(f for f in pf if f.rule == "TMG204")
    assert f.severity == "info" and "no static form" in f.message


def test_suppressed_graph_error_keeps_the_device_pass_in_both():
    def build(ns):
        p = ns.FB.of(ns.ft.Prediction, "p").from_column().as_predictor()
        est = _AnyInput.make(ns)().set_input(p)
        return ns.WorkflowModel(result_features=[est.get_output()],
                                fitted_stages={})
    jm, pm = _both(build)
    for sup in ((), ["TMG106"]):
        pf = plint.check_model(pm, device=True, suppress=sup)
        _same_findings(jlint.check_model(jm, device=True, suppress=sup), pf,
                       jm.result_features, pm.result_features)
        assert any(f.rule == "TMG204" for f in pf)
        assert any(f.severity == "error" for f in pf) == (not sup)


def test_preflight_of_a_fitted_model_is_clean_and_launches_nothing():
    """A trained binary workflow (fit in f64 on the CPU: TMG202 reads the
    f32 vector pipeline, not the fit's dtype) is clean in both packages;
    the port's pass launches no kernel and keeps no meta table."""
    def build(ns):
        wf, *_ = _binary_flow(ns)
        return _train(ns, wf)
    jm, pm = _both(build)
    before = dict(_hist.KERNEL_LAUNCHES)
    assert pm.check(device=True) == [] == jm.validate(device=True)
    assert dict(_hist.KERNEL_LAUNCHES) == before
    for m in pm.fitted_stages.values():
        for key in getattr(m, "__dict__", {}).get("_device_tables", {}):
            assert key[1] != "meta"


def test_tree_predictor_propagates_on_the_meta_device():
    """``predict_trees`` takes the operator's fake on meta tensors; the
    CPU and CUDA paths are unchanged."""
    X = torch.empty((8, 5), device="meta")
    feat = torch.zeros((2, 7), dtype=torch.int32, device="meta")
    thr = torch.zeros((2, 7), device="meta")
    leaf = torch.zeros((2, 8, 1), device="meta")
    before = dict(_hist.KERNEL_LAUNCHES)
    out = _hist.predict_trees(X, feat, thr, leaf, 3)
    assert out.device.type == "meta" and tuple(out.shape) == (8, 1)
    assert dict(_hist.KERNEL_LAUNCHES) == before


def test_device_table_takes_a_device_name_and_keeps_no_meta_table():
    from transmogrifai_tpu_torch.models.base import device_table
    owner = types.SimpleNamespace()
    host = device_table(owner, "w", lambda: np.arange(3.0), "cpu")
    for dev in ("meta", torch.device("meta")):
        t = device_table(owner, "w", lambda: np.arange(3.0), dev)
        assert t.device.type == "meta" and tuple(t.shape) == (3,)
        assert t.dtype == torch.float64
    assert host.device.type == "cpu"
    assert list(owner._device_tables) == [("w", "cpu")]


# ---------------------------------------------------------------------------
# suppression and enforce
# ---------------------------------------------------------------------------


def test_suppress_and_enforce_semantics_in_both():
    (jwf, *_), (pwf, *_) = _both(_mistyped)
    for lint, wf in ((jlint, jwf), (plint, pwf)):
        assert lint.check_workflow(wf, suppress=["TMG101"]) == []
        assert lint.check_workflow(wf, suppress="TMG101") == []
        with pytest.raises(ValueError, match="unknown lint rule"):
            lint.check_workflow(wf, suppress=["TMG999"])
        findings = [lint.Finding("TMG203", "warn-only")]
        lint.enforce(findings, fail_on="error")
        with pytest.raises(lint.LintError):
            lint.enforce(findings, fail_on="warning")
        with pytest.raises(ValueError):
            lint.enforce(findings, fail_on="info")
    with pytest.raises(plint.LintError) as ei:
        plint.enforce(plint.check_workflow(pwf))
    assert "TMG101" in str(ei.value) and ei.value.fail_on == "error"


# ---------------------------------------------------------------------------
# temporal rules (TMG7xx)
# ---------------------------------------------------------------------------


def _amount(ns, name, window=None):
    b = ns.FB.Real(name).extract(ns.temporal.field("amount"),
                                 "amount").aggregate(
        ns.aggregators.SumAggregator())
    if window is not None:
        b = b.window(window)
    return b.as_predictor()


def _flag_label(ns, window=None):
    b = (ns.FB.RealNN("label").extract(ns.temporal.field("flag"), "flag")
         .aggregate(ns.aggregators.LogicalOrAggregator()))
    if window is not None:
        b = b.window(window)
    return b.as_response()


class _NoIO:
    """Records that fail the test when read."""

    def read_records(self):
        raise AssertionError("reader I/O during a static check")


def _temporal_flow(ns, cutoff=None, window=None, conditional=False):
    field = ns.temporal.field
    R = ns.readers
    cut = (R.CutOffTime.no_cutoff() if cutoff is None
           else R.CutOffTime.at(cutoff))
    base = R.DataReaders.simple.records([])
    if conditional:
        reader = R.ConditionalReader(base, field("ts"),
                                     lambda r: bool(r["flag"]),
                                     key_fn=field("user"))
    else:
        reader = R.AggregateReader(base, field("ts"), cut,
                                   key_fn=field("user"))
    reader.read_records = _NoIO().read_records
    label = _flag_label(ns, window)
    spend = _amount(ns, "spend")
    sel = ns.Selector.with_cross_validation(
        num_folds=2, families=[ns.LR()], splitter=None)
    pred = label.transform_with(sel, ns.transmogrify([spend]))
    return ns.Workflow().set_result_features(pred), reader


@pytest.mark.parametrize("case", [
    dict(), dict(cutoff=500), dict(cutoff=500, conditional=True),
    dict(cutoff=500, window=100)],
    ids=["no-cutoff", "cutoff", "conditional", "response-window"])
def test_tmg701_702_over_readers_built_in_both(case):
    (jwf, jr), (pwf, pr) = _both(lambda ns: _temporal_flow(ns, **case))
    jf = jlint.check_workflow(jwf, reader=jr)
    pf = plint.check_workflow(pwf, reader=pr)
    _same_findings(jf, pf, jwf.result_features, pwf.result_features)
    rules = {f.rule for f in pf}
    assert ("TMG701" in rules) == (case == {})
    assert ("TMG702" in rules) == ("window" in case)
    # the reader set on the workflow is found there too
    assert {f.rule for f in plint.check_workflow(pwf.set_reader(pr))} \
        == rules


def test_tmg703_join_key_from_a_response_field_in_both():
    def build(ns, key):
        field, R = ns.temporal.field, ns.readers
        left = R.DataReaders.simple.records([], key_fn=field(key))
        right = R.DataReaders.simple.records([], key_fn=field(key))
        join = R.TemporalJoinReader(left, right, key_field=key)
        reader = R.AggregateReader(join, field("ts"), R.CutOffTime.at(500),
                                   key_fn=field(key))
        return reader, [_flag_label(ns), _amount(ns, "spend")]
    for key, fires in (("flag", True), ("user", False)):
        (jr, jfeats), (pr, pfeats) = _both(lambda ns: build(ns, key))
        jf = jtemporal.check_temporal(jr, jfeats)
        pf = ptemporal.check_temporal(pr, pfeats)
        _same_findings(jf, pf, jfeats, pfeats)
        assert any(f.rule == "TMG703" for f in pf) == fires


# ---------------------------------------------------------------------------
# the runner's pre-flight
# ---------------------------------------------------------------------------


class _CountingReader:
    def __init__(self, records):
        self._records = records
        self.calls = 0

    def read_records(self):
        self.calls += 1
        return list(self._records)


def test_runner_rejects_a_mistyped_workflow_before_any_reader_io():
    PT.uid.reset()
    wf, tv, _vec = _mistyped(PT)
    reader = _CountingReader(_records())
    runner = P.runner.OpWorkflowRunner(wf, training_reader=reader,
                                       device="cpu")
    with pytest.raises(plint.LintError) as ei:
        runner.run(P.runner.RunType.TRAIN, P.runner.OpParams())
    assert "TMG101" in str(ei.value) and tv.uid in str(ei.value)
    assert reader.calls == 0


def test_runner_temporal_gate_blocks_before_reader_io():
    PT.uid.reset()
    wf, reader = _temporal_flow(PT)
    runner = P.runner.OpWorkflowRunner(wf, training_reader=reader,
                                       device="cpu")
    R = P.runner
    with pytest.raises(plint.LintError, match="TMG701"):
        runner.run(R.RunType.TRAIN, R.OpParams(custom_params={
            "plan": False}))
    # suppressed, the train goes on to the reader, which reads
    with pytest.raises(AssertionError, match="reader I/O"):
        runner.run(R.RunType.TRAIN, R.OpParams(custom_params={
            "plan": False, "lintSuppress": ["TMG701"]}))


def test_runner_fail_on_validate_and_suppress_as_the_jax_package():
    def build(ns):
        p = ns.FB.of(ns.ft.Prediction, "p").from_column().as_predictor()
        est = _AnyInput.make(ns)().set_input(p)
        return ns.Workflow().set_result_features(est.get_output())
    jwf, pwf = _both(build)
    jr = J.runner.OpWorkflowRunner(jwf)
    pr = P.runner.OpWorkflowRunner(pwf, device="cpu")
    for cp in ({}, {"validate": False}, {"validate": "false"},
               {"failOn": "warning", "lintSuppress": ["TMG106"]}):
        want = jr._preflight(J.runner.OpParams(custom_params=dict(cp)),
                             workflow=jwf)
        got = pr._preflight(P.runner.OpParams(custom_params=dict(cp)),
                            workflow=pwf)
        assert got == want
    assert got == {"findings": 0, "failOn": "warning"}
    for runner, R, wf in ((jr, J.runner, jwf), (pr, P.runner, pwf)):
        with pytest.raises((jlint.LintError, plint.LintError)):
            runner._preflight(R.OpParams(custom_params={
                "failOn": "warning"}), workflow=wf)


def test_opapp_fail_on_and_no_validate(tmp_path):
    PT.uid.reset()
    wf, *_ = _binary_flow(PT)
    reader = _CountingReader(_records())
    seen = {}

    class App(P.runner.OpApp):
        def runner(self, params):
            seen["params"] = params
            return P.runner.OpWorkflowRunner(wf, training_reader=reader,
                                             device="cpu",
                                             dtype=torch.float64)

    out = App().main(["--run-type", "Train", "--quiet", "--fail-on",
                      "warning", "--model-location",
                      str(tmp_path / "m")])
    assert seen["params"].custom_params["failOn"] == "warning"
    assert out.metrics["preflight"] == {"findings": 0, "failOn": "warning"}
    out = App().main(["--run-type", "Train", "--quiet", "--no-validate",
                      "--model-location", str(tmp_path / "m2")])
    assert out.metrics["preflight"] is None


def test_runner_score_preflights_the_loaded_model(tmp_path):
    """Score runs the graph rules and the device pass over the loaded
    model (``validateDevice: false`` skips the device pass)."""
    PT.uid.reset()
    wf, *_ = _binary_flow(PT)
    reader = _CountingReader(_records())
    R = P.runner
    runner = R.OpWorkflowRunner(wf, training_reader=reader,
                                scoring_reader=reader, device="cpu",
                                dtype=torch.float64)
    params = R.OpParams(model_location=str(tmp_path / "m"))
    runner.run(R.RunType.TRAIN, params)
    calls = []
    orig = plint.preflight_device

    def spy(model, n_rows=8, target=None):
        calls.append(target)
        return orig(model, n_rows=n_rows, target=target)
    try:
        plint.preflight_device = spy
        out = runner.run(R.RunType.SCORE, params)
        assert out.metrics["preflight"] == {"findings": 0,
                                            "failOn": "error"}
        assert calls == [torch.device("cpu")]
        params.custom_params["validateDevice"] = False
        runner.run(R.RunType.SCORE, params)
        assert len(calls) == 1
    finally:
        plint.preflight_device = orig


# ---------------------------------------------------------------------------
# the run summary
# ---------------------------------------------------------------------------


def test_summary_pretty_table_equals_the_jax_packages():
    def build(ns):
        wf, *_ = _binary_flow(ns)
        return _train(ns, wf)
    jm, pm = _both(build)
    jt, pt = jm.summary_pretty(), pm.summary_pretty()

    def table(text):
        lines = text.split("\n\n")[0].splitlines()
        rows = [[c.strip() for c in ln.strip("|").split("|")]
                for ln in lines if ln.startswith("| ")]
        rows = [r for r in rows if len(r) > 1]      # not the title row
        return rows[0], [r[:2] for r in rows[1:]], rows

    jhead, jrows, _ = table(jt)
    phead, prows, pall = table(pt)
    assert phead == jhead
    assert prows == jrows
    # this package measures no compile seconds: the column is empty
    col = phead.index("compile s")
    assert all(r[col] == "" for r in pall[1:])
    assert "Stage metrics" in pt
    doc = json.loads(pt.split("\n\n", 1)[1])
    assert "stageMetrics" not in doc and doc["uid"] == pm.uid


def test_table_renders_as_the_jax_packages():
    from transmogrifai_tpu.utils.table import Table as JTable
    from transmogrifai_tpu_torch.utils.table import Table as PTable
    rows = [["a", 1.23456789, None], ["bb", 2, "x"]]
    for name in (None, "Title"):
        assert PTable(["c1", "c2", "c3"], rows, name=name).render() \
            == JTable(["c1", "c2", "c3"], rows, name=name).render()
    with pytest.raises(ValueError):
        PTable([], [])
    with pytest.raises(ValueError):
        PTable(["a"], [[1, 2]])
