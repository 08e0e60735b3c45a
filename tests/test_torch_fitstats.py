"""The port's fused fit-statistics pass (``transmogrifai_tpu_torch/
fitstats.py``) against its own sequential fits and against the JAX
package's ``fitstats.py`` on the CPU, in f64: the host tier bitwise for
every opted-in stage (the SanityChecker's fitted state too, its summary
within 1e-9 as in ``test_torch_vectorizers.py``), one scan a layer,
deduplicated requests, warm-started stages left out, the torch device tier
against the JAX device tier (counts, minima and maxima exact, moments
within rtol 1e-12), the chunked fold against one chunk, SufficientStats'
merge and JSON, the train's states and their warm start, and a failing
device pass or opt-in raising."""
import json

import numpy as np
import pytest
import torch

import transmogrifai_tpu as J
import transmogrifai_tpu.fitstats as JF
import transmogrifai_tpu.workflow as JW
from transmogrifai_tpu.types import feature_types as JFT
import transmogrifai_tpu_torch as P
import transmogrifai_tpu_torch.fitstats as PF
import transmogrifai_tpu_torch.workflow as PW
from transmogrifai_tpu_torch.types import feature_types as PFT

N = 400
CPU = dict(device="cpu", dtype=torch.float64)
MOMENTS = ("count", "mean", "variance", "std", "min", "max")


@pytest.fixture(autouse=True)
def _host_gate(monkeypatch):
    """The JAX package's bandwidth gate held low, as its own tests hold
    it: its pass takes the host tier unless a test asks for the device."""
    monkeypatch.setattr(JW, "_DEVICE_BW_MBPS", 1.0)


def _columns(seed=42, n=N):
    rng = np.random.default_rng(seed)
    cols = {}
    for j in range(3):
        v = rng.normal(size=n) * 10 ** j + j
        cols[f"x{j}"] = ("Real", [None if rng.random() < 0.15 else float(x)
                                  for x in v])
    cols["i0"] = ("Integral", [None if rng.random() < 0.2
                               else int(rng.integers(0, 5))
                               for _ in range(n)])
    cols["b0"] = ("Binary", [None if rng.random() < 0.3
                             else bool(rng.integers(0, 2))
                             for _ in range(n)])
    cats = ["a", "b", "c", "d", None]
    cols["cat"] = ("PickList", [cats[int(rng.integers(0, 5))]
                                for _ in range(n)])
    cols["set0"] = ("MultiPickList", [set(np.random.default_rng(i).choice(
        ["u", "v", "w"], size=i % 3).tolist()) for i in range(n)])
    return cols


def _stores(cols):
    return (J.ColumnStore.from_dict(
        {k: (JFT.FEATURE_TYPE_REGISTRY[t], v) for k, (t, v) in cols.items()}),
        P.ColumnStore.from_dict(
        {k: (PFT.feature_type_by_name(t), v) for k, (t, v) in cols.items()}))


@pytest.fixture
def stores():
    return _stores(_columns())


def _feat(pkg, name, type_name="Real"):
    return getattr(pkg.FeatureBuilder, type_name)(name).from_column() \
        .as_predictor()


def _fused_fit(F, stage, store, **run_kw):
    plan = F.LayerStatsPlan(list(stage.stat_requests(store)), n_stages=1)
    return stage.fit(store, stats=plan.run(store, **run_kw))


def _state(m):
    return repr(sorted(m.get_model_state().items()))


def _stage(pkg, case):
    """(stage, its inputs' (name, type)) of one opted-in estimator."""
    mod = __import__(pkg.__name__ + ".ops.numeric", fromlist=["x"])
    oh = __import__(pkg.__name__ + ".ops.onehot", fromlist=["x"])
    sc = __import__(pkg.__name__ + ".ops.scalers", fromlist=["x"])
    return {
        "fill_mean": (pkg.dsl.FillMissingWithMean(), [("x1", "Real")]),
        "normalizer": (pkg.dsl.ScalarNormalizer(), [("x1", "Real")]),
        "std_scaler": (sc.OpScalarStandardScaler(), [("x1", "Real")]),
        "real": (mod.RealVectorizer(),
                 [("x0", "Real"), ("x1", "Real"), ("x2", "Real")]),
        "integral": (mod.IntegralVectorizer(), [("i0", "Integral")]),
        "binary": (mod.BinaryVectorizer(), [("b0", "Binary")]),
        "bucketizer": (mod.NumericBucketizer(num_buckets=4),
                       [("x2", "Real")]),
        "pivot": (oh.OneHotVectorizer(top_k=3, min_support=1),
                  [("cat", "PickList")]),
        "set_pivot": (oh.SetVectorizer(top_k=2, min_support=1),
                      [("set0", "MultiPickList")]),
    }[case]


@pytest.mark.parametrize("case", ["fill_mean", "normalizer", "std_scaler",
                                  "real", "integral", "binary",
                                  "bucketizer", "pivot", "set_pivot"])
def test_host_tier_equals_sequential_and_the_jax_package(stores, case):
    """Every opted-in stage: the port's fused fit (host tier) equals its
    sequential fit and the JAX package's fused fit, bit for bit."""
    js, ps = stores
    states = []
    for pkg, F, store in ((J, JF, js), (P, PF, ps)):
        stage, inputs = _stage(pkg, case)
        stage.set_input(*[_feat(pkg, n, t) for n, t in inputs])
        fused = _fused_fit(F, stage, store)
        if pkg is P:
            assert _state(fused) == _state(stage.fit(store))
        states.append(_state(fused))
    assert states[0] == states[1]


def test_sanity_checker_fused_equals_sequential_and_the_jax_package():
    """The SanityChecker's request runs the function its sequential fit
    runs, on the workflow's device: keep indices and summary equal to the
    sequential fit's, keep indices equal to the JAX package's fused fit
    and its statistics within 1e-9."""
    rng = np.random.default_rng(42)
    n = 300
    y = rng.integers(0, 2, n).astype(float)
    X = rng.normal(size=(n, 5)).astype(np.float32)
    X[:, 0] = y + rng.normal(size=n) * 1e-4       # leaky
    X[:, 1] = 0.0                                 # constant
    fitted = []
    for pkg in (J, P):
        sc = __import__(pkg.__name__ + ".ops.sanity_checker",
                        fromlist=["x"])
        cols = __import__(pkg.__name__ + ".columns", fromlist=["x"])
        vm = __import__(pkg.__name__ + ".vector_metadata", fromlist=["x"])
        ft = JFT if pkg is J else PFT
        meta = vm.VectorMetadata("vec", [vm.VectorColumnMetadata(
            parent_feature_name=f"f{i}", parent_feature_type="Real")
            for i in range(5)])
        store = pkg.ColumnStore({
            "label": cols.column_from_values(ft.RealNN, y),
            "vec": cols.VectorColumn(ft.OPVector, X, meta)})
        checker = sc.SanityChecker(remove_bad_features=True,
                                   remove_feature_group=False)
        checker.set_input(
            pkg.FeatureBuilder.RealNN("label").from_column().as_response(),
            pkg.FeatureBuilder.OPVector("vec").from_column().as_predictor())
        if pkg is J:
            fitted.append(_fused_fit(JF, checker, store))
            continue
        seq = checker.fit(store, **CPU)
        fused = _fused_fit(PF, checker, store, workflow_device="cpu",
                           dtype=torch.float64)
        assert fused.keep_indices == seq.keep_indices
        assert repr(fused.summary()) == repr(seq.summary())
        fitted.append(fused)
    jm, pm = fitted
    assert pm.keep_indices == jm.keep_indices == [2, 3, 4]
    for a, b in zip(jm.summary()["columnStats"],
                    pm.summary()["columnStats"]):
        for k in ("mean", "variance", "min", "max", "corrWithLabel"):
            if a[k] is None or np.isnan(a[k]):
                assert b[k] is None or np.isnan(b[k])
            else:
                assert abs(a[k] - b[k]) <= 1e-9, (a["name"], k)


def _layer_flow(pkg, store, n_fill=3, with_pivot=True):
    outs = [_feat(pkg, f"x{j}").fill_missing_with_mean()
            for j in range(n_fill)]
    if with_pivot:
        outs.append(_feat(pkg, "cat", "PickList").pivot(top_k=3,
                                                        min_support=1))
    return pkg.Workflow().set_input_store(store).set_result_features(*outs)


def _train(pkg, flow):
    return flow.train(**CPU) if pkg is P else flow.train()


def test_three_estimator_layer_scans_once(stores, monkeypatch):
    """Four opted-in estimators in one layer: no sequential fit runs, the
    pass reads each input column once (``bytes_scanned``), as the JAX
    package's pass does, and saves three passes."""
    js, ps = stores

    def boom(self, store, **kw):
        raise AssertionError("a sequential fit ran in a fused layer")
    tallies = []
    for pkg, F, store in ((J, JF, js), (P, PF, ps)):
        monkeypatch.setattr(pkg.dsl.FillMissingWithMean, "fit_columns", boom)
        oh = __import__(pkg.__name__ + ".ops.onehot", fromlist=["x"])
        monkeypatch.setattr(oh.OneHotVectorizer, "fit_columns", boom)
        F.reset_fitstats_stats()
        model = _train(pkg, _layer_flow(pkg, store))
        assert len(model.fitted_stages) == 4
        tallies.append(F.fitstats_stats())
    expected = sum(ps[f"x{j}"].values.nbytes + ps[f"x{j}"].mask.nbytes
                   for j in range(3)) + ps["cat"].values.nbytes
    for t in tallies:
        assert (t["layers_fused"], t["passes_saved"], t["bytes_scanned"],
                t["host_passes"], t["device_passes"]) == (1, 3, expected,
                                                          1, 0)


def test_fused_layer_records_its_pass(stores):
    """Each fused stage says so in its metrics, with the pass's tier,
    stages, requests and bytes; its fit equals the sequential one."""
    _js, ps = stores
    model = _train(P, _layer_flow(P, ps))
    PF.FITSTATS_ENABLED = False
    try:
        seq = _train(P, _layer_flow(P, ps))
    finally:
        PF.FITSTATS_ENABLED = True
    fused = [m for m in model.stage_metrics.values() if m.get("fusedStats")]
    assert len(fused) == 4
    info = fused[0]["statsPass"]
    assert (info["tier"], info["stages"], info["requests"]) == ("host", 4, 4)
    assert sorted(map(_state, model.fitted_stages.values())) == \
        sorted(map(_state, seq.fitted_stages.values()))


def test_single_opt_in_stays_sequential(stores):
    """One opted-in estimator saves no pass: no plan runs, but its moment
    state is still recorded."""
    _js, ps = stores
    PF.reset_fitstats_stats()
    model = _train(P, _layer_flow(P, ps, n_fill=1, with_pivot=False))
    assert PF.fitstats_stats()["layers_fused"] == 0
    assert list(model.fit_stats) == ["0:x0"]
    assert model.fit_stats["0:x0"] == PF.collect_column_state(ps["x0"])


def test_layer_without_opt_ins_fits_sequentially(stores):
    _js, ps = stores
    PF.reset_fitstats_stats()
    from transmogrifai_tpu_torch.ops.smart_text import SmartTextVectorizer
    st = SmartTextVectorizer()
    st.set_input(_feat(P, "cat", "PickList"))
    model = _train(P, P.Workflow().set_input_store(ps)
                   .set_result_features(st.get_output()))
    assert PF.fitstats_stats()["layers_fused"] == 0
    assert len(model.fitted_stages) == 1 and not model.fit_stats


def test_disabled_flag_gives_the_sequential_fit(stores, monkeypatch):
    _js, ps = stores
    monkeypatch.setattr(PF, "FITSTATS_ENABLED", False)
    PF.reset_fitstats_stats()
    model = _train(P, _layer_flow(P, ps))
    assert PF.fitstats_stats()["layers_fused"] == 0
    assert not any(m.get("fusedStats") for m in model.stage_metrics.values())
    assert len(model.fitted_stages) == 4


def test_shared_requests_are_deduplicated(stores):
    """Two pivots over one column share one count; each cuts its own top
    K, as the JAX package's do."""
    vocabs = []
    for pkg, F, store in ((J, JF, stores[0]), (P, PF, stores[1])):
        oh = __import__(pkg.__name__ + ".ops.onehot", fromlist=["x"])
        a = oh.OneHotVectorizer(top_k=2, min_support=1)
        a.set_input(_feat(pkg, "cat", "PickList"))
        b = oh.OneHotVectorizer(top_k=4, min_support=1)
        b.set_input(_feat(pkg, "cat", "PickList"))
        plan = F.LayerStatsPlan(list(a.stat_requests(store))
                                + list(b.stat_requests(store)), n_stages=2)
        assert plan.n_requests == 1
        stats = plan.run(store)
        ma, mb = a.fit(store, stats=stats), b.fit(store, stats=stats)
        assert ma.vocabs != mb.vocabs
        assert _state(ma) == _state(a.fit(store))
        assert _state(mb) == _state(b.fit(store))
        vocabs.append((ma.vocabs, mb.vocabs))
    assert vocabs[0] == vocabs[1]


def test_warm_started_stages_are_left_out(stores):
    """A layer of three fills where two are warm-started leaves one opt-in:
    below the threshold, sequential; the models equal the first train's."""
    _js, ps = stores
    model = _train(P, _layer_flow(P, ps, with_pivot=False))
    PF.reset_fitstats_stats()
    flow = _layer_flow(P, ps, with_pivot=False)
    flow.result_features = model.result_features
    warm = dict(list(model.fitted_stages.items())[:2])
    flow._warm_stages = warm
    model2 = _train(P, flow)
    assert PF.fitstats_stats()["layers_fused"] == 0
    for uid, m in model.fitted_stages.items():
        assert _state(m) == _state(model2.fitted_stages[uid])


def _moment_plan(F, names):
    return F.LayerStatsPlan(
        [F.StatRequest(k, nm) for nm in names for k in MOMENTS]
        + [F.StatRequest("std", nm, params=(1,)) for nm in names],
        n_stages=len(names))


def _hold(reqs, a, b, rtol):
    for r in reqs:
        x, y = a.for_request(r), b.for_request(r)
        if r.kind in ("count", "min", "max"):
            assert x == y, (r, x, y)
        else:
            assert x == pytest.approx(y, rel=rtol, abs=0), (r, x, y)


def test_device_tier_matches_the_jax_device_tier(stores):
    """The torch fold on the CPU in f64 against the JAX package's jitted
    fold under x64, and against the port's host tier: counts, minima and
    maxima exact, the moments within rtol 1e-12; the states alike."""
    js, ps = stores
    names = ["x0", "x1", "x2", "i0"]
    jplan, pplan = _moment_plan(JF, names), _moment_plan(PF, names)
    jstate, pstate = {}, {}
    jdev = jplan.run(js, device=True, mesh=False, state_out=jstate)
    pdev = pplan.run(ps, device=True, state_out=pstate,
                     workflow_device="cpu", dtype=torch.float64)
    assert pplan.tier == "device"
    _hold(pplan.requests, jdev, pdev, 1e-12)
    _hold(pplan.requests, pplan.run(ps, device=False), pdev, 1e-12)
    for nm in names:
        a, b = jstate[nm], pstate[nm]
        assert (a.count, a.min, a.max) == (b.count, b.min, b.max)
        np.testing.assert_allclose([b.mean, b.m2], [a.mean, a.m2],
                                   rtol=1e-12)


def test_chunked_fold_equals_one_chunk(stores, monkeypatch):
    """Chan's merge across chunks of 128 rows against one chunk."""
    _js, ps = stores
    plan = _moment_plan(PF, ["x0", "x1", "x2"])
    kw = dict(device=True, workflow_device="cpu", dtype=torch.float64)
    one = plan.run(ps, **kw)
    monkeypatch.setattr(PF, "_chunk_rows", lambda n: 128)
    chunked = plan.run(ps, **kw)
    _hold(plan.requests, one, chunked, 1e-12)


def test_gate_takes_the_device_tier_only_on_the_card(stores, monkeypatch):
    """``run()`` with no tier given: the host tier on the CPU at any size,
    and below ``FUSE_MIN_ROWS`` on any device."""
    _js, ps = stores
    plan = _moment_plan(PF, ["x0"])
    monkeypatch.setattr(PW, "FUSE_MIN_ROWS", 1)
    plan.run(ps, workflow_device="cpu")
    assert plan.tier == "host"
    assert plan._gate_device(ps, "cuda") and plan._gate_device(ps, None)
    monkeypatch.setattr(PW, "FUSE_MIN_ROWS", N + 1)
    assert not plan._gate_device(ps, "cuda")


def test_sufficient_stats_merge_and_json_equal_the_jax_packages(stores):
    js, ps = stores
    for nm in ("x0", "x1", "x2", "i0", "b0"):
        a = JF.collect_column_state(js[nm])
        b = PF.collect_column_state(ps[nm])
        assert a.to_json() == b.to_json()
    ja = [JF.collect_column_state(js[f"x{j}"]) for j in range(3)]
    pa = [PF.collect_column_state(ps[f"x{j}"]) for j in range(3)]
    jm = ja[0].merge(ja[1]).merge(ja[2]).merge(JF.SufficientStats())
    pm = pa[0].merge(pa[1]).merge(pa[2]).merge(PF.SufficientStats())
    assert jm.to_json() == pm.to_json()
    assert PF.SufficientStats().merge(PF.SufficientStats()) == \
        PF.SufficientStats()
    doc = {"0:x0": pm, "1:e": PF.SufficientStats()}
    text = json.dumps(PF.sufficient_stats_to_json(doc))
    assert text == json.dumps(JF.sufficient_stats_to_json(
        {"0:x0": jm, "1:e": JF.SufficientStats()}))
    back = PF.sufficient_stats_from_json(json.loads(text))
    assert back == doc
    assert {k: v.to_json() for k, v in JF.sufficient_stats_from_json(
        json.loads(text)).items()} == {k: v.to_json()
                                       for k, v in back.items()}
    for kind in MOMENTS:
        assert pm.finalize(kind) == jm.finalize(kind)
    assert pm.finalize("std", (1,)) == jm.finalize("std", (1,))


@pytest.mark.parametrize("n_fill,with_pivot,keys", [
    (3, True, ["0:x0", "0:x1", "0:x2"]), (1, False, ["0:x0"])])
def test_train_states_equal_the_jax_packages(stores, n_fill, with_pivot,
                                             keys):
    """The train's ``"<layer>:<column>"`` states, of a fused layer and of a
    single opt-in's, equal the JAX package's."""
    jst, pst = [_train(pkg, _layer_flow(pkg, store, n_fill, with_pivot))
                .fit_stats for pkg, store in zip((J, P), stores)]
    assert sorted(pst) == sorted(jst) == keys
    for k in keys:
        assert pst[k].to_json() == jst[k].to_json()


def test_warm_fit_stats_merge_the_old_window(monkeypatch):
    """A train warm-started from the first half's states fits its fills
    over both halves while it scans the second, as the JAX package's."""
    cols = _columns(seed=3, n=2 * N)
    first = {k: (t, v[:N]) for k, (t, v) in cols.items()}
    second = {k: (t, v[N:]) for k, (t, v) in cols.items()}
    fills = []
    for pkg in (J, P):
        js1, ps1 = _stores(first)
        js2, ps2 = _stores(second)
        s1, s2 = (js1, js2) if pkg is J else (ps1, ps2)
        old = _train(pkg, _layer_flow(pkg, s1, with_pivot=False))
        flow = _layer_flow(pkg, s2, with_pivot=False)
        flow.result_features = old.result_features
        warm = _train(pkg, flow.with_warm_fit_stats(old.fit_stats))
        fills.append(sorted(m.mean for m in warm.fitted_stages.values()))
    _js, whole = _stores(cols)
    want = sorted(float(whole[f"x{j}"].values[whole[f"x{j}"].mask].mean())
                  for j in range(3))
    assert fills[1] == pytest.approx(want, rel=1e-12)
    assert fills[1] == pytest.approx(fills[0], rel=1e-13)


def test_failing_device_pass_raises(stores, monkeypatch):
    """The device tier has no host fallback: its failure reaches the
    caller."""
    _js, ps = stores

    def broken(v, b):
        raise RuntimeError("device fold failed")
    monkeypatch.setattr(PF, "_moment_step", broken)
    with pytest.raises(RuntimeError, match="device fold failed"):
        _moment_plan(PF, ["x0"]).run(ps, device=True,
                                     workflow_device="cpu")


def test_failing_opt_in_raises(stores, monkeypatch):
    _js, ps = stores

    def broken(self, store):
        raise ValueError("stat_requests failed")
    monkeypatch.setattr(P.dsl.FillMissingWithMean, "stat_requests", broken)
    with pytest.raises(ValueError, match="stat_requests failed"):
        _train(P, _layer_flow(P, ps))


def test_a_value_the_plan_did_not_compute_raises(stores):
    plan = PF.LayerStatsPlan([PF.StatRequest("mean", "x0")])
    stats = plan.run(stores[1])
    with pytest.raises(KeyError, match="not computed"):
        stats.value("mean", "x1")


@pytest.mark.cuda
def test_device_tier_on_the_card_against_the_host_tier():
    """The card's f32 fold at 200,000 rows against the host tier: counts
    exact, minima and maxima those of the f32-rounded values, the moments
    within rtol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the device tier runs on the card")
    _js, ps = _stores(_columns(seed=5, n=200_000))
    plan = _moment_plan(PF, ["x0", "x1", "x2", "i0"])
    host = plan.run(ps, device=False)
    card = plan.run(ps, workflow_device="cuda")
    assert plan.tier == "device"
    for r in plan.requests:
        a, b = host.for_request(r), card.for_request(r)
        if r.kind in ("min", "max"):
            # f32 rounding is monotonic: the extreme of the rounded values
            # is the rounded extreme
            assert b == float(np.float32(a)), (r, a, b)
        elif r.kind == "count":
            assert a == b
        else:
            assert b == pytest.approx(a, rel=1e-5), (r, a, b)
