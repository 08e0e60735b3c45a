"""Persistence of the PyTorch port (``transmogrifai_tpu_torch/model_io.py``)
held against the JAX package's format: the golden model, models saved by
either package loaded by the other, the config codec, checkpoints, warm
starts and the row-level scorer. Everything runs on the CPU in f64 (the
JAX package with x64 on, the port with ``dtype=torch.float64``) from the
same numpy-seeded records, with both uid counters reset."""
import json
import os

import numpy as np
import pytest
import torch

from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import model_io as jio
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JS
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch import model_io as pio
from transmogrifai_tpu_torch.dsl import transmogrify as ptransmogrify
from transmogrifai_tpu_torch.models import linear as PL
from transmogrifai_tpu_torch.models import trees as PTR
from transmogrifai_tpu_torch.models.selector import \
    BinaryClassificationModelSelector as PS
from transmogrifai_tpu_torch.models.tuning import DataBalancer
from transmogrifai_tpu_torch.utils import uid as puid

GOLDEN = os.path.join(os.path.dirname(__file__), "resources",
                      "golden_model_v1")
F64 = dict(device="cpu", dtype=torch.float64)


def _records(n=160, seed=3):
    rng = np.random.default_rng(seed)
    age = rng.normal(40, 10, size=n)
    cls = rng.integers(1, 4, size=n)
    sex = rng.choice(["m", "f"], size=n)
    y = ((sex == "f") | (rng.random(n) < 0.2)).astype(float)
    return [{"age": None if rng.random() < 0.2 else float(age[i]),
             "cls": int(cls[i]), "sex": str(sex[i]), "y": float(y[i])}
            for i in range(n)]


def _dag(FB, transmogrify, selector_cls, family):
    y = FB.RealNN("y").from_column().as_response()
    age = FB.Real("age").from_column().as_predictor()
    cls = FB.Integral("cls").from_column().as_predictor()
    sex = FB.PickList("sex").from_column().as_predictor()
    vec = transmogrify([age, cls, sex])
    sel = selector_cls.with_cross_validation(num_folds=2, families=[family],
                                             splitter=None, seed=5)
    return y.transform_with(sel, vec), sel, vec


def _lr(L):
    return L.LogisticRegressionFamily(
        grid=[{"regParam": 0.01, "elasticNetParam": 0.1}])


def _gbt(T):
    return T.GBTFamily(grid=[{"maxDepth": 3, "minInstancesPerNode": 5,
                              "minInfoGain": 0.0}])


def _rf(T):
    return T.RandomForestFamily(grid=[{"maxDepth": 4,
                                       "minInstancesPerNode": 5,
                                       "minInfoGain": 0.0}], num_trees=5)


WINNERS = {"lr": (_lr, JL, PL), "gbt": (_gbt, JTR, PTR),
           "rf": (_rf, JTR, PTR)}


def _jax_model(kind, records):
    make, jmod, _ = WINNERS[kind]
    juid.reset()
    pred, _sel, _vec = _dag(JFB, jtransmogrify, JS, make(jmod))
    model = JWorkflow().set_input_records(records).set_result_features(
        pred).train()
    return model, pred


def _port_model(kind, records):
    make, _, pmod = WINNERS[kind]
    puid.reset()
    pred, _sel, _vec = _dag(PFB, ptransmogrify, PS, make(pmod))
    model = PWorkflow().set_input_records(records).set_result_features(
        pred).train(**F64)
    return model, pred


def _same_scores(got, want):
    """Predictions equal; raw margins and probabilities within 1e-12 (f64).
    Not bitwise for the trees: the JAX package sums the leaves in chunks
    of 16 trees under XLA, the port in tree order, which moves a GBT
    margin by an ulp."""
    np.testing.assert_array_equal(got.prediction, want.prediction)
    for k in ("raw_prediction", "probability"):
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=1e-12)


def test_golden_model_loads_and_reproduces_expected():
    """The checked-in format-1 model (bare weights.npz): predictions
    exact, probability[:, 1] within rtol 1e-6 (the JAX package's own
    bound, tests/test_workflow_io.py)."""
    expected = json.load(open(os.path.join(GOLDEN, "expected.json")))
    model = PWorkflowModel.load(GOLDEN)
    for engine in (False, True):
        pcol = model.score(expected["rows"], device="cpu",
                           engine=engine)[expected["pred_name"]]
        np.testing.assert_array_equal(pcol.prediction,
                                      expected["expected_pred"])
        np.testing.assert_allclose(pcol.probability[:, 1],
                                   expected["expected_prob1"], rtol=1e-6)
    assert model.uid == "WorkflowModel_000000000014"


@pytest.mark.parametrize("kind", sorted(WINNERS))
def test_jax_saved_model_loads_in_port(kind, tmp_path):
    """A workflow the JAX package trained (LR, GBT or RF winner) and saved
    scores the same in the port (``_same_scores``)."""
    records = _records()
    jm, jpred = _jax_model(kind, records)
    path = str(tmp_path / "m")
    jm.save(path)
    pm = PWorkflowModel.load(path)
    assert pm.uid == jm.uid
    got = pm.score(records, device="cpu")[jpred.name]
    _same_scores(got, jm.score(records)[jpred.name])


@pytest.mark.parametrize("kind", sorted(WINNERS))
def test_port_saved_model_loads_in_jax(kind, tmp_path):
    """The reverse: a model the port trained and saved loads in the JAX
    package's ``WorkflowModel.load`` and scores the same there."""
    records = _records(seed=11)
    pm, ppred = _port_model(kind, records)
    path = str(tmp_path / "m")
    pm.save(path)
    jm = JWorkflowModel.load(path)
    got = jm.score(records)[ppred.name]
    _same_scores(got, pm.score(records, device="cpu")[ppred.name])


def test_saved_files_name_only_the_jax_package(tmp_path):
    """model.json never names a module of the port: stage records carry
    class names, and a checkpoint's unfitted selector carries its
    families, splitter and validator as the JAX package's modules."""
    records = _records()
    puid.reset()
    pred, sel, _vec = _dag(PFB, ptransmogrify, PS, _gbt(PTR))
    sel.set_params(splitter=DataBalancer(seed=3))
    arrays = {}
    recs = pio.collect_stage_records(pio._topo_features([pred]), arrays)
    text = json.dumps(recs)
    assert "transmogrifai_tpu_torch" not in text
    objs = [r["params"] for r in recs if r["className"] == "ModelSelector"]
    assert objs[0]["families"][0]["__obj__"] == \
        "transmogrifai_tpu.models.trees:GBTFamily"
    assert objs[0]["splitter"]["__obj__"] == \
        "transmogrifai_tpu.models.tuning:DataBalancer"
    assert objs[0]["validator"]["__obj__"] == \
        "transmogrifai_tpu.models.tuning:CrossValidation"
    pm, _ = _port_model("lr", records)
    pm.save(str(tmp_path / "m"))
    assert "transmogrifai_tpu_torch" not in open(
        tmp_path / "m" / "model.json").read()


def test_obj_codec_round_trip_and_allowlist():
    """Config objects round-trip through the JAX package's module names
    in both packages; a module outside the JAX package is refused before
    any import, and a class that is not a config base is not built."""
    fam = PTR.GBTFamily(grid=[{"maxDepth": 2}], max_iter=7)
    arrays = {}
    enc = pio._encode_param(fam, arrays, "t")
    back = pio._decode_param(enc, arrays)
    assert type(back) is PTR.GBTFamily
    assert back.grid == fam.grid and back.max_iter == 7
    jback = jio._decode_param(enc, arrays)          # the JAX package reads it
    assert type(jback).__module__ == "transmogrifai_tpu.models.trees"
    assert jback.grid == fam.grid
    jenc = jio._encode_param(JL.LogisticRegressionFamily(
        grid=[{"regParam": 0.5}]), arrays, "j")
    assert type(pio._decode_param(jenc, arrays)) is \
        PL.LogisticRegressionFamily
    with pytest.raises(ValueError, match="Refusing to import"):
        pio._decode_param({"__obj__": "os:system", "params": {}}, {})
    with pytest.raises(ValueError, match="Refusing to import"):
        pio._decode_param({"__obj__": "transmogrifai_tpu_torch.model_io:"
                           "save_workflow_model", "params": {}}, {})
    with pytest.raises(ValueError, match="Refusing to instantiate"):
        pio._decode_param({"__obj__": "transmogrifai_tpu.model_io:"
                           "save_workflow_model", "params": {}}, {})


def test_overwrite_protection(tmp_path):
    pm, pred = _port_model("lr", _records())
    path = str(tmp_path / "m")
    pm.save(path)
    with pytest.raises(FileExistsError):
        pm.save(path)
    pm.save(path, overwrite=True)
    files = os.listdir(path)
    assert "model.json" in files and not any(f.endswith(".pending")
                                             for f in files)
    doc = json.load(open(os.path.join(path, "model.json")))
    assert doc["formatVersion"] == 2 and doc["weightsFile"] in files
    assert {"version", "torch"} <= set(doc["versionInfo"])


def test_checkpoint_and_resume_after_crash(tmp_path):
    """A crash in the selector's fit leaves the vectorizer layer in the
    checkpoint; ``fit(resume_from=)`` warm-starts from it and refits only
    the selector, scoring as an uninterrupted train does."""
    records = _records()
    pm, _ = _port_model("lr", records)
    puid.reset()
    pred, sel, _vec = _dag(PFB, ptransmogrify, PS, _lr(PL))
    ckpt = str(tmp_path / "ckpt")
    orig = sel.fit_columns
    calls = {"n": 0}

    def crashing(store, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("simulated preemption")
        return orig(store, **kw)

    sel.fit_columns = crashing
    wf = (PWorkflow().set_input_records(records).set_result_features(pred)
          .with_checkpointing(ckpt))
    with pytest.raises(RuntimeError, match="preemption"):
        wf.train(**F64)
    partial = PWorkflowModel.load(ckpt)
    assert partial.fitted_stages and sel.uid not in partial.fitted_stages
    model = (PWorkflow().set_input_records(records)
             .set_result_features(pred).fit(resume_from=ckpt, **F64))
    warm = {u for u, m in model.stage_metrics.items()
            if m.get("warmStarted")}
    assert warm == set(partial.fitted_stages)
    assert model.stage_metrics[sel.uid]["fitSeconds"] > 0
    np.testing.assert_array_equal(
        model.score(records, device="cpu")[pred.name].probability,
        pm.score(records, device="cpu")[pred.name].probability)
    # the completed fit checkpointed the selector's layer too
    assert sel.uid in PWorkflowModel.load(ckpt).fitted_stages


def test_checkpoint_swap_recovers_either_sibling(tmp_path):
    """A crash between the checkpoint swap's renames leaves the save at
    <dir>.tmp or only <dir>.old; load recovers it and renames it back."""
    pm, pred = _port_model("lr", _records())
    ckpt = str(tmp_path / "ck")
    for sibling in (".tmp", ".old"):
        pio._atomic_checkpoint(pm, ckpt)
        os.rename(ckpt, ckpt + sibling)
        loaded = PWorkflowModel.load(ckpt)
        assert os.path.exists(os.path.join(ckpt, "model.json"))
        assert set(loaded.fitted_stages) == set(pm.fitted_stages)


def test_warm_start_skips_the_refit():
    """``with_model_stages``: every estimator warm-starts (fitSeconds 0),
    the scores are the donor's, and the donor's stages are untouched."""
    records = _records()
    donor, pred = _port_model("gbt", records)
    before = {u: (m.input_features, m._output_feature)
              for u, m in donor.fitted_stages.items()}
    model = (PWorkflow().set_result_features(pred)
             .set_input_records(records).with_model_stages(donor)
             .train(**F64))
    est = [u for u in donor.fitted_stages]
    for u in est:
        assert model.stage_metrics[u]["warmStarted"] is True
        assert model.stage_metrics[u]["fitSeconds"] == 0.0
    np.testing.assert_array_equal(
        model.score(records, device="cpu")[pred.name].probability,
        donor.score(records, device="cpu")[pred.name].probability)
    assert before == {u: (m.input_features, m._output_feature)
                      for u, m in donor.fitted_stages.items()}


@pytest.mark.parametrize("kind", ["lr", "rf"])
def test_score_fn_agrees_with_batch_scores(kind, tmp_path):
    """The row-level closure of a loaded model gives each row's batch
    score: prediction equal, probabilities within 1e-12."""
    records = _records(n=60)
    pm, pred = _port_model(kind, records)
    pm.save(str(tmp_path / "m"))
    loaded = PWorkflowModel.load(str(tmp_path / "m"))
    batch = pm.score(records, device="cpu")[pred.name]
    fn = loaded.score_fn(device="cpu")
    for i in range(0, 60, 7):
        raw = {k: v for k, v in records[i].items() if k != "y"}
        out = fn(raw)[pred.name]
        assert out["prediction"] == batch.prediction[i]
        assert abs(out["probability_1"] - batch.probability[i, 1]) < 1e-12


def test_summary_and_stage_metrics():
    records = _records(n=80)
    pm, pred = _port_model("lr", records)
    s = pm.summary()
    assert {"uid", "trainTimeSeconds", "stageMetrics", "stages"} <= set(s)
    sel_uid = pred.origin_stage.uid
    assert s["stages"][sel_uid]["model"] == "SelectedModel"
    assert "fitSeconds" in s["stageMetrics"][sel_uid]


def _fit_stats_json(states):
    return {k: v.to_json() for k, v in sorted(states.items())}


def test_jax_saved_fit_stats_load_as_sufficient_stats(tmp_path):
    """A JAX-package save's ``fitSufficientStats`` loads into the port's
    ``SufficientStats``, equal to the JAX package's own reading of it."""
    from transmogrifai_tpu import fitstats as JF
    from transmogrifai_tpu_torch import fitstats as PF
    jm, _pred = _jax_model("lr", _records())
    path = str(tmp_path / "m")
    jm.save(path)
    want = _fit_stats_json(JF.load_sufficient_stats(path))
    assert want and all(k.startswith("0:") for k in want)
    pm = PWorkflowModel.load(path)
    assert all(isinstance(v, PF.SufficientStats)
               for v in pm.fit_stats.values())
    assert _fit_stats_json(pm.fit_stats) == want
    assert _fit_stats_json(PF.load_sufficient_stats(path)) == want


def test_port_saved_fit_stats_read_back_in_the_jax_package(tmp_path):
    """The port's train states, saved, read back in the JAX package equal
    (its ``load_sufficient_stats`` and its loaded model's states), and
    equal the JAX package's own train's states."""
    from transmogrifai_tpu import fitstats as JF
    records = _records(seed=11)
    pm, _pred = _port_model("lr", records)
    jm, _ = _jax_model("lr", records)
    got = _fit_stats_json(pm.fit_stats)
    assert got == _fit_stats_json(jm.fit_stats)
    path = str(tmp_path / "m")
    pm.save(path)
    assert _fit_stats_json(JF.load_sufficient_stats(path)) == got
    assert _fit_stats_json(JWorkflowModel.load(path).fit_stats) == got
    assert _fit_stats_json(PWorkflowModel.load(path).fit_stats) == got


def test_golden_model_without_fit_stats_round_trips(tmp_path):
    """The golden model holds no sufficient statistics: it loads with
    none, saves none, and its save still scores as it does."""
    expected = json.load(open(os.path.join(GOLDEN, "expected.json")))
    model = PWorkflowModel.load(GOLDEN)
    assert model.fit_stats == {}
    path = str(tmp_path / "m")
    model.save(path)
    with open(os.path.join(path, pio.MODEL_JSON)) as fh:
        assert json.load(fh)["fitSufficientStats"] is None
    pcol = PWorkflowModel.load(path).score(
        expected["rows"], device="cpu")[expected["pred_name"]]
    np.testing.assert_array_equal(pcol.prediction, expected["expected_pred"])
