"""Calibrators and collection lifts in the port against the JAX package
on the CPU.

Tolerances: exact — the percentile splits and scores, PAVA's boundaries
and values, the isotonic transform, every lifted map / list / set value;
the wiring-time type errors raise alike; saves load both ways and carried
states transform alike (exact)."""
import numpy as np
import pytest

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.ops import calibrators as JC
from transmogrifai_tpu.ops import collections as JL
from transmogrifai_tpu.ops.scalers import ScalerTransformer as JScaler
from transmogrifai_tpu.ops.text_suite import EmailParser as JEmail
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch.carry_over import fitted_stage_from_state
from transmogrifai_tpu_torch.columns import ColumnStore as PStore
from transmogrifai_tpu_torch.ops import calibrators as PC
from transmogrifai_tpu_torch.ops import collections as PL
from transmogrifai_tpu_torch.ops.scalers import ScalerTransformer as PScaler
from transmogrifai_tpu_torch.ops.text_suite import EmailParser as PEmail
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import uid as puid

PKG = {"j": (JFB, JWorkflow, JStore, JFT, juid, JC, JL, JScaler, JEmail),
       "p": (PFB, PWorkflow, PStore, PFT, puid, PC, PL, PScaler, PEmail)}


def _data(n=400, seed=0):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=n)
    y = (s + rng.normal(size=n) > 0).astype(float)
    return {
        "y": ("RealNN", y.tolist()),
        "s": ("Real", [None if i % 13 == 0 else float(np.round(s[i], 1))
                       for i in range(n)]),
        "m": ("RealMap", [{k: float(rng.poisson(3)) for k in ("a", "b", "c")
                           if rng.random() < 0.7} for _ in range(n)]),
        "l": ("TextList", [[f"u{j}@d{rng.integers(0, 4)}.com"
                            for j in range(rng.integers(0, 3))]
                           + (["not-an-email"] if i % 7 == 0 else [])
                           for i in range(n)]),
        "ms": ("MultiPickList", [{f"v{j}@e{j % 2}.org"
                                  for j in range(rng.integers(0, 3))}
                                 for _ in range(n)]),
    }


def _pipeline(key, data, train=True):
    FB, W, Store, FT, uid, C, L, Scaler, Email = PKG[key]
    uid.reset()
    store = Store.from_dict({k: (getattr(FT, t), v)
                             for k, (t, v) in data.items()})
    y = FB.RealNN("y").from_column().as_response()
    s = FB.Real("s").from_column().as_predictor()
    m = FB.RealMap("m").from_column().as_predictor()
    lst = FB.TextList("l").from_column().as_predictor()
    ms = FB.MultiPickList("ms").from_column().as_predictor()
    feats = [s.to_percentile(), s.transform_with(
                 C.PercentileCalibrator(num_buckets=7)),
             s.to_isotonic_calibrated(y),
             s.to_isotonic_calibrated(y, isotonic=False),
             m.transform_with(L.OPMapTransformer(Scaler(slope=2.0,
                                                        intercept=1.0))),
             lst.transform_with(L.OPListTransformer(Email(part="domain"))),
             ms.transform_with(L.OPSetTransformer(Email(part="domain")))]
    model = W().set_input_store(store).set_result_features(*feats).train(
        **({"device": "cpu"} if key == "p" else {}))
    out = model.transform(store, **({"device": "cpu", "engine": False}
                                    if key == "p" else {}))
    return model, store, feats, [out[f.name] for f in feats]


def _values(col):
    return [col.get_raw(i) for i in range(len(col))]


def test_calibrators_and_lifts_exact():
    data = _data()
    jm, _, jf, jcols = _pipeline("j", data)
    pm, _, pf, pcols = _pipeline("p", data)
    for a, b in zip(pcols, jcols):
        assert _values(a) == _values(b)
    for f_j, f_p in zip(jf[:4], pf[:4]):
        js = jm.fitted_stages[f_j.origin_stage.uid].get_model_state()
        ps = pm.fitted_stages[f_p.origin_stage.uid].get_model_state()
        for k in js:
            np.testing.assert_array_equal(np.asarray(ps[k]),
                                          np.asarray(js[k]))


def test_pava_exact():
    rng = np.random.default_rng(3)
    for n in (1, 2, 50, 400):
        s = np.round(rng.normal(size=n), 1)
        y = (rng.random(n) < 0.5).astype(float)
        w = rng.random(n) + 0.1
        for a, b in zip(PC.pava(s, y, w), JC.pava(s, y, w)):
            np.testing.assert_array_equal(a, b)


def test_lift_type_errors_alike():
    for key in ("j", "p"):
        FB, *_, C, L, Scaler, Email = PKG[key]
        lf = FB.TextList("l").from_column().as_predictor()
        with pytest.raises(TypeError, match="not convertible"):
            lf.transform_with(L.OPListTransformer(Scaler()))
        with pytest.raises(TypeError, match="not convertible"):
            L.lift_to_collection(Scaler(), PKG[key][3].TextMap)
        assert isinstance(L.lift_to_collection(Scaler(), PKG[key][3].RealMap),
                          L.OPMapTransformer)
        assert L.map_type_for(PKG[key][3].Real) is PKG[key][3].RealMap


def test_saves_both_ways_and_carry_over(tmp_path):
    data = _data(seed=5)
    jm, jstore, jf, jcols = _pipeline("j", data)
    pm, pstore, pf, pcols = _pipeline("p", data)
    jm.save(str(tmp_path / "j"))
    got = PWorkflowModel.load(str(tmp_path / "j")).transform(
        pstore, device="cpu", engine=False)
    for f, want in zip(jf, jcols):
        assert _values(got[f.name]) == _values(want)
    pm.save(str(tmp_path / "p"))
    back = JWorkflowModel.load(str(tmp_path / "p")).transform(jstore)
    for f, want in zip(pf, pcols):
        assert _values(back[f.name]) == _values(want)
    for f_j, f_p, want in zip(jf[:4], pf[:4], jcols):
        st = jm.fitted_stages[f_j.origin_stage.uid]
        stage = fitted_stage_from_state(type(st).__name__,
                                        st.get_model_state(),
                                        st.get_params())
        stage.input_features = pm.fitted_stages[
            f_p.origin_stage.uid].input_features
        assert _values(stage.transform_columns(pstore)) == _values(want)
