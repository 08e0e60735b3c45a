"""The workflows the serving and program-bank tests share: numpy-seeded
records through transmogrify → SanityChecker → a one-point selector (LR
or GBT), trained by the JAX package (x64), saved, and loaded into the
port, so both packages hold one model with the same uids."""
import numpy as np

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.models import linear as JL
from transmogrifai_tpu.models import trees as JTR
from transmogrifai_tpu.models.selector import \
    BinaryClassificationModelSelector as JS
from transmogrifai_tpu.ops.sanity_checker import SanityChecker as JSC
from transmogrifai_tpu.ops.transmogrifier import transmogrify as jtransmogrify
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel

#: the scoring engines' bucket cap in these tests: ladder 8, 16, 32, 64
BUCKET_CAP = 64


def records(n=160, seed=3):
    """Rows of a numeric, an integral with gaps, a pick list and a label
    that leans on all three."""
    rng = np.random.default_rng(seed)
    age = rng.normal(40, 10, size=n)
    cls = rng.integers(1, 4, size=n)
    sex = rng.choice(["m", "f"], size=n)
    y = ((sex == "f") | (rng.random(n) < 0.2)
         | (age > 55)).astype(float)
    return [{"age": None if rng.random() < 0.2 else float(age[i]),
             "cls": int(cls[i]), "sex": str(sex[i]), "y": float(y[i])}
            for i in range(n)]


def _family(kind):
    if kind == "lr":
        return JL.LogisticRegressionFamily(
            grid=[{"regParam": 0.01, "elasticNetParam": 0.1}])
    return JTR.GBTFamily(grid=[{"maxDepth": 3, "minInstancesPerNode": 5,
                                "minInfoGain": 0.0}])


def jax_model(kind, rows, seed=5):
    """``kind`` ("lr" or "gbt") trained by the JAX package: (model, the
    prediction feature's name)."""
    juid.reset()
    y = JFB.RealNN("y").from_column().as_response()
    age = JFB.Real("age").from_column().as_predictor()
    cls = JFB.Integral("cls").from_column().as_predictor()
    sex = JFB.PickList("sex").from_column().as_predictor()
    vec = jtransmogrify([age, cls, sex])
    checker = JSC(remove_bad_features=True, remove_feature_group=False)
    y.transform_with(checker, vec)
    sel = JS.with_cross_validation(num_folds=2, families=[_family(kind)],
                                   splitter=None, seed=seed)
    pred = y.transform_with(sel, checker.get_output())
    model = JWorkflow().set_input_records(rows).set_result_features(
        pred).train()
    return model, pred.name


def trained(kind, path, n=160, seed=3):
    """(JAX model, the port's load of its save at ``path``, records,
    prediction name)."""
    rows = records(n, seed)
    jm, name = jax_model(kind, rows, seed=seed + 2)
    jm.save(path)
    return jm, PWorkflowModel.load(path), rows, name


def flat_blocks(eng, rows):
    """Host-prepared blocks of ``rows`` by a scoring artifact's keys
    (``uid/name`` for prepared blocks, the column for uploads)."""
    from transmogrifai_tpu_torch.workflow import _raw_store
    _, prepared, uploads = eng.host_blocks(_raw_store(rows,
                                                      eng._raw_features))
    out = {f"{uid}/{k}": v for uid, bl in prepared.items()
           for k, v in bl.items()}
    out.update(uploads)
    return out


def assert_bitwise(a, b):
    for fld in ("prediction", "raw_prediction", "probability"):
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                      err_msg=fld)


def artifact_bitwise(out, col, name):
    """A scoring artifact's flat outputs against an engine's column."""
    for key, fld in (("prediction", "prediction"),
                     ("rawPrediction", "raw_prediction"),
                     ("probability", "probability")):
        np.testing.assert_array_equal(
            np.asarray(out[f"{name}.{key}"], np.float64), getattr(col, fld),
            err_msg=key)
