"""The tenants the model-server and lifecycle tests share: the two-feature
logistic-regression workflow of ``tests/test_server.py`` and
``tests/test_lifecycle.py``, trained by the JAX package on one device
(``set_mesh(False)``), saved, loaded into the port and exported by the
port on the CPU with a program bank over the buckets 8, 16, 32 and 64."""
import numpy as np

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.filters.raw_feature_filter import \
    RawFeatureFilter as JRFF
from transmogrifai_tpu.models import (BinaryClassificationModelSelector,
                                      LogisticRegressionFamily)
from transmogrifai_tpu.ops.transmogrifier import transmogrify
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch import serving

#: the engines' bucket cap: ladder 8, 16, 32, 64
BUCKET_CAP = 64


def records(seed, n=200):
    """The JAX tests' records: a balanced label, x1 leaning on it, x2
    noise."""
    rng = np.random.default_rng(seed)
    y = np.asarray([i % 2 for i in range(n)], float)
    rng.shuffle(y)
    return [{"label": float(y[i]), "x1": float(rng.normal() + y[i]),
             "x2": float(rng.normal())} for i in range(n)]


def jax_train(seed, rows, rff_bins=None):
    """(JAX model, prediction name): the JAX tests' ``_train`` on one
    device; ``rff_bins`` attaches a RawFeatureFilter so the training
    distributions persist (``tests/test_lifecycle.py``)."""
    juid.reset()
    label = JFB.RealNN("label").from_column().as_response()
    f1 = JFB.Real("x1").from_column().as_predictor()
    f2 = JFB.Real("x2").from_column().as_predictor()
    vec = transmogrify([f1, f2])
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily()], splitter=None,
        seed=seed)
    pred = label.transform_with(sel, vec)
    wf = JWorkflow().set_input_records(rows).set_result_features(pred)
    if rff_bins:
        wf = wf.with_raw_feature_filter(JRFF(bins=rff_bins))
    return wf.set_mesh(False).train(), pred.name


def tenant(seed, model_dir, export_dir, rff_bins=None):
    """One tenant: the JAX model, the port's load of its save, the port's
    export (program bank on the CPU), the records and prediction name."""
    rows = records(seed)
    jm, name = jax_train(seed, rows, rff_bins)
    jm.save(model_dir, overwrite=True)
    pm = PWorkflowModel.load(model_dir)
    serving.export_scoring_fn(pm, export_dir, rows[:8],
                              bucket_cap=BUCKET_CAP, device="cpu")
    return {"jax": jm, "model": pm, "records": rows, "pred": name,
            "model_dir": model_dir, "export_dir": export_dir}


def jax_scores(jm, rows, name):
    """The JAX package's engine scores of ``rows`` (one device)."""
    return jm.scoring_engine(gate_bandwidth=False, mesh=False,
                             bucket_cap=BUCKET_CAP).score_store(rows)[name]


def assert_bitwise(a, b):
    for fld in ("prediction", "raw_prediction", "probability"):
        np.testing.assert_array_equal(getattr(a, fld), getattr(b, fld),
                                      err_msg=fld)
