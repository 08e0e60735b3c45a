"""Fitted stages carried over from the JAX package: each ported stage (the
vectorizers, the SanityChecker, the DSL's fitted models, tree ensembles
of every kind, logistic regression and linear SVC coefficients, the
selected model) is rebuilt from a JAX stage's ``get_model_state()`` and
``get_params()`` —
numpy arrays and JSON values only, so nothing of the JAX package is
imported. A workflow trained there scores the same here.

    stage = fitted_stage_from_state(type(jax_stage).__name__,
                                    jax_stage.get_model_state(),
                                    jax_stage.get_params())

:func:`workflow_model_from_states` wires such stages into the port's own
DAG of the same workflow (built in the same order from fresh uid
counters, so the estimators' uids agree).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .dsl import FillMissingWithMeanModel, ScalarNormalizerModel
from .features import Feature
from .graph import compute_dag
from .models.linear import LogisticRegressionModel
from .models.selector import SelectedModel
from .models.svm import LinearSVCModel
from .models.trees import tree_model_from_numpy
from .ops.dates import DateToUnitCircleVectorizer
from .ops.numeric import NumericVectorizerModel
from .ops.onehot import OneHotModel
from .ops.sanity_checker import SanityCheckerModel
from .ops.smart_text import SmartTextVectorizerModel
from .stages.base import Estimator, FittedModel
from .workflow import WorkflowModel

__all__ = ["fitted_stage_from_state", "workflow_model_from_states"]

#: ctor parameters each carried stage takes from ``get_params()``
_PARAMS = {
    "NumericVectorizerModel": ("track_nulls", "ftype_name"),
    "OneHotModel": ("track_nulls", "ftype_name"),
    "SmartTextVectorizerModel": ("num_features", "track_nulls",
                                 "track_text_len", "seed", "ftype_name"),
    "DateToUnitCircleVectorizer": ("periods", "track_nulls", "input_names",
                                   "ftype_name"),
}


def fitted_stage_from_state(type_name: str, state: Dict[str, Any],
                            params: Optional[Dict[str, Any]] = None
                            ) -> FittedModel:
    """The port's fitted stage of JAX class ``type_name``, from that
    stage's model state and ctor params (the stage's uid included)."""
    params = dict(params or {})
    uid = params.get("uid")
    kw = {k: params[k] for k in _PARAMS.get(type_name, ()) if k in params}
    names = list(state.get("input_names_saved", ()))
    if type_name == "NumericVectorizerModel":
        return NumericVectorizerModel(
            fill_values=[float(v) for v in state["fill_values"]],
            input_names=names, uid=uid, **kw)
    if type_name == "OneHotModel":
        if params.get("is_set"):
            raise NotImplementedError(
                "the set pivot (SetVectorizer) is not ported yet")
        return OneHotModel(vocabs=state["vocabs"], input_names=names,
                           uid=uid, **kw)
    if type_name == "SmartTextVectorizerModel":
        return SmartTextVectorizerModel(
            is_categorical=state["is_categorical"], vocabs=state["vocabs"],
            input_names=names, uid=uid, **kw)
    if type_name == "DateToUnitCircleVectorizer":
        return DateToUnitCircleVectorizer(uid=uid, **kw)
    if type_name == "SanityCheckerModel":
        return SanityCheckerModel(keep_indices=state["keep_indices"],
                                  uid=uid)
    if type_name == "TreeEnsembleModel":
        model = tree_model_from_numpy(
            str(params["kind"]), int(params["n_classes"]),
            int(params["max_depth"]),
            {k[5:]: np.asarray(v) for k, v in state.items()
             if k.startswith("tree_")})
        model.uid = uid or model.uid
        return model
    if type_name == "LogisticRegressionModel":
        return LogisticRegressionModel(
            np.asarray(state["coefficients"]), np.asarray(state["intercept"]),
            int(state.get("n_classes", 2)), uid=uid)
    if type_name == "LinearSVCModel":
        return LinearSVCModel(np.asarray(state["coefficients"]),
                              np.asarray(state["intercept"]), uid=uid)
    if type_name == "FillMissingWithMeanModel":
        return FillMissingWithMeanModel(mean=float(state["mean"]), uid=uid)
    if type_name == "ScalarNormalizerModel":
        return ScalarNormalizerModel(mean=float(state["mean"]),
                                     std=float(state["std"]), uid=uid)
    if type_name == "SelectedModel":
        inner = fitted_stage_from_state(state["inner_class"],
                                        state["inner_state"],
                                        state["inner_params"])
        return SelectedModel(inner=inner, task=params.get("task", "binary"),
                             uid=uid)
    raise NotImplementedError(f"no ported counterpart of {type_name}")


def workflow_model_from_states(
        result_features: Sequence[Feature],
        states: Dict[str, Tuple[str, Dict[str, Any], Dict[str, Any]]]
) -> WorkflowModel:
    """A fitted port workflow: every estimator of ``result_features``' DAG
    gets the stage carried from ``states[estimator uid]`` = (JAX class
    name, model state, ctor params)."""
    dag = compute_dag(result_features)
    fitted: Dict[str, FittedModel] = {}
    for layer in dag:
        for est in layer:
            if not isinstance(est, Estimator):
                continue
            if est.uid not in states:
                raise KeyError(f"no carried state for estimator {est.uid}")
            model = fitted_stage_from_state(*states[est.uid])
            model.uid = model.parent_estimator_uid = est.uid
            model.input_features = est.input_features
            model._output_feature = est.get_output()
            fitted[est.uid] = model
    return WorkflowModel(result_features, fitted, dag)
