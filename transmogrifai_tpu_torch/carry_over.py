"""Fitted stages carried over from the JAX package: each ported stage (the
vectorizers of every feature type — map keys and their delegates, bucket
splits, set vocabularies, geo fills —, the scalers' means and stds, the
IDF weights, the SanityChecker, the DSL's fitted models, tree ensembles
of every kind, logistic regression and linear SVC coefficients, GLM
coefficients and MLP weights, LDA's topics, Word2Vec's vectors, the count
vectorizer's vocabularies, the calibrators' tables, the selected model)
is rebuilt from a JAX stage's ``get_model_state()`` and
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

from .features import Feature
from .graph import compute_dag
from .stages.base import Estimator, FittedModel, stage_from_state
from .workflow import WorkflowModel

__all__ = ["fitted_stage_from_state", "workflow_model_from_states"]


def fitted_stage_from_state(type_name: str, state: Dict[str, Any],
                            params: Optional[Dict[str, Any]] = None
                            ) -> FittedModel:
    """The port's fitted stage of JAX class ``type_name``, from that
    stage's model state and ctor params (the stage's uid included),
    through the decoder ``model_io`` loads saved stages with."""
    stage = stage_from_state(type_name, dict(params or {}), state)
    if not isinstance(stage, FittedModel):
        raise TypeError(f"{type_name} is not a fitted model")
    return stage


def workflow_model_from_states(
        result_features: Sequence[Feature],
        states: Dict[str, Tuple[str, Dict[str, Any], Dict[str, Any]]]
) -> WorkflowModel:
    """A fitted port workflow: every estimator of ``result_features``' DAG
    gets the stage carried from ``states[estimator uid]`` = (JAX class
    name, model state, ctor params), wired to the inputs its fitted model
    reads (``Estimator.fitted_inputs``)."""
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
            model.input_features = est.fitted_inputs()
            model._output_feature = est.get_output()
            fitted[est.uid] = model
    return WorkflowModel(result_features, fitted, dag)
