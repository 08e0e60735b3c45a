"""Predictor base classes and the ModelFamily protocol for CV grids — the
port of ``transmogrifai_tpu/models/base.py``.

* :class:`ModelFamily` fits every point of a hyperparameter grid
  (``fit_batch``) and predicts with them (``predict_batch``); the CV
  engine (``models/tuning.py``) loops folds over it.
* :class:`PredictorEstimator` / :class:`PredictorModel` are the stage
  wrappers: Estimator(RealNN label, OPVector features) → Prediction.

Device policy: model code runs on ``device`` — ``"cuda"`` unless the
caller asks for ``"cpu"`` — and never moves to the CPU by itself
(:func:`resolve_device`). f32 is the working type; f64 is taken on the
CPU where a test holds the port against the JAX package's f64 path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor

from ..columns import Column, ColumnStore, PredictionColumn, VectorColumn
from ..stages.base import (AllowLabelAsInput, Estimator, FittedModel,
                           FixedArity, InputSpec)
from ..types.feature_types import OPVector, Prediction, RealNN

__all__ = ["PredictorEstimator", "PredictorModel", "ModelFamily",
           "extract_xy", "resolve_device", "score_sigmoid", "device_table"]


def resolve_device(device=None) -> torch.device:
    """``None`` → the card; a CUDA request without a visible card raises
    (entry points never drop to the CPU unasked)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU")
    return dev


def device_table(owner, key: str, make, device: torch.device
                 ) -> torch.Tensor:
    """A fitted stage's constant (``make()``, a host array) as a tensor on
    ``device``, uploaded once and kept on ``owner`` by (key, device).
    Scoring reads its weights from here, so the scoring engine's CUDA
    graphs capture no host-to-device copy, and a model scored many times
    uploads its tables once. ``apply_model_state`` clears the cache.

    A trace (``torch.export``, ``torch.compile``) reads a cached table as
    a constant, but never fills the cache: the value it would keep is a
    FakeTensor with no data, and every later eager call would return it.
    So a cold table under a trace raises, naming the table; an export
    first warms every table with one eager call on its device. A table
    on the ``meta`` device (the pre-flight's shapes, ``lint.py``) holds
    no data and is never kept."""
    if torch.device(device).type == "meta":
        a = np.array(make())
        return torch.empty(a.shape, device=device,
                           dtype=torch.from_numpy(a.reshape(-1)[:0]).dtype)
    cache = owner.__dict__.setdefault("_device_tables", {})
    k = (key, str(device))
    t = cache.get(k)
    if t is None:
        if torch.compiler.is_compiling():
            raise RuntimeError(_cold_table(owner, key, device))
        t = torch.as_tensor(np.array(make()), device=device)
        if isinstance(t, FakeTensor):
            raise RuntimeError(_cold_table(owner, key, device))
        cache[k] = t
    return t


def _cold_table(owner, key: str, device) -> str:
    return (f"device table {key!r} of {type(owner).__name__} "
            f"{getattr(owner, 'uid', '')} is not on {device} yet and is "
            "asked for under a trace; run the program once eagerly on "
            "that device before tracing it")


def _features(store: ColumnStore, features_name: str) -> np.ndarray:
    xcol = store[features_name]
    if not isinstance(xcol, VectorColumn):
        raise TypeError(f"{features_name!r} must be a vector column")
    return np.asarray(xcol.values)


def extract_xy(store: ColumnStore, label_name: str, features_name: str
               ) -> Tuple[np.ndarray, np.ndarray]:
    """(X as stored — the f32 pipeline matrix —, y as f64)."""
    return (_features(store, features_name),
            np.asarray(store[label_name].values, dtype=np.float64))


def score_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """σ(x) = 1 / (1 + e^−x) for the prediction heads: equal inputs get
    equal scores wherever they sit in the tensor. On the CPU
    ``torch.sigmoid``'s vectorized loop and its scalar tail round apart
    by an ulp, which splits a tie of equal margins into two scores and
    moves a threshold metric (AuPR) computed over them."""
    return 1.0 / (1.0 + torch.exp(-x))


def to_f64(out) -> Tuple[np.ndarray, ...]:
    """A prediction triple of tensors → host float64 arrays."""
    return tuple(o.detach().to("cpu", torch.float64).numpy() for o in out)


class PredictorModel(FittedModel, AllowLabelAsInput):
    """Fitted predictor: OPVector → Prediction struct column. Keeps the
    estimator's (label, features) inputs; the label is read only by the
    holdout evaluation."""

    output_type = Prediction
    #: the workflow passes ``device=`` to this stage's transform
    uses_device = True

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, OPVector)

    def predict_device(self, Xd: torch.Tensor):
        """(prediction [n], raw [n, k], prob [n, k]) tensors on ``Xd``'s
        device: the contract the scoring engine fuses. No read-back to
        the host, no upload after the first call (``device_table``), so
        the engine can capture it in a CUDA graph."""
        raise NotImplementedError(
            f"{type(self).__name__} implements neither predict_device nor "
            "predict_arrays")

    def predict_arrays(self, X: np.ndarray, device=None
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(prediction [n], raw [n, k], prob [n, k]) as host float64, by
        :meth:`predict_device` on ``device`` (default: the card)."""
        Xd = torch.as_tensor(X, device=resolve_device(device))
        return to_f64(self.predict_device(Xd))

    def transform_columns(self, store: ColumnStore, device=None) -> Column:
        X = _features(store, self.input_features[1].name)
        return PredictionColumn(*self.predict_arrays(X, device=device))


class PredictorEstimator(Estimator, AllowLabelAsInput):
    """Estimator(label: RealNN, features: OPVector) → Prediction; fits on
    ``device`` in ``dtype`` (``fit(store, device=..., dtype=...)``)."""

    output_type = Prediction
    uses_device = True

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(RealNN, OPVector)

    @property
    def label_name(self) -> str:
        return self.input_features[0].name

    @property
    def features_name(self) -> str:
        return self.input_features[1].name


class ModelFamily:
    """Fit/predict over a hyperparameter grid (a list of dicts).

      * ``fit_batch(X, y, w, grid)`` → one params dict per grid point
      * ``predict_batch(params, X)`` → one (prediction, raw, prob) each
      * ``realize(params_i, hparams_i)`` → a fitted model stage
    """

    name: str = "family"
    default_grid: List[Dict[str, Any]] = []

    def __init__(self, grid: Optional[List[Dict[str, Any]]] = None):
        self.grid = list(grid) if grid is not None else list(self.default_grid)
        if not self.grid:
            self.grid = [{}]

    def grid_size(self) -> int:
        return len(self.grid)

    def param_defaults(self) -> Dict[str, Any]:
        return {}

    def device_prep(self, Xd: torch.Tensor):
        """The fit input made once per sweep from the device matrix (the
        tree families bin it); by default the matrix itself."""
        return Xd

    def fit_prepared(self, Xd: torch.Tensor, y, w, grid=None):
        """(params list, fit input) for the final refit; the fit input
        serves ``predict_batch(..., on_train=True)``."""
        Xarg = self.device_prep(Xd)
        return self.fit_batch(Xarg, y, w, grid), Xarg

    def fit_batch(self, X, y, w, grid=None):
        raise NotImplementedError

    def predict_batch(self, params, X, on_train: bool = False):
        """``on_train=True`` asserts X is the matrix ``fit_batch`` saw, so
        families may answer from fit-time caches; never for fresh data."""
        raise NotImplementedError

    def realize(self, params, hparams: Dict[str, Any]) -> PredictorModel:
        raise NotImplementedError

    def clone_single(self, hparams: Dict[str, Any]) -> "ModelFamily":
        """Same family configured with a one-point grid (final refit)."""
        new = type(self)(grid=[dict(hparams)])
        new.__dict__.update({k: v for k, v in self.__dict__.items()
                             if k != "grid"})
        return new

    def __repr__(self) -> str:
        return f"{type(self).__name__}(grid={len(self.grid)})"
