"""Stage abstraction: transformers, estimators, fitted models.

Host copy of ``transmogrifai_tpu/stages/base.py``. A stage's bulk operation
is columnar (``transform_columns`` over a ColumnStore); ``transform_row``
routes through a 1-row store so row and column semantics cannot diverge;
estimators ``fit`` on a ColumnStore and return a fitted model transformer.
"""
from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Type

from ..columns import Column, ColumnStore, column_from_values
from ..features import Feature
from ..types.feature_types import FeatureType, OPVector
from ..utils import uid as uid_mod

__all__ = [
    "InputSpec", "FixedArity", "VarArity", "OpPipelineStage", "Transformer",
    "Estimator", "FittedModel", "LambdaTransformer", "AllowLabelAsInput",
    "STAGE_REGISTRY", "register_stage", "stage_from_state", "ctor_kwargs",
]


STAGE_REGISTRY: Dict[str, type] = {}


def register_stage(cls):
    """Register a stage class for serialization lookup."""
    STAGE_REGISTRY[cls.__name__] = cls
    return cls


#: the modules that register this package's stages, imported when a
#: decode meets a class name the registry does not hold yet
_STAGE_MODULES = ("..stages.generator", "..dsl", "..ops.numeric",
                  "..ops.onehot", "..ops.smart_text", "..ops.hashing",
                  "..ops.dates", "..ops.vectors", "..ops.sanity_checker",
                  "..ops.text", "..ops.indexers", "..models")


def ctor_kwargs(cls, params: Dict[str, Any]) -> Dict[str, Any]:
    """``params`` that ``cls``' ctor takes. A key it does not take is
    dropped when its value is None (an argument the JAX package's
    counterpart has and left at its default, such as ``mesh``), and
    refused otherwise."""
    sig = inspect.signature(cls.__init__).parameters
    if any(p.kind is p.VAR_KEYWORD for p in sig.values()):
        return dict(params)
    bad = sorted(k for k, v in params.items()
                 if k not in sig and v is not None)
    if bad:
        raise ValueError(f"{cls.__name__} takes no parameter(s) {bad}: the "
                         "saved value has no counterpart in this package")
    return {k: v for k, v in params.items() if k in sig}


def stage_from_state(class_name: str, params: Dict[str, Any],
                     state: Optional[Dict[str, Any]] = None,
                     uid: Optional[str] = None) -> "OpPipelineStage":
    """The one decoder of a saved stage: the registered class
    ``class_name`` built from its decoded ctor ``params`` (``uid`` wins
    over a ``"uid"`` among them), then its fitted ``state`` applied —
    ``apply_model_state`` where the stage has one, else each entry set as
    an attribute. Shared by ``model_io`` (files of either package) and
    ``carry_over`` (a live JAX stage's ``get_params`` /
    ``get_model_state``)."""
    if class_name not in STAGE_REGISTRY:
        import importlib
        for mod in _STAGE_MODULES:
            importlib.import_module(mod, __package__)
    cls = STAGE_REGISTRY.get(class_name)
    if cls is None:
        raise ValueError(f"Stage class {class_name!r} is not registered: "
                         "this package has no such stage (not ported yet)")
    params = ctor_kwargs(cls, params or {})
    given_uid = params.pop("uid", None)
    stage = cls(uid=uid or given_uid, **params)
    if state is not None:
        if hasattr(stage, "apply_model_state"):
            stage.apply_model_state(state)
        else:
            for k, v in state.items():
                setattr(stage, k, v)
    return stage


class InputSpec:
    """Input arity/type contract for a stage."""

    def check(self, features: Sequence[Feature]) -> None:
        raise NotImplementedError

    def describe(self) -> str:
        """Human-readable form of the declared contract — the static
        checker (lint.py TMG101) quotes it next to the actual wired
        feature types so a mis-typed edge names both sides."""
        return "?"


class FixedArity(InputSpec):
    """Exactly len(types) inputs, positionally typed (OpPipelineStage1..4)."""

    def __init__(self, *types: Type[FeatureType]):
        self.types = types

    def describe(self) -> str:
        return "(" + ", ".join(t.__name__ for t in self.types) + ")"

    def check(self, features: Sequence[Feature]) -> None:
        if len(features) != len(self.types):
            raise TypeError(
                f"Expected {len(self.types)} input features, got {len(features)}")
        for i, (f, t) in enumerate(zip(features, self.types)):
            if not issubclass(f.ftype, t):
                raise TypeError(
                    f"Input {i} ({f.name!r}) has type {f.ftype.__name__}, "
                    f"expected {t.__name__}")


class VarArity(InputSpec):
    """N same-typed inputs, optionally with fixed positional heads
    (SequenceEstimator / BinarySequenceEstimator)."""

    def __init__(self, seq_type: Type[FeatureType],
                 head_types: Sequence[Type[FeatureType]] = (), min_seq: int = 1):
        self.seq_type = seq_type
        self.head_types = tuple(head_types)
        self.min_seq = min_seq

    def describe(self) -> str:
        seq = (self.seq_type.__name__ if isinstance(self.seq_type, type)
               else "|".join(t.__name__ for t in self.seq_type))
        head = ", ".join(t.__name__ for t in self.head_types)
        return f"({head}{', ' if head else ''}{seq}*)"

    def check(self, features: Sequence[Feature]) -> None:
        n_head = len(self.head_types)
        if len(features) < n_head + self.min_seq:
            raise TypeError(
                f"Expected at least {n_head + self.min_seq} inputs, "
                f"got {len(features)}")
        for i, t in enumerate(self.head_types):
            if not issubclass(features[i].ftype, t):
                raise TypeError(
                    f"Input {i} ({features[i].name!r}) has type "
                    f"{features[i].ftype.__name__}, expected {t.__name__}")
        for f in features[n_head:]:
            if not issubclass(f.ftype, self.seq_type):
                expected = (self.seq_type.__name__
                            if isinstance(self.seq_type, type) else
                            "|".join(t.__name__ for t in self.seq_type))
                raise TypeError(
                    f"Sequence input {f.name!r} has type {f.ftype.__name__}, "
                    f"expected {expected}")


class AllowLabelAsInput:
    """Marker mixin: stage may consume response features without its output
    becoming a response (OpPipelineStages.scala:204-211)."""


class OpPipelineStage:
    """Base pipeline stage: named operation over input features.

    Subclass ``__init__`` kwargs are captured automatically for JSON
    round-trip (the reference's ctor-args serialization,
    ``OpPipelineStageWriter.scala``).
    """

    #: override in subclasses
    operation_name: str = "stage"
    output_type: Type[FeatureType] = OPVector

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        orig = cls.__init__
        if getattr(orig, "_captures_params", False):
            return
        try:
            sig = inspect.signature(orig)
        except (TypeError, ValueError):  # pragma: no cover
            return

        @functools.wraps(orig)
        def wrapper(self, *args, **kwargs):
            if not hasattr(self, "_ctor_params"):
                try:
                    bound = sig.bind(self, *args, **kwargs)
                    bound.apply_defaults()
                    self._ctor_params = {
                        k: v for k, v in bound.arguments.items()
                        if k not in ("self",) and not k.startswith("_")
                        and k != "kwargs"}
                    self._ctor_params.update(bound.arguments.get("kwargs") or {})
                except TypeError:
                    self._ctor_params = {}
            orig(self, *args, **kwargs)

        wrapper._captures_params = True
        cls.__init__ = wrapper

    def __init__(self, uid: Optional[str] = None):
        self.uid = uid or uid_mod.make_uid(type(self))
        self.input_features: Tuple[Feature, ...] = ()
        self._output_feature: Optional[Feature] = None

    # -- contract ----------------------------------------------------------
    @property
    def input_spec(self) -> InputSpec:
        raise NotImplementedError

    def stage_name(self) -> str:
        return f"{type(self).__name__}_{self.operation_name}"

    # -- wiring ------------------------------------------------------------
    def set_input(self, *features: Feature) -> "OpPipelineStage":
        self.input_spec.check(features)
        for f in features:
            if f.is_response and not isinstance(self, AllowLabelAsInput) \
                    and not all(x.is_response for x in features):
                raise TypeError(
                    f"Stage {self.stage_name()} mixes response feature "
                    f"{f.name!r} with predictors; only AllowLabelAsInput "
                    "stages may do that (label-leakage gate)")
        self.input_features = tuple(features)
        self._output_feature = None
        return self

    def get_output(self) -> Feature:
        if self._output_feature is None:
            if not self.input_features:
                raise ValueError(f"{self.stage_name()}: inputs not set")
            self._output_feature = Feature(
                name=self.make_output_name(),
                ftype=self.output_type,
                is_response=all(f.is_response for f in self.input_features),
                origin_stage=self,
                parents=self.input_features)
        return self._output_feature

    def make_output_name(self) -> str:
        ins = "-".join(f.name for f in self.input_features[:4])
        _, uid_hex = uid_mod.parse_uid(self.uid)
        return f"{ins}_{self.operation_name}_{uid_hex[-6:]}"

    @property
    def output_name(self) -> str:
        return self.get_output().name

    # -- params / serialization -------------------------------------------
    def get_params(self) -> Dict[str, Any]:
        return dict(getattr(self, "_ctor_params", {}))

    def set_params(self, **params) -> "OpPipelineStage":
        """Reflectively update ctor params + matching attributes
        (OpWorkflow.setStageParameters analog)."""
        for k, v in params.items():
            if hasattr(self, k):
                setattr(self, k, v)
            self._ctor_params[k] = v
        return self

    def copy(self) -> "OpPipelineStage":
        """Fresh instance with same ctor params + uid (ReflectionUtils.copy)."""
        params = self.get_params()
        params["uid"] = self.uid
        new = type(self)(**params)
        if self.input_features:
            new.input_features = self.input_features
        return new

    def __repr__(self) -> str:
        return f"{type(self).__name__}(uid={self.uid})"


class Transformer(OpPipelineStage):
    """Stage whose output is a pure function of its inputs."""

    def transform_columns(self, store: ColumnStore) -> Column:
        """Bulk columnar transform: compute the output column."""
        raise NotImplementedError

    def transform(self, store: ColumnStore, **kw) -> ColumnStore:
        """``kw`` (e.g. ``device``) reaches ``transform_columns``."""
        return store.with_column(self.output_name,
                                 self.transform_columns(store, **kw))

    # -- row-level path (local serving / contract tests) -------------------
    def transform_row(self, row: Dict[str, Any], **kw) -> Any:
        """Compute the output value for one row dict {feature name: raw value}.

        Default routes through a 1-row ColumnStore so the row path can never
        diverge from the columnar path; ``kw`` (e.g. ``device``) reaches
        ``transform_columns``. Stages may override for speed.
        """
        cols = {}
        for f in self.input_features:
            cols[f.name] = column_from_values(f.ftype, [row.get(f.name)])
        out = self.transform_columns(ColumnStore(cols, 1), **kw)
        return out.get_raw(0)

    def transform_key_value(self, get: Callable[[str], Any]) -> Any:
        row = {f.name: get(f.name) for f in self.input_features}
        return self.transform_row(row)


class FittedModel(Transformer):
    """A fitted estimator: transformer + serializable numeric state.

    Shares the estimator's uid and output feature so the workflow swaps it
    into the DAG in place of the estimator after fitting.
    """

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.parent_estimator_uid: Optional[str] = None

    def get_model_state(self) -> Dict[str, Any]:
        """JSON-able dict; numpy arrays allowed (stored via npz)."""
        raise NotImplementedError

    @classmethod
    def from_model_state(cls, state: Dict[str, Any], **ctor) -> "FittedModel":
        raise NotImplementedError

    def has_test_eval(self) -> bool:
        """True for models that evaluate on holdout during workflow fit
        (HasTestEval, used by ModelSelector)."""
        return False

    def evaluate_model(self, test: ColumnStore) -> None:  # pragma: no cover
        pass


class Estimator(OpPipelineStage):
    """Stage that must be fit on data, producing a :class:`FittedModel`.

    Estimators may additionally opt into the layer-wide fused
    fit-statistics engine (``fitstats.py``, the SequenceAggregators
    analog) by overriding :meth:`stat_requests` and
    :meth:`fit_columns_from_stats`: the workflow then computes every
    opted-in estimator's sufficient statistics for a DAG layer in ONE
    pass over the train store and hands each stage its finalized stats,
    instead of every ``fit_columns`` re-scanning the full store. The
    plain ``fit_columns`` stays as the sequential fallback and the two
    paths must produce identical models.
    """

    def fit(self, store: ColumnStore, stats: Optional[Any] = None,
            **fit_kw) -> FittedModel:
        """``fit_kw`` (e.g. ``device``, ``dtype``) reaches ``fit_columns``."""
        if stats is None:
            model = self.fit_columns(store, **fit_kw)
        else:
            model = self.fit_columns_from_stats(store, stats)
        model.uid = self.uid
        model.parent_estimator_uid = self.uid
        model.input_features = self.input_features
        model._output_feature = self.get_output()
        if not hasattr(model, "_ctor_params"):
            model._ctor_params = {}
        return model

    def fit_columns(self, store: ColumnStore) -> FittedModel:
        raise NotImplementedError

    # -- fused fit-statistics protocol (fitstats.py) -----------------------
    def stat_requests(self, store: ColumnStore):
        """Sufficient statistics this estimator needs to fit, as a list
        of ``fitstats.StatRequest`` — or None to stay on the sequential
        ``fit_columns`` path (the default). An EMPTY list is a valid
        opt-in meaning "no data needed" (constant-fill vectorizers)."""
        return None

    def fit_columns_from_stats(self, store: ColumnStore,
                               stats: Any) -> FittedModel:
        """Finalize a fitted model from the layer pass's stats — must
        produce the identical model ``fit_columns`` would."""
        raise NotImplementedError(
            f"{type(self).__name__} declares stat_requests but not "
            "fit_columns_from_stats")


class LambdaTransformer(Transformer):
    """Transformer from a columnar function — the workhorse for math ops,
    aliasing, and the DSL's cheap derived features.

    ``fn(*input_columns, store) -> Column`` or ``fn(*input_columns) -> Column``.
    Not JSON-serializable unless ``fn_name`` refers to a registered function.
    """

    def __init__(self, operation_name: str,
                 fn: Callable[..., Column],
                 input_types: Sequence[Type[FeatureType]],
                 output_type: Type[FeatureType],
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.operation_name = operation_name
        self.fn = fn
        self._input_types = tuple(input_types)
        self.output_type = output_type

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(*self._input_types)

    def transform_columns(self, store: ColumnStore) -> Column:
        cols = [store[f.name] for f in self.input_features]
        return self.fn(*cols)
