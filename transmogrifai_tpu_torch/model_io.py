"""Model persistence — the ``op-model.json`` analog; the port of
``transmogrifai_tpu/model_io.py``, in the JAX package's on-disk format.

One ``model.json`` holds the workflow uid, the result-feature uids, the
topologically sorted feature graph and one record per stage (class name,
ctor params, JSON state); the stages' numeric arrays sit in a weights
archive beside it (``OpWorkflowModelWriter.scala:75-146``). Files move
between the packages in both directions:

* a model the JAX package saved (``formatVersion`` 1 with a bare
  ``weights.npz``, or 2 with a save-unique ``weightsFile``) loads here;
* a model saved here loads in ``transmogrifai_tpu.workflow.WorkflowModel
  .load``. Stage records carry the class names both packages register,
  and config objects (``{"__obj__": "module:qualname"}``) carry the JAX
  package's module names, from :data:`REFERENCE_MODULES`.

Reading ``{"__obj__": "transmogrifai_tpu.<m>:<name>"}`` maps the module to
this package's ``transmogrifai_tpu_torch.<m>`` by string; no module of
the JAX package is imported, and only the codec's config classes
(model families, splitters, the cross validator) may be built from a
file.

A feature's ``parentUids`` are the inputs of the stage that computes it
as its stage record names them (``inputFeatureUids``; the fitted model's,
``Estimator.fitted_inputs``), and a load wires each stage to its record's
inputs (:func:`parent_uids` for both). The two differ from the graph the
user built only where a fit read the label and its fitted model does not:
the decision-tree bucketizers. So a save here records the bucketizer's
numeric input alone as its output's parents, where a JAX-package save
lists the label too. This is what lets the JAX package load the port's
save: its loader wires stages from ``parentUids``, and would hand the
fitted bucketizer the label, which its label-leakage check refuses (so it
cannot load its own save of such a workflow). A JAX-package save loads
here through the stage records' inputs.

``rawFeatureFilterResults`` is written from and read into the model's
``filters.RawFeatureFilterResults``; ``fitSufficientStats`` from and into
its train-time ``fitstats.SufficientStats`` (``"<layer>:<column>"`` →
count, mean, m2, min, max). A stage that holds another stage by uid
(``RecordInsightsLOCO``'s scored model) is re-attached by
``rebind_stages`` once every stage of a load exists.
"""
from __future__ import annotations

import functools
import importlib
import inspect
import json
import os
import shutil
import time
import uuid
import zipfile
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .features import Feature
from .fitstats import sufficient_stats_from_json, sufficient_stats_to_json
from .stages.base import (FittedModel, OpPipelineStage, ctor_kwargs,
                          stage_from_state)
from .types.feature_types import FeatureType, feature_type_by_name
from .vector_metadata import VectorMetadata

__all__ = ["save_workflow_model", "load_workflow_model", "MODEL_JSON",
           "WEIGHTS_NPZ", "FORMAT_VERSION", "REFERENCE_MODULES",
           "collect_stage_records", "rebuild_stages", "rebuild_features",
           "stage_input_uids", "parent_uids"]

MODEL_JSON = "model.json"
#: the weights archive of a ``formatVersion`` 1 save
WEIGHTS_NPZ = "weights.npz"
#: 2: the weights live in a save-unique ``weights-<id>.npz`` named by
#: model.json's ``weightsFile`` (crash-consistent overwrites)
FORMAT_VERSION = 2

_PKG = __name__.partition(".")[0]
#: the JAX package, named only as data: the prefix of ``__obj__`` modules
_REF_PKG = "transmogrifai_tpu"
#: each config class the codec writes → its module in the JAX package,
#: whose layout this package mirrors (``transmogrifai_tpu.<m>`` is
#: ``transmogrifai_tpu_torch.<m>``)
REFERENCE_MODULES = {
    "LogisticRegressionFamily": "transmogrifai_tpu.models.linear",
    "LinearRegressionFamily": "transmogrifai_tpu.models.linear",
    "NaiveBayesFamily": "transmogrifai_tpu.models.linear",
    "LinearSVCFamily": "transmogrifai_tpu.models.svm",
    "MLPFamily": "transmogrifai_tpu.models.svm",
    "GLMRegressionFamily": "transmogrifai_tpu.models.glm",
    "RandomForestFamily": "transmogrifai_tpu.models.trees",
    "DecisionTreeFamily": "transmogrifai_tpu.models.trees",
    "GBTFamily": "transmogrifai_tpu.models.trees",
    "XGBoostFamily": "transmogrifai_tpu.models.trees",
    "Splitter": "transmogrifai_tpu.models.tuning",
    "DataSplitter": "transmogrifai_tpu.models.tuning",
    "DataBalancer": "transmogrifai_tpu.models.tuning",
    "DataCutter": "transmogrifai_tpu.models.tuning",
    "CrossValidation": "transmogrifai_tpu.models.tuning",
    "TrainValidationSplit": "transmogrifai_tpu.models.tuning",
}


@functools.lru_cache(maxsize=None)
def _codec_bases():
    """Config objects encoded structurally (ctor-arg capture): model
    families, splitters and the validators (an unfitted ModelSelector's
    params, reached by layer checkpoints)."""
    from .models.base import ModelFamily
    from .models.tuning import Splitter, _ValidatorBase
    return (ModelFamily, Splitter, _ValidatorBase)


def _encode_obj(v: Any, arrays: Dict[str, np.ndarray], prefix: str) -> Any:
    cls = type(v)
    module = REFERENCE_MODULES.get(cls.__qualname__)
    if module is None or cls.__module__ != _PKG + module[len(_REF_PKG):]:
        raise TypeError(f"{cls.__module__}.{cls.__qualname__} has no entry "
                        "in model_io.REFERENCE_MODULES; it cannot be saved")
    params = {}
    for name, p in inspect.signature(cls.__init__).parameters.items():
        if name == "self" or p.kind is p.VAR_POSITIONAL:
            continue
        if p.kind is p.VAR_KEYWORD:
            kw = getattr(v, name, None)
            if isinstance(kw, dict) and kw:
                params["__var_kw__"] = _encode_param(kw, arrays, prefix)
            continue
        if hasattr(v, name):
            params[name] = _encode_param(getattr(v, name), arrays, prefix)
    return {"__obj__": f"{module}:{cls.__qualname__}", "params": params}


def _encode_param(v: Any, arrays: Dict[str, np.ndarray], prefix: str) -> Any:
    if isinstance(v, type) and issubclass(v, FeatureType):
        return {"__ftype__": v.__name__}
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    if isinstance(v, np.ndarray):
        key = f"{prefix}::{len(arrays)}"
        arrays[key] = v
        return {"__array__": key}
    if isinstance(v, VectorMetadata):
        return {"__vecmeta__": v.to_json()}
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, (list, tuple)):
        return [_encode_param(x, arrays, prefix) for x in v]
    if isinstance(v, dict):
        return {str(k): _encode_param(x, arrays, prefix)
                for k, x in v.items()}
    if isinstance(v, _codec_bases()):
        return _encode_obj(v, arrays, prefix)
    if isinstance(v, OpPipelineStage):
        rec: Dict[str, Any] = {
            "__stage__": type(v).__name__,
            "params": {k: _encode_param(x, arrays, prefix)
                       for k, x in v.get_params().items()}}
        if isinstance(v, FittedModel):
            rec["modelState"] = {k: _encode_param(x, arrays, prefix)
                                 for k, x in v.get_model_state().items()}
        return rec
    if callable(v):
        return {"__dropped_callable__": getattr(v, "__name__", "fn")}
    return v


def _decode_obj(v: Dict[str, Any], arrays: Dict[str, np.ndarray]) -> Any:
    mod_name, _, qual = v["__obj__"].partition(":")
    # the module allowlist comes BEFORE any import: only the JAX
    # package's module names, which map onto this package's own
    if mod_name != _REF_PKG and not mod_name.startswith(_REF_PKG + "."):
        raise ValueError(
            f"Refusing to import {mod_name!r} from serialized data: only "
            f"{_REF_PKG} modules (read as {_PKG}'s) may be referenced")
    obj = importlib.import_module(_PKG + mod_name[len(_REF_PKG):])
    for part in qual.split("."):
        obj = getattr(obj, part)
    # only the codec's config classes may be built from a file
    if not (isinstance(obj, type) and issubclass(obj, _codec_bases())):
        raise ValueError(f"Refusing to instantiate {v['__obj__']!r}: not a "
                         "registered config class")
    kwargs = {k: _decode_param(x, arrays) for k, x in v["params"].items()}
    kwargs.update(kwargs.pop("__var_kw__", None) or {})
    return obj(**ctor_kwargs(obj, kwargs))


def _decode_param(v: Any, arrays: Dict[str, np.ndarray]) -> Any:
    if isinstance(v, dict):
        if "__ftype__" in v:
            return feature_type_by_name(v["__ftype__"])
        if "__array__" in v:
            return arrays[v["__array__"]]
        if "__vecmeta__" in v:
            return VectorMetadata.from_json(v["__vecmeta__"])
        if "__stage__" in v:
            state = v.get("modelState")
            return stage_from_state(
                v["__stage__"], _decode_param(v["params"], arrays),
                _decode_param(state, arrays) if state else None)
        if "__obj__" in v:
            return _decode_obj(v, arrays)
        if "__dropped_callable__" in v:
            return None
        return {k: _decode_param(x, arrays) for k, x in v.items()}
    if isinstance(v, list):
        return [_decode_param(x, arrays) for x in v]
    return v


def _stage_record(stage: OpPipelineStage, arrays: Dict[str, np.ndarray]
                  ) -> Dict[str, Any]:
    rec: Dict[str, Any] = {
        "className": type(stage).__name__,
        "uid": stage.uid,
        "params": _encode_param(stage.get_params(), arrays, stage.uid),
        "inputFeatureUids": [f.uid for f in stage.input_features],
    }
    if isinstance(stage, FittedModel):
        rec["isModel"] = True
        rec["modelState"] = _encode_param(stage.get_model_state(), arrays,
                                          stage.uid + "#s")
    return rec


def _feature_record(f: Feature,
                    stage_inputs: Optional[Dict[str, List[str]]] = None
                    ) -> Dict[str, Any]:
    """A feature's record; its ``parentUids`` by :func:`parent_uids`."""
    origin = f.origin_stage.uid if f.origin_stage else None
    return {
        "uid": f.uid,
        "name": f.name,
        "typeName": f.ftype.__name__,
        "isResponse": f.is_response,
        "originStageUid": origin,
        "parentUids": parent_uids(origin, [p.uid for p in f.parents],
                                  stage_inputs),
    }


def _topo_features(result_features) -> List[Feature]:
    """All features reachable from the results, parents before children."""
    order: List[Feature] = []
    seen = set()

    def visit(f: Feature) -> None:
        if f.uid in seen:
            return
        seen.add(f.uid)
        for p in f.parents:
            visit(p)
        order.append(f)

    for f in result_features:
        visit(f)
    return order


def collect_stage_records(features: List[Feature],
                          arrays: Dict[str, np.ndarray],
                          fitted_lookup: Optional[Dict[str, Any]] = None
                          ) -> List[Dict[str, Any]]:
    """One stage record per distinct origin stage of ``features`` (topo
    order, deduped by uid), the fitted model in place of its estimator
    where ``fitted_lookup`` has one."""
    records: List[Dict[str, Any]] = []
    recorded = set()
    for f in features:
        st = f.origin_stage
        if st is None or st.uid in recorded:
            continue
        recorded.add(st.uid)
        if fitted_lookup is not None:
            st = fitted_lookup.get(st.uid, st)
        records.append(_stage_record(st, arrays))
    return records


def save_workflow_model(model, path: str, overwrite: bool = False) -> None:
    """Write ``model`` to the directory ``path`` (format 2). The weights go
    to a save-unique file first and model.json lands last by an atomic
    replace, so a crash at any point leaves the previous save loadable;
    weights orphaned by earlier saves are swept after a minute."""
    mj = os.path.join(path, MODEL_JSON)
    if os.path.exists(mj) and not overwrite:
        raise FileExistsError(f"Model already exists at {path}")
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    features = _topo_features(model.result_features)
    stage_records = collect_stage_records(
        features, arrays, fitted_lookup=model.fitted_stages)

    from .utils.version import version_info
    weights_name = f"weights-{uuid.uuid4().hex[:12]}.npz"
    doc = {
        "formatVersion": FORMAT_VERSION,
        "versionInfo": version_info(),
        "uid": model.uid,
        "resultFeatureUids": [f.uid for f in model.result_features],
        "blacklistedFeatureUids": [f.uid
                                   for f in model.blacklisted_features],
        "features": [_feature_record(f, stage_input_uids(stage_records))
                     for f in features],
        "stages": stage_records,
        "parameters": model.parameters,
        "trainTimeSeconds": model.train_time_s,
        "rawFeatureFilterResults": (model.rff_results.to_json()
                                    if model.rff_results is not None
                                    else None),
        "fitSufficientStats": (sufficient_stats_to_json(model.fit_stats)
                               if model.fit_stats else None),
        "weightsFile": weights_name,
    }
    # a concurrent saver stalled between its weights and its model.json
    # is exempt from the orphan sweep while this sidecar exists
    pending = os.path.join(path, weights_name + ".pending")
    with open(pending, "w") as fh:
        fh.write(str(os.getpid()))
    np.savez(os.path.join(path, weights_name), **arrays)
    json_tmp = mj + ".tmp"
    with open(json_tmp, "w") as fh:
        json.dump(doc, fh, indent=1, default=str)
    os.replace(json_tmp, mj)
    try:
        os.remove(pending)
    except OSError:
        pass
    now = time.time()   # lint: wall-clock — compared against file mtimes
    for fn in os.listdir(path):
        full = os.path.join(path, fn)
        try:
            if fn.endswith(".npz.pending") and fn != weights_name + ".pending":
                if now - os.path.getmtime(full) > 86_400.0:
                    os.remove(full)
                continue
            if (fn.endswith(".npz") and fn != weights_name
                    and (fn.startswith("weights-") or fn == WEIGHTS_NPZ)):
                if os.path.exists(full + ".pending"):
                    continue
                if now - os.path.getmtime(full) > 60.0:
                    os.remove(full)
        except OSError:
            pass


def rebuild_stages(records, arrays: Dict[str, np.ndarray]
                   ) -> Dict[str, OpPipelineStage]:
    """Stage records → stages (registry-checked), by uid."""
    stage_by_uid: Dict[str, OpPipelineStage] = {}
    for rec in records:
        state = (_decode_param(rec.get("modelState", {}), arrays)
                 if rec.get("isModel") else None)
        stage_by_uid[rec["uid"]] = stage_from_state(
            rec["className"], _decode_param(rec["params"], arrays), state,
            uid=rec["uid"])
    # stages that hold another stage by uid (RecordInsightsLOCO's scored
    # model) re-attach it now that every stage exists
    for stage in stage_by_uid.values():
        if hasattr(stage, "rebind_stages"):
            stage.rebind_stages(stage_by_uid)
    return stage_by_uid


def stage_input_uids(records) -> Dict[str, List[str]]:
    """Stage uid → the input feature uids its record names."""
    return {rec["uid"]: list(rec["inputFeatureUids"]) for rec in records
            if "inputFeatureUids" in rec}


def parent_uids(origin_uid: Optional[str], parents: List[str],
                stage_inputs: Optional[Dict[str, List[str]]] = None
                ) -> List[str]:
    """The inputs of the stage ``origin_uid`` that computes a feature: the
    ones its stage record names (``stage_inputs``, from
    :func:`stage_input_uids`) where there is one, else the feature's
    ``parents``. The save writes a feature's ``parentUids`` by this rule
    and the load wires each stage by it."""
    return list((stage_inputs or {}).get(origin_uid, parents))


def rebuild_features(records, stage_by_uid: Dict[str, OpPipelineStage],
                     stage_inputs: Optional[Dict[str, List[str]]] = None
                     ) -> Dict[str, Feature]:
    """Feature records (topological order) → the wired feature graph,
    each stage wired to :func:`parent_uids`."""
    feat_by_uid: Dict[str, Feature] = {}
    for frec in records:
        stage = stage_by_uid.get(frec["originStageUid"])
        if stage is None:
            raise ValueError(
                f"Feature {frec['name']!r} has unknown origin stage")
        input_uids = parent_uids(stage.uid, frec["parentUids"],
                                 stage_inputs)
        if input_uids:
            parents = [feat_by_uid[u] for u in input_uids]
            if tuple(stage.input_features) != tuple(parents):
                stage.set_input(*parents)
        feat = stage.get_output()
        feat.uid = frec["uid"]
        feat.name = frec["name"]
        feat.is_response = frec["isResponse"]
        feat_by_uid[frec["uid"]] = feat
    return feat_by_uid


def _recover_checkpoint(path: str) -> str:
    """Resolve a checkpoint directory a crash left mid-swap.

    ``workflow._atomic_checkpoint`` renames ``<path>.tmp`` (a complete
    save) over ``<path>``, parking the previous save at ``<path>.old``.
    If the process died between the renames, ``<path>`` is missing but a
    sibling is loadable: ``.tmp`` is preferred (it is complete before any
    rename starts), then ``.old``, and the chosen one is renamed into
    place. MODEL_JSON, written last, marks a complete save.

    In a world of ranks only the coordinator repairs the shared directory
    (one writer). Another rank returns ``path`` at once when no sibling
    is complete (the load then fails downstream); otherwise it waits up
    to 30 s for the repaired target, then reads a complete sibling, which
    nothing renames any more."""
    if os.path.exists(os.path.join(path, MODEL_JSON)):
        return path
    from .parallel.multihost import is_coordinator
    if not is_coordinator():
        if not any(os.path.exists(os.path.join(s, MODEL_JSON))
                   for s in (f"{path}.tmp", f"{path}.old")):
            return path
        for _ in range(60):
            if os.path.exists(os.path.join(path, MODEL_JSON)):
                return path
            time.sleep(0.5)
        sibs = [s for s in (path, f"{path}.tmp", f"{path}.old")
                if os.path.exists(os.path.join(s, MODEL_JSON))]
        return sibs[0] if sibs else path
    for sibling in (f"{path}.tmp", f"{path}.old"):
        if os.path.exists(os.path.join(sibling, MODEL_JSON)):
            if not os.path.exists(path):
                try:
                    os.rename(sibling, path)
                except FileNotFoundError:
                    continue
            return path
    return path


def _atomic_checkpoint(model, directory: str) -> None:
    """Write a checkpoint crash-consistently: save into ``<dir>.tmp``,
    then swap it in by renames (the previous save parked at ``<dir>.old``
    until the swap is done). A crash at any point leaves a loadable
    checkpoint; :func:`_recover_checkpoint` repairs a torn swap. The write
    rides ``resilience.CHECKPOINT_RETRY`` (a transient filesystem failure
    does not kill a long fit) behind the ``checkpoint.write`` fault site;
    the swap carries ``checkpoint.rename``."""
    from . import resilience
    tmp, old = f"{directory}.tmp", f"{directory}.old"
    # adopt a predecessor's mid-swap save first, so the cleanup below only
    # deletes a torn .tmp or a superseded .old, never the only good save
    _recover_checkpoint(directory)

    def save_tmp() -> None:
        resilience.inject("checkpoint.write", directory=directory)
        shutil.rmtree(tmp, ignore_errors=True)
        save_workflow_model(model, tmp, overwrite=True)

    resilience.CHECKPOINT_RETRY.call("checkpoint.write", save_tmp)
    shutil.rmtree(old, ignore_errors=True)
    if os.path.exists(directory):
        os.rename(directory, old)
    resilience.inject("checkpoint.rename", directory=directory)
    os.rename(tmp, directory)
    shutil.rmtree(old, ignore_errors=True)


def _load_weights_npz(npz_path: str) -> Dict[str, np.ndarray]:
    """A weights archive, with a magic check first: a truncated copy or
    torn write fails naming the file."""
    with open(npz_path, "rb") as fh:
        head = fh.read(4)
    # PK\x03\x04: a local file header; PK\x05\x06: an empty archive
    if head[:2] != b"PK":
        raise ValueError(
            f"corrupt model weights at {npz_path!r}: "
            f"{'empty file' if not head else 'bad magic ' + repr(head)} "
            "— the archive is truncated or was not written by np.savez")
    try:
        with np.load(npz_path, allow_pickle=False) as npz:
            return {k: npz[k] for k in npz.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError, ValueError) as e:
        raise ValueError(
            f"corrupt model weights at {npz_path!r}: {type(e).__name__}: "
            f"{e} (truncated archive — re-save or re-copy the model)"
        ) from e


def _read_model_dir(path: str):
    """(model.json document, weight arrays) of the save at ``path``,
    retried when a concurrent re-save replaces the weights mid-read."""
    for attempt in range(3):
        resolved = _recover_checkpoint(path)
        try:
            try:
                with open(os.path.join(resolved, MODEL_JSON)) as fh:
                    doc = json.load(fh)
            except json.JSONDecodeError as e:
                raise ValueError(
                    f"corrupt model at {path!r}: {MODEL_JSON} is not "
                    f"valid JSON ({e})") from e
            if int(doc.get("formatVersion", 1)) > FORMAT_VERSION:
                raise ValueError(
                    f"Model at {path} uses format {doc['formatVersion']}, "
                    f"newer than this library supports ({FORMAT_VERSION})")
            arrays: Dict[str, np.ndarray] = {}
            if "weightsFile" in doc:
                arrays = _load_weights_npz(
                    os.path.join(resolved, doc["weightsFile"]))
            else:                       # format 1: a bare weights.npz
                npz_path = os.path.join(resolved, WEIGHTS_NPZ)
                if os.path.exists(npz_path):
                    arrays = _load_weights_npz(npz_path)
            return doc, arrays
        except FileNotFoundError:
            if attempt == 2:
                raise
            time.sleep(0.25)


def load_workflow_model(path: str):
    """The :class:`~transmogrifai_tpu_torch.workflow.WorkflowModel` saved
    at ``path`` by either package (format 1 or 2)."""
    from .workflow import WorkflowModel
    doc, arrays = _read_model_dir(path)
    stage_by_uid = rebuild_stages(doc["stages"], arrays)
    feat_by_uid = rebuild_features(doc["features"], stage_by_uid,
                                   stage_input_uids(doc["stages"]))
    result_features = [feat_by_uid[u] for u in doc["resultFeatureUids"]]
    fitted = {uid: st for uid, st in stage_by_uid.items()
              if isinstance(st, FittedModel)}
    rff_results = None
    if doc.get("rawFeatureFilterResults"):
        from .filters.raw_feature_filter import RawFeatureFilterResults
        rff_results = RawFeatureFilterResults.from_json(
            doc["rawFeatureFilterResults"])
    model = WorkflowModel(
        result_features=result_features,
        fitted_stages=fitted,
        parameters=doc.get("parameters") or {},
        train_time_s=doc.get("trainTimeSeconds", 0.0),
        rff_results=rff_results,
        fit_stats=sufficient_stats_from_json(
            doc.get("fitSufficientStats") or {}))
    model.uid = doc["uid"]
    return model
