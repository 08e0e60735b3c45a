"""Feature-graph JSON (de)serialization, the FeatureJsonHelper analog; the
port of ``transmogrifai_tpu/feature_json.py``.

Parity: ``features/.../FeatureJsonHelper.scala``: an unfitted feature DAG
(features, their origin stages and the wiring) round-trips through JSON,
to version feature definitions or ship them between services, apart from
any trained model. It reuses ``model_io``'s stage and feature records, so
the document is the JAX package's: either package reads the other's.
Numpy ctor params are embedded as lists (a feature graph carries no
fitted weights).
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

from . import model_io
from .features import Feature

__all__ = ["features_to_json", "features_from_json"]


def features_to_json(result_features: Sequence[Feature]) -> Dict[str, Any]:
    arrays: Dict[str, np.ndarray] = {}
    feats = model_io._topo_features(result_features)
    stage_records = model_io.collect_stage_records(feats, arrays)
    return {
        "features": [model_io._feature_record(f) for f in feats],
        "resultFeatureUids": [f.uid for f in result_features],
        "stages": stage_records,
        "arrays": {k: v.tolist() for k, v in arrays.items()},
    }


def features_from_json(doc: Dict[str, Any]) -> List[Feature]:
    """Rebuild the result features (and their whole ancestor graph)."""
    arrays = {k: np.asarray(v) for k, v in (doc.get("arrays") or {}).items()}
    stage_by_uid = model_io.rebuild_stages(doc["stages"], arrays)
    feat_by_uid = model_io.rebuild_features(doc["features"], stage_by_uid)
    return [feat_by_uid[u] for u in doc["resultFeatureUids"]]
