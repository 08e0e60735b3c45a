"""Portable model export: the port of ``transmogrifai_tpu/serving.py``.

A fitted model's device half exports as a ``torch.export`` program,
polymorphic in the batch size (one symbolic ``Dim`` over every block's
row axis), saved with ``torch.export.save``:

* :func:`export_prediction_fn` — the prediction head alone (feature
  vector → prediction, raw prediction, probability), as
  ``prediction_fn.pt2`` beside ``export.json``.
* :func:`export_scoring_fn` — the scoring engine's whole fused chain
  (every vectorizer's ``device_compute``, the combiner, the
  SanityChecker's gather, the scaler, the predictor) as
  ``scoring_fn.pt2`` beside ``scoring_export.json``, and by default a
  program bank of every ladder bucket (``aot.py``). The host half
  (``host_prepare``: hashing, vocabularies) stays host Python; the
  caller hands the loader the prepared blocks.

The metadata carries the JAX package's keys, the plan and state digests
and the environment (torch and CUDA runtime versions, platform, device
name). A loader checks the artifact's recorded size and blake2b digest
before it reads it (a descriptive ``ValueError`` on a missing,
truncated, non-JSON or altered artifact), warns (TMG503) and still loads
on a torch or CUDA version skew, and refuses a device other than the one
the artifact was exported for: the program's constants and device
arguments are bound to it.

Loaders take ``device=None`` (the card) or ``device="cpu"``. Where the
JAX package's artifact needs only jax, this one needs torch and the
registration of ``tmog_torch::predict_trees``, the operator a tree
model's program calls: importing ``transmogrifai_tpu_torch.models._hist``
registers it, and this module imports it.

Not carried over: the telemetry spans and counters (ROADMAP queue A,
A6.8).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from . import aot as aot_mod
from .lint import Finding
from .models import _hist  # noqa: F401  (registers tmog_torch::predict_trees)
from .models.base import resolve_device
from .scoring import BUCKET_MIN

logger = logging.getLogger(__name__)

__all__ = ["export_prediction_fn", "load_prediction_fn",
           "export_scoring_fn", "load_scoring_fn"]

_BLOB = "prediction_fn.pt2"
_META = "export.json"
_SCORE_BLOB = "scoring_fn.pt2"
_SCORE_META = "scoring_export.json"


def _blob_fingerprint(payload: bytes) -> Dict[str, Any]:
    """Integrity fields of the export metadata: the program's byte size
    and a blake2b-128 digest of its bytes."""
    return {"blobBytes": len(payload),
            "blobDigest": hashlib.blake2b(payload, digest_size=16)
                                 .hexdigest()}


def _load_verified_blob(path: str, blob_name: str, meta_name: str
                        ) -> tuple:
    """(meta, program bytes), with a descriptive ``ValueError`` on a
    missing, truncated or corrupt artifact: the metadata's recorded size
    and digest are checked before the bytes reach ``torch.export.load``.
    Metadata without the fingerprint fields skips those checks."""
    meta_path = os.path.join(path, meta_name)
    blob_path = os.path.join(path, blob_name)
    try:
        with open(meta_path) as fh:
            meta = json.load(fh)
    except FileNotFoundError:
        raise ValueError(
            f"no serving artifact at {path!r}: missing {meta_name} "
            "(was this directory written by export_*_fn?)") from None
    except json.JSONDecodeError as e:
        raise ValueError(
            f"corrupt serving artifact at {path!r}: {meta_name} is not "
            f"valid JSON ({e})") from e
    try:
        with open(blob_path, "rb") as fh:
            payload = fh.read()
    except FileNotFoundError:
        raise ValueError(
            f"corrupt serving artifact at {path!r}: {meta_name} present "
            f"but {blob_name} missing") from None
    expect = meta.get("blobBytes")
    if expect is not None:
        try:
            expect = int(expect)
        except (TypeError, ValueError):
            raise ValueError(
                f"corrupt serving artifact at {path!r}: {meta_name} "
                f"records a non-numeric blobBytes ({expect!r})") from None
        if len(payload) != expect:
            raise ValueError(
                f"truncated serving artifact at {path!r}: {blob_name} is "
                f"{len(payload)} bytes, export recorded {expect} (partial "
                "copy or torn write — re-export or re-copy the artifact)")
    digest = meta.get("blobDigest")
    if digest is not None:
        got = hashlib.blake2b(payload, digest_size=16).hexdigest()
        if got != digest:
            raise ValueError(
                f"corrupt serving artifact at {path!r}: {blob_name} "
                f"digest {got} does not match the export's {digest} "
                "(bytes were altered in transit)")
    return meta, payload


def _load_program(meta: Dict[str, Any], payload: bytes, path: str,
                  device: torch.device):
    """The artifact's program, on ``device``: its platform must be the
    one it was exported on."""
    env = meta.get("environment")
    want = env.get("platform") if isinstance(env, dict) else None
    if want is not None and want != device.type:
        raise ValueError(
            f"serving artifact at {path!r} was exported for {want!r}; "
            f"it cannot run on {device.type!r} — export it again there")
    return aot_mod.load_program_file(
        payload, f"corrupt serving artifact at {path!r}").module()


def _batch_dim():
    return torch.export.Dim("b", min=1)


def _feature_dim(model, predictor) -> int:
    vec_feature = predictor.input_features[1]
    vec_stage = model.fitted_stages.get(
        vec_feature.origin_stage.uid if vec_feature.origin_stage else "",
        None)
    width = getattr(vec_stage, "width", None)
    if width is None and hasattr(vec_stage, "keep_indices"):
        width = len(vec_stage.keep_indices)
    if width is None:
        raise ValueError("Cannot infer feature_dim; pass it explicitly")
    return int(width)


class _PredictionHead(torch.nn.Module):
    def __init__(self, predictor):
        super().__init__()
        self._predictor = predictor

    def forward(self, X):
        pred, raw, prob = self._predictor.predict_device(X)
        return {"prediction": pred, "rawPrediction": raw,
                "probability": prob}


def export_prediction_fn(model, path: str, pred_feature=None,
                         feature_dim: Optional[int] = None,
                         device=None) -> Dict[str, Any]:
    """Export the fitted prediction head, f32 [b, feature_dim] → the
    prediction triple, traced on ``device`` (default: the card).

    ``pred_feature`` — the Prediction result feature (default: the first
    Prediction-typed result); ``feature_dim`` — the input width (default:
    the width of the predictor's input stage). Returns the metadata
    written beside the artifact."""
    from .types.feature_types import Prediction

    dev = resolve_device(device)
    if pred_feature is None:
        pred_feature = next(
            (f for f in model.result_features if f.ftype is Prediction),
            None)
        if pred_feature is None:
            raise ValueError("Model has no Prediction result feature")
    predictor = model.stage_of(pred_feature)
    if feature_dim is None:
        feature_dim = _feature_dim(model, predictor)
    head = _PredictionHead(predictor)
    example = torch.zeros((BUCKET_MIN, feature_dim),
                          dtype=torch.float32, device=dev)
    head(example)                       # warm the device tables
    ep = torch.export.export(head, (example,),
                             dynamic_shapes=({0: _batch_dim()},),
                             strict=False)
    payload = aot_mod.save_program(ep)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _BLOB), "wb") as fh:
        fh.write(payload)
    meta = {"featureDim": int(feature_dim),
            "predFeature": pred_feature.name,
            "coverage": "prediction_head",
            "outputs": ["prediction", "rawPrediction", "probability"],
            "environment": aot_mod.environment_fingerprint(dev),
            **_blob_fingerprint(payload)}
    with open(os.path.join(path, _META), "w") as fh:
        json.dump(meta, fh, indent=1)
    return meta


def _to_numpy(v: torch.Tensor) -> np.ndarray:
    return v.detach().to("cpu").numpy()


def load_prediction_fn(path: str, device=None
                       ) -> Callable[[np.ndarray], Dict[str, Any]]:
    """Load an exported head → callable(X [n, d] f32) → dict of
    prediction / rawPrediction / probability arrays, run on ``device``
    (default: the card). A truncated or corrupt artifact raises a
    descriptive ``ValueError``."""
    dev = resolve_device(device)
    meta, payload = _load_verified_blob(path, _BLOB, _META)
    _warn_version_skew(meta, path)
    fn = _load_program(meta, payload, path, dev)

    def call(X: np.ndarray) -> Dict[str, Any]:
        X = np.asarray(X, dtype=np.float32)
        if X.ndim != 2 or X.shape[1] != meta["featureDim"]:
            raise ValueError(
                f"Expected [n, {meta['featureDim']}] input, got {X.shape}")
        out = fn(torch.from_numpy(np.ascontiguousarray(X)).to(dev))
        return {k: _to_numpy(v) for k, v in out.items()}

    return call


def _block_key(spec: Dict[str, Any]) -> str:
    return (f"{spec['uid']}/{spec['name']}" if spec["kind"] == "prepared"
            else spec["name"])


def export_scoring_fn(model, path: str, sample_data,
                      bucket_cap: Optional[int] = None,
                      aot: bool = True,
                      aot_ladder: Optional[List[int]] = None,
                      device=None) -> Dict[str, Any]:
    """Export the whole fused transform → predict chain, traced on
    ``device`` (default: the card).

    Every stage between the prepared host blocks and the result features
    must be fused (the engine's plan must hold the predictor); otherwise
    a ``ValueError`` (:func:`export_prediction_fn` exports the head
    alone). ``sample_data`` (records or a raw ColumnStore) gives one host
    pass for the block manifest and the trace's example. With ``aot``
    (the default) every ladder bucket (or ``aot_ladder``'s) is also
    exported as a static-shape program under ``aot_bank/`` (aot.py);
    without, any earlier bank there is removed. Returns the metadata
    written beside the artifact."""
    from .scoring import ScoringEngine, bucket_ladder

    eng = ScoringEngine(model, device=device, graphs=False,
                        **({"bucket_cap": bucket_cap} if bucket_cap else {}))
    if not eng.covers_prediction:
        raise ValueError(
            "full-chain export needs the predictor inside the fused "
            "program; a host-only stage consumes a device output "
            "(export_prediction_fn covers the head alone)")
    out_names = eng._out_names(results_only=True)
    if not out_names:
        raise ValueError("no fused result features to export")
    manifest = eng.export_manifest(sample_data)
    module = eng.export_callable(manifest, out_names)
    # the trace's example: the sample's blocks, at least BUCKET_MIN rows
    from .workflow import _raw_store
    store = _raw_store(sample_data, eng._raw_features)
    _, prepared, uploads = eng.host_blocks(store)
    n = store.n_rows
    rows = max(n, BUCKET_MIN)
    example = tuple(
        torch.from_numpy(np.ascontiguousarray(eng._pad_rows(
            prepared[s["uid"]][s["name"]] if s["kind"] == "prepared"
            else uploads[s["name"]], n, rows))).to(eng.device)
        for s in manifest)
    module(*example)                    # warm the device tables
    b = _batch_dim()
    ep = torch.export.export(module, example,
                             dynamic_shapes=(tuple({0: b}
                                                   for _ in example),),
                             strict=False)
    payload = aot_mod.save_program(ep)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, _SCORE_BLOB), "wb") as fh:
        fh.write(payload)
    meta = {"coverage": "fused_chain",
            "fusedStages": len(eng._plan),
            "inputs": manifest,
            "resultFeatures": out_names,
            "bucketCap": int(eng.bucket_cap),
            "bucketLadder": bucket_ladder(eng.bucket_cap),
            "planDigest": eng.rewrite_digest(),
            "stateDigest": eng.state_digest(),
            "environment": aot_mod.environment_fingerprint(eng.device),
            **_blob_fingerprint(payload)}
    if aot:
        bank = aot_mod.build_program_bank(eng, manifest, out_names, path,
                                          ladder=aot_ladder)
        meta["aot"] = {"programs": len(bank["programs"]),
                       "bytes": aot_mod.bank_bytes(bank),
                       "bucketLadder": bank["bucketLadder"]}
    else:
        # never leave an earlier export's bank (other weights) beside
        # the fresh artifact
        aot_mod.remove_bank(path)
        meta["aot"] = None
    with open(os.path.join(path, _SCORE_META), "w") as fh:
        json.dump(meta, fh, indent=1)
    return meta


def _warn_version_skew(meta: Dict[str, Any], path: str) -> None:
    """Compare the artifact's recorded torch and CUDA runtime versions to
    this process's and warn (TMG503) on a difference: the program should
    still load, so skew is a risk note, not an error. Metadata without an
    ``environment`` skips the check."""
    want = meta.get("environment")
    if not isinstance(want, dict):
        return
    env = {"torch": torch.__version__, "cuda": torch.version.cuda}
    skew = {k: (want.get(k), env[k]) for k in ("torch", "cuda")
            if want.get(k) is not None and want.get(k) != env[k]}
    if not skew:
        return
    detail = ", ".join(f"{k}: exported {a!r} / running {b!r}"
                       for k, (a, b) in sorted(skew.items()))
    f = Finding("TMG503",
                f"serving artifact version skew ({detail}) — the program "
                "should still load, but re-export to clear the risk",
                location=path)
    logger.warning("serving: %s", f.format())


def load_scoring_fn(path: str, prefer_bank: bool = True, device=None
                    ) -> Callable[[Dict[str, np.ndarray]],
                                  Dict[str, np.ndarray]]:
    """Load a full-chain artifact → callable({block key: array}) → dict of
    output arrays, run on ``device`` (default: the card). Block keys are
    ``"<stage uid>/<block name>"`` for prepared blocks and the column
    name for direct uploads (``meta["inputs"]``); the caller supplies the
    host-prepared blocks, all with one batch size.

    With ``prefer_bank`` and a compatible program bank beside the
    artifact, a request is zero-padded to its ladder bucket and runs that
    bucket's banked program. A bucket the bank lacks, a bank that is
    incompatible, stale or corrupt (TMG501/502 findings, logged), and a
    batch past the bank's cap run the batch-polymorphic program, on the
    same device."""
    from .scoring import bucket_for, flatten_outputs

    dev = resolve_device(device)
    meta, payload = _load_verified_blob(path, _SCORE_BLOB, _SCORE_META)
    _warn_version_skew(meta, path)
    fn = _load_program(meta, payload, path, dev)
    manifest: List[Dict[str, Any]] = meta["inputs"]

    bank_programs: Dict[int, Any] = {}
    bank_cap = 0
    if prefer_bank:
        bank_manifest, bank_programs, findings = \
            aot_mod.load_flat_programs(
                path, expect_digests={
                    "planDigest": meta.get("planDigest"),
                    "stateDigest": meta.get("stateDigest")},
                device=dev)
        for f in findings:
            logger.warning("serving: %s", f.format())
        if bank_programs:
            bank_cap = int(bank_manifest.get("bucketCap", 0))

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def _bank_call(args: List[np.ndarray], n: int,
                   bucket: int) -> Dict[str, np.ndarray]:
        prepared: Dict[str, Dict[str, Any]] = {}
        uploads: Dict[str, Any] = {}
        for spec, a in zip(manifest, args):
            if bucket != n:
                pad = np.zeros((bucket - n,) + a.shape[1:], dtype=a.dtype)
                a = np.concatenate([a, pad], axis=0)
            if spec["kind"] == "prepared":
                prepared.setdefault(spec["uid"], {})[spec["name"]] = put(a)
            else:
                uploads[spec["name"]] = put(a)
        outs = flatten_outputs(bank_programs[bucket](prepared, uploads))
        return {k: _to_numpy(v)[:n] for k, v in outs.items()}

    def call(blocks: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        args = []
        for spec in manifest:
            key = _block_key(spec)
            if key not in blocks:
                raise ValueError(f"missing input block {key!r}")
            args.append(np.asarray(blocks[key], dtype=spec["dtype"]))
        ns = {a.shape[0] for a in args}
        if len(ns) > 1:
            raise ValueError(f"inconsistent batch sizes across blocks: {ns}")
        if bank_programs and args:
            n = args[0].shape[0]
            bucket = bucket_for(n, bank_cap)
            if n <= bank_cap and bucket in bank_programs:
                return _bank_call(args, n, bucket)
        out = fn(*[put(a) for a in args])
        return {k: _to_numpy(v) for k, v in out.items()}

    call.meta = meta
    call.bank_buckets = sorted(bank_programs)
    return call
