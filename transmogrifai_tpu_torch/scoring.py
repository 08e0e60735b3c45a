"""Batched scoring engine — one device program per model and bucket; the
port of ``transmogrifai_tpu/scoring.py``.

``WorkflowModel.transform`` applies one layer at a time, crossing between
host and device at each. The engine instead runs a fitted model's
device-capable chain as one program: every vectorizer's
``device_compute``, the combiner's concatenation, the SanityChecker's
column gather, the vector standard scaler's affine map and the
predictor's ``predict_device``. A scoring batch
crosses once: prepared host blocks in, result columns out.

* **Bucketed batch shapes.** A batch is zero-padded to a power-of-two
  ladder (``bucket_ladder``) and batches past the cap run in chunks of
  the largest bucket, the last chunk padded to its own bucket. Padding is
  safe because every fused stage is row-independent; the padded rows are
  sliced off.
* **One CUDA graph per program.** Programs live in a bounded LRU keyed by
  (block shapes and dtypes, outputs): at most one per bucket and output
  set. On the card, a program's first call runs eagerly as a warm-up
  (it also uploads the model's tables once, ``models.base.device_table``),
  the second captures the program as a CUDA graph, and every later call
  copies the prepared blocks into the graph's static input buffers and
  replays it. The kernels launch on the current stream, which the capture
  records; nothing in the program reads back to the host. A capture that
  fails raises: the engine never drops to eager execution or to the CPU.
  On the CPU (the tests) every call runs the program eagerly.
* **Overlapped streaming.** :func:`stream_score_overlapped` prepares batch
  k+1 on a worker thread while batch k runs on the card.

Host/device split: a fitted stage is device-capable when the engine knows
its array form — a ``VectorizerModel`` (``host_prepare`` →
``device_compute``; the map vectorizers and bucketizers among them), the
``VectorsCombiner``, the ``SanityCheckerModel``, the
``StandardScalerModel``, any ``PredictorModel`` with ``predict_device`` (a selected model's label
mapping included) and the ``PredictionDeIndexerModel``, whose label
codes the program computes and whose strings are looked up on the host
after the pull. The fused set is the
largest consumer-closed subset of device-capable stages: one whose output
a host stage reads is demoted to the host. Host stages (the DSL's row
transformers, the map key filters and extractors, the term frequencies
and IDF, stop words, Jaccard) run first; their columns feed
``host_prepare`` and the direct vector uploads.

* **The planner's rewrites.** An attached ``planner.ExecutionPlan``
  (``plan=``; ``WorkflowModel.attach_plan``) carries two rewrites, both
  bitwise equal to the unplanned program by construction. Verified CSE
  merges: a structurally identical twin's output fans out from the kept
  vectorizer's computation, and its ``host_prepare`` and
  ``device_compute`` never run. Dead-column pruning: columns the
  SanityChecker drops before any sink are gathered away right after
  their ``device_compute`` (a gather of a concatenation equals the
  concatenation of the gathers), the select's indices remapped into the
  pruned coordinates and a scaler's constants sliced to the surviving
  columns. Pruning switches off for a program whose outputs it would
  narrow (the transform path), and wholly (``_disable``, logged) where a
  narrowed value would reach a stage that cannot remap it. ``enabled()``
  follows the plan's measured ``engine_tier``.
* **Export.** ``export_manifest``, ``program_callable``,
  ``export_callable``, ``program_key`` / ``preload`` and the
  ``rewrite_digest`` / ``state_digest`` identities are what
  ``serving.py`` exports (``torch.export``) and ``aot.py`` banks and
  preloads; a preload is not a build, so ``compile_count`` stays 0.

Not carried over from the JAX package: the circuit breaker to the host
tier, the link-bandwidth gate, mesh sharding and telemetry spans.
"""
from __future__ import annotations

import hashlib
import logging
import threading
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .columns import (ColumnStore, GeoColumn, MapColumn, NumericColumn,
                      PredictionColumn, RaggedColumn, TextColumn,
                      TextListColumn, TextSetColumn, VectorColumn,
                      column_of_empty)
from .models import _hist
from .models.base import PredictorModel, device_table, resolve_device
from .models.selector import SelectedModel
from .ops.indexers import PredictionDeIndexerModel
from .ops.sanity_checker import SanityCheckerModel
from .ops.vectorizer_base import VectorizerModel, canonicalize_prepared
from .ops.vectors import StandardScalerModel, VectorsCombiner
from .types.feature_types import OPVector
from .vector_metadata import VectorMetadata

logger = logging.getLogger(__name__)

__all__ = ["ScoringEngine", "bucket_for", "bucket_ladder",
           "build_fused_plan", "stream_score_overlapped", "flatten_outputs",
           "SCORING_MIN_ROWS", "DEFAULT_BUCKET_CAP", "BUCKET_MIN"]

#: smallest padded batch
BUCKET_MIN = 8

#: the largest bucket; bigger batches run in chunks of it
DEFAULT_BUCKET_CAP = 8192

#: ``WorkflowModel.score`` / ``transform`` / ``evaluate`` take the engine
#: from this many rows (``engine="auto"``); ``engine=True`` or direct
#: engine use ignores it
SCORING_MIN_ROWS = 2048

#: programs (CUDA graphs on the card) kept per engine, least recently
#: used dropped first; the ladder bounds the live ones in practice
PROGRAM_CACHE_CAP = 32


def bucket_for(n: int, cap: int = DEFAULT_BUCKET_CAP) -> int:
    """Smallest ladder bucket holding ``n`` rows (a non-power-of-two cap
    is itself the top rung, so the result never exceeds it)."""
    if n <= BUCKET_MIN:
        return BUCKET_MIN
    if n >= cap:
        return cap
    return min(cap, 1 << (n - 1).bit_length())


def bucket_ladder(cap: int = DEFAULT_BUCKET_CAP) -> List[int]:
    """The full bucket ladder: powers of two from BUCKET_MIN to cap."""
    out = [BUCKET_MIN]
    while out[-1] < cap:
        out.append(min(out[-1] * 2, cap))
    return out


class _FusedStage:
    """One device step of the program."""

    __slots__ = ("model", "kind", "out", "ins")

    def __init__(self, model, kind: str, out: str, ins: List[str]):
        self.model = model
        self.kind = kind      # vec | combine | select | scale | predict
        #                       | deindex
        self.out = out
        self.ins = ins        # env / upload names read (no label slots)


def _has_predict_device(m) -> bool:
    """True when ``m.predict_device`` is implemented (not the
    PredictorModel stub), through a SelectedModel to its inner model."""
    if isinstance(m, SelectedModel):
        return m.inner is not None and _has_predict_device(m.inner)
    return type(m).predict_device is not PredictorModel.predict_device


def _classify(m) -> Optional[str]:
    """Device-capable kind of a fitted stage, or None (host)."""
    if isinstance(m, VectorizerModel):
        return "vec"
    if isinstance(m, VectorsCombiner):
        return "combine"
    if isinstance(m, SanityCheckerModel):
        return "select"
    if isinstance(m, StandardScalerModel):
        return "scale"
    if isinstance(m, PredictorModel) and _has_predict_device(m):
        return "predict"
    if isinstance(m, PredictionDeIndexerModel):
        return "deindex"
    return None


def build_fused_plan(layers) -> Tuple[List[_FusedStage], List[List[Any]]]:
    """Classify a resolved DAG's stages and take the largest
    consumer-closed fused set: ``(plan items, host layers)``."""
    flat = [m for layer in layers for m in layer]
    kinds = {m.uid: _classify(m) for m in flat}
    consumers: Dict[str, List[Any]] = {}
    for m in flat:
        for f in m.input_features:
            consumers.setdefault(f.name, []).append(m)
    # shallow → deep: a device-capable stage stays fused only if every
    # consumer of its output is fused
    fused: Dict[str, bool] = {}
    for m in reversed(flat):
        ok = kinds[m.uid] is not None
        if ok:
            ok = all(fused.get(c.uid, False)
                     for c in consumers.get(m.output_name, []))
        fused[m.uid] = ok
    plan: List[_FusedStage] = []
    host_layers: List[List[Any]] = []
    for layer in layers:
        host_row = []
        for m in layer:
            if not fused[m.uid]:
                host_row.append(m)
                continue
            kind = kinds[m.uid]
            if kind == "vec":
                ins: List[str] = []
            elif kind in ("select", "predict", "deindex"):
                # (label, vector or prediction) arity: only the second
                # input crosses
                ins = [m.input_features[1].name]
            else:
                ins = [f.name for f in m.input_features]
            plan.append(_FusedStage(m, kind, m.output_name, ins))
        host_layers.append(host_row)
    return plan, host_layers


class _PreparedBatch:
    """Host half of a scoring call (:meth:`ScoringEngine.prepare_batch`):
    per chunk, (host store, prepared blocks, uploads, rows, bucket), the
    blocks padded to the bucket."""

    __slots__ = ("chunks", "n_rows")

    def __init__(self, chunks, n_rows: int):
        self.chunks = chunks
        self.n_rows = n_rows


class _Program:
    """One cached program: its calls so far and, on the card from the
    second call on, its CUDA graph with the graph's static input and
    output tensors and the kernel launches one replay makes. ``fn`` is a
    preloaded program (:meth:`ScoringEngine.preload`), run in place of
    the engine's own body."""

    __slots__ = ("bucket", "calls", "graph", "inputs", "outputs",
                 "launches", "fn")

    def __init__(self, bucket: int, fn=None):
        self.bucket = bucket
        self.fn = fn
        self.calls = 0
        self.graph = None
        self.inputs = None
        self.outputs = None
        self.launches: Dict[str, int] = {}


class ScoringEngine:
    """Batched scorer for one fitted ``WorkflowModel`` on one device.

    Build once per model and device (``model.scoring_engine(device)``
    keeps it); every ``score_store`` / ``transform_store`` call reuses the
    plan and the programs. ``graphs=False`` runs every call eagerly on the
    card (the warm-up's path), which is what the captured graphs are
    held against. ``plan`` is the ``planner.ExecutionPlan`` the engine
    follows (None: unplanned)."""

    def __init__(self, model, device=None,
                 bucket_cap: int = DEFAULT_BUCKET_CAP,
                 graphs: Optional[bool] = None, plan=None):
        self.model = model
        self.device = resolve_device(device)
        self.bucket_cap = int(bucket_cap)
        on_card = self.device.type == "cuda"
        self.graphs = on_card if graphs is None else bool(graphs)
        if self.graphs and not on_card:
            raise ValueError("CUDA graphs need a CUDA device")
        self._programs: "OrderedDict[Tuple, _Program]" = OrderedDict()
        self._compile_count = 0
        self._graph_count = 0
        self._lock = threading.Lock()
        #: repeat calls on the same ColumnStore (score → evaluate) skip the
        #: host half; weakref-checked identity keys
        self._prep_cache: "OrderedDict[Tuple, Tuple[Any, _PreparedBatch]]" \
            = OrderedDict()
        from .workflow import _raw_features_of
        layers = model._resolved_dag()
        self._plan, self._host_layers = build_fused_plan(layers)
        produced = {it.out for it in self._plan}
        self._upload_names: List[str] = []
        for it in self._plan:
            for nm in it.ins:
                if nm not in produced and nm not in self._upload_names:
                    self._upload_names.append(nm)
        self._fused_out = produced
        self._by_out = {it.out: it for it in self._plan}
        self._result_names = [f.name for f in model.result_features]
        self._raw_features = _raw_features_of(model.result_features)
        self._exec_plan = plan
        self._apply_exec_plan()

    # -- the planner's rewrites (planner.py) -------------------------------
    def _apply_exec_plan(self) -> None:
        """The attached plan as program rewrites: CSE output aliases, each
        pruned vectorizer's live columns, the select indices remapped
        into pruned coordinates, the scalers' constant slices, and the
        measured tier ``enabled()`` reads."""
        self._cse_alias: Dict[str, str] = {}
        self._prune: Dict[str, np.ndarray] = {}
        self._prune_affected: set = set()
        self._select_keep_remap: Dict[str, np.ndarray] = {}
        self._scale_slice: Dict[str, np.ndarray] = {}
        plan = self._exec_plan
        self._plan_tier = getattr(plan, "engine_tier", None)
        if plan is None:
            return
        by_uid = {it.model.uid: it for it in self._plan}
        cse_groups: List[List[str]] = []
        for m in plan.cse:
            kept = by_uid.get(m.get("kept"))
            if kept is None or kept.kind != "vec":
                continue
            members = [kept.model.uid]
            for uid in m.get("dropped", ()):
                it = by_uid.get(uid)
                if it is not None and it.kind == "vec" \
                        and it.out != kept.out:
                    self._cse_alias[it.out] = kept.out
                    members.append(uid)
            if len(members) > 1:
                cse_groups.append(members)
        for uid, live in sorted(plan.prune.items()):
            it = by_uid.get(uid)
            w = plan.widths.get(uid)
            if it is None or it.kind != "vec" or not w:
                continue
            live = np.asarray(live, dtype=np.int64)
            if live.size and live.size < int(w) \
                    and int(live.max()) < int(w) and int(live.min()) >= 0:
                self._prune[uid] = live
        # CSE and pruning: an aliased output is the kept computation, so
        # every member of a merge group carries one live set, the union
        # (a fully live member means no pruning for the group)
        for members in cse_groups:
            lives = [self._prune.get(u) for u in members]
            if all(lv is None for lv in lives):
                continue
            w = by_uid[members[0]].model.vector_metadata().size
            union: Optional[np.ndarray] = None
            if all(lv is not None for lv in lives):
                union = np.asarray(
                    sorted(set(int(j) for lv in lives for j in lv)),
                    dtype=np.int64)
                if union.size >= w:
                    union = None
            for u in members:
                if union is None:
                    self._prune.pop(u, None)
                else:
                    self._prune[u] = union
        if not self._prune:
            return
        affected = {by_uid[uid].out for uid in self._prune}
        for it in self._plan:
            if it.kind in ("combine", "scale") \
                    and any(nm in affected for nm in it.ins):
                affected.add(it.out)
        self._prune_affected = affected

        def _disable(reason: str, uid: str) -> None:
            # a designed routing, not a fallback: this plan's pruning
            # cannot be applied to this DAG, so the program is unpruned
            logger.warning("planner pruning disabled: %s (%s)", reason,
                           uid)
            self._prune = {}
            self._prune_affected = set()
            self._select_keep_remap = {}
            self._scale_slice = {}

        for it in self._plan:
            # only select, scale and combine understand a narrowed input
            if it.kind not in ("select", "scale", "combine") \
                    and any(nm in affected for nm in it.ins):
                return _disable("a non-remappable stage consumes a "
                                "pruned value", it.model.uid)
        for it in self._plan:
            if it.kind == "scale" and it.ins[0] in affected:
                # the scaler's fitted mean and std are full width: slice
                # them to the input's surviving columns
                o2n = self._old_to_new(it.ins[0])
                if o2n is None:
                    return _disable("unresolvable width under a "
                                    "scaler", it.model.uid)
                self._scale_slice[it.model.uid] = np.nonzero(o2n >= 0)[0]
            if it.kind != "select" or it.ins[0] not in affected:
                continue
            o2n = self._old_to_new(it.ins[0])
            keep = np.asarray(it.model.keep_indices, dtype=np.int64)
            remap = (None if o2n is None
                     or keep.size and int(keep.max()) >= o2n.size
                     else o2n[keep])
            if remap is None or (remap < 0).any():
                # a kept column the liveness pass marked dead (or an
                # unresolvable width): never risk a wrong gather
                return _disable("select keeps a column the liveness "
                                "pass marked dead", it.model.uid)
            self._select_keep_remap[it.model.uid] = remap

    def _in_width(self, name: str) -> Optional[int]:
        it = self._by_out.get(name)
        if it is None:
            return None                      # an upload: width unknown
        if it.kind == "vec":
            return it.model.vector_metadata().size
        if it.kind == "combine":
            ws = [self._in_width(nm) for nm in it.ins]
            return sum(ws) if all(w is not None for w in ws) else None
        if it.kind == "select":
            return len(it.model.keep_indices)
        if it.kind == "scale":
            return self._in_width(it.ins[0])
        return None

    def _old_to_new(self, name: str) -> Optional[np.ndarray]:
        """Old → pruned column index map of a fused value (−1: dead), or
        None when pruning does not narrow it."""
        it = self._by_out.get(name)
        if it is None:
            return None
        if it.kind == "vec":
            live = self._prune.get(it.model.uid)
            if live is None:
                return None
            o2n = np.full(it.model.vector_metadata().size, -1,
                          dtype=np.int64)
            o2n[live] = np.arange(live.size, dtype=np.int64)
            return o2n
        if it.kind == "combine":
            parts = []
            any_pruned = False
            new_off = 0
            for nm in it.ins:
                sub = self._old_to_new(nm)
                w = self._in_width(nm)
                if w is None:
                    return None              # unresolvable width
                if sub is None:
                    sub = np.arange(w, dtype=np.int64)
                else:
                    any_pruned = True
                parts.append(np.where(sub >= 0, sub + new_off, -1))
                new_off += int((sub >= 0).sum())
            return np.concatenate(parts) if any_pruned else None
        if it.kind == "scale":
            return self._old_to_new(it.ins[0])
        return None                # select outputs are never pruned

    def _active_prune(self, out_names) -> Optional[Dict[str, np.ndarray]]:
        """The prune map of a program pulling ``out_names``: None when a
        requested output would be narrowed (the transform path
        materializes every column; scoring prunes)."""
        if not self._prune:
            return None
        if any(nm in self._prune_affected for nm in out_names):
            return None
        return self._prune

    # -- introspection -----------------------------------------------------
    def enabled(self) -> bool:
        """The engine runs: something is fused and the attached plan's
        measured tier, if any, is not "host"."""
        return bool(self._plan) and self._plan_tier != "host"

    @property
    def pruned_columns(self) -> int:
        """Columns the planned scoring program gathers away."""
        widths = {it.model.uid: it.model.vector_metadata().size
                  for it in self._plan if it.kind == "vec"}
        return int(sum(widths[uid] - len(live)
                       for uid, live in self._prune.items()))

    @property
    def cse_aliases(self) -> Dict[str, str]:
        """{dropped twin's output: kept output} of the applied merges."""
        return dict(self._cse_alias)

    @property
    def covers_prediction(self) -> bool:
        """A predictor is inside the fused program."""
        return any(it.kind == "predict" for it in self._plan)

    @property
    def compile_count(self) -> int:
        """Programs built so far (one per new key): the ladder guard."""
        return self._compile_count

    @property
    def graphs_captured(self) -> int:
        return self._graph_count

    def programs(self) -> List[Tuple]:
        """The live program keys, least recently used first."""
        with self._lock:
            return list(self._programs.keys())

    def buckets_used(self) -> List[int]:
        """The buckets of the live programs."""
        with self._lock:
            return sorted({p.bucket for p in self._programs.values()})

    def program_budget(self) -> int:
        """Most programs the ladder permits per output set."""
        return len(bucket_ladder(self.bucket_cap))

    # -- host half ---------------------------------------------------------
    def host_blocks(self, store: ColumnStore):
        """Every host stage, then every fused vectorizer's canonicalized
        ``host_prepare`` and the direct vector uploads:
        (host store, prepared, uploads), unpadded."""
        from .workflow import _device_kw
        for layer in self._host_layers:
            for m in layer:
                store = m.transform(store, **_device_kw(m, self.device))
        # a CSE-aliased vectorizer contributes no blocks: its output fans
        # out from the kept twin's computation
        prepared = {it.model.uid: canonicalize_prepared(
            it.model.host_prepare(store))
            for it in self._plan
            if it.kind == "vec" and it.out not in self._cse_alias}
        uploads = {nm: np.asarray(store[nm].values)
                   for nm in self._upload_names}
        return store, prepared, uploads

    @staticmethod
    def _pad_rows(a: np.ndarray, n: int, bucket: int) -> np.ndarray:
        """Zero-pad the leading (row) axis from n to bucket; blocks whose
        leading dim is not the row count (fitted constants) pass."""
        a = np.asarray(a)
        if a.ndim == 0 or a.shape[0] != n or n == bucket:
            return a
        pad = np.zeros((bucket - n,) + a.shape[1:], dtype=a.dtype)
        return np.concatenate([a, pad], axis=0)

    def prepare_batch(self, data, use_cache: bool = True) -> _PreparedBatch:
        """Host half of a scoring call, padded to the ladder: host stages,
        ``host_prepare`` and padding, chunk by chunk (numpy and Python
        only, so it may run on a worker thread). Re-scoring the same
        ColumnStore object reuses its prepared blocks (``use_cache``)."""
        from .workflow import _raw_store
        cache_key = None
        if use_cache and isinstance(data, ColumnStore):
            cache_key = (id(data), data.n_rows)
            with self._lock:
                hit = self._prep_cache.get(cache_key)
            if hit is not None and hit[0]() is data:
                return hit[1]
        store = _raw_store(data, self._raw_features)
        n_total = store.n_rows
        chunks = []
        for lo in range(0, max(n_total, 1), self.bucket_cap):
            sub = store
            if n_total > self.bucket_cap:
                sub = store.take(np.arange(lo, min(lo + self.bucket_cap,
                                                   n_total)))
            n = sub.n_rows
            bucket = bucket_for(n, self.bucket_cap)
            host_store, prepared, uploads = self.host_blocks(sub)
            prepared = {uid: {k: self._pad_rows(v, n, bucket)
                              for k, v in blocks.items()}
                        for uid, blocks in prepared.items()}
            uploads = {k: self._pad_rows(v, n, bucket)
                       for k, v in uploads.items()}
            chunks.append((host_store, prepared, uploads, n, bucket))
        pb = _PreparedBatch(chunks, n_total)
        if cache_key is not None:
            with self._lock:
                self._prep_cache[cache_key] = (weakref.ref(data), pb)
                while len(self._prep_cache) > 4:
                    self._prep_cache.popitem(last=False)
        return pb

    # -- device program ----------------------------------------------------
    def _signature(self, prepared, uploads, out_names) -> Tuple:
        sig = []
        for uid in sorted(prepared):
            for k in sorted(prepared[uid]):
                a = np.asarray(prepared[uid][k])
                sig.append((uid, k, a.shape, str(a.dtype)))
        for k in sorted(uploads):
            a = np.asarray(uploads[k])
            sig.append(("", k, a.shape, str(a.dtype)))
        return tuple(sig), tuple(out_names)

    def _program(self, key: Tuple, bucket: int) -> _Program:
        with self._lock:
            prog = self._programs.pop(key, None)
            if prog is None:
                prog = _Program(bucket)
                self._compile_count += 1
            self._programs[key] = prog          # most recently used
            self._evict_locked()
        return prog

    def _evict_locked(self) -> None:
        """Drop the least recently used programs past the cap (the caller
        holds ``self._lock``)."""
        while len(self._programs) > PROGRAM_CACHE_CAP:
            self._programs.popitem(last=False)

    def _body(self, prepared: Dict[str, Dict[str, torch.Tensor]],
              uploads: Dict[str, torch.Tensor], out_names,
              prune: Optional[Dict[str, np.ndarray]] = None
              ) -> Dict[str, Any]:
        """The fused program on device tensors, with the plan's rewrites
        (``prune``: :meth:`_active_prune`). Vectors leave each stage in
        f32, as the layer path's columns hold them; no value is read back
        to the host, so the body can be captured."""
        env: Dict[str, Any] = dict(uploads)
        for it in self._plan:
            m = it.model
            alias = self._cse_alias.get(it.out)
            if alias is not None:
                # CSE fan-out: the twin's output is the kept computation
                env[it.out] = env[alias]
            elif it.kind == "vec":
                v = m.device_compute(prepared[m.uid]).to(torch.float32)
                if prune is not None and m.uid in prune:
                    # dead columns gathered away at the producer
                    v = v.index_select(1, device_table(
                        self, f"prune:{m.uid}", lambda u=m.uid: prune[u],
                        v.device))
                env[it.out] = v
            elif it.kind == "combine":
                env[it.out] = torch.cat([env[nm] for nm in it.ins], dim=1)
            elif it.kind == "select":
                x = env[it.ins[0]]
                if prune is not None and m.uid in self._select_keep_remap:
                    keep = device_table(
                        self, f"keep:{m.uid}",
                        lambda u=m.uid: self._select_keep_remap[u],
                        x.device)
                    env[it.out] = x.index_select(1, keep)
                elif m.keep_indices == list(range(x.shape[1])):
                    env[it.out] = x
                else:
                    keep = device_table(m, "keep_indices", lambda m=m:
                                        np.asarray(m.keep_indices,
                                                   dtype=np.int64),
                                        x.device)
                    env[it.out] = x.index_select(1, keep)
            elif it.kind == "scale":
                x = env[it.ins[0]]
                if prune is not None and m.uid in self._scale_slice:
                    # a pruned input: the fitted constants sliced to the
                    # surviving columns, the affine of scale_device
                    sl = self._scale_slice[m.uid]
                    mean = device_table(self, f"mean:{m.uid}",
                                        lambda m=m: m.mean[sl], x.device)
                    std = device_table(self, f"std:{m.uid}",
                                       lambda m=m: m.std[sl], x.device)
                    env[it.out] = (x - mean[None, :]) / std[None, :]
                else:
                    env[it.out] = m.scale_device(x)
            elif it.kind == "predict":
                env[it.out] = m.predict_device(env[it.ins[0]])
            else:                                        # deindex
                env[it.out] = m.codes_device(env[it.ins[0]][0])
        return {nm: env[nm] for nm in out_names}

    def _upload(self, prepared, uploads):
        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        return ({uid: {k: put(v) for k, v in blocks.items()}
                 for uid, blocks in prepared.items()},
                {k: put(v) for k, v in uploads.items()})

    def _capture(self, prog: _Program, body, prepared, uploads,
                 bucket: int) -> None:
        """Capture the program as a CUDA graph over static input buffers
        holding this chunk's blocks. The wrappers count the launches they
        record; a capture launches nothing, so those counts are taken back
        and added again at each replay."""
        ins = self._upload(prepared, uploads)
        before = dict(_hist.KERNEL_LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(graph):
                outs = body(*ins)
        except Exception as e:
            raise RuntimeError(
                f"scoring engine: CUDA graph capture failed at bucket "
                f"{bucket} ({type(e).__name__}: {e})") from e
        finally:
            launches = {k: v - before[k]
                        for k, v in _hist.KERNEL_LAUNCHES.items()}
            _hist.KERNEL_LAUNCHES.update(before)
        prog.graph, prog.inputs, prog.outputs = graph, ins, outs
        prog.launches = {k: v for k, v in launches.items() if v}
        self._graph_count += 1

    def _replay(self, prog: _Program, prepared, uploads) -> Dict[str, Any]:
        ins_p, ins_u = prog.inputs
        for uid, blocks in prepared.items():
            for k, v in blocks.items():
                ins_p[uid][k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        for k, v in uploads.items():
            ins_u[k].copy_(torch.from_numpy(np.ascontiguousarray(v)))
        prog.graph.replay()
        _hist.count_graph_replay(prog.launches)
        return prog.outputs

    def _device_outputs(self, prepared, uploads, out_names, bucket: int):
        prog = self._program(self.program_key(prepared, uploads, out_names),
                             bucket)
        body = prog.fn or self.program_callable(out_names)
        if not self.graphs or prog.calls == 0:
            outs = body(*self._upload(prepared, uploads))
        else:
            if prog.graph is None:
                self._capture(prog, body, prepared, uploads, bucket)
            outs = self._replay(prog, prepared, uploads)
        prog.calls += 1
        return outs

    # -- output wiring -----------------------------------------------------
    def _out_names(self, results_only: bool) -> List[str]:
        if results_only:
            return [nm for nm in self._result_names if nm in self._fused_out]
        return [it.out for it in self._plan]

    def _width_env(self, store) -> Dict[str, Optional[int]]:
        """Column count of every fused value, from the model state and
        the uploads (None: unknown)."""
        w: Dict[str, Optional[int]] = {}
        for nm in self._upload_names:
            vals = getattr(store[nm], "values", None) if nm in store else None
            w[nm] = (int(vals.shape[1])
                     if vals is not None and np.ndim(vals) == 2 else None)
        for it in self._plan:
            if it.kind == "vec":
                w[it.out] = it.model.vector_metadata().size
            elif it.kind == "combine":
                ins = [w.get(nm) for nm in it.ins]
                w[it.out] = (sum(ins) if all(x is not None for x in ins)
                             else None)
            elif it.kind == "select":
                w[it.out] = len(it.model.keep_indices)
            elif it.kind == "scale":
                w[it.out] = w.get(it.ins[0])
            else:
                w[it.out] = None
        return w

    def _meta_for(self, it: _FusedStage, store, meta_env, width_env):
        """The vector metadata the layer path's stage would attach."""
        def in_meta(nm):
            if nm in meta_env:
                return meta_env[nm]
            return getattr(store[nm] if nm in store else None,
                           "metadata", None)

        if it.kind == "vec":
            return it.model.vector_metadata()
        if it.kind == "combine":
            metas = [in_meta(nm) or VectorMetadata(f.name, [])
                     for f, nm in zip(it.model.input_features, it.ins)]
            meta = VectorMetadata.flatten(it.out, metas)
            width = width_env.get(it.out)
            return None if width is not None and meta.size != width \
                else meta
        if it.kind == "select":
            meta = in_meta(it.ins[0])
            if meta is None:
                return None
            meta = meta.select(it.model.keep_indices)
            meta.name = it.out
            return meta
        if it.kind == "scale":
            return in_meta(it.ins[0])
        return None

    def run_batch(self, prep: _PreparedBatch, results_only: bool = True,
                  keep: Sequence[str] = ()) -> ColumnStore:
        """Device half: one program run and one pull per chunk, then the
        columns; chunks are stitched in order. With ``results_only``, a
        batch of several chunks keeps the result columns and the host
        columns named in ``keep``."""
        out_names = self._out_names(results_only)
        stores = []
        for host_store, prepared, uploads, n, bucket in prep.chunks:
            outs = (self._device_outputs(prepared, uploads, out_names,
                                         bucket) if out_names else {})
            store = host_store
            meta_env: Dict[str, Any] = {}
            if not results_only:
                width_env = self._width_env(host_store)
                for it in self._plan:
                    meta_env[it.out] = self._meta_for(it, host_store,
                                                      meta_env, width_env)
            for nm in out_names:
                val = outs[nm]
                kind = self._by_out[nm].kind
                if kind == "predict":
                    pred, raw, prob = (v[:n].to("cpu", torch.float64).numpy()
                                       for v in val)
                    col = PredictionColumn(pred, raw, prob)
                elif kind == "deindex":
                    col = self._by_out[nm].model.label_column(
                        val[:n].cpu().numpy())
                else:
                    col = VectorColumn(
                        OPVector, val[:n].to("cpu", copy=True).numpy(),
                        meta_env.get(nm))
                store = store.with_column(nm, col)
            if results_only and len(prep.chunks) > 1:
                store = store.select([nm for nm in (*self._result_names,
                                                    *keep) if nm in store])
            stores.append(store)
        return stores[0] if len(stores) == 1 else _concat_stores(stores)

    # -- public scoring ----------------------------------------------------
    def transform_store(self, data, use_cache: bool = True) -> ColumnStore:
        """``WorkflowModel.transform`` through the engine: every DAG column
        (host columns and every fused output)."""
        return self.run_batch(self.prepare_batch(data, use_cache=use_cache),
                              results_only=False)

    def score_store(self, data, keep_intermediate: bool = False,
                    use_cache: bool = True, keep: Sequence[str] = ()
                    ) -> ColumnStore:
        """``WorkflowModel.score`` through the engine: only the result
        columns leave the device. ``keep`` names host columns (raw or
        host-stage features, such as an evaluator's label) to return
        beside them."""
        if keep_intermediate:
            return self.transform_store(data, use_cache=use_cache)
        store = self.run_batch(self.prepare_batch(data, use_cache=use_cache),
                               results_only=True, keep=keep)
        return store.select([nm for nm in (*self._result_names, *keep)
                             if nm in store])

    # -- export ------------------------------------------------------------
    def program_callable(self, out_names: List[str]):
        """The program body for ``out_names``:
        ``run(prepared, uploads) -> {name: tensor or prediction triple}``
        on device tensors. The engine runs it (eagerly or captured), and
        the program bank exports it (``aot.py``), so a banked program and
        a built one compute the same graph. The plan's rewrites are
        baked in."""
        out_names = list(out_names)
        prune = self._active_prune(out_names)

        def run(prepared, uploads):
            return self._body(prepared, uploads, out_names, prune=prune)

        return run

    def program_key(self, prepared, uploads, out_names: List[str]) -> Tuple:
        """The program-cache key a call with these blocks (shapes, dtypes)
        and outputs uses, with the plan's rewrite bits: where a preloaded
        program (:meth:`preload`) is found."""
        prune = self._active_prune(out_names)
        return self._signature(prepared, uploads, out_names) \
            + (("plan", bool(self._cse_alias), prune is not None),)

    def preload(self, key: Tuple, fn) -> None:
        """Seed the program cache with ``fn`` under ``key`` (from
        :meth:`program_key`), a program built elsewhere (a bank's
        ``torch.export`` program). A preload is not a build:
        ``compile_count`` stays as it is. On the card the preloaded
        program takes the path a built one takes: its first call runs
        eagerly, its second is captured as a CUDA graph, later calls
        replay it; a capture that fails raises."""
        try:                    # the first block's rows: the bucket
            bucket = int(key[0][0][2][0])
        except (IndexError, TypeError, ValueError):
            bucket = 0
        with self._lock:
            self._programs.pop(key, None)
            self._programs[key] = _Program(bucket, fn)
            self._evict_locked()

    def export_manifest(self, sample_data) -> List[Dict[str, Any]]:
        """The flat input manifest of an exported program: each prepared
        block (by stage uid, then name) and each direct upload (by name)
        with its tail shape and dtype, from one host pass over
        ``sample_data``. Every block must be row-leading: the exported
        program is polymorphic in the row count and pads nothing."""
        from .workflow import _raw_store
        store = _raw_store(sample_data, self._raw_features)
        n = store.n_rows
        _, prepared, uploads = self.host_blocks(store)
        manifest = []
        for uid in sorted(prepared):
            for k in sorted(prepared[uid]):
                a = np.asarray(prepared[uid][k])
                if a.ndim == 0 or a.shape[0] != n:
                    raise ValueError(
                        f"prepared block {uid}/{k} is not row-leading "
                        f"(shape {a.shape}); full-chain export needs every "
                        "input batch-polymorphic")
                manifest.append({"kind": "prepared", "uid": uid, "name": k,
                                 "tail": list(a.shape[1:]),
                                 "dtype": str(a.dtype)})
        for k in sorted(uploads):
            a = np.asarray(uploads[k])
            if a.ndim == 0 or a.shape[0] != n:
                raise ValueError(f"upload {k} is not row-leading")
            manifest.append({"kind": "upload", "uid": "", "name": k,
                             "tail": list(a.shape[1:]),
                             "dtype": str(a.dtype)})
        return manifest

    def rewrite_digest(self) -> str:
        """blake2b-128 over the fused plan (each step's kind, stage uid,
        output and inputs) and the attached plan's rewrites (CSE aliases,
        live sets, remapped select indices, sliced scaler constants), as
        the JAX engine hashes them. A bank records it at export, and a
        serving engine whose rewrites differ does not take the bank (its
        programs would gather other columns)."""
        h = hashlib.blake2b(digest_size=16)
        for it in self._plan:
            h.update(f"{it.kind}|{it.model.uid}|{it.out}|"
                     f"{','.join(it.ins)};".encode())
        for k in sorted(self._cse_alias):
            h.update(f"cse:{k}->{self._cse_alias[k]};".encode())
        for tag, table in (("prune", self._prune),
                           ("remap", self._select_keep_remap),
                           ("slice", self._scale_slice)):
            for uid in sorted(table):
                h.update(f"{tag}:{uid}:".encode())
                h.update(np.asarray(table[uid], np.int64).tobytes())
        return h.hexdigest()

    def state_digest(self) -> str:
        """blake2b-128 over the fused stages' fitted array state: every
        numpy array or tensor reachable through public attributes (sorted
        by path; objects, lists and dicts three levels deep). Exported
        programs hold these values as constants, so a bank records the
        digest and a model whose arrays differ does not take the bank.
        Values that are not arrays and private attributes (the device
        tables among them) are left out: they differ across a save and a
        load of the same model."""
        h = hashlib.blake2b(digest_size=16)

        def leaves(obj, path: str, depth: int, out) -> None:
            if isinstance(obj, torch.Tensor):
                out.append((path, obj.detach().to("cpu").numpy()))
                return
            if isinstance(obj, np.ndarray):
                if obj.dtype != object:
                    out.append((path, obj))
                return
            if depth <= 0:
                return
            if isinstance(obj, (list, tuple)):
                for i, v in enumerate(obj):
                    leaves(v, f"{path}[{i}]", depth - 1, out)
                return
            if isinstance(obj, dict):
                for k in sorted(obj, key=str):
                    leaves(obj[k], f"{path}.{k}", depth - 1, out)
                return
            d = getattr(obj, "__dict__", None)
            if isinstance(d, dict):
                for k in sorted(d):
                    if not k.startswith("_"):
                        leaves(d[k], f"{path}.{k}", depth - 1, out)

        for it in self._plan:
            out: List[Tuple[str, np.ndarray]] = []
            leaves(it.model, "", 3, out)
            h.update(f"{it.kind}|{it.model.uid}|".encode())
            for path, a in sorted(out, key=lambda kv: kv[0]):
                h.update(path.encode())
                h.update(str(a.dtype).encode())
                h.update(str(a.shape).encode())
                h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    def export_callable(self, manifest: List[Dict[str, Any]],
                        out_names: List[str]) -> torch.nn.Module:
        """The program over flat arguments, for ``torch.export``: a module
        whose ``forward(*blocks)`` takes the blocks in ``manifest`` order
        and returns the flat output dict (a prediction triple as
        ``<name>.prediction``, ``.rawPrediction``, ``.probability``)."""
        return _FlatProgram(self.program_callable(out_names), manifest)


class _FlatProgram(torch.nn.Module):
    """:meth:`ScoringEngine.export_callable`'s module."""

    def __init__(self, run, manifest):
        super().__init__()
        self._run = run
        self._manifest = [dict(spec) for spec in manifest]

    def forward(self, *blocks):
        prepared: Dict[str, Dict[str, Any]] = {}
        uploads: Dict[str, Any] = {}
        for spec, a in zip(self._manifest, blocks):
            if spec["kind"] == "prepared":
                prepared.setdefault(spec["uid"], {})[spec["name"]] = a
            else:
                uploads[spec["name"]] = a
        return flatten_outputs(self._run(prepared, uploads))


def flatten_outputs(outs: Dict[str, Any]) -> Dict[str, Any]:
    """``{name: value or prediction triple}`` → a flat dict, a triple as
    ``<name>.prediction``, ``<name>.rawPrediction`` and
    ``<name>.probability`` (the serving artifacts' output names)."""
    flat: Dict[str, Any] = {}
    for nm, v in outs.items():
        if isinstance(v, tuple):
            flat[f"{nm}.prediction"] = v[0]
            flat[f"{nm}.rawPrediction"] = v[1]
            flat[f"{nm}.probability"] = v[2]
        else:
            flat[nm] = v
    return flat


def _concat_stores(stores: List[ColumnStore]) -> ColumnStore:
    """Row-concatenate per-chunk stores (the column kinds the engine and
    the host stages produce)."""
    first = stores[0]
    cols = {}
    for nm in first.names():
        parts = [s[nm] for s in stores]
        c0 = parts[0]
        if isinstance(c0, PredictionColumn):
            cols[nm] = PredictionColumn(
                np.concatenate([p.prediction for p in parts]),
                np.concatenate([p.raw_prediction for p in parts]),
                np.concatenate([p.probability for p in parts]))
        elif isinstance(c0, VectorColumn):
            cols[nm] = VectorColumn(
                c0.ftype, np.concatenate([p.values for p in parts]),
                c0.metadata)
        elif isinstance(c0, NumericColumn):
            cols[nm] = NumericColumn(
                c0.ftype, np.concatenate([p.values for p in parts]),
                np.concatenate([p.mask for p in parts]), c0.labels)
        elif isinstance(c0, TextColumn):
            cols[nm] = TextColumn(
                c0.ftype, np.concatenate([p.values for p in parts]))
        elif isinstance(c0, (TextListColumn, TextSetColumn)):
            cols[nm] = type(c0)(c0.ftype,
                                [v for p in parts for v in p.values])
        elif isinstance(c0, GeoColumn):
            cols[nm] = GeoColumn(
                c0.ftype, np.concatenate([p.values for p in parts]),
                np.concatenate([p.mask for p in parts]))
        elif isinstance(c0, MapColumn):
            keys = sorted({k for p in parts for k in p.children})
            children = {k: _concat_stores([ColumnStore(
                {k: p.children.get(k) or column_of_empty(
                    c0.ftype.element_type, p.n_rows)}, p.n_rows)
                for p in parts])[k] for k in keys}
            cols[nm] = MapColumn(c0.ftype, children,
                                 sum(p.n_rows for p in parts))
        elif isinstance(c0, RaggedColumn):
            lengths = np.concatenate([np.diff(p.offsets) for p in parts])
            cols[nm] = RaggedColumn(
                c0.ftype, np.concatenate([p.flat for p in parts]),
                np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64))
        else:
            raise TypeError(f"cannot row-concatenate column {nm!r} "
                            f"({type(c0).__name__}) across scoring chunks")
    return ColumnStore(cols, sum(s.n_rows for s in stores))


_END = object()


def stream_score_overlapped(model, batches, keep_intermediate: bool = False,
                            engine: Optional[ScoringEngine] = None,
                            device=None):
    """Score a stream of batches (record lists or ColumnStores), one
    ColumnStore each, in order: the host half of batch k+1
    (``prepare_batch``) runs on a worker thread while batch k runs on the
    device. The same stores as scoring each batch on its own. A model the
    engine fuses nothing of scores by layers."""
    eng = engine if engine is not None else model.scoring_engine(device)
    if not eng.enabled():
        for batch in batches:
            yield model.score(batch, keep_intermediate=keep_intermediate,
                              device=eng.device, engine=False)
        return
    results_only = not keep_intermediate
    it = iter(batches)
    with ThreadPoolExecutor(max_workers=1,
                            thread_name_prefix="score-prep") as pool:
        nxt = next(it, _END)
        fut = (None if nxt is _END
               else pool.submit(eng.prepare_batch, nxt, False))
        while fut is not None:
            prep = fut.result()
            nxt = next(it, _END)
            fut = (None if nxt is _END
                   else pool.submit(eng.prepare_batch, nxt, False))
            store = eng.run_batch(prep, results_only=results_only)
            if results_only:
                store = store.select([nm for nm in eng._result_names
                                      if nm in store])
            yield store
