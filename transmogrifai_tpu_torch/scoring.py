"""Batched scoring engine — one device program per model and bucket; the
port of ``transmogrifai_tpu/scoring.py``.

``WorkflowModel.transform`` applies one layer at a time, crossing between
host and device at each. The engine instead runs a fitted model's
device-capable chain as one program: every vectorizer's
``device_compute``, the combiner's concatenation, the SanityChecker's
column gather and the predictor's ``predict_device``. A scoring batch
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
``device_compute``), the ``VectorsCombiner``, the ``SanityCheckerModel``,
any ``PredictorModel`` with ``predict_device`` (a selected model's label
mapping included) and the ``PredictionDeIndexerModel``, whose label
codes the program computes and whose strings are looked up on the host
after the pull. The fused set is the
largest consumer-closed subset of device-capable stages: one whose output
a host stage reads is demoted to the host. Host stages (the DSL's row
transformers) run first; their columns feed ``host_prepare`` and the
direct vector uploads.

Not carried over from the JAX package: the circuit breaker to the host
tier, the link-bandwidth gate, the planner's rewrites (CSE, pruning),
mesh sharding, telemetry spans and the export of the program
(``serving.py``; ROADMAP queue A, item 5).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .columns import (ColumnStore, GeoColumn, NumericColumn,
                      PredictionColumn, RaggedColumn, TextColumn,
                      TextListColumn, TextSetColumn, VectorColumn)
from .models import _hist
from .models.base import PredictorModel, device_table, resolve_device
from .models.selector import SelectedModel
from .ops.indexers import PredictionDeIndexerModel
from .ops.sanity_checker import SanityCheckerModel
from .ops.vectorizer_base import VectorizerModel, canonicalize_prepared
from .ops.vectors import VectorsCombiner
from .types.feature_types import OPVector
from .vector_metadata import VectorMetadata

__all__ = ["ScoringEngine", "bucket_for", "bucket_ladder",
           "build_fused_plan", "stream_score_overlapped",
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
        self.kind = kind      # vec | combine | select | predict | deindex
        self.out = out
        self.ins = ins        # env / upload names read (no label slots)


def _has_predict_device(m) -> bool:
    """True when ``m.predict_device`` is implemented (not the
    PredictorModel stub), through a SelectedModel to its inner model."""
    if isinstance(m, SelectedModel):
        return m.inner is not None and _has_predict_device(m.inner)
    return type(m).predict_device is not PredictorModel.predict_device


def _classify(m) -> Optional[str]:
    """Device-capable kind of a fitted stage, or None (host). The JAX
    package's "scale" kind waits for ``StandardScalerModel`` (ROADMAP
    queue A, item 2)."""
    if isinstance(m, VectorizerModel):
        return "vec"
    if isinstance(m, VectorsCombiner):
        return "combine"
    if isinstance(m, SanityCheckerModel):
        return "select"
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
    output tensors and the kernel launches one replay makes."""

    __slots__ = ("bucket", "calls", "graph", "inputs", "outputs",
                 "launches")

    def __init__(self, bucket: int):
        self.bucket = bucket
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
    held against."""

    def __init__(self, model, device=None,
                 bucket_cap: int = DEFAULT_BUCKET_CAP,
                 graphs: Optional[bool] = None):
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

    # -- introspection -----------------------------------------------------
    def enabled(self) -> bool:
        """Something to fuse: the engine has a device program to run."""
        return bool(self._plan)

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
        prepared = {it.model.uid: canonicalize_prepared(
            it.model.host_prepare(store))
            for it in self._plan if it.kind == "vec"}
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
            while len(self._programs) > PROGRAM_CACHE_CAP:
                self._programs.popitem(last=False)
        return prog

    def _body(self, prepared: Dict[str, Dict[str, torch.Tensor]],
              uploads: Dict[str, torch.Tensor], out_names) -> Dict[str, Any]:
        """The fused program on device tensors. Vectors leave each stage
        in f32, as the layer path's columns hold them; no value is read
        back to the host, so the body can be captured."""
        env: Dict[str, Any] = dict(uploads)
        for it in self._plan:
            m = it.model
            if it.kind == "vec":
                env[it.out] = m.device_compute(prepared[m.uid]).to(
                    torch.float32)
            elif it.kind == "combine":
                env[it.out] = torch.cat([env[nm] for nm in it.ins], dim=1)
            elif it.kind == "select":
                x = env[it.ins[0]]
                if m.keep_indices == list(range(x.shape[1])):
                    env[it.out] = x
                else:
                    keep = device_table(m, "keep_indices", lambda m=m:
                                        np.asarray(m.keep_indices,
                                                   dtype=np.int64),
                                        x.device)
                    env[it.out] = x.index_select(1, keep)
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

    def _capture(self, prog: _Program, prepared, uploads, out_names,
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
                outs = self._body(*ins, out_names)
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
        prog = self._program(self._signature(prepared, uploads, out_names),
                             bucket)
        if not self.graphs or prog.calls == 0:
            outs = self._body(*self._upload(prepared, uploads), out_names)
        else:
            if prog.graph is None:
                self._capture(prog, prepared, uploads, out_names, bucket)
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
