"""Fused fit statistics: one pass over the train store per DAG layer; the
port of ``transmogrifai_tpu/fitstats.py`` (the ``SequenceAggregators``
analog, ``SequenceAggregators.scala:41``).

* Estimators declare what they need as :class:`StatRequest` s
  (``Estimator.stat_requests(store)``: count, mean, variance, std, min,
  max, quantile, mode, value counts, histogram, the SanityChecker's
  statistics).
* The workflow collects a layer's requests, drops duplicates by
  ``StatRequest.key()`` (two stages needing one column's mean share one
  reduction) and runs them in one :class:`LayerStatsPlan` pass.
* Each opted-in stage fits from the finalized values
  (``Estimator.fit(store, stats=...)`` → ``fit_columns_from_stats``), with
  no scan of its own.

Two tiers compute the moment kinds (count, mean, variance, std, min, max):

* the **host tier** runs the numpy expressions of the sequential
  ``fit_columns`` on the same compressed arrays, so fused and per-stage
  fits are bit-identical;
* the **device tier** (rows ≥ ``workflow.FUSE_MIN_ROWS`` and the
  workflow's device is the card, or ``run(device=True)``) stacks the
  requested columns into [n, k] with masked rows zeroed, folds chunks of
  ``_chunk_rows(n)`` rows in torch on the workflow's device (count, sum,
  chunk mean, centered M2, min, max a column), pulls every chunk's
  partials in one copy and merges them on the host in f64 with Chan's
  parallel combination, in the fit's dtype (f32 on the card by default).
  Counts are exact, and minima and maxima are those of the values in that
  dtype; the other moments differ from numpy's in their low bits. A failed
  device pass raises.

Quantiles, modes, value counts, histograms and the SanityChecker's
request are host work on both tiers (strings never reach the card; the
SanityChecker's gram runs on the workflow's device through the same
function as its sequential fit). They ride the same single pass: each
column is read once, whatever mix of stages needs it.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry
from .parallel import mesh as _mesh

logger = logging.getLogger(__name__)

__all__ = [
    "StatRequest", "StatResults", "LayerStatsPlan", "SufficientStats",
    "StreamingMomentFold",
    "FITSTATS_ENABLED", "FITSTATS_MIN_STAGES", "FITSTATS_CHUNK_ROWS",
    "fitstats_stats", "reset_fitstats_stats", "collect_column_state",
    "sufficient_stats_to_json", "sufficient_stats_from_json",
    "load_sufficient_stats",
]

#: the fused pass's switch (tests set the attribute)
FITSTATS_ENABLED = True

#: a layer fuses only when at least this many of its estimators scan
#: data: below it there is no pass to save
FITSTATS_MIN_STAGES = 2

#: row chunk of the device fold; the last chunk is zero-mask-padded to
#: the full chunk shape
FITSTATS_CHUNK_ROWS = 262_144

#: the kinds computed together from one column's moment bundle, the ones
#: the device tier folds
_MOMENT_KINDS = frozenset(
    {"count", "mean", "variance", "std", "min", "max"})

_TALLY_LOCK = threading.Lock()
_TALLY = {"layers_fused": 0, "passes_saved": 0, "bytes_scanned": 0,
          "host_passes": 0, "device_passes": 0, "warm_state_merges": 0}


def fitstats_stats() -> Dict[str, int]:
    """The process-wide tallies of the fused pass."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_fitstats_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


# -- requests and results ----------------------------------------------------


@dataclass(frozen=True)
class StatRequest:
    """One sufficient statistic over a named column.

    ``kind``: ``count | mean | variance | std | min | max | quantile |
    mode | value_counts | set_value_counts | histogram | sanity``.
    ``label`` names the label column of the label-aware kind (``sanity``);
    ``params`` holds the kind's knobs (ddof, bucket count, edges, the
    SanityChecker's configuration) and is part of the dedup key.
    """

    kind: str
    column: str
    label: Optional[str] = None
    params: Tuple = ()

    def key(self) -> Tuple:
        return (self.kind, self.column, self.label, self.params)


class StatResults:
    """Finalized values by request key, what ``fit_columns_from_stats``
    reads. A lookup the plan did not compute raises with its key."""

    def __init__(self, values: Dict[Tuple, Any]):
        self._values = values

    def value(self, kind: str, column: str, label: Optional[str] = None,
              params: Tuple = ()) -> Any:
        key = (kind, column, label, tuple(params))
        if key not in self._values:
            raise KeyError(
                f"stat {key} was not computed by the layer plan — the "
                "stage's stat_requests and fit_columns_from_stats disagree")
        return self._values[key]

    def for_request(self, req: StatRequest) -> Any:
        return self.value(req.kind, req.column, req.label, req.params)

    def __contains__(self, key: Tuple) -> bool:
        return tuple(key) in self._values

    def __len__(self) -> int:
        return len(self._values)


# -- sufficient statistics ---------------------------------------------------


@dataclass
class SufficientStats:
    """One column's moment statistics as a monoid: (count, mean, centered
    M2, min, max). ``merge`` is Chan's parallel combination, the merge
    the device tier runs across chunks, so a refit over [old window +
    fresh slice] is one merge and one pass over the fresh slice."""

    count: float = 0.0
    mean: float = 0.0
    m2: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")

    def merge(self, other: "SufficientStats") -> "SufficientStats":
        tot = self.count + other.count
        if tot <= 0:
            return SufficientStats()
        delta = other.mean - self.mean
        mean = (self.count * self.mean + other.count * other.mean) / tot
        m2 = self.m2 + other.m2 + delta * delta \
            * self.count * other.count / tot
        return SufficientStats(tot, mean, m2, min(self.min, other.min),
                               max(self.max, other.max))

    def finalize(self, kind: str, params: Tuple = ()) -> Any:
        """The value a request of ``kind`` asks for, by the expressions
        the device tier finalizes its merged partials with."""
        c = int(self.count)
        if kind == "count":
            return c
        if c == 0:
            return None
        if kind == "mean":
            return float(self.mean)
        if kind == "variance":
            return float(self.m2 / c)
        if kind == "std":
            ddof = params[0] if params else 0
            return (float(np.sqrt(self.m2 / (c - ddof)))
                    if c > ddof else None)
        if kind == "min":
            return float(self.min)
        if kind == "max":
            return float(self.max)
        raise ValueError(f"unknown moment kind {kind!r}")

    def to_json(self) -> Dict[str, float]:
        return {"count": self.count, "mean": self.mean, "m2": self.m2,
                "min": self.min, "max": self.max}

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "SufficientStats":
        return SufficientStats(float(d["count"]), float(d["mean"]),
                               float(d["m2"]), float(d["min"]),
                               float(d["max"]))


def _state_of(vals: np.ndarray) -> SufficientStats:
    """The state of compressed f64 values, by numpy's own reductions."""
    n = int(vals.size)
    if n == 0:
        return SufficientStats()
    return SufficientStats(float(n), float(vals.mean()),
                           float(vals.var() * n), float(vals.min()),
                           float(vals.max()))


def collect_column_state(col) -> SufficientStats:
    """One column's :class:`SufficientStats` from its masked values (the
    host tier's collector)."""
    return _state_of(col.values[col.mask].astype(np.float64))


def sufficient_stats_to_json(states: Mapping[str, SufficientStats]
                             ) -> Dict[str, Dict[str, float]]:
    return {k: s.to_json() for k, s in states.items()}


def sufficient_stats_from_json(doc: Mapping[str, Any]
                               ) -> Dict[str, SufficientStats]:
    return {str(k): SufficientStats.from_json(v) for k, v in doc.items()}


def load_sufficient_stats(model_dir: str
                          ) -> Optional[Dict[str, SufficientStats]]:
    """The sufficient statistics saved with a model (``model.json``'s
    ``fitSufficientStats``), or None when the save holds none or the
    block is unreadable."""
    from .model_io import MODEL_JSON
    try:
        with open(os.path.join(model_dir, MODEL_JSON)) as fh:
            raw = json.load(fh).get("fitSufficientStats")
        if not raw:
            return None
        return sufficient_stats_from_json(raw)
    except (OSError, ValueError, KeyError, TypeError):
        logger.exception("sufficient stats at %s are unreadable", model_dir)
        return None


# -- host tier: the sequential fits' expressions -----------------------------


def _host_moment_bundle(col, kinds: Dict[str, List[Tuple]]
                        ) -> Tuple[Dict[Tuple, Any], SufficientStats]:
    """Every moment value one column's requests ask for, by the sequential
    fits' expressions on one ``values[mask].astype(f64)`` array, and the
    column's state from the same array."""
    vals = col.values[col.mask].astype(np.float64)
    count = int(vals.size)
    out: Dict[Tuple, Any] = {}
    for kind, params_list in kinds.items():
        for params in params_list:
            if kind == "count":
                v: Any = count
            elif count == 0:
                v = None
            elif kind == "mean":
                v = float(vals.mean())
            elif kind == "variance":
                v = float(vals.var())
            elif kind == "std":
                ddof = params[0] if params else 0
                v = float(vals.std(ddof=ddof)) if count > ddof else None
            elif kind == "min":
                v = float(vals.min())
            elif kind == "max":
                v = float(vals.max())
            else:  # pragma: no cover - guarded by _MOMENT_KINDS
                raise ValueError(f"unknown moment kind {kind!r}")
            out[(kind, params)] = v
    return out, _state_of(vals)


def _exec_quantile(store, req: StatRequest, dev, dtype):
    """The sequential NumericBucketizer's ``np.quantile`` (None for an
    empty column)."""
    col = store[req.column]
    present = col.values[col.mask].astype(np.float64)
    if present.size == 0:
        return None
    return np.quantile(present, np.linspace(0, 1, int(req.params[0]) + 1))


def _exec_mode(store, req: StatRequest, dev, dtype):
    """The most frequent value, ties to the smallest."""
    col = store[req.column]
    if not col.mask.any():
        return None
    vals, counts = np.unique(col.values[col.mask], return_counts=True)
    return float(vals[np.argmax(counts)])


def _exec_value_counts(store, req: StatRequest, dev, dtype):
    from .ops._hostvec import value_counts
    return value_counts(store[req.column].values)


def _exec_set_value_counts(store, req: StatRequest, dev, dtype):
    from .ops._hostvec import flatten_ragged, value_counts
    return value_counts(flatten_ragged(store[req.column].values)[0])


def _exec_histogram(store, req: StatRequest, dev, dtype):
    col = store[req.column]
    vals = col.values[col.mask].astype(np.float64)
    return np.histogram(vals, bins=np.asarray(req.params, np.float64))[0]


def _exec_sanity(store, req: StatRequest, dev, dtype):
    """The SanityChecker's statistics through the function its sequential
    fit calls, on the workflow's device in the fit's dtype."""
    from .ops.sanity_checker import compute_sanity_stats
    return compute_sanity_stats(store, req.label, req.column, device=dev,
                                dtype=dtype, **dict(req.params))


_HOST_EXEC = {
    "quantile": _exec_quantile,
    "mode": _exec_mode,
    "value_counts": _exec_value_counts,
    "set_value_counts": _exec_set_value_counts,
    "histogram": _exec_histogram,
    "sanity": _exec_sanity,
}


# -- device tier: a chunked fold in torch and Chan's merge -------------------


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _chunk_rows(n: int) -> int:
    """The fold's chunk: a power of two, at least 1,024 rows, at most
    ``FITSTATS_CHUNK_ROWS``."""
    return min(FITSTATS_CHUNK_ROWS, max(_pow2_ceil(n), 1024))


def _moment_step(v: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One chunk's [6, k] partials: count, sum, chunk mean, centered M2,
    min, max a column. Masked and padded rows (value 0, mask False) are
    inert."""
    bf = b.to(v.dtype)
    cnt = bf.sum(dim=0)
    s = (v * bf).sum(dim=0)
    mean_c = s / torch.clamp(cnt, min=1.0)
    d = (v - mean_c[None, :]) * bf
    m2 = (d * d).sum(dim=0)
    inf = torch.tensor(float("inf"), dtype=v.dtype, device=v.device)
    mn = torch.where(b, v, inf).amin(dim=0)
    mx = torch.where(b, v, -inf).amax(dim=0)
    return torch.stack([cnt, s, mean_c, m2, mn, mx])


def _chan_combine(parts: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Merge [chunks, 6, k] partials in f64 by Chan's parallel combination
    (exact for counts, minima and maxima)."""
    parts = np.asarray(parts, np.float64)
    cnt, _s, mean, m2, mn, mx = parts[0]
    for c2, _s2, me2, m22, mn2, mx2 in parts[1:]:
        tot = cnt + c2
        safe = np.maximum(tot, 1.0)
        delta = me2 - mean
        mean = np.where(tot > 0, (cnt * mean + c2 * me2) / safe, 0.0)
        m2 = m2 + m22 + delta * delta * cnt * c2 / safe
        cnt = tot
        mn = np.minimum(mn, mn2)
        mx = np.maximum(mx, mx2)
    return cnt, mean, m2, mn, mx


def _device_moment_bundles(store, col_kinds: Dict[str, Dict[str, List[Tuple]]],
                           dev: torch.device, dtype: torch.dtype, mesh=None
                           ) -> Tuple[Dict[str, Dict[Tuple, Any]],
                                      Dict[str, SufficientStats]]:
    """The device tier: the requested columns stacked into [n, k] (masked
    rows zeroed), chunks of ``_chunk_rows(n)`` rows folded on ``dev`` in
    ``dtype``, every chunk's partials pulled in one copy and merged on
    the host in f64. Returns each column's values by (kind, params) and
    its state (the merged partials).

    Over a mesh whose ``data`` axis D divides the chunk, each chunk is D
    pieces and rank r folds pieces r, r + D, ...; the pieces' partials
    are summed over the ``data`` group from zero-filled copies, so every
    rank merges the same partials (counts, minima and maxima exact; the
    moments within rounding of the unsharded pass)."""
    names = sorted(col_kinds)
    n, k = store.n_rows, len(names)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    chunk = _chunk_rows(n)
    rows = max(-(-n // chunk), 1) * chunk      # every chunk full-shaped
    V = np.zeros((rows, k), np_dtype)
    B = np.zeros((rows, k), bool)
    for j, nm in enumerate(names):
        col = store[nm]
        B[:n, j] = col.mask
        V[:n, j] = np.where(col.mask, col.values.astype(np.float64), 0.0)
    pinned = dev.type == "cuda"
    Vt, Bt = torch.from_numpy(V), torch.from_numpy(B)
    if pinned:
        Vt, Bt = Vt.pin_memory(), Bt.pin_memory()
    n_chunks = rows // chunk
    D = 1 if mesh is None else mesh.shape["data"]
    sharded = D > 1 and chunk % D == 0
    if sharded:
        piece = chunk // D
        mine = list(range(mesh.axis_index("data"), rows // piece, D))
        Vt = torch.cat([Vt[j * piece:(j + 1) * piece] for j in mine])
        Bt = torch.cat([Bt[j * piece:(j + 1) * piece] for j in mine])
    # the device seconds of the upload and the fold (the analytic ~10
    # operations a cell: count, sum, chunk mean, centered delta, M2, min,
    # max), read after the pull below
    with telemetry.device_timer("fitstats", dev,
                                flops=10.0 * chunk * k * n_chunks / D):
        Vd = Vt.to(dev, non_blocking=pinned)
        Bd = Bt.to(dev, non_blocking=pinned)
        if sharded:
            parts = torch.zeros((rows // piece, 6, k), dtype=Vd.dtype,
                                device=dev)
            for i, j in enumerate(mine):
                parts[j] = _moment_step(Vd[i * piece:(i + 1) * piece],
                                        Bd[i * piece:(i + 1) * piece])
            _mesh.all_reduce(parts, mesh, "data")
        else:
            parts = torch.stack([_moment_step(Vd[off:off + chunk],
                                              Bd[off:off + chunk])
                                 for off in range(0, rows, chunk)])
    parts = parts.cpu().numpy()
    telemetry.settle_device_timers()
    with telemetry.span("fit:psum_merge", chunks=n_chunks, columns=k,
                        sharded=sharded):
        cnt, mean, m2, mn, mx = _chan_combine(parts)
    out: Dict[str, Dict[Tuple, Any]] = {}
    states: Dict[str, SufficientStats] = {}
    for j, nm in enumerate(names):
        st = states[nm] = SufficientStats(
            float(cnt[j]), float(mean[j]), float(m2[j]), float(mn[j]),
            float(mx[j]))
        out[nm] = {(kind, params): st.finalize(kind, params)
                   for kind, params_list in col_kinds[nm].items()
                   for params in params_list}
    return out, states


class StreamingMomentFold:
    """The device fold over row batches as they stream off a directory
    reader, with no materialized store: host memory stays at the staging
    chunks.

    Bitwise :func:`_device_moment_bundles` over the same rows, by
    construction: the batches are re-buffered into exactly the chunks the
    materialized pass would cut the concatenated rows into —
    ``FITSTATS_CHUNK_ROWS`` rows once the stream passes one chunk, else
    the one zero-padded ``_chunk_rows(n)`` chunk — each chunk runs the
    same :func:`_moment_step` on ``device`` in ``dtype`` at the same shape,
    and the chunks' partials are Chan-combined on the host in stream
    order. So :meth:`finalize` gives the :class:`SufficientStats` the
    materialized device pass reports for the same column set. There is no
    host tier: a device failure raises (``fitstats.device_pass``).

    Usage: construct with the column names, ``update(batch_store)`` for
    each streamed batch (a ColumnStore with those columns), then
    ``finalize()`` once the stream is drained.
    """

    def __init__(self, columns: Sequence[str], device=None,
                 dtype: torch.dtype = torch.float32):
        from .models.base import resolve_device
        from .pipeline import BufferPool
        self.columns = sorted(columns)
        self._k = len(self.columns)
        self._dev = resolve_device(device)
        self._dtype = dtype
        self._np_dtype = np.float64 if dtype == torch.float64 \
            else np.float32
        self._pool = BufferPool(max_per_key=4,
                                pin=self._dev.type == "cuda")
        self._parts: List[torch.Tensor] = []
        #: chunks whose upload may still read their staging buffers
        self._inflight: List[Tuple[List[np.ndarray], Any]] = []
        self._V: Optional[np.ndarray] = None
        self._B: Optional[np.ndarray] = None
        self._fill = 0
        self._n = 0
        self._flushed = 0

    @property
    def n_rows(self) -> int:
        return self._n

    def _ensure_buffers(self) -> None:
        if self._V is None:
            shape = (FITSTATS_CHUNK_ROWS, self._k)
            self._V = self._pool.take(shape, self._np_dtype)
            self._B = self._pool.take(shape, bool)

    def _fold_chunk(self, V: np.ndarray, B: np.ndarray,
                    staged: List[np.ndarray]) -> None:
        """Upload one full-shaped chunk and fold it on the device; the
        staging buffers return to the pool once the copy has read them."""
        from . import resilience
        resilience.inject("fitstats.device_pass", rows=int(V.shape[0]))
        card = self._dev.type == "cuda"
        with telemetry.device_timer("fitstats", self._dev,
                                    flops=10.0 * V.shape[0] * self._k):
            Vd = torch.from_numpy(V).to(self._dev, non_blocking=card)
            Bd = torch.from_numpy(B).to(self._dev, non_blocking=card)
            self._parts.append(_moment_step(Vd, Bd))
        if not card:
            for buf in staged:
                self._pool.give(buf)
            return
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self._dev))
        self._inflight.append((staged, ev))
        # two chunks in flight at most: the older copy has read its
        # buffers once its event completes
        while len(self._inflight) > 1:
            bufs, old = self._inflight.pop(0)
            old.synchronize()
            for buf in bufs:
                self._pool.give(buf)

    def _flush_full(self) -> None:
        V, B = self._V, self._B
        self._V = self._B = None
        self._fill = 0
        self._flushed += 1
        self._fold_chunk(V, B, [V, B])

    def update(self, store) -> None:
        """Fold one streamed batch (a ColumnStore with the columns)."""
        if not self.columns:
            return
        m = store.n_rows
        if m == 0:
            return
        Vb = np.empty((m, self._k), self._np_dtype)
        Bb = np.empty((m, self._k), bool)
        for j, nm in enumerate(self.columns):
            col = store[nm]
            Bb[:, j] = col.mask
            Vb[:, j] = np.where(col.mask, col.values.astype(np.float64), 0.0)
        off = 0
        while off < m:
            if self._fill == FITSTATS_CHUNK_ROWS:
                # full and more rows follow: only now is it an interior
                # chunk (a stream of exactly one chunk stays the padded
                # single chunk)
                self._flush_full()
            self._ensure_buffers()
            take = min(FITSTATS_CHUNK_ROWS - self._fill, m - off)
            self._V[self._fill:self._fill + take] = Vb[off:off + take]
            self._B[self._fill:self._fill + take] = Bb[off:off + take]
            self._fill += take
            off += take
        self._n += m

    def finalize(self) -> Dict[str, SufficientStats]:
        """Drain the fold: each column's full-stream state (the merged
        partials, what the materialized device pass reports)."""
        if not self.columns:
            return {}
        if self._flushed == 0:
            # one padded chunk of _chunk_rows(n) rows, as the materialized
            # pass's single chunk
            chunk = _chunk_rows(self._n)
            vp = np.zeros((chunk, self._k), self._np_dtype)
            bp = np.zeros((chunk, self._k), bool)
            staged: List[np.ndarray] = []
            if self._V is not None:
                vp[:self._fill] = self._V[:self._fill]
                bp[:self._fill] = self._B[:self._fill]
                staged = [self._V, self._B]
                self._V = self._B = None
            if self._dev.type == "cuda":
                vp = torch.from_numpy(vp).pin_memory().numpy()
                bp = torch.from_numpy(bp).pin_memory().numpy()
            for buf in staged:
                self._pool.give(buf)
            self._fold_chunk(vp, bp, [])
        elif self._V is not None:
            # the tail chunk, zero-mask-padded to the full shape
            self._V[self._fill:] = 0
            self._B[self._fill:] = False
            self._flush_full()
        parts = torch.stack(self._parts).cpu().numpy()
        for bufs, ev in self._inflight:
            ev.synchronize()
            for buf in bufs:
                self._pool.give(buf)
        self._inflight = []
        telemetry.settle_device_timers()
        n_chunks = len(self._parts)
        _tally("device_passes")
        _tally("bytes_scanned", int(self._n) * self._k
               * (np.dtype(self._np_dtype).itemsize + 1))
        with telemetry.span("fit:psum_merge", chunks=n_chunks,
                            columns=self._k, sharded=False, streamed=True):
            cnt, mean, m2, mn, mx = _chan_combine(parts)
        self._parts = []
        return {nm: SufficientStats(float(cnt[j]), float(mean[j]),
                                    float(m2[j]), float(mn[j]),
                                    float(mx[j]))
                for j, nm in enumerate(self.columns)}


def _col_bytes(col) -> int:
    """Host bytes behind one column (values and a stored mask), the unit
    of ``bytes_scanned``."""
    b = 0
    v = getattr(col, "values", None)
    if isinstance(v, np.ndarray):
        b += v.nbytes
    elif isinstance(v, list):
        b += 8 * len(v)
    m = col.__dict__.get("mask")        # not TextColumn's computed mask
    if isinstance(m, np.ndarray):
        b += m.nbytes
    return b


class LayerStatsPlan:
    """One DAG layer's StatRequests, deduplicated, computed in one pass
    over the train store."""

    def __init__(self, requests: Sequence[StatRequest], n_stages: int = 1):
        dedup: Dict[Tuple, StatRequest] = {}
        for r in requests:
            dedup.setdefault(r.key(), r)
        self.requests: List[StatRequest] = list(dedup.values())
        self.n_stages = n_stages
        #: the last run's tier: "device" or "host"
        self.tier: Optional[str] = None

    @property
    def n_requests(self) -> int:
        return len(self.requests)

    @staticmethod
    def _warm_merge(states: Dict[str, SufficientStats],
                    warm_state: Optional[Mapping[str, SufficientStats]]
                    ) -> Dict[str, SufficientStats]:
        """Each column's fresh state Chan-merged with its persisted warm
        state, where there is one, through the ``continual.merge_stats``
        fault site. A failed merge (a fault, a malformed warm record)
        leaves that column fresh-only, logged: a warm start is an
        optimization of the host merge, never a dependency."""
        from . import resilience
        merged: Dict[str, SufficientStats] = {}
        for nm, fresh in states.items():
            warm = (warm_state or {}).get(nm)
            if warm is None:
                continue
            try:
                resilience.inject("continual.merge_stats", column=nm)
                merged[nm] = warm.merge(fresh)
            except (OSError, ValueError, TypeError, AttributeError):
                logger.exception("warm-state merge for column %r failed; "
                                 "the refit uses fresh-slice stats for it",
                                 nm)
                continue
            _tally("warm_state_merges")
            telemetry.counter("fitstats.warm_state_merges").inc()
        return merged

    @staticmethod
    def _gate_device(store, workflow_device,
                     tier_hint: Optional[str] = None) -> bool:
        """The device tier from ``workflow.FUSE_MIN_ROWS`` rows when the
        workflow's device (default: the card) is the card; ``tier_hint``
        (the planner's measured tier, "device" or "host") replaces the
        card condition, never the row floor."""
        from . import workflow
        if store.n_rows < workflow.FUSE_MIN_ROWS:
            return False
        if tier_hint is not None:
            return tier_hint == "device"
        return torch.device(workflow_device or "cuda").type == "cuda"

    def run(self, store, device: Optional[bool] = None,
            state_out: Optional[Dict[str, SufficientStats]] = None,
            warm_state: Optional[Mapping[str, SufficientStats]] = None,
            workflow_device=None, dtype: torch.dtype = torch.float32,
            tier_hint: Optional[str] = None,
            stream_state: Optional[Mapping[str, SufficientStats]] = None,
            mesh=None) -> StatResults:
        """Compute every request in one pass.

        ``device`` picks the moment kinds' tier (None: the device tier
        from ``workflow.FUSE_MIN_ROWS`` rows when ``workflow_device`` is
        the card, or as ``tier_hint`` says). From the row floor the
        pass's seconds feed the planner's ``phase:fitstats`` cost.
        ``workflow_device`` (default: the card) and ``dtype`` are the
        fit's: the device tier and the SanityChecker's statistics
        run there. ``state_out`` receives each moment column's
        :class:`SufficientStats`; ``warm_state`` maps columns to persisted
        states, each Chan-merged with the fresh one, and the moment
        values of those columns finalize from the merged state (non-moment
        kinds always compute over ``store``).

        ``stream_state`` (the out-of-core fit's) maps columns to the
        full-stream states a :class:`StreamingMomentFold` folded: a moment
        request on such a column finalizes from it (bitwise a materialized
        device pass over every streamed row) and the subsample ``store``
        is not scanned for it; it persists and warm-merges like a fresh
        state.

        ``mesh`` (the workflow's): the device tier's rows are folded
        across its ``data`` ranks (:func:`_device_moment_bundles`)."""
        from .models.base import resolve_device
        dev = None

        def target() -> torch.device:
            nonlocal dev
            if dev is None:
                dev = resolve_device(workflow_device)
            return dev

        moment_cols: Dict[str, Dict[str, List[Tuple]]] = {}
        other: List[StatRequest] = []
        for r in self.requests:
            if r.kind in _MOMENT_KINDS:
                moment_cols.setdefault(r.column, {}) \
                    .setdefault(r.kind, []).append(tuple(r.params))
            else:
                other.append(r)
        stream_cols: Dict[str, Dict[str, List[Tuple]]] = {}
        if stream_state:
            stream_cols = {nm: moment_cols.pop(nm) for nm in list(moment_cols)
                           if nm in stream_state}
        if device is None:
            device = self._gate_device(store, workflow_device, tier_hint)
        use_device = bool(moment_cols) and bool(device)
        t_run = time.perf_counter()

        values: Dict[Tuple, Any] = {}
        touched: Dict[str, int] = {}
        if moment_cols or stream_cols:
            if not moment_cols:
                bundles, states = {}, {}
            elif use_device:
                # the device tier's fault site: a fault raises to the
                # caller (no host tier takes the pass over)
                from . import resilience
                resilience.inject("fitstats.device_pass", rows=store.n_rows)
                bundles, states = _device_moment_bundles(
                    store, moment_cols, target(), dtype,
                    _mesh.mesh_if_multi(mesh))
            else:
                bundles, states = {}, {}
                for nm, kinds in moment_cols.items():
                    bundles[nm], states[nm] = _host_moment_bundle(
                        store[nm], kinds)
            for nm in stream_cols:
                states[nm] = stream_state[nm]
            merged = self._warm_merge(states, warm_state)
            for r in self.requests:
                if r.kind not in _MOMENT_KINDS:
                    continue
                touched.setdefault(r.column, _col_bytes(store[r.column]))
                if r.column in merged:
                    values[r.key()] = merged[r.column].finalize(
                        r.kind, tuple(r.params))
                elif r.column in stream_cols:
                    values[r.key()] = stream_state[r.column].finalize(
                        r.kind, tuple(r.params))
                else:
                    values[r.key()] = \
                        bundles[r.column][(r.kind, tuple(r.params))]
            if state_out is not None:
                # the persisted state is cumulative across warm retrains
                state_out.update({**states, **merged})

        for r in other:
            exec_fn = _HOST_EXEC.get(r.kind)
            if exec_fn is None:
                raise ValueError(f"unknown stat kind {r.kind!r}")
            values[r.key()] = exec_fn(
                store, r, target() if r.kind == "sanity" else None, dtype)
            touched.setdefault(r.column, _col_bytes(store[r.column]))
            if r.label is not None:
                touched.setdefault(r.label, _col_bytes(store[r.label]))

        scanned = sum(touched.values())
        saved = max(self.n_stages - 1, 0)
        self.tier = "device" if use_device else "host"
        self.bytes_scanned = scanned
        _tally("layers_fused")
        _tally("passes_saved", saved)
        _tally("bytes_scanned", scanned)
        _tally(f"{self.tier}_passes")
        telemetry.counter("fitstats.layers_fused").inc()
        telemetry.counter("fitstats.passes_saved").inc(saved)
        telemetry.counter("fitstats.bytes_scanned").inc(scanned)
        if use_device:
            telemetry.counter("fitstats.device_passes").inc()
        else:
            telemetry.counter("fitstats.host_passes").inc()
        logger.info(
            "fitstats: %d request(s) for %d stage(s) in one %s pass "
            "(%d column(s), %.1f MB scanned)", self.n_requests,
            self.n_stages, self.tier, len(touched), scanned / 1e6)
        from . import workflow
        if moment_cols and store.n_rows >= workflow.FUSE_MIN_ROWS:
            from . import planner
            planner.observe_phase("fitstats", self.tier,
                                  time.perf_counter() - t_run,
                                  store.n_rows)
        return StatResults(values)
