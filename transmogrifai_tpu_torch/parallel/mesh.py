"""The (data, grid) mesh over a world of ranks and the row-sharding
helpers — the port of ``transmogrifai_tpu/parallel/mesh.py``.

The JAX package runs one controller over many devices and lets GSPMD
insert the collectives. PyTorch runs one process a device
(``torchrun``), so here the mesh is a ``DeviceMesh`` over the ranks of
the process group (``multihost.initialize``), with the axes
``("data", "grid")``, and every collective is written out: each rank runs
the same program on its own row shard and sums over the ``data`` group
(:func:`all_reduce`), and gathers go through an all-reduce into a
zero-filled buffer (:func:`gather_rows`, :func:`gather_axis`) — gloo,
the backend of ranks that share a card and of the CPU, reduces CUDA
tensors but gathers only host ones.

Axes:

* ``data`` — rows. A rank holds rows ``data_sharding(mesh, n)`` of the
  zero-weight-padded row space (:func:`pad_rows`); the tree histograms,
  the linear solvers' row sums and the statistics fold are summed over
  the ``data`` group.
* ``grid`` — the CV sweep's (fold × grid point) batch, or the tree
  engine's column chunks under ``featureShards`` (``models/_treefit``).

Every rank reads the whole input; a row-sharded phase takes its own rows
of it. Rank r sits at (r // grid, r % grid).

With no process group the process mesh is the degenerate 1×1 and
:func:`mesh_if_multi` returns None, so every consumer takes the
single-process path, and nothing initializes ``torch.distributed``.
``TMOG_MESH=0`` keeps every consumer on that path even in a world of
several ranks (each rank then computes the whole result alone).

Not row-sharded in this slice (:data:`REPLICATED`): under a multi-rank
mesh these run replicated — every rank computes the unsharded result on
all rows, the JAX package's result too.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "data_sharding", "shard_cv_inputs",
           "pad_rows", "local_rows", "process_default_mesh",
           "set_process_mesh", "mesh_if_multi", "stage_mesh",
           "mesh_topology",
           "mesh_constructions", "mesh_enabled", "feature_shard_mesh",
           "all_reduce", "gather_rows", "gather_axis", "sharded_scope",
           "active_sharded_mesh", "collective_stats",
           "reset_collective_stats", "REPLICATED", "MESH_ENABLED"]

#: master switch for the mesh (``TMOG_MESH=0`` keeps every consumer on the
#: single-process path)
MESH_ENABLED = os.environ.get("TMOG_MESH", "1") != "0"

#: what a multi-rank mesh runs replicated in this slice, by ROADMAP item:
#: every rank computes the unsharded result on all rows
REPLICATED = {
    "the scoring engine's row-sharded buckets (scoring.py)": "A6.6 (b) 1",
    "the data-sharded sums of GLM, the MLP, LDA and Word2Vec "
    "(models/glm.py, models/svm.py, ops/topics.py)": "A6.6 (b) 2",
    "StreamingMomentFold over a mesh (fitstats.py)": "A6.6 (b) 3",
}

_CONSTRUCTIONS = [0]
_PROCESS_MESH: Optional["Mesh"] = None
_PROCESS_MESH_LOCK = threading.Lock()
#: the mesh whose ``data`` ranks hold row shards of the current fit's
#: inputs (:func:`sharded_scope`)
_SHARDED = [None]
_STATS = {"all_reduce": 0, "all_reduce_s": 0.0, "all_reduce_bytes": 0}
_STATS_LOCK = threading.Lock()
#: (start, end) CUDA events around all-reduces whose time is not summed yet
_PENDING: list = []


def _dist():
    import torch.distributed as dist
    return dist


def _world() -> int:
    """Ranks of the initialized process group (1 without one)."""
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _rank() -> int:
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Mesh:
    """A (data, grid) mesh over ranks: ``ranks`` [data, grid] global
    ranks, ``backend`` the groups' backend (None for one rank),
    ``groups`` the ``data`` / ``grid`` process group this rank belongs to
    (None on an axis of one rank), ``device_mesh`` the
    ``torch.distributed.device_mesh.DeviceMesh`` over them (None for one
    rank). A rank outside ``ranks`` holds a mesh it is not part of: it
    computes alone (:func:`mesh_if_multi` gives None)."""

    axis_names = ("data", "grid")

    def __init__(self, ranks: np.ndarray, backend: Optional[str] = None,
                 groups: Optional[Dict[str, Any]] = None,
                 device_mesh=None, rank: int = 0):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.backend = backend
        self.groups = dict(groups or {})
        self.device_mesh = device_mesh
        self.rank = int(rank)
        hit = np.argwhere(self.ranks == self.rank)
        self.member = len(hit) > 0
        self.coord = tuple(int(v) for v in hit[0]) if self.member else None

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": int(self.ranks.shape[0]),
                "grid": int(self.ranks.shape[1])}

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def axis_index(self, axis: str) -> int:
        """This rank's position on ``axis`` (0 outside the mesh)."""
        if not self.member:
            return 0
        return self.coord[self.axis_names.index(axis)]

    def group(self, axis: str):
        """The process group of this rank's ``axis`` line, or None when
        the line holds one rank."""
        if self.shape[axis] <= 1 or not self.member:
            return None
        return self.groups[axis]

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, grid={self.shape['grid']}"
                f", backend={self.backend})")


def mesh_enabled() -> bool:
    """True when the mesh is on (``TMOG_MESH``)."""
    return MESH_ENABLED


def mesh_constructions() -> int:
    """How many meshes this process has built (:func:`make_mesh` calls)."""
    return _CONSTRUCTIONS[0]


def _device_type() -> str:
    """The DeviceMesh's device type: the rank's card where it has one."""
    return "cuda" if torch.cuda.is_available() else "cpu"


def _build_groups(ranks: np.ndarray, backend: str):
    """Every rank of the world makes every data and grid line's group, in
    one order (``new_group`` is collective over the world), and keeps its
    own; then the DeviceMesh over the mesh's two groups."""
    dist = _dist()
    from .multihost import collective_timeout
    me = _rank()
    groups: Dict[str, Any] = {}
    lines = {"data": [ranks[:, j] for j in range(ranks.shape[1])],
             "grid": [ranks[i, :] for i in range(ranks.shape[0])]}
    for axis, axis_lines in lines.items():
        for line in axis_lines:
            g = dist.new_group([int(r) for r in line], backend=backend,
                               timeout=collective_timeout())
            if me in line:
                groups[axis] = g
    device_mesh = None
    if me in ranks:
        from torch.distributed.device_mesh import DeviceMesh
        device_mesh = DeviceMesh.from_group(
            [groups["data"], groups["grid"]], _device_type(),
            mesh=torch.as_tensor(ranks), mesh_dim_names=("data", "grid"))
    return groups, device_mesh


def make_mesh(n_devices: Optional[int] = None, grid_size: int = 1,
              devices: Optional[Sequence[int]] = None,
              grid_axis: Optional[int] = None) -> Mesh:
    """2-D ``(data, grid)`` mesh over the world's ranks (``devices``:
    global ranks, default all of them).

    ``grid_size`` is the (fold × grid point) batch the caller wants to
    spread; the grid axis is the largest power of two dividing the rank
    count that does not exceed it. An explicit ``grid_axis`` overrides the
    sizing and must divide the rank count.

    Impossible splits raise a ``ValueError``: more ranks than the world
    holds (a world of one process holds one: start ranks with
    ``torchrun``), a non-positive count, a ``grid_axis`` that does not
    divide the count. Every rank of the world must make the same meshes
    in the same order (their process groups are made together)."""
    world = _world()
    devs = list(devices) if devices is not None else list(range(world))
    if n_devices is not None:
        if n_devices < 1:
            raise ValueError(
                f"make_mesh: n_devices must be >= 1, got {n_devices}")
        if n_devices > len(devs):
            raise ValueError(
                f"make_mesh: n_devices={n_devices} exceeds the world's "
                f"{len(devs)} rank(s) — an oversized request must not "
                "silently shrink to what exists; start one process a "
                f"device, e.g. `torchrun --nproc-per-node {n_devices} ...`")
        devs = devs[:n_devices]
    n = len(devs)
    if n == 0:
        raise ValueError("make_mesh: no ranks to build a mesh over")
    if grid_axis is not None:
        if grid_axis < 1 or n % grid_axis != 0:
            raise ValueError(
                f"make_mesh: impossible (data, grid) split — grid_axis="
                f"{grid_axis} does not divide the {n} rank(s) evenly "
                f"(data axis would be {n}/{grid_axis})")
    else:
        grid_axis = 1
        while (n % (grid_axis * 2) == 0 and grid_axis * 2 <= max(grid_size, 1)
               and grid_axis * 2 <= n):
            grid_axis *= 2
    ranks = np.asarray(devs, dtype=np.int64).reshape(n // grid_axis,
                                                    grid_axis)
    _CONSTRUCTIONS[0] += 1
    me = _rank()
    if n == 1:
        # one rank: no group, no collective (every rank of a larger world
        # asking for one device computes alone)
        return Mesh(np.asarray([[me]]), rank=me)
    from .multihost import backend as world_backend
    backend = world_backend()
    groups, device_mesh = _build_groups(ranks, backend)
    return Mesh(ranks, backend=backend, groups=groups,
                device_mesh=device_mesh, rank=me)


def feature_shard_mesh(n_shards: int,
                       devices: Optional[Sequence[int]] = None) -> Mesh:
    """(data × grid) mesh with a ``grid`` axis of exactly ``n_shards`` —
    what the tree engine's column sharding needs (``featureShards``
    engages only when the active mesh's grid axis equals it). Raises like
    :func:`make_mesh` when ``n_shards`` does not divide the rank count."""
    return make_mesh(devices=devices, grid_axis=int(n_shards))


def process_default_mesh() -> Mesh:
    """The process-wide ``(data, grid)`` mesh over every rank of the
    world, built once: data-heavy (grid axis 1); a grid axis is opt-in
    through :func:`set_process_mesh` / the runner's
    ``customParams.meshGridSize``. Without a process group it is the
    degenerate 1×1."""
    global _PROCESS_MESH
    if _PROCESS_MESH is None:
        with _PROCESS_MESH_LOCK:
            if _PROCESS_MESH is None:
                _PROCESS_MESH = make_mesh(grid_size=1)
    return _PROCESS_MESH


def set_process_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Install ``mesh`` as the process default (``None`` resets: the next
    :func:`process_default_mesh` builds over the world again). Returns
    the previous one — the runner's run-scoped mesh knobs restore it."""
    global _PROCESS_MESH
    with _PROCESS_MESH_LOCK:
        prev = _PROCESS_MESH
        _PROCESS_MESH = mesh
    return prev


def mesh_if_multi(mesh) -> Optional[Mesh]:
    """``mesh`` when it spans more than one rank and this rank is in it,
    else None (``False``, the force-unsharded sentinel, too): the
    degenerate mesh routes consumers onto the single-process path."""
    if mesh is None or mesh is False or not MESH_ENABLED:
        return None
    return mesh if mesh.size > 1 and mesh.member else None


def stage_mesh(stage) -> Optional[Mesh]:
    """The mesh a stage's fit shards over (:func:`mesh_if_multi`-
    normalized): its ``mesh`` when a workflow assigned one (``_mesh_auto``,
    even a resolved None) or the caller set it (False: the
    single-process path), else the process default."""
    m = getattr(stage, "mesh", None)
    if m is None and not getattr(stage, "_mesh_auto", False):
        m = process_default_mesh()
    return mesh_if_multi(m)


def mesh_topology(mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """JSON-ready topology of ``mesh`` (default: the process mesh) for
    the metrics documents: ranks, axis sizes, platform, backend."""
    if mesh is None:
        mesh = process_default_mesh()
    platform = "gpu" if _device_type() == "cuda" else "cpu"
    return {"devices": mesh.size, "data": mesh.shape["data"],
            "grid": mesh.shape["grid"], "platform": platform,
            "backend": mesh.backend, "enabled": MESH_ENABLED}


# ---------------------------------------------------------------------------
# row sharding
# ---------------------------------------------------------------------------

def data_sharding(mesh: Mesh, n: int) -> slice:
    """This rank's rows of ``n`` rows padded to a multiple of the ``data``
    axis: ``slice(lo, lo + per)``, ``per = ceil(n / data)`` (rows past
    ``n`` are padding)."""
    d = mesh.shape["data"]
    per = max(-(-int(n) // d), 1)
    lo = mesh.axis_index("data") * per
    return slice(lo, lo + per)


def local_rows(mesh: Mesh, a, axis: int = 0):
    """This rank's rows of ``a`` (numpy or torch) along ``axis``
    (:func:`data_sharding`), zero rows past the end."""
    n = a.shape[axis]
    sl = data_sharding(mesh, n)
    per = sl.stop - sl.start
    lo, hi = min(sl.start, n), min(sl.stop, n)
    if torch.is_tensor(a):
        part = a.narrow(axis, lo, hi - lo)
        if hi - lo == per:
            return part.contiguous()
        shape = list(a.shape)
        shape[axis] = per - (hi - lo)
        return torch.cat([part, torch.zeros(shape, dtype=a.dtype,
                                            device=a.device)], dim=axis)
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(lo, hi)
    part = np.asarray(a)[tuple(idx)]
    if hi - lo == per:
        return np.ascontiguousarray(part)
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, per - (hi - lo))
    return np.pad(part, pad)


def pad_rows(X, y, w_folds, multiple: int):
    """Pad the row dimension to a multiple with zero-weight rows (every
    fit reduction is sample-weighted, so they are inert). Returns (X, y,
    w_folds, n_original)."""
    n = X.shape[0]
    pad = (-n) % multiple
    if pad == 0:
        return X, y, w_folds, n
    X = np.concatenate([X, np.zeros((pad, X.shape[1]), dtype=X.dtype)])
    y = np.concatenate([y, np.zeros((pad,), dtype=y.dtype)])
    w_folds = np.concatenate(
        [w_folds, np.zeros((w_folds.shape[0], pad), dtype=w_folds.dtype)],
        axis=1)
    return X, y, w_folds, n


def shard_cv_inputs(mesh: Mesh, X, y, w_folds, extra=None):
    """This rank's rows of the CV inputs: X [n, d], y [n], w_folds [K, n]
    (and ``extra`` [K, n], e.g. the validation weights), padded with
    zero-weight rows to a multiple of the ``data`` axis. Returns (X, y,
    w, n_orig) or (X, y, w, extra, n_orig); ``n_orig`` is where a
    gathered output is cut (:func:`gather_rows`)."""
    X, y, w_folds = np.asarray(X), np.asarray(y), np.asarray(w_folds)
    X, y, w_folds, n_orig = pad_rows(X, y, w_folds, mesh.shape["data"])
    sl = data_sharding(mesh, n_orig)
    out = [X[sl], y[sl], w_folds[:, sl]]
    if extra is not None:
        extra = np.asarray(extra)
        pad = X.shape[0] - extra.shape[1]
        if pad:
            extra = np.concatenate(
                [extra, np.zeros((extra.shape[0], pad), extra.dtype)], axis=1)
        out.append(extra[:, sl])
    return tuple(out) + (n_orig,)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def all_reduce(t: torch.Tensor, mesh: Optional[Mesh],
               axis: str = "data") -> torch.Tensor:
    """Sum ``t`` in place over this rank's ``axis`` group (nothing on an
    axis of one rank, or without a mesh); returns ``t``. Every rank of the
    group gets the same bits."""
    g = None if mesh is None else mesh.group(axis)
    if g is None:
        return t
    if t.is_cuda:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        _dist().all_reduce(t, group=g)
        ev[1].record()
        dt = 0.0
    else:
        ev = None
        t0 = time.perf_counter()
        _dist().all_reduce(t, group=g)
        dt = time.perf_counter() - t0
    with _STATS_LOCK:
        _STATS["all_reduce"] += 1
        _STATS["all_reduce_s"] += dt
        _STATS["all_reduce_bytes"] += t.numel() * t.element_size()
        if ev is not None:
            _PENDING.append(ev)
            _fold_pending(wait=False)
    return t


def _fold_pending(wait: bool) -> None:
    """Add the finished (all, when ``wait``) pending event pairs' times to
    the seconds; the caller holds the lock."""
    keep = []
    for start, end in _PENDING:
        if wait:
            end.synchronize()
        if wait or end.query():
            _STATS["all_reduce_s"] += start.elapsed_time(end) / 1e3
        else:
            keep.append((start, end))
    _PENDING[:] = keep


def gather_rows(mesh: Optional[Mesh], t: torch.Tensor,
                n: int) -> torch.Tensor:
    """Every rank's rows of ``t`` ([per, ...], :func:`data_sharding` of
    ``n``) as the whole [n, ...] on every rank: each rank writes its rows
    into a zero-filled [data · per, ...] buffer and the buffers are
    summed (x + 0 = x, so the rows are exact)."""
    g = None if mesh is None else mesh.group("data")
    if g is None:
        return t[:n]
    per = t.shape[0]
    buf = torch.zeros((per * mesh.shape["data"],) + tuple(t.shape[1:]),
                      dtype=t.dtype, device=t.device)
    lo = mesh.axis_index("data") * per
    buf[lo:lo + per] = t
    return all_reduce(buf, mesh, "data")[:n]


def gather_axis(mesh: Optional[Mesh], t: torch.Tensor,
                axis: str = "grid") -> torch.Tensor:
    """[size, *t.shape]: ``t`` of every rank on this rank's ``axis``
    line, by position, through a zero-filled buffer summed over the
    group."""
    size = 1 if mesh is None else mesh.shape[axis]
    if mesh is None or mesh.group(axis) is None:
        return t[None]
    buf = torch.zeros((size,) + tuple(t.shape), dtype=t.dtype,
                      device=t.device)
    buf[mesh.axis_index(axis)] = t
    return all_reduce(buf, mesh, axis)


@contextlib.contextmanager
def sharded_scope(mesh):
    """The block's fits take rank-local rows of ``mesh`` (normalized by
    :func:`mesh_if_multi`; None or the degenerate mesh: the
    single-process path): the tree histograms and the linear solvers'
    row sums are summed over its ``data`` group. Re-entrant; the previous
    scope is restored on exit."""
    prev = _SHARDED[0]
    _SHARDED[0] = mesh_if_multi(mesh)
    try:
        yield _SHARDED[0]
    finally:
        _SHARDED[0] = prev


def active_sharded_mesh() -> Optional[Mesh]:
    """The mesh of :func:`sharded_scope`, or None."""
    return _SHARDED[0]


def collective_stats() -> Dict[str, Any]:
    """All-reduces made by :func:`all_reduce` in this process, their
    seconds and bytes. A CUDA tensor's all-reduce is timed by CUDA events
    on the current stream around it: from the moment the stream has run
    the work queued before it until its result is on the stream, under
    either backend (gloo's host staging included, the kernels queued
    before it not; a wait for a slower rank included). A CPU tensor's is
    timed by the host clock. Waits for the pending events."""
    with _STATS_LOCK:
        _fold_pending(wait=True)
        return dict(_STATS)


def reset_collective_stats() -> None:
    with _STATS_LOCK:
        _PENDING.clear()
        _STATS.update(all_reduce=0, all_reduce_s=0.0, all_reduce_bytes=0)
