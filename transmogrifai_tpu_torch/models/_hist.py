"""The tree engine's kernels: CUDA wrappers, plain PyTorch versions, and
the build.

Counterpart of ``transmogrifai_tpu/models/_pallas_hist.py``. Each kernel
has a wrapper and a plain version of the same function:

* ``cumhist`` — level histograms ``cum[s,c,t,f] = Σ_i 1[node_i=s] ·
  1[bin_fi ≤ t] · stats_ic`` ([A, C, B, F]); ``bc=`` takes the
  precomputed ``bin ≤ t`` indicator from :func:`make_bc` (counted as
  ``cumhist_bc``).
* ``cumhist_sparse01`` — the same [A, C, 2, Fb] histograms for a 2-bin
  block of 0/1 indicator columns, from the block itself: t=1 is the
  per-slot total, t=0 the total minus the nonzero side.
* ``group_rows`` — the live rows sorted by slot (stable), each slot's
  segment padded to the MMA K-step: the row order both histogram kernels
  read. The port's own helper; no TPU kernel corresponds to it.
* ``split_scan`` — per slot, the best (score, t-major flat index t·F+f,
  valid) over a cumulative histogram.
* ``route_level`` — per row, (slot, g) → (child slot, 2g + right), from
  the slot tables.
* ``level_epilogue`` — a tree level after its split scans, in one launch:
  the blocks' winners merged and decoded, the exact gains, ``do_split``,
  the gain ranking and child slots, the node and leaf records, the next
  level's slot state, and every row routed (``route_level``'s TPU kernel
  with the bookkeeping XLA fuses around it in the JAX package).
* ``predict_trees`` — rows down stacked level-order trees, summed leaves.
  It is the one kernel a scoring program reaches, so it is an operator,
  ``tmog_torch::predict_trees`` (``torch.library.custom_op``, registered
  when this module is imported): its CPU implementation is the plain
  version, its CUDA one the kernel's launch, and its fake implementation
  the empty [n, K] result, so ``torch.export`` traces a tree model's
  program with the operator in its graph and a loaded program finds it
  again. The other wrappers stay direct calls: the dispatcher adds tens
  of µs of host time a call (``chip_smoke.py`` times it), and a tree
  level makes 12–22 launches.

On the card the two histograms multiply each slot's live rows only: the
level loop calls :func:`group_rows` once and passes its result as
``groups=`` to every block's histogram, and each fit makes the row-major
uint8 copies the kernels gather rows from (:func:`hist_rows`,
:func:`sparse01_rows`, and :func:`bc_rows` for ``bc=``; ``rows=``) once.
A wrapper given neither makes them itself.

A wrapper given tensors on the CPU runs the plain version (what the CPU
tests use); given CUDA tensors it launches its kernel or raises — there
is no fallback. The plain versions work on any device and are what the
card's kernels are checked against.

The kernels are CUDA C++ for ``sm_90a`` in ``../csrc``. Each source is
built by its own ``nvcc`` into a shared library with a plain C interface
(all started together, on first use, into ``build/torch_ext/`` at the
repository root) and bound with ``ctypes``. Every launch returns
``cudaGetLastError()``, and the wrapper raises on anything but success.

``KERNEL_LAUNCHES`` counts, per kernel, the launches its wrapper made
(one per wrapper call that reached the card; for ``predict_trees`` the
operator's CUDA implementation counts, so a trace counts nothing). A
wrapper called while a CUDA graph is captured records its kernel instead
of launching it; the scoring engine takes those counts back after the
capture and adds them at each replay of the graph
(:func:`count_graph_replay`), which is where the recorded kernels launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

#: the most stat channels (classes + the count) and leaf values the card's
#: tree kernels take
MAX_CARD_CHANNELS = 8

#: what a tree fit or predict of more than seven classes waits for on the
#: card (C > 8 stat channels or K > 8 leaf values)
WIDE_CLASSES_ITEM = ("more than seven classes on the card: wider channel "
                     "templates for the histograms, the split scan and the "
                     "level epilogue, and K in chunks of 8 for "
                     "predict_trees, ROADMAP queue B, item 7")

__all__ = ["cumhist", "cumhist_reference", "make_bc", "hist_rows",
           "bc_rows", "cumhist_sparse01", "cumhist_sparse01_reference",
           "sparse01_rows", "group_rows", "group_rows_reference",
           "group_chunk", "KSTEP",
           "split_scan", "split_scan_reference", "route_level",
           "route_level_reference", "split_gain", "level_epilogue",
           "level_epilogue_reference", "predict_trees",
           "predict_trees_reference", "predict_trees_chunk", "build_kernels",
           "KERNEL_LAUNCHES", "reset_launch_counts", "count_graph_replay",
           "SPLIT_NEG"]

#: masked-out candidate score (the criteria's scores are all ≥ 0)
SPLIT_NEG = -1e30
_EPS = 1e-12
#: the operator ``predict_trees`` is registered as (see the module
#: docstring); an exported scoring program names it
PREDICT_TREES_OP = "tmog_torch::predict_trees"
_KINDS = {"variance": 0, "gini": 1, "xgb": 2}

KERNEL_LAUNCHES: Dict[str, int] = {"cumhist": 0, "cumhist_bc": 0,
                                   "cumhist_sparse01": 0, "group_rows": 0,
                                   "split_scan": 0, "route_level": 0,
                                   "level_epilogue": 0, "predict_trees": 0}


def reset_launch_counts() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


def count_graph_replay(launches: Dict[str, int]) -> None:
    """One replay of a CUDA graph that holds ``launches`` kernel launches
    (per kernel, as the wrappers counted them during the capture)."""
    for k, v in launches.items():
        KERNEL_LAUNCHES[k] += v


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
_NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               # no contraction into multiply-add: split_scan's scores
               # must equal the plain version's IEEE f32 op sequence
               "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C entry point → (source stem, argtypes)
_ENTRY = {
    "cumhist_launch": ("cumhist", [_P] * 6 + [_I] * 8 + [_P]),
    "cumhist_bc_launch": ("cumhist", [_P] * 6 + [_I] * 8 + [_P]),
    "cumhist_sparse01_launch": ("cumhist_sparse01",
                                [_P] * 6 + [_I] * 7 + [_P]),
    "group_rows_launch": ("group_rows", [_P] * 4 + [_I] * 2 + [_P]),
    "split_scan_launch": ("split_scan",
                          [_P, _P] + [_I] * 5 + [_F] * 3 + [_P] * 4),
    "route_level_launch": ("route_level", [_P] * 10 + [_I] * 3 + [_P]),
    "level_epilogue_launch": ("route_level", [ctypes.c_void_p, _P]),
    "level_epilogue_smem": ("route_level", [_I, _I]),
    "predict_trees_launch": ("predict_trees",
                             [_P] * 5 + [_I] * 5 + [_P]),
    "predict_trees_chunk": ("predict_trees", [_I] * 3),
}
_STEMS = tuple(dict.fromkeys(stem for stem, _ in _ENTRY.values()))

_LIBS: Dict[str, ctypes.CDLL] = {}
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    for cand in ((os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
                  else None), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build_kernels() -> float:
    """Build (when their sources changed) and load all the kernel
    libraries; returns the seconds spent. One ``nvcc`` per source, all
    started together; outputs are keyed by a hash of the source, the
    shared headers and the flags."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        if len(_LIBS) == len(_STEMS):
            return 0.0
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        headers = b"".join(p.read_bytes()
                           for p in sorted(_CSRC.glob("*.cuh")))
        nvcc = None
        jobs = []
        targets = {}
        for stem in _STEMS:
            src = _CSRC / f"{stem}.cu"
            tag = hashlib.sha1(src.read_bytes() + headers
                               + " ".join(_NVCC_FLAGS).encode()).hexdigest()
            out = _BUILD_DIR / f"{stem}-{tag[:16]}.so"
            targets[stem] = out
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            jobs.append((stem, proc, tmp, out))
        errors = []
        for stem, proc, tmp, out in jobs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{stem}.cu:\n{log.decode(errors='replace')}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(errors))
        libs = {stem: ctypes.CDLL(str(targets[stem])) for stem in _STEMS}
        for fn_name, (stem, argtypes) in _ENTRY.items():
            fn = getattr(libs[stem], fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS.update(libs)
    return time.perf_counter() - t0


def _call(fn_name: str, *args) -> int:
    """Call entry point ``fn_name`` (building the kernels first if need
    be); returns its int."""
    stem = _ENTRY[fn_name][0]
    if stem not in _LIBS:
        build_kernels()
    return getattr(_LIBS[stem], fn_name)(*args)


def _launch(kernel: str, fn_name: str, *args) -> None:
    """Call entry point ``fn_name``; count one launch of ``kernel``."""
    rc = _call(fn_name, *args)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES[kernel] += 1


def _check(t: torch.Tensor, name: str, dtype: torch.dtype,
           shape: Tuple[Optional[int], ...], device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and t.shape[i] != s for i, s in enumerate(shape)):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}")
    return False


# ---------------------------------------------------------------------------
# group_rows: live rows by slot, the grouped histograms' row order
# ---------------------------------------------------------------------------

#: the MMA K-step of csrc/grouped_hist.cuh: every slot's segment of the
#: grouped order is padded to a multiple of it
KSTEP = 16
#: group_rows' kernel takes at most this many slots (csrc/group_rows.cu)
GROUP_MAX_SLOTS = 1024


def group_rows_reference(node: torch.Tensor, n_nodes: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`group_rows`: one stable ``argsort`` of the
    slots (idle rows last), ``bincount`` and ``cumsum`` for the padded
    segment offsets, and a scatter into the padded layout."""
    n, A = node.shape[0], int(n_nodes)
    dev = node.device
    cap = n + (KSTEP - 1) * A
    key = torch.where((node >= 0) & (node < A), node.long(),
                      torch.full_like(node, A, dtype=torch.long))
    perm = torch.argsort(key, stable=True)
    ks = key[perm]
    cnt = torch.bincount(key, minlength=A + 1)[:A]
    seg_off = torch.zeros(A + 1, dtype=torch.long, device=dev)
    seg_off[1:] = torch.cumsum((cnt + KSTEP - 1) // KSTEP * KSTEP, 0)
    first = torch.zeros(A + 1, dtype=torch.long, device=dev)
    first[1:] = torch.cumsum(cnt, 0)                # unpadded, sorted order
    kc = ks.clamp(max=A - 1)
    dest = torch.where(ks < A, seg_off[kc] + torch.arange(n, device=dev)
                       - first[kc], torch.full_like(ks, cap))
    order = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    order[dest] = perm.to(torch.int32)              # idle rows → dropped cap
    return order[:cap], seg_off.to(torch.int32)


def group_rows(node: torch.Tensor, n_nodes: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[n] int32 slots (idle rows: outside [0, A)) → (order [n + 15·A]
    int32, seg_off [A + 1] int32): slot s's live row ids in increasing
    order at ``order[seg_off[s]:seg_off[s+1]]``, each segment padded to a
    multiple of :data:`KSTEP` with the id n (a zero row), the tail past
    ``seg_off[A]`` too. What the histogram wrappers' ``groups=`` takes;
    the level loop makes it once per level for all blocks. Kernel: int32,
    A ≤ 1024."""
    if _on_cpu(node):
        return group_rows_reference(node, n_nodes)
    dev = node.device
    n, A = node.shape[0], int(n_nodes)
    _check(node, "node", torch.int32, (n,), dev)
    if not (n >= 1 and 1 <= A <= GROUP_MAX_SLOTS):
        raise ValueError(f"group_rows: unsupported shape n={n} A={A}")
    counts = torch.empty(A * (-(-n // 1024)), dtype=torch.int32, device=dev)
    order = torch.empty(n + (KSTEP - 1) * A, dtype=torch.int32, device=dev)
    seg_off = torch.empty(A + 1, dtype=torch.int32, device=dev)
    _launch("group_rows", "group_rows_launch", node.data_ptr(),
            counts.data_ptr(), order.data_ptr(), seg_off.data_ptr(), n, A,
            _stream(dev))
    return order, seg_off


#: the grouped kernels' chunks of the order aim at this many blocks (four
#: per SM of an H100); a function of (n, A) only, so a call's summation
#: order is fixed
_GROUP_TARGET_CHUNKS = 4 * 132
#: chunk sizes are multiples of the kernels' 32-row stage
_STAGE_ROWS = 32


def group_chunk(n: int, n_nodes: int) -> Tuple[int, int]:
    """(positions per chunk, chunks) of the grouped order of n rows and A
    slots: the blocks of the grouped histogram kernels. A slot's partial
    sums are taken per chunk and added in chunk order."""
    cap = n + (KSTEP - 1) * int(n_nodes)
    per = -(-cap // _GROUP_TARGET_CHUNKS)
    chunk = max(64, -(-per // _STAGE_ROWS) * _STAGE_ROWS)
    return chunk, -(-cap // chunk)


def _groups_for(node: torch.Tensor, A: int, groups):
    if groups is None:
        return group_rows(node, A)
    order, seg_off = groups
    dev, n = node.device, node.shape[0]
    _check(order, "groups.order", torch.int32, (n + (KSTEP - 1) * A,), dev)
    _check(seg_off, "groups.seg_off", torch.int32, (A + 1,), dev)
    return order, seg_off


def _row_pad(width: int) -> int:
    return -(-width // 16) * 16


def hist_rows(XbT: torch.Tensor) -> torch.Tensor:
    """[F, n] bins (< 256) → the row-major uint8 [n, F rounded up to 16]
    copy :func:`cumhist`'s kernel gathers rows from; made once per fit."""
    F, n = XbT.shape
    out = torch.zeros((n, _row_pad(F)), dtype=torch.uint8, device=XbT.device)
    out[:, :F] = XbT.t()
    return out


def sparse01_rows(Xb01: torch.Tensor) -> torch.Tensor:
    """[Fb, n] 0/1 block → the row-major uint8 [n, Fb + 1 rounded up to
    16] copy :func:`cumhist_sparse01`'s kernel gathers rows from: the
    block's bytes (nonzero → 1), then an all-ones column at Fb (the
    per-slot total); made once per fit."""
    Fb, n = Xb01.shape
    out = torch.zeros((n, _row_pad(Fb + 1)), dtype=torch.uint8,
                      device=Xb01.device)
    out[:, :Fb] = Xb01.t() != 0
    out[:, Fb] = 1
    return out


def bc_rows(bc: torch.Tensor) -> torch.Tensor:
    """[B·F, n] 0/1 indicator of :func:`make_bc` → the row-major uint8
    [n, B·F rounded up to 16] copy ``cumhist(..., bc=...)``'s kernel
    gathers rows from: ``bc.t()``, zero-padded; made once per fit."""
    M, n = bc.shape
    out = torch.zeros((n, _row_pad(M)), dtype=torch.uint8, device=bc.device)
    out[:, :M] = bc.t()
    return out


# ---------------------------------------------------------------------------
# cumhist
# ---------------------------------------------------------------------------

def make_bc(XbT: torch.Tensor, n_bins: int) -> torch.Tensor:
    """[F, n] bins → [B·F, n] uint8 ``bin ≤ t`` indicator, row t·F + f —
    the precomputed operand of ``cumhist(..., bc=...)``."""
    thr = torch.arange(n_bins, device=XbT.device, dtype=XbT.dtype)
    return (XbT[None, :, :] <= thr[:, None, None]).to(torch.uint8).reshape(
        n_bins * XbT.shape[0], XbT.shape[1])


def cumhist_reference(stats: torch.Tensor, node: torch.Tensor,
                      XbT: torch.Tensor, n_nodes: int, n_bins: int, *,
                      bc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: ``(one_hot(node) ⊗ stats)ᵀ @ (bin ≤ t)``, as
    ``_treefit._level_cumhist``. f32 stats are rounded to bf16 first and
    the products summed in f32 (counts stay exact); f64 stays f64."""
    F, n = XbT.shape
    C = stats.shape[1]
    st = (stats.to(torch.bfloat16).to(torch.float32)
          if stats.dtype == torch.float32 else stats)
    NS = torch.zeros((n, n_nodes, C), dtype=st.dtype, device=st.device)
    rows = torch.nonzero(node < n_nodes).squeeze(1)
    NS[rows, node[rows].long()] = st[rows]
    if bc is not None:
        Bc = bc.t().to(st.dtype)
    else:
        thr = torch.arange(n_bins, device=XbT.device, dtype=XbT.dtype)
        Bc = (XbT.t()[:, None, :] <= thr[None, :, None]).to(st.dtype)
    h = NS.reshape(n, n_nodes * C).t() @ Bc.reshape(n, n_bins * F)
    return h.reshape(n_nodes, C, n_bins, F)


def cumhist(stats: torch.Tensor, node: torch.Tensor, XbT: torch.Tensor,
            n_nodes: int, n_bins: int, *,
            bc: Optional[torch.Tensor] = None, groups=None,
            rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, C] stats + [n] node slots (idle rows: node == n_nodes) + [F, n]
    bins → [A, C, B, F] cumulative histograms.

    On the card the rows are grouped by slot (``groups``, the
    ``(order, seg_off)`` of :func:`group_rows` on ``node``, made here when
    not given) and the kernel gathers each live row's bins from ``rows``,
    the row-major uint8 copy of :func:`hist_rows` (made here when not
    given; a fit makes it once). With ``bc``, the 0/1 uint8 [B·F, n]
    indicator of :func:`make_bc`, the same kernel reads the indicator
    instead of comparing bins: ``rows`` is then :func:`bc_rows`' copy of
    ``bc`` (made here when not given; a fit would make it once) and its
    launches count under ``cumhist_bc``. Kernel: f32 stats, int32
    node/bins, C ≤ 8, B ≤ 256 (any B with ``bc``), any F. The CPU takes
    the plain version, which reads ``XbT`` (or ``bc``) and ignores
    ``groups`` and ``rows``."""
    if _on_cpu(stats):
        return cumhist_reference(stats, node, XbT, n_nodes, n_bins, bc=bc)
    dev = stats.device
    F, n = XbT.shape
    C = stats.shape[1]
    A, B = int(n_nodes), int(n_bins)
    _check(stats, "stats", torch.float32, (n, C), dev)
    _check(node, "node", torch.int32, (n,), dev)
    _check(XbT, "XbT", torch.int32, (F, n), dev)
    if not (1 <= C <= MAX_CARD_CHANNELS and A >= 1 and B >= 1 and n >= 1):
        raise ValueError(f"cumhist: unsupported shape n={n} C={C} A={A} "
                         f"B={B}")
    if (B > 256 and bc is None) or B * F >= 2 ** 31:
        raise ValueError(f"cumhist: B={B} > 256 does not fit the uint8 row "
                         f"copy, or B·F={B * F} overflows the kernel's int")
    if bc is not None:
        _check(bc, "bc", torch.uint8, (B * F, n), dev)
        kernel, width = "cumhist_bc", B * F
        if rows is None:
            rows = bc_rows(bc)
    else:
        kernel, width = "cumhist", F
        if rows is None:
            rows = hist_rows(XbT)
    _check(rows, "rows", torch.uint8, (n, _row_pad(width)), dev)
    order, seg_off = _groups_for(node, A, groups)
    chunk, n_chunks = group_chunk(n, A)
    partial = torch.empty((n_chunks + A) * C * B * F, dtype=torch.float32,
                          device=dev)
    out = torch.empty((A, C, B, F), dtype=torch.float32, device=dev)
    _launch(kernel, f"{kernel}_launch", stats.data_ptr(), rows.data_ptr(),
            order.data_ptr(), seg_off.data_ptr(), partial.data_ptr(),
            out.data_ptr(), n, C, A, B, F, rows.shape[1], chunk, n_chunks,
            _stream(dev))
    return out


def cumhist_sparse01_reference(stats: torch.Tensor, node: torch.Tensor,
                               Xb01: torch.Tensor,
                               n_nodes: int) -> torch.Tensor:
    """Plain version: ``(one_hot(node) ⊗ stats)ᵀ @ [X | 1]`` — the nonzero
    side of each column and, from the all-ones column, the per-slot total
    — then t=0 = total − nonzero side and t=1 = total. f32 stats are
    rounded to bf16 first and the products summed in f32 (counts stay
    exact); f64 stays f64."""
    Fb, n = Xb01.shape
    C = stats.shape[1]
    A = int(n_nodes)
    st = (stats.to(torch.bfloat16).to(torch.float32)
          if stats.dtype == torch.float32 else stats)
    NS = torch.zeros((n, A, C), dtype=st.dtype, device=st.device)
    rows = torch.nonzero(node < A).squeeze(1)
    NS[rows, node[rows].long()] = st[rows]
    X1 = torch.cat([(Xb01.t() != 0).to(st.dtype),
                    torch.ones((n, 1), dtype=st.dtype, device=st.device)],
                   dim=1)
    h = NS.reshape(n, A * C).t() @ X1                  # [A·C, Fb + 1]
    tot = h[:, Fb:].expand(A * C, Fb)
    return torch.stack([tot - h[:, :Fb], tot], dim=1).reshape(A, C, 2, Fb)


def cumhist_sparse01(stats: torch.Tensor, node: torch.Tensor,
                     Xb01: torch.Tensor, n_nodes: int, *, groups=None,
                     rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, C] stats + [n] node slots (idle rows: node == n_nodes) + [Fb, n]
    0/1 block → [A, C, 2, Fb] histograms, as :func:`cumhist` at B=2 on the
    same bins.

    The public layout is the JAX package's [Fb, n]; the kernel gathers
    rows from ``rows``, the row-major uint8 copy of :func:`sparse01_rows`
    (made here when not given; a fit makes it once), grouped by slot
    (``groups`` as in :func:`cumhist`). Kernel: f32 stats, int32 node,
    uint8 block, C ≤ 8. The CPU takes the plain version, which reads
    ``Xb01`` and ignores ``groups`` and ``rows``."""
    if _on_cpu(stats):
        return cumhist_sparse01_reference(stats, node, Xb01, n_nodes)
    dev = stats.device
    Fb, n = Xb01.shape
    C = stats.shape[1]
    A = int(n_nodes)
    _check(stats, "stats", torch.float32, (n, C), dev)
    _check(node, "node", torch.int32, (n,), dev)
    _check(Xb01, "Xb01", torch.uint8, (Fb, n), dev)
    if not (1 <= C <= MAX_CARD_CHANNELS and A >= 1 and Fb >= 1
            and n >= 1):
        raise ValueError(f"cumhist_sparse01: unsupported shape n={n} C={C} "
                         f"A={A} Fb={Fb}")
    if rows is None:
        rows = sparse01_rows(Xb01)
    _check(rows, "rows", torch.uint8, (n, _row_pad(Fb + 1)), dev)
    order, seg_off = _groups_for(node, A, groups)
    chunk, n_chunks = group_chunk(n, A)
    partial = torch.empty((n_chunks + A) * C * (Fb + 1), dtype=torch.float32,
                          device=dev)
    out = torch.empty((A, C, 2, Fb), dtype=torch.float32, device=dev)
    _launch("cumhist_sparse01", "cumhist_sparse01_launch", stats.data_ptr(),
            rows.data_ptr(), order.data_ptr(), seg_off.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, C, A, Fb, rows.shape[1],
            chunk, n_chunks, _stream(dev))
    return out


# ---------------------------------------------------------------------------
# split_scan
# ---------------------------------------------------------------------------

def split_scan_reference(cum: torch.Tensor, kind: str, min_instances, *,
                         lam: float = 0.0, min_child_weight=None,
                         mask: Optional[torch.Tensor] = None):
    """Plain version: the criterion's score over every (t < B−1, f)
    candidate, the min-instances / min-child-weight / [A, F] masks
    (masked score ``SPLIT_NEG``), and the first maximum along the t-major
    flat axis (``jnp.argmax`` on the XLA path). → (score [A], idx [A]
    int32, valid [A] bool)."""
    A, C, B, F = cum.shape
    dt = cum.dtype
    mi = torch.as_tensor(min_instances, dtype=dt, device=cum.device)

    def ch(c):
        return cum[:, c, :-1, :], cum[:, c, -1:, :]

    if kind == "variance":
        (wL, wT), (sL, sT) = ch(0), ch(1)
        sR, wR = sT - sL, wT - wL
        sb = sL * sL / torch.clamp(wL, min=_EPS) \
            + sR * sR / torch.clamp(wR, min=_EPS)
    elif kind == "gini":
        wL = wR = l2 = r2 = torch.zeros_like(cum[:, 0, :-1, :])
        for k in range(C - 1):
            lk, tk = ch(k)
            rk = tk - lk
            wL, wR = wL + lk, wR + rk
            l2, r2 = l2 + lk * lk, r2 + rk * rk
        sb = l2 / torch.clamp(wL, min=_EPS) + r2 / torch.clamp(wR, min=_EPS)
    elif kind == "xgb":
        (gL, gT), (hL, hT) = ch(0), ch(1)
        gR, hR = gT - gL, hT - hL
        sb = gL * gL / (hL + lam + _EPS) + gR * gR / (hR + lam + _EPS)
    else:
        raise ValueError(f"split_scan: unknown kind {kind!r}")
    lc, tc = ch(C - 1)
    ok = (lc >= mi) & (tc - lc >= mi)
    if kind == "xgb":
        mcw = torch.as_tensor(0.0 if min_child_weight is None
                              else min_child_weight, dtype=dt,
                              device=cum.device)
        hL, hT = ch(1)
        ok = ok & (hL >= mcw) & (hT - hL >= mcw)
    if mask is not None:
        ok = ok & (mask > 0.5)[:, None, :]
    flat = torch.where(ok, sb, torch.full_like(sb, SPLIT_NEG)).reshape(A, -1)
    best = torch.argmax(flat, dim=1)            # first maximum
    score = flat.gather(1, best[:, None])[:, 0]
    valid = ok.reshape(A, -1).gather(1, best[:, None])[:, 0]
    return score, best.to(torch.int32), valid


def split_scan(cum: torch.Tensor, kind: str, min_instances, *,
               lam: float = 0.0, min_child_weight=None,
               mask: Optional[torch.Tensor] = None, out=None):
    """[A, C, B, F] cumulative histograms → per-slot (best score [A],
    best t-major flat index [A] int32, valid [A] bool); ``kind`` ∈
    {"variance", "gini", "xgb"}; ``mask`` [A, F] (0/1) or None. Ties go
    to the lower flat index. ``out``: (score, idx, valid) [A] tensors to
    write into and return (the level loop passes the rows of one
    [blocks, A] table). Kernel: f32; ``valid`` is written in place as
    bool bytes (no conversion launch)."""
    if _on_cpu(cum):
        res = split_scan_reference(cum, kind, min_instances, lam=lam,
                                   min_child_weight=min_child_weight,
                                   mask=mask)
        if out is None:
            return res
        for o, r in zip(out, res):
            o.copy_(r)
        return tuple(out)
    dev = cum.device
    A, C, B, F = cum.shape
    _check(cum, "cum", torch.float32, (A, C, B, F), dev)
    if mask is not None:
        _check(mask, "mask", torch.float32, (A, F), dev)
    if kind not in _KINDS:
        raise ValueError(f"split_scan: unknown kind {kind!r}")
    if B < 2 or B * F >= 2 ** 31 or C < (3 if kind != "gini" else 2):
        raise ValueError(f"split_scan: unsupported shape {tuple(cum.shape)}")
    if out is None:
        score = torch.empty((A,), dtype=torch.float32, device=dev)
        idx = torch.empty((A,), dtype=torch.int32, device=dev)
        valid = torch.empty((A,), dtype=torch.bool, device=dev)  # 0/1 bytes
    else:
        score, idx, valid = out
        for name, t, dt in (("score", score, torch.float32),
                            ("idx", idx, torch.int32),
                            ("valid", valid, torch.bool)):
            _check(t, f"out {name}", dt, (A,), dev)
    mcw = 0.0 if min_child_weight is None else float(min_child_weight)
    _launch("split_scan", "split_scan_launch",
            cum.data_ptr(),
            mask.data_ptr() if mask is not None else None, A, C, B, F,
            _KINDS[kind], float(min_instances), mcw, float(lam),
            score.data_ptr(), idx.data_ptr(), valid.data_ptr(), _stream(dev))
    return score, idx, valid


# ---------------------------------------------------------------------------
# route_level
# ---------------------------------------------------------------------------

#: the route's and the epilogue's kernels take at most this many slots
_MAX_SLOTS = 2048


def route_level_reference(XbT, slot, g, f_idx, t_idx, lchild, rchild,
                          do_split, A_parent: int, A_child: int):
    """Plain version: right iff the slot splits and bin[f] > t; idle
    rows (slot ≥ A_parent) → A_child; g' = 2g + right."""
    live = slot < A_parent
    s = torch.clamp(slot, max=A_parent - 1).long()
    x = XbT.gather(0, f_idx.long()[s][None, :])[0]
    right = live & do_split[s] & (x > t_idx[s])
    child = torch.where(right, rchild[s], lchild[s])
    slot2 = torch.where(live, child, torch.full_like(child, A_child))
    return slot2.to(torch.int32), (2 * g + right.to(g.dtype)).to(torch.int32)


def route_level(XbT, slot, g, f_idx, t_idx, lchild, rchild, do_split,
                A_parent: int, A_child: int):
    """(slot, g) → (slot', g') for one tree level over [F, n] bins, from
    the [A_parent] slot tables. The level loop routes through
    :func:`level_epilogue`, which plans the tables itself; this is the
    route alone (the JAX ``route_level``'s signature). Kernel: int32
    throughout (``do_split`` bool), A_parent ≤ 2048; the five tables are
    read where they lie."""
    if _on_cpu(XbT):
        return route_level_reference(XbT, slot, g, f_idx, t_idx, lchild,
                                     rchild, do_split, A_parent, A_child)
    dev = XbT.device
    F, n = XbT.shape
    Ap = int(A_parent)
    _check(XbT, "XbT", torch.int32, (F, n), dev)
    _check(slot, "slot", torch.int32, (n,), dev)
    _check(g, "g", torch.int32, (n,), dev)
    for name, t in (("f_idx", f_idx), ("t_idx", t_idx),
                    ("lchild", lchild), ("rchild", rchild)):
        _check(t, name, torch.int32, (Ap,), dev)
    _check(do_split, "do_split", torch.bool, (Ap,), dev)
    if not 1 <= Ap <= _MAX_SLOTS:
        raise ValueError(f"route_level: A_parent={Ap} outside [1, "
                         f"{_MAX_SLOTS}]")
    slot2 = torch.empty_like(slot)
    g2 = torch.empty_like(g)
    _launch("route_level", "route_level_launch",
            XbT.data_ptr(), slot.data_ptr(), g.data_ptr(), f_idx.data_ptr(),
            t_idx.data_ptr(), lchild.data_ptr(), rchild.data_ptr(),
            do_split.data_ptr(), slot2.data_ptr(), g2.data_ptr(), n, Ap,
            int(A_child), _stream(dev))
    return slot2, g2


# ---------------------------------------------------------------------------
# level_epilogue: a tree level after its split scans
# ---------------------------------------------------------------------------

def split_gain(kind: str, l: torch.Tensor, t: torch.Tensor,
               lam: float = 0.0) -> torch.Tensor:
    """The exact gain at [A, C] left / total stats: Spark's Variance
    impurity decrease (``variance``; channels w, w·y, w·y², count),
    Spark's Gini impurity decrease (``gini``; channels: the class weights,
    then the count, which takes no part) or XGBoost's ½(G_L²/(H_L+λ) +
    G_R²/(H_R+λ) − G²/(H+λ)) (``xgb``; channels g, h, count). The
    epilogue kernel evaluates the same operations in the same order: the
    gini class sums run left to right over the channels, at any class
    count."""
    if kind == "variance":
        def imp(w, s1, s2):
            w = torch.clamp(w, min=_EPS)
            return s2 / w - (s1 / w) ** 2
        W = torch.clamp(t[:, 0], min=_EPS)
        wL, wR = l[:, 0], t[:, 0] - l[:, 0]
        return imp(t[:, 0], t[:, 1], t[:, 2]) \
            - (wL / W) * imp(wL, l[:, 1], l[:, 2]) \
            - (wR / W) * imp(wR, t[:, 1] - l[:, 1], t[:, 2] - l[:, 2])
    if kind == "gini":
        def imp(cls):
            w, q = cls[0], cls[0] * cls[0]
            for c in cls[1:]:
                w, q = w + c, q + c * c
            w = torch.clamp(w, min=_EPS)
            return 1.0 - q / (w * w), w
        K = l.shape[1] - 1
        lc = [l[:, k] for k in range(K)]
        tc = [t[:, k] for k in range(K)]
        iT, W = imp(tc)
        iL, wL = imp(lc)
        iR, wR = imp([b - a for a, b in zip(lc, tc)])
        W = torch.clamp(W, min=_EPS)
        return iT - (wL / W) * iL - (wR / W) * iR
    if kind == "xgb":
        def s(g, h):
            return g * g / (h + lam + _EPS)
        return 0.5 * (s(l[:, 0], l[:, 1])
                      + s(t[:, 0] - l[:, 0], t[:, 1] - l[:, 1])
                      - s(t[:, 0], t[:, 1]))
    raise ValueError(f"split_gain: unknown kind {kind!r}")


def level_epilogue_reference(score, idx, valid, cums, cols, sparse01, edges,
                             alive, gpos, XbT, slot, g, feat, thr, gain,
                             leaf_stats, *, kind: str, lam: float, mig,
                             d: int, max_depth: int, A_next: int,
                             split_ok: bool = True, node_even: bool = False):
    """Plain version of :func:`level_epilogue`, the level loop's eager
    code."""
    A = alive.shape[0]
    C = cums[0].shape[1]
    dev = alive.device
    D = max_depth
    total_nodes, n_leaves = (1 << D) - 1, 1 << D
    i32 = dict(dtype=torch.int32, device=dev)
    # the blocks' winners merge on the concatenated candidate axis: the
    # highest score, ties to the lower index (one argmax over the
    # concatenation)
    off = 0
    for bi, cumb in enumerate(cums):
        gi = off + idx[bi].long()
        if bi == 0:
            s_best, best, ok = score[0], gi, valid[0]
        else:
            take = (score[bi] > s_best) | ((score[bi] == s_best)
                                           & (gi < best))
            best = torch.where(take, gi, best)
            ok = torch.where(take, valid[bi], ok)
            s_best = torch.where(take, score[bi], s_best)
        off += (cumb.shape[2] - 1) * cumb.shape[3]
    # decode the winner in its block (later blocks override where the
    # winner lies in them); the exact gain is taken at the winner's
    # [A, C] left / total stats
    off = 0
    for bi, cumb in enumerate(cums):
        fb_n = cumb.shape[3]
        size = (cumb.shape[2] - 1) * fb_n
        local = best - off
        if len(cums) > 1:
            local = torch.clamp(local, 0, size - 1)
        fg = cols[bi][local % fb_n]
        tb = local // fb_n
        thr_b = (torch.full((A,), 0.5, dtype=edges.dtype, device=dev)
                 if sparse01[bi] else edges[fg, tb])
        lb = cumb[:, :, :-1, :].reshape(A, C, size).gather(
            2, local[:, None, None].expand(A, C, 1))[:, :, 0]
        if bi == 0:
            f_idx, t_idx, thr_v, lstats = fg, tb, thr_b, lb
        else:
            inb = best >= off
            f_idx = torch.where(inb, fg, f_idx)
            t_idx = torch.where(inb, tb, t_idx)
            thr_v = torch.where(inb, thr_b, thr_v)
            lstats = torch.where(inb[:, None], lb, lstats)
        off += size
    f_idx, t_idx = f_idx.to(torch.int32), t_idx.to(torch.int32)
    tstats = cums[0][:, :, -1, 0]
    best_gain = split_gain(kind, lstats, tstats, lam)
    do_split = alive & ok & (best_gain >= mig)
    if not split_ok:
        do_split = torch.zeros_like(do_split)
    f_idx = torch.where(do_split, f_idx, torch.zeros_like(f_idx))
    thr_rec = torch.where(do_split, thr_v,
                          torch.full_like(thr_v, float("inf")))

    # next level: rank splitting slots by gain, allocate child slots
    rank = torch.argsort(torch.where(
        do_split, -best_gain, torch.full_like(best_gain, float("inf"))),
        stable=True)
    inv = torch.empty((A,), **i32)
    inv[rank] = torch.arange(A, **i32)
    parent_ok = do_split & (inv < A_next // 2)
    sink = torch.full_like(inv, A_next)
    lchild = torch.where(parent_ok, 2 * inv, sink)
    rchild = torch.where(parent_ok, 2 * inv + 1, sink)
    slot2, g2 = route_level_reference(XbT, slot, g, f_idx, t_idx, lchild,
                                      rchild, do_split, A, A_next)
    # index A_next / total_nodes / n_leaves is a dropped sink entry
    gpos2 = torch.zeros((A_next + 1,), **i32)
    gpos2[lchild.long()] = 2 * gpos
    gpos2[rchild.long()] = 2 * gpos + 1
    alive2 = torch.zeros((A_next + 1,), dtype=torch.bool, device=dev)
    alive2[lchild.long()] = parent_ok
    alive2[rchild.long()] = parent_ok

    # record splits: node (d, j) lives at flat index (2^d − 1) + j
    node = torch.where(alive, (1 << d) - 1 + gpos,
                       torch.full_like(gpos, total_nodes)).long()
    feat[node] = f_idx
    thr[node] = thr_rec
    gain[node] = torch.where(do_split, best_gain,
                             torch.zeros_like(best_gain))
    # leaf stats: a node that stops splitting is a leaf over the
    # g-range [gpos << (D−d), …); a split whose children leave the
    # slot budget or that happens at the last level emits two leaves
    dying = alive & ~do_split
    no_leaf = torch.full_like(gpos, n_leaves)
    leaf_stats[torch.where(dying, gpos << (D - d), no_leaf).long()] = tstats
    emit = do_split & (~parent_ok | (d == D - 1))
    sh = D - d - 1
    li = torch.where(emit, (2 * gpos) << sh, no_leaf).long()
    ri = torch.where(emit, (2 * gpos + 1) << sh, no_leaf).long()
    leaf_stats[li] = lstats
    leaf_stats[ri] = tstats - lstats
    # the next level's sibling mask: left children (even slots) by parent
    even2 = None
    if node_even:
        even2 = torch.where((slot2 < A_next) & (slot2 % 2 == 0), slot2 // 2,
                            torch.full_like(slot2, A_next // 2))
    return (slot2, g2, even2, gpos2[:A_next], alive2[:A_next],
            rank[:A_next // 2])


#: candidate blocks the epilogue kernel merges (csrc/route_level.cu)
_MAX_CAND_BLOCKS = 4
#: dynamic shared memory an H100 block may use
_SMEM_MAX = 232448


class _EpilogueParams(ctypes.Structure):
    """``EpilogueParams`` of csrc/route_level.cu, field for field."""
    _fields_ = ([("cum", _P * _MAX_CAND_BLOCKS),
                 ("cols", _P * _MAX_CAND_BLOCKS)]
                + [(k, _I * _MAX_CAND_BLOCKS)
                   for k in ("n_bins", "width", "sparse01")]
                + [(k, _P) for k in (
                    "score", "idx", "valid", "edges", "alive", "gpos", "xbt",
                    "slot", "g", "slot2", "g2", "node_even2", "gpos2",
                    "alive2", "rank", "feat", "thr", "gain", "leaf_stats")]
                + [(k, _I) for k in (
                    "n_blocks", "edge_stride", "n", "A", "A_next", "C",
                    "kind", "split", "d", "D")]
                + [("lam", _F), ("mig", _F)])


def level_epilogue(score, idx, valid, cums, cols, sparse01, edges, alive,
                   gpos, XbT, slot, g, feat, thr, gain, leaf_stats, *,
                   kind: str, lam: float, mig, d: int, max_depth: int,
                   A_next: int, split_ok: bool = True,
                   node_even: bool = False):
    """One tree level after its split scans: A parent slots → A_next
    child slots.

    Inputs: every candidate block's ``split_scan`` results as [blocks, A]
    tables (``score``, ``idx`` int32, ``valid`` bool), the blocks'
    cumulative histograms ``cums`` ([A, C, n_bins_b, F_b] each; block 0's
    last bin holds the slot totals), their global columns ``cols`` (int64)
    and ``sparse01`` flags (stored threshold 0.5), ``edges`` [F, B−1], the
    slots' ``alive`` / ``gpos``, the bins ``XbT`` [F, n] and the rows'
    ``slot`` / ``g``; the criterion ``kind`` ("variance", "gini" or
    "xgb") with ``lam``, the gain floor ``mig``, level ``d`` of
    ``max_depth``, and ``split_ok`` (False past the depth limit: nothing
    splits).

    Writes the level's records in place — ``feat`` / ``thr`` / ``gain``
    [2^D] at flat index 2^d − 1 + gpos and ``leaf_stats`` [2^D + 1, C]
    (the last entry of each is a sink that is never read) — and returns
    (slot', g', node_even' or None, gpos' [A_next], alive' [A_next],
    rank [A_next // 2] int64): the rows' child slots and g' = 2g + right;
    with ``node_even``, each row's left-child parent index for the next
    level's sibling subtraction (A_next // 2 elsewhere); the children's
    positions and liveness; the parents in gain order.

    Kernel: one launch; f32, int32 rows, A ≤ 2048, C ≤ 8, at most four
    blocks."""
    args = (score, idx, valid, cums, cols, sparse01, edges, alive, gpos,
            XbT, slot, g, feat, thr, gain, leaf_stats)
    kw = dict(kind=kind, lam=lam, mig=mig, d=d, max_depth=max_depth,
              A_next=A_next, split_ok=split_ok, node_even=node_even)
    if _on_cpu(XbT):
        return level_epilogue_reference(*args, **kw)
    dev = XbT.device
    F, n = XbT.shape
    nblk, A = len(cums), alive.shape[0]
    C = cums[0].shape[1]
    D, A_next = int(max_depth), int(A_next)
    if kind not in _KINDS:
        raise ValueError(f"level_epilogue: no kernel for kind {kind!r}")
    if not (1 <= nblk <= _MAX_CAND_BLOCKS and 1 <= A <= _MAX_SLOTS
            and 3 <= C <= MAX_CARD_CHANNELS and A_next >= 1
            and 1 <= D <= 30):
        raise ValueError(f"level_epilogue: unsupported blocks={nblk} A={A} "
                         f"C={C} A_next={A_next} D={D}")
    if _call("level_epilogue_smem", A, C) > _SMEM_MAX:
        raise ValueError(f"level_epilogue: the plan of A={A} slots, C={C} "
                         "does not fit one block's shared memory")
    for bi, (cumb, cb) in enumerate(zip(cums, cols)):
        _check(cumb, f"cums[{bi}]", torch.float32, (A, C, None, None), dev)
        _check(cb, f"cols[{bi}]", torch.int64, (cumb.shape[3],), dev)
    _check(score, "score", torch.float32, (nblk, A), dev)
    _check(idx, "idx", torch.int32, (nblk, A), dev)
    _check(valid, "valid", torch.bool, (nblk, A), dev)
    _check(edges, "edges", torch.float32, (F, None), dev)
    _check(alive, "alive", torch.bool, (A,), dev)
    _check(gpos, "gpos", torch.int32, (A,), dev)
    _check(XbT, "XbT", torch.int32, (F, n), dev)
    _check(slot, "slot", torch.int32, (n,), dev)
    _check(g, "g", torch.int32, (n,), dev)
    _check(feat, "feat", torch.int32, (1 << D,), dev)
    _check(thr, "thr", torch.float32, (1 << D,), dev)
    _check(gain, "gain", torch.float32, (1 << D,), dev)
    _check(leaf_stats, "leaf_stats", torch.float32, ((1 << D) + 1, C), dev)
    rows = torch.empty((3 if node_even else 2, n), dtype=torch.int32,
                       device=dev)
    gpos2 = torch.empty((A_next,), dtype=torch.int32, device=dev)
    alive2 = torch.empty((A_next,), dtype=torch.bool, device=dev)
    rank = torch.empty((A_next // 2,), dtype=torch.int64, device=dev)
    p = _EpilogueParams()
    for bi, (cumb, cb) in enumerate(zip(cums, cols)):
        p.cum[bi], p.cols[bi] = cumb.data_ptr(), cb.data_ptr()
        p.n_bins[bi], p.width[bi] = cumb.shape[2], cumb.shape[3]
        p.sparse01[bi] = bool(sparse01[bi])
    for name, t in (("score", score), ("idx", idx), ("valid", valid),
                    ("edges", edges), ("alive", alive), ("gpos", gpos),
                    ("xbt", XbT), ("slot", slot), ("g", g),
                    ("slot2", rows[0]), ("g2", rows[1]), ("gpos2", gpos2),
                    ("alive2", alive2), ("rank", rank), ("feat", feat),
                    ("thr", thr), ("gain", gain),
                    ("leaf_stats", leaf_stats)):
        setattr(p, name, t.data_ptr())
    p.node_even2 = rows[2].data_ptr() if node_even else None
    p.n_blocks, p.edge_stride, p.n, p.A, p.A_next, p.C = \
        nblk, edges.shape[1], n, A, A_next, C
    p.kind, p.split, p.d, p.D = _KINDS[kind], bool(split_ok), int(d), D
    p.lam, p.mig = float(lam), float(mig)
    _launch("level_epilogue", "level_epilogue_launch", ctypes.addressof(p),
            _stream(dev))
    return (rows[0], rows[1], rows[2] if node_even else None, gpos2, alive2,
            rank)


# ---------------------------------------------------------------------------
# predict_trees
# ---------------------------------------------------------------------------

def predict_trees_reference(X, feat, thr, leaf_w, max_depth: int):
    """Plain version: per tree, ``node = 2·node + (x[feat] > thr)`` for
    ``max_depth`` levels, then the leaves summed in tree order."""
    n = X.shape[0]
    T, _NN = feat.shape
    out = torch.zeros((n, leaf_w.shape[-1]), dtype=leaf_w.dtype,
                      device=X.device)
    for t in range(T):
        node = torch.zeros((n,), dtype=torch.long, device=X.device)
        for d in range(max_depth):
            pos = (1 << d) - 1 + node
            x = X.gather(1, feat[t].long()[pos][:, None])[:, 0]
            node = 2 * node + (x > thr[t][pos]).long()
        out = out + leaf_w[t][node]
    return out


def _predict_trees_launch(X, feat, thr, leaf_w, max_depth: int):
    """The CUDA implementation of ``tmog_torch::predict_trees``: one launch
    of ``csrc/predict_trees.cu`` on the current stream, counted. f32
    X/thr/leaf, int32 feat, K ≤ 8."""
    dev = X.device
    n, F = X.shape
    T, NN = feat.shape
    K = leaf_w.shape[-1]
    D = int(max_depth)
    if NN != (1 << D) - 1:
        raise ValueError(f"predict_trees: {NN} nodes for depth {D}")
    _check(X, "X", torch.float32, (n, F), dev)
    _check(feat, "feat", torch.int32, (T, NN), dev)
    _check(thr, "thr", torch.float32, (T, NN), dev)
    _check(leaf_w, "leaf_w", torch.float32, (T, 1 << D, K), dev)
    if not (1 <= K <= MAX_CARD_CHANNELS and 1 <= D <= 16):
        raise ValueError(f"predict_trees: unsupported K={K} D={D}; the "
                         f"kernel sums at most {MAX_CARD_CHANNELS} leaf "
                         f"values ({WIDE_CLASSES_ITEM})")
    out = torch.empty((n, K), dtype=torch.float32, device=dev)
    _launch("predict_trees", "predict_trees_launch",
            X.data_ptr(), feat.data_ptr(), thr.data_ptr(),
            leaf_w.data_ptr(), out.data_ptr(), n, F, T, D, K, _stream(dev))
    return out


@torch.library.custom_op(PREDICT_TREES_OP, mutates_args=(),
                         device_types="cpu")
def _predict_trees_op(X: torch.Tensor, feat: torch.Tensor,
                      thr: torch.Tensor, leaf_w: torch.Tensor,
                      max_depth: int) -> torch.Tensor:
    return predict_trees_reference(X, feat, thr, leaf_w, max_depth)


_predict_trees_op.register_kernel("cuda")(_predict_trees_launch)


@_predict_trees_op.register_fake
def _predict_trees_fake(X, feat, thr, leaf_w, max_depth):
    return X.new_empty((X.shape[0], leaf_w.shape[-1]), dtype=leaf_w.dtype)


def predict_trees(X, feat, thr, leaf_w, max_depth: int):
    """[n, F] rows through [T, 2^D−1] stacked trees → [n, K] summed
    (tree-weight-scaled) leaves, through ``tmog_torch::predict_trees``:
    the plain version for CPU tensors, the kernel for CUDA tensors, the
    empty [n, K] shape under a trace and on the ``meta`` device (the
    pre-flight's shapes, ``lint.py``: no data, nothing launched)."""
    if X.device.type != "meta":
        _on_cpu(X)              # raises for a device with no kernel
    return torch.ops.tmog_torch.predict_trees(X, feat, thr, leaf_w,
                                              int(max_depth))


def predict_trees_chunk(n_features: int, max_depth: int,
                        n_out: int = 1) -> int:
    """Trees the predict kernel holds in shared memory at once at this
    shape (it takes a larger ensemble in chunks of this many trees; 0:
    one tree does not fit). Builds the kernels if need be."""
    return _call("predict_trees_chunk", int(n_features), int(max_depth),
                 int(n_out))
