"""The tree engine's five kernels: CUDA wrappers, plain PyTorch versions,
and the build.

Counterpart of ``transmogrifai_tpu/models/_pallas_hist.py``. Each kernel
has a wrapper and a plain version of the same function:

* ``cumhist`` — level histograms ``cum[s,c,t,f] = Σ_i 1[node_i=s] ·
  1[bin_fi ≤ t] · stats_ic`` ([A, C, B, F]); ``bc=`` takes the
  precomputed ``bin ≤ t`` indicator from :func:`make_bc`.
* ``cumhist_sparse01`` — the same [A, C, 2, Fb] histograms for a 2-bin
  block of 0/1 indicator columns, from the block itself: t=1 is the
  per-slot total, t=0 the total minus the nonzero side.
* ``split_scan`` — per slot, the best (score, t-major flat index t·F+f,
  valid) over a cumulative histogram.
* ``route_level`` — per row, (slot, g) → (child slot, 2g + right).
* ``predict_trees`` — rows down stacked level-order trees, summed leaves.

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
(one per wrapper call that reached the card).
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

__all__ = ["cumhist", "cumhist_reference", "make_bc",
           "cumhist_sparse01", "cumhist_sparse01_reference",
           "split_scan", "split_scan_reference", "route_level",
           "route_level_reference", "predict_trees",
           "predict_trees_reference", "build_kernels", "KERNEL_LAUNCHES",
           "reset_launch_counts", "SPLIT_NEG"]

#: masked-out candidate score (the criteria's scores are all ≥ 0)
SPLIT_NEG = -1e30
_EPS = 1e-12
_KINDS = {"variance": 0, "gini": 1, "xgb": 2}

KERNEL_LAUNCHES: Dict[str, int] = {"cumhist": 0, "cumhist_sparse01": 0,
                                   "split_scan": 0, "route_level": 0,
                                   "predict_trees": 0}


def reset_launch_counts() -> None:
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


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
#: source stem → (C entry point, argtypes)
_ENTRY = {
    "cumhist": ("cumhist_launch",
                [_P] * 6 + [_I] * 9 + [_P]),
    "cumhist_sparse01": ("cumhist_sparse01_launch",
                         [_P] * 5 + [_I] * 8 + [_P]),
    "split_scan": ("split_scan_launch",
                   [_P, _P] + [_I] * 5 + [_F] * 3 + [_P] * 4),
    "route_level": ("route_level_launch", [_P] * 6 + [_I] * 3 + [_P]),
    "predict_trees": ("predict_trees_launch", [_P] * 5 + [_I] * 5 + [_P]),
}

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
    started together; outputs are keyed by a hash of source and flags."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        if len(_LIBS) == len(_ENTRY):
            return 0.0
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        jobs = []
        targets = {}
        for stem in _ENTRY:
            src = _CSRC / f"{stem}.cu"
            tag = hashlib.sha1(src.read_bytes()
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
        for stem, (fn_name, argtypes) in _ENTRY.items():
            lib = ctypes.CDLL(str(targets[stem]))
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LIBS[stem] = lib
    return time.perf_counter() - t0


def _launch(stem: str, *args) -> None:
    if stem not in _LIBS:
        build_kernels()
    fn = getattr(_LIBS[stem], _ENTRY[stem][0])
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{stem} kernel launch failed: CUDA error {rc}")
    KERNEL_LAUNCHES[stem] += 1


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


#: row splits per call aim at this many blocks (four per SM of an H100);
#: a function of shapes only, so a call's summation order is fixed
_CUMHIST_TARGET_BLOCKS = 4 * 132
#: the kernels' output tile (csrc/cumhist.cu and cumhist_sparse01.cu
#: BM = BN); M and N are padded to it
_CUMHIST_TILE = 128


def _tiling(n: int, M: int, N: int) -> Tuple[int, int, int, int]:
    """(M_pad, N_pad, row splits, rows per split) of a histogram product
    with M output rows, N output columns and n data rows; rows per split
    is a multiple of the kernels' 32-row step."""
    T = _CUMHIST_TILE
    M_pad = -(-M // T) * T
    N_pad = -(-N // T) * T
    tiles = (M_pad // T) * (N_pad // T)
    splits = max(1, min(-(-n // 32), -(-_CUMHIST_TARGET_BLOCKS // tiles)))
    rows_per_split = -(-(-(-n // splits)) // 32) * 32
    return M_pad, N_pad, -(-n // rows_per_split), rows_per_split


def cumhist(stats: torch.Tensor, node: torch.Tensor, XbT: torch.Tensor,
            n_nodes: int, n_bins: int, *,
            bc: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[n, C] stats + [n] node slots (idle rows: node == n_nodes) + [F, n]
    bins → [A, C, B, F] cumulative histograms. Kernel: f32 stats, int32
    node/bins, C ≤ 8; ``bc`` the uint8 [B·F, n] indicator of
    :func:`make_bc`."""
    if _on_cpu(stats):
        return cumhist_reference(stats, node, XbT, n_nodes, n_bins, bc=bc)
    dev = stats.device
    F, n = XbT.shape
    C = stats.shape[1]
    A, B = int(n_nodes), int(n_bins)
    _check(stats, "stats", torch.float32, (n, C), dev)
    _check(node, "node", torch.int32, (n,), dev)
    _check(XbT, "XbT", torch.int32, (F, n), dev)
    if bc is not None:
        _check(bc, "bc", torch.uint8, (B * F, n), dev)
    if not (1 <= C <= 8 and A >= 1 and B >= 1 and n >= 1):
        raise ValueError(f"cumhist: unsupported shape n={n} C={C} A={A} "
                         f"B={B}")
    M_pad, N_pad, splits, rows_per_split = _tiling(n, A * C, B * F)
    partial = torch.empty(splits * M_pad * N_pad, dtype=torch.float32,
                          device=dev)
    out = torch.empty((A, C, B, F), dtype=torch.float32, device=dev)
    _launch("cumhist", stats.data_ptr(), node.data_ptr(), XbT.data_ptr(),
            bc.data_ptr() if bc is not None else None, partial.data_ptr(),
            out.data_ptr(), n, C, A, B, F, splits, rows_per_split, M_pad,
            N_pad, _stream(dev))
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
                     Xb01: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """[n, C] stats + [n] node slots (idle rows: node == n_nodes) + [Fb, n]
    0/1 block → [A, C, 2, Fb] histograms, as :func:`cumhist` at B=2 on the
    same bins. Kernel: f32 stats, int32 node, uint8 block, C ≤ 8."""
    if _on_cpu(stats):
        return cumhist_sparse01_reference(stats, node, Xb01, n_nodes)
    dev = stats.device
    Fb, n = Xb01.shape
    C = stats.shape[1]
    A = int(n_nodes)
    _check(stats, "stats", torch.float32, (n, C), dev)
    _check(node, "node", torch.int32, (n,), dev)
    _check(Xb01, "Xb01", torch.uint8, (Fb, n), dev)
    if not (1 <= C <= 8 and A >= 1 and Fb >= 1 and n >= 1):
        raise ValueError(f"cumhist_sparse01: unsupported shape n={n} C={C} "
                         f"A={A} Fb={Fb}")
    # the all-ones column j = Fb rides in the product's padding
    M_pad, N_pad, splits, rows_per_split = _tiling(n, A * C, Fb + 1)
    partial = torch.empty(splits * M_pad * N_pad, dtype=torch.float32,
                          device=dev)
    out = torch.empty((A, C, 2, Fb), dtype=torch.float32, device=dev)
    _launch("cumhist_sparse01", stats.data_ptr(), node.data_ptr(),
            Xb01.data_ptr(), partial.data_ptr(), out.data_ptr(), n, C, A,
            Fb, splits, rows_per_split, M_pad, N_pad, _stream(dev))
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
               mask: Optional[torch.Tensor] = None):
    """[A, C, B, F] cumulative histograms → per-slot (best score [A],
    best t-major flat index [A] int32, valid [A] bool); ``kind`` ∈
    {"variance", "gini", "xgb"}; ``mask`` [A, F] (0/1) or None. Ties go
    to the lower flat index. Kernel: f32."""
    if _on_cpu(cum):
        return split_scan_reference(cum, kind, min_instances, lam=lam,
                                    min_child_weight=min_child_weight,
                                    mask=mask)
    dev = cum.device
    A, C, B, F = cum.shape
    _check(cum, "cum", torch.float32, (A, C, B, F), dev)
    if mask is not None:
        _check(mask, "mask", torch.float32, (A, F), dev)
    if kind not in _KINDS:
        raise ValueError(f"split_scan: unknown kind {kind!r}")
    if B < 2 or (B - 1) * F >= 2 ** 31 or C < (3 if kind != "gini" else 2):
        raise ValueError(f"split_scan: unsupported shape {tuple(cum.shape)}")
    score = torch.empty((A,), dtype=torch.float32, device=dev)
    idx = torch.empty((A,), dtype=torch.int32, device=dev)
    valid = torch.empty((A,), dtype=torch.uint8, device=dev)
    mcw = 0.0 if min_child_weight is None else float(min_child_weight)
    _launch("split_scan", cum.data_ptr(),
            mask.data_ptr() if mask is not None else None, A, C, B, F,
            _KINDS[kind], float(min_instances), mcw, float(lam),
            score.data_ptr(), idx.data_ptr(), valid.data_ptr(), _stream(dev))
    return score, idx, valid.bool()


# ---------------------------------------------------------------------------
# route_level
# ---------------------------------------------------------------------------

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
    """(slot, g) → (slot', g') for one tree level over [F, n] bins.
    Kernel: int32 throughout (``do_split`` bool), A_parent ≤ 2048."""
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
    if not 1 <= Ap <= 2048:
        raise ValueError(f"route_level: A_parent={Ap} outside [1, 2048]")
    tab = torch.stack([f_idx, t_idx, lchild, rchild,
                       do_split.to(torch.int32)]).contiguous()
    slot2 = torch.empty_like(slot)
    g2 = torch.empty_like(g)
    _launch("route_level", XbT.data_ptr(), slot.data_ptr(), g.data_ptr(),
            tab.data_ptr(), slot2.data_ptr(), g2.data_ptr(), n, Ap,
            int(A_child), _stream(dev))
    return slot2, g2


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


def predict_trees(X, feat, thr, leaf_w, max_depth: int):
    """[n, F] rows through [T, 2^D−1] stacked trees → [n, K] summed
    (tree-weight-scaled) leaves. Kernel: f32 X/thr/leaf, int32 feat,
    K ≤ 8."""
    if _on_cpu(X):
        return predict_trees_reference(X, feat, thr, leaf_w, max_depth)
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
    if not (1 <= K <= 8 and 1 <= D <= 16):
        raise ValueError(f"predict_trees: unsupported K={K} D={D}")
    out = torch.empty((n, K), dtype=torch.float32, device=dev)
    _launch("predict_trees", X.data_ptr(), feat.data_ptr(), thr.data_ptr(),
            leaf_w.data_ptr(), out.data_ptr(), n, F, T, D, K, _stream(dev))
    return out
