#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``transmogrifai_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py             # add --profile for device-time tables

1. Prints the card's name and power limit and builds the six tree-engine
   kernel sources from ``transmogrifai_tpu_torch/csrc`` (one ``nvcc``
   each, in parallel) and the native text hasher (``native/fasthash.cc``,
   ``g++``).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (n=200,000 rows; F=20 features, B=32 bins; the 2-bin
   indicator block at Fb=512 columns): ``group_rows``' order and segment
   offsets, counts, selected indices, valid flags, routes and g
   bit-identical (``cumhist_sparse01``'s counts also equal ``cumhist``'s
   at B=2 on the same bins, and ``cumhist(bc=)``'s those from the bins);
   weighted histogram channels and predict sums within 2e-5 of the
   channel's max |value|; two histogram calls on the same inputs bitwise
   equal, all-idle rows giving zeros. ``split_scan``'s scores are bitwise
   equal to the plain version's at every criterion (variance, gini, xgb),
   A ∈ {1, 2, 32, 64, 128} slots, (F, B) ∈ {(20, 32), (32, 32), (419, 2),
   (600, 32)}, with and without a feature mask, and at constructed ties
   (duplicate feature columns; the lowest flat index wins). Times each
   (median of 20 launches, CUDA events) beside its plain version and one
   PyTorch call computing the same function where there is one (a bf16
   ``torch.matmul`` of the histograms' materialized operands, a stable
   ``torch.argsort`` for ``group_rows``); the histograms (``cumhist``
   from the bins and from ``bc=``, ``cumhist_sparse01``) at A ∈ {1, 16,
   32, 64} slots as the level loop calls them (rows grouped once per
   level, the row-major copy made once per fit), the first two also
   grouping their own rows, and the per-fit copies on their own lines;
   ``split_scan`` at each of its shapes at A ∈ {1, 128}. Then the
   histograms at blocks with several groups of output rows (``cumhist``
   at F ∈ {40, 600, 1100} features, B ∈ {32, 2, 1}; ``cumhist(bc=)`` at
   F=40, B=32; ``cumhist_sparse01`` at Fb=1,500) against their plain
   versions at 20,000 rows, timed at 200,000.
3. The tree-model AutoML sweep — GBT maxDepth {3, 6, 9} and XGBoost
   maxDepth {3, 6}, 20 rounds, 5-fold CV on AuPR, refit, scoring — through
   ``Workflow.train`` and ``WorkflowModel.evaluate`` on 200,000 rows, with
   every kernel launch counted (``group_rows`` once per level, no
   ``cumhist(bc=)``); then the same sweep at 20,000 rows (depths {3, 6})
   on the card and on the CPU, which must pick the same model with AuPR
   within 1e-4.
4. The BigPassenger workflow (``big_passenger.py``): 200,000 typed records
   → transmogrify → SanityChecker → GBT + XGBoost maxDepth {3, 6}, 20
   rounds, 3-fold CV → refit → evaluate, with every kernel launch counted
   (the six main-path kernels must launch, ``group_rows`` once per level,
   no ``cumhist(bc=)``); then the same workflow at 2,000 rows (GBT {3} +
   XGBoost {3}, 5 rounds, 2 folds) on the card and on the CPU, which must
   pick the same model with AuPR within 1e-4.

``--profile`` runs each main path once more under ``torch.profiler`` and
prints its device-time table: the busy share, the histogram kernels, the
split scans and the uint8 → bool copies. ``--timings-only`` skips every
check and prints only ``split_scan``'s times and both paths' profiles,
with no result line; it uses only what every version of the port has,
so a copy of this script in another checkout times that checkout.

Any failure exits non-zero before the result line. With no CUDA device it
exits 2 and prints no result. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists each kernel's numbers as JSON (launches from the
BigPassenger run of phase 4).
"""
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

N, F, B = 200_000, 20, 32
#: the indicator block of the sparse01 check: BigPassenger's hash width,
#: at the density of its hashed buckets (one voyage token in ~1,000)
FB, DENSITY = 512, 0.016
REPS = 20
REL_TOL = 2e-5
#: H100 SXM peaks (data sheet): bytes/s and f32 FLOP/s outside the tensor
#: cores (every kernel's arithmetic is f32)
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, reps=REPS):
    """Median device time of ``fn`` over ``reps`` calls (CUDA events). A
    GPU-side spin before each call keeps the queue busy while the host
    enqueues it, so the events bracket device work, not launch latency."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(1_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def rel_err(out, ref):
    """max |out − ref| over max |ref| (per call; 0 for an all-zero ref)."""
    scale = ref.abs().max().item()
    return (out - ref).abs().max().item() / scale if scale > 0 else 0.0


def hold(out, again, refs, what):
    """A histogram (last channel the counts) against its plain versions:
    ``again`` (a second call) bitwise equal, counts equal to every ref's,
    weighted channels within REL_TOL of the first ref. Returns the max
    abs error of the weighted channels."""
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        fail(f"{what}: two calls differ")
    if not all(torch.equal(out[:, -1], r[:, -1]) for r in refs):
        fail(f"{what}: counts differ")
    ref = refs[0]
    worst = 0.0
    for c in range(out.shape[1] - 1):
        worst = max(worst, (out[:, c] - ref[:, c]).abs().max().item())
        e = rel_err(out[:, c], ref[:, c])
        if e > REL_TOL:
            fail(f"{what}: channel {c} rel err {e:.3g}")
    return worst


def stats_with_count(rng, n, C):
    """[n, C] f32 normal stats whose last channel is a 0/1 count."""
    st = rng.normal(size=(n, C)).astype(np.float32)
    st[:, -1] = rng.random(n) > 0.1
    return st


#: blocks with several groups of output rows (one group is up to 1,024)
#: and rows wider than a group reads: cumhist's (F, B) (B·F > 1,024; at
#: B = 1 the widest groups take fewer m-tiles a warp) and sparse01's Fb
N_WIDE = 20_000
WIDE_CUMHIST = ((40, 32), (600, 32), (1100, 2), (600, 1))
WIDE_FB = 1500
#: cumhist(bc=)'s (F, B): B·F = 1,280 bytes of indicator a row, two
#: groups of 640 output rows
WIDE_BC = (40, 32)


def check_wide(H, dev, rng, put):
    """The histograms at several groups of output rows against their
    plain versions (N_WIDE rows: the plain cumhist materializes [n, B·F]),
    timed at N rows. Returns each kernel's max abs error of the weighted
    channels."""
    worst = {"cumhist": 0.0, "cumhist_bc": 0.0, "cumhist_sparse01": 0.0}
    gen = torch.Generator(device=dev).manual_seed(5)
    st4 = put(stats_with_count(rng, N, 4))
    node = put(rng.integers(0, 65, size=N, dtype=np.int32))
    for Fw, Bw in WIDE_CUMHIST:
        XbT = put(rng.integers(0, Bw, size=(Fw, N_WIDE), dtype=np.int32))
        for A in (1, 64):
            nd = put(rng.integers(0, A + 1, size=N_WIDE, dtype=np.int32))
            for C in (3, 4):
                st = put(stats_with_count(rng, N_WIDE, C))
                worst["cumhist"] = max(worst["cumhist"], hold(
                    H.cumhist(st, nd, XbT, A, Bw),
                    H.cumhist(st, nd, XbT, A, Bw),
                    [H.cumhist_reference(st, nd, XbT, A, Bw)],
                    f"cumhist F={Fw} B={Bw} A={A} C={C}"))
        big = torch.randint(0, Bw, (Fw, N), generator=gen, device=dev,
                            dtype=torch.int32)
        hrows, groups = H.hist_rows(big), H.group_rows(node, 64)
        ms = time_ms(lambda: H.cumhist(st4, node, big, 64, Bw, groups=groups,
                                       rows=hrows))
        del big, hrows
        print(f"cumhist F={Fw} B={Bw} ({Bw * Fw} output rows): counts exact, "
              f"weighted channels within {REL_TOL:g}, two calls bitwise equal "
              f"(A = 1, 64; C = 3, 4; {N_WIDE} rows); main-path call at {N} "
              f"rows, A=64 C=4: {ms:.4f} ms")
    Fw, Bw = WIDE_BC
    XbT = put(rng.integers(0, Bw, size=(Fw, N_WIDE), dtype=np.int32))
    bc = H.make_bc(XbT, Bw)
    for A in (1, 64):
        nd = put(rng.integers(0, A + 1, size=N_WIDE, dtype=np.int32))
        for C in (3, 4):
            st = put(stats_with_count(rng, N_WIDE, C))
            worst["cumhist_bc"] = max(worst["cumhist_bc"], hold(
                H.cumhist(st, nd, XbT, A, Bw, bc=bc),
                H.cumhist(st, nd, XbT, A, Bw, bc=bc),
                [H.cumhist_reference(st, nd, XbT, A, Bw, bc=bc),
                 H.cumhist_reference(st, nd, XbT, A, Bw)],
                f"cumhist(bc=) F={Fw} B={Bw} A={A} C={C}"))
    big = torch.randint(0, Bw, (Fw, N), generator=gen, device=dev,
                        dtype=torch.int32)
    bc = H.make_bc(big, Bw)
    brows, groups = H.bc_rows(bc), H.group_rows(node, 64)
    ms = time_ms(lambda: H.cumhist(st4, node, big, 64, Bw, bc=bc,
                                   groups=groups, rows=brows))
    del big, bc, brows
    print(f"cumhist(bc=) F={Fw} B={Bw} ({Bw * Fw} output rows, 2 groups): "
          f"counts exact, weighted channels within {REL_TOL:g}, two calls "
          f"bitwise equal (A = 1, 64; C = 3, 4; {N_WIDE} rows); main-path "
          f"call at {N} rows, A=64 C=4: {ms:.4f} ms")
    X01 = put((rng.random((WIDE_FB, N_WIDE)) < DENSITY).astype(np.uint8))
    for A in (1, 64):
        nd = put(rng.integers(0, A + 1, size=N_WIDE, dtype=np.int32))
        for C in (3, 4):
            st = put(stats_with_count(rng, N_WIDE, C))
            e = hold(H.cumhist_sparse01(st, nd, X01, A),
                     H.cumhist_sparse01(st, nd, X01, A),
                     [H.cumhist_sparse01_reference(st, nd, X01, A),
                      H.cumhist(st, nd, X01.to(torch.int32), A, 2)],
                     f"cumhist_sparse01 Fb={WIDE_FB} A={A} C={C}")
            worst["cumhist_sparse01"] = max(worst["cumhist_sparse01"], e)
    big = (torch.rand((WIDE_FB, N), generator=gen, device=dev)
           < DENSITY).to(torch.uint8)
    srows, groups = H.sparse01_rows(big), H.group_rows(node, 64)
    ms = time_ms(lambda: H.cumhist_sparse01(st4, node, big, 64,
                                            groups=groups, rows=srows))
    del big, srows
    print(f"cumhist_sparse01 Fb={WIDE_FB} (2 groups of output rows): counts "
          f"equal the plain version and cumhist at B=2, weighted channels "
          f"within {REL_TOL:g}, two calls bitwise equal (A = 1, 64; C = 3, "
          f"4; {N_WIDE} rows); main-path call at {N} rows, A=64 C=4: "
          f"{ms:.4f} ms")
    return worst


#: split_scan's (F, B): the sweep's block, the text path's two blocks and
#: a wide one (several warps' feature groups a slot)
SCAN_SHAPES = ((20, 32), (32, 32), (419, 2), (600, 32))
SCAN_SLOTS = (1, 2, 32, 64, 128)
SCAN_KINDS = (("variance", 4), ("gini", 3), ("xgb", 3))


def scan_stats(rng, kind, C, n):
    """[n, C] f32 stats of a split criterion; the last channel counts."""
    st = np.empty((n, C), np.float32)
    yv = (rng.random(n) > 0.7).astype(np.float32)
    if kind == "variance":
        wv = rng.random(n).astype(np.float32) + 0.5
        st[:, 0], st[:, 1], st[:, 2] = wv, wv * yv, wv * yv * yv
    elif kind == "gini":
        st[:, 0], st[:, 1] = 1.0 - yv, yv
    else:
        p = rng.random(n).astype(np.float32)
        st[:, 0], st[:, 1] = p - yv, p * (1.0 - p) + 1e-6
    st[:, -1] = 1.0
    return st


def scan_holds(H, cum, kind, mask, what):
    """split_scan against its plain version on one histogram: indices and
    valid flags exact, scores bitwise equal. Returns the kernel's
    (score, idx, valid)."""
    kw = dict(lam=1.0, min_child_weight=1.0, mask=mask)
    got = H.split_scan(cum, kind, 10.0, **kw)
    ref = H.split_scan_reference(cum, kind, 10.0, **kw)
    torch.cuda.synchronize()
    if not (torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])):
        fail(f"split_scan selection differs ({what})")
    if not torch.equal(got[0], ref[0]):
        fail(f"split_scan scores are not bitwise equal ({what})")
    return got


def check_scans(H, dev, rng, put):
    """split_scan at every criterion, slot count, shape and mask, and at
    constructed ties: each slot's best column copied into features 0 and
    F − 1, so the same score stands at three flat indices of one t and the
    lowest (f = 0) must win. The histograms come from the cumhist kernel
    on N rows."""
    gen = torch.Generator(device=dev).manual_seed(7)
    for Fs, Bs in SCAN_SHAPES:
        Xs = torch.randint(0, Bs, (Fs, N), generator=gen, device=dev,
                           dtype=torch.int32)
        srows = H.hist_rows(Xs)
        for kind, C in SCAN_KINDS:
            st = put(scan_stats(rng, kind, C, N))
            for A in SCAN_SLOTS:
                node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
                cum = H.cumhist(st, node, Xs, A, Bs, rows=srows)
                what = f"{kind} F={Fs} B={Bs} A={A}"
                mask = put((rng.random((A, Fs)) > 0.2).astype(np.float32))
                scan_holds(H, cum, kind, mask, f"{what} masked")
                best = scan_holds(H, cum, kind, None, what)[1]
                col = cum.gather(3, (best.long() % Fs).view(A, 1, 1, 1)
                                 .expand(A, C, Bs, 1))
                tie = cum.clone()
                tie[..., :1] = col
                tie[..., Fs - 1:] = col
                if (scan_holds(H, tie, kind, None, f"{what} tie")[1]
                        % Fs).any():
                    fail(f"split_scan tie not resolved to f = 0 ({what})")
        del Xs, srows
        print(f"split_scan F={Fs} B={Bs}: selections, valid flags and "
              f"bitwise scores equal the plain version (variance, gini, "
              f"xgb; A = {', '.join(map(str, SCAN_SLOTS))}; masked and "
              f"not; ties to the lowest flat index)")


def time_scans(H, dev):
    """split_scan's time (variance, C = 4) at each shape, A ∈ {1, 128},
    on a histogram of N rows from the cumhist kernel; beside it the time
    of one launch that does almost nothing (a 128-byte fill), the floor
    of this way of timing. Returns {(F, B, A): ms}."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(8)
    tiny = torch.empty(128, dtype=torch.uint8, device=dev)
    print(f"one-launch floor (a 128-byte fill): "
          f"{time_ms(lambda: tiny.fill_(0)):.4f} ms")
    st = torch.as_tensor(scan_stats(rng, "variance", 4, N), device=dev)
    times = {}
    for Fs, Bs in SCAN_SHAPES:
        Xs = torch.randint(0, Bs, (Fs, N), generator=gen, device=dev,
                           dtype=torch.int32)
        for A in (1, 128):
            node = torch.as_tensor(rng.integers(0, A + 1, size=N,
                                                dtype=np.int32), device=dev)
            cum = H.cumhist(st, node, Xs, A, Bs)
            ms = time_ms(lambda: H.split_scan(cum, "variance", 10.0))
            times[Fs, Bs, A] = ms
            print(f"split_scan variance F={Fs} B={Bs} A={A}: kernel "
                  f"{ms:.4f} ms")
    return times


def check_kernels(H, dev):
    """Phase 2: every kernel against its plain version; returns the per-
    kernel numbers of the result line."""
    rng = np.random.default_rng(0)

    def put(a):
        return torch.as_tensor(a, device=dev)

    XbT = put(rng.integers(0, B, size=(F, N), dtype=np.int32))
    bc = H.make_bc(XbT, B)
    rows = {}

    # -- group_rows: exact against its plain version ----------------------
    for A in (1, 64, 128):
        for case in ("mixed", "all idle", "empty slots"):
            node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
            if case == "all idle":
                node[:] = A
            elif case == "empty slots":            # odd slots hold no row
                node = torch.where(node % 2 == 1, A, node)
            got = H.group_rows(node, A)
            ref = H.group_rows_reference(node, A)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                fail(f"group_rows differs (A={A}, {case})")
    print("group_rows: order and seg_off exact (A = 1, 64, 128; mixed, all "
          "idle, empty slots)")
    for A in (1, 16, 32, 64):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        key = torch.where(node < A, node, A)
        ms = time_ms(lambda: H.group_rows(node, A))
        lib_ms = time_ms(lambda: torch.argsort(key, stable=True))
        print(f"group_rows A={A:3d}: kernel {ms:.4f} ms, one stable "
              f"torch.argsort {lib_ms:.4f} ms")
    plain_ms = time_ms(lambda: H.group_rows_reference(node, A))
    rows["group_rows"] = dict(
        replaces="none: the port's own helper (no TPU kernel)",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        # node once, order and seg_off written once; a few integer
        # operations a row
        bound=((4 * N + 4 * (N + (H.KSTEP - 1) * A) + 4 * (A + 1))
               / HBM_BPS, 8.0 * N / F32_FLOPS))

    # -- cumhist and cumhist(bc=): every channel, A in {1, 64, 128} -------
    hrows, brows = H.hist_rows(XbT), H.bc_rows(bc)
    worst = {"cumhist": 0.0, "cumhist_bc": 0.0}
    for A in (1, 64, 128):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        groups = H.group_rows(node, A)
        for C in (3, 4):
            stats = put(stats_with_count(rng, N, C))
            ref = H.cumhist_reference(stats, node, XbT, A, B)
            worst["cumhist"] = max(worst["cumhist"], hold(
                H.cumhist(stats, node, XbT, A, B, groups=groups, rows=hrows),
                H.cumhist(stats, node, XbT, A, B), [ref],
                f"cumhist A={A} C={C}"))
            worst["cumhist_bc"] = max(worst["cumhist_bc"], hold(
                H.cumhist(stats, node, XbT, A, B, bc=bc, groups=groups,
                          rows=brows),
                H.cumhist(stats, node, XbT, A, B, bc=bc),
                [H.cumhist_reference(stats, node, XbT, A, B, bc=bc), ref],
                f"cumhist(bc=) A={A} C={C}"))
            print(f"cumhist A={A:3d} C={C}: counts exact, weighted "
                  f"channels within {REL_TOL:g}, two calls bitwise equal "
                  "(from the bins and from bc=)")
    idle = torch.full((N,), 64, dtype=torch.int32, device=dev)
    if H.cumhist(stats, idle, XbT, 64, B).any():
        fail("cumhist: an all-idle node vector gave nonzero histograms")
    if H.cumhist(stats, idle, XbT, 64, B, bc=bc, rows=brows).any():
        fail("cumhist(bc=): an all-idle node vector gave nonzero histograms")
    print("cumhist, cumhist(bc=): all-idle rows give zeros")
    # the slot counts of the main paths: the call as the level loop makes
    # it (groups and the per-fit row copy given), with its own grouping,
    # and bc= as a fit would call it (groups and bc_rows given)
    st4 = put(rng.normal(size=(N, 4)).astype(np.float32))
    for A in (1, 16, 32, 64):
        nd = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        gr = H.group_rows(nd, A)
        m_ms = time_ms(lambda: H.cumhist(st4, nd, XbT, A, B, groups=gr,
                                         rows=hrows))
        s_ms = time_ms(lambda: H.cumhist(st4, nd, XbT, A, B, rows=hrows))
        b_ms = time_ms(lambda: H.cumhist(st4, nd, XbT, A, B, bc=bc,
                                         groups=gr, rows=brows))
        print(f"cumhist A={A:3d} C=4: main-path call {m_ms:.4f} ms, with "
              f"its own grouping {s_ms:.4f} ms, bc= (groups and bc_rows "
              f"given) {b_ms:.4f} ms")
    print(f"per-fit row copy hist_rows [{F} x {N}]: "
          f"{time_ms(lambda: H.hist_rows(XbT)):.4f} ms")
    print(f"per-fit row copy bc_rows [{B * F} x {N}]: "
          f"{time_ms(lambda: H.bc_rows(bc)):.4f} ms")
    # the row of the result line: A=64, GBT stats
    A, C = 64, 4
    node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
    groups = H.group_rows(node, A)
    st = rng.normal(size=(N, C)).astype(np.float32)
    st[:, -1] = 1.0
    stats = put(st)
    ms = time_ms(lambda: H.cumhist(stats, node, XbT, A, B, groups=groups,
                                   rows=hrows))
    plain_ms = time_ms(lambda: H.cumhist_reference(stats, node, XbT, A, B))
    NS = torch.zeros((N, A, C), dtype=torch.bfloat16, device=dev)
    live = (node < A).nonzero().squeeze(1)
    NS[live, node[live].long()] = stats[live].to(torch.bfloat16)
    NS = NS.reshape(N, A * C)
    Bc = bc.t().to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(NS.t(), Bc))
    del NS, Bc
    out_bytes = A * C * B * F * 4
    # what the function must read in the form the port stores it per fit:
    # node once, the live rows' stats and uint8 bins, the output once
    nbytes = N * 4 + live.numel() * (C * 4 + F) + out_bytes
    old_bytes = N * C * 4 + N * 4 + F * N * 4 + out_bytes
    # what these inputs need: each live row adds its C stats into the
    # B − bin cumulative columns of each feature, f32 adds
    adds = C * float((B - XbT[:, live]).sum().item())
    rows["cumhist"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:160",
        max_abs_err=worst["cumhist"], ms=ms, plain_ms=plain_ms,
        library_ms=lib_ms, bound=(nbytes / HBM_BPS, adds / F32_FLOPS))
    print(f"cumhist A={A} C={C}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms, bound "
          f"{1e3 * max(nbytes / HBM_BPS, adds / F32_FLOPS):.5f} ms "
          f"(int32 all-rows bound: "
          f"{1e3 * max(old_bytes / HBM_BPS, adds / F32_FLOPS):.5f} ms)")

    # the bc= call at the same inputs: the indicator bytes of the live
    # rows instead of their bins; the same matmul is its library call
    bc_ms = time_ms(lambda: H.cumhist(stats, node, XbT, A, B, bc=bc,
                                      groups=groups, rows=brows))
    bc_plain_ms = time_ms(lambda: H.cumhist_reference(stats, node, XbT, A,
                                                      B, bc=bc))
    bc_bytes = N * 4 + live.numel() * (C * 4 + B * F) + out_bytes
    bc_old_bytes = N * C * 4 + N * 4 + B * F * N + out_bytes
    rows["cumhist_bc"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:193",
        source="transmogrifai_tpu_torch/csrc/cumhist.cu",
        max_abs_err=worst["cumhist_bc"], ms=bc_ms, plain_ms=bc_plain_ms,
        library_ms=lib_ms, bound=(bc_bytes / HBM_BPS, adds / F32_FLOPS))
    print(f"cumhist(bc=) A={A} C={C}: kernel {bc_ms:.4f} ms, plain "
          f"{bc_plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms, bound "
          f"{1e3 * max(bc_bytes / HBM_BPS, adds / F32_FLOPS):.5f} ms "
          f"(all-rows bound: "
          f"{1e3 * max(bc_old_bytes / HBM_BPS, adds / F32_FLOPS):.5f} ms)")

    # -- cumhist_sparse01: the 2-bin indicator block ----------------------
    X01 = put((rng.random((FB, N)) < DENSITY).astype(np.uint8))
    X01_bins = X01.to(torch.int32)
    srows = H.sparse01_rows(X01)
    worst = 0.0
    for A in (1, 64, 128):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        groups = H.group_rows(node, A)
        for C in (3, 4):
            stats = put(stats_with_count(rng, N, C))
            worst = max(worst, hold(
                H.cumhist_sparse01(stats, node, X01, A, groups=groups,
                                   rows=srows),
                H.cumhist_sparse01(stats, node, X01, A),
                [H.cumhist_sparse01_reference(stats, node, X01, A),
                 H.cumhist(stats, node, X01_bins, A, 2, groups=groups)],
                f"cumhist_sparse01 A={A} C={C}"))
        print(f"cumhist_sparse01 A={A:3d}: counts equal the plain version "
              f"and cumhist at B=2, weighted channels within {REL_TOL:g}, "
              "two calls bitwise equal (C = 3, 4)")
    if H.cumhist_sparse01(stats, idle, X01, 64).any():
        fail("cumhist_sparse01: an all-idle node vector gave nonzero "
             "histograms")
    print("cumhist_sparse01: all-idle rows give zeros")
    for A in (1, 16, 32, 64):
        nd = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        gr = H.group_rows(nd, A)
        m_ms = time_ms(lambda: H.cumhist_sparse01(st4, nd, X01, A,
                                                  groups=gr, rows=srows))
        s_ms = time_ms(lambda: H.cumhist_sparse01(st4, nd, X01, A,
                                                  rows=srows))
        print(f"cumhist_sparse01 A={A:3d} C=4: main-path call {m_ms:.4f} "
              f"ms, with its own grouping {s_ms:.4f} ms")
    print(f"per-fit row copy sparse01_rows [{FB} x {N}]: "
          f"{time_ms(lambda: H.sparse01_rows(X01)):.4f} ms")
    A, C = 64, 4
    node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
    groups = H.group_rows(node, A)
    st = rng.normal(size=(N, C)).astype(np.float32)
    st[:, -1] = 1.0
    stats = put(st)
    ms = time_ms(lambda: H.cumhist_sparse01(stats, node, X01, A,
                                            groups=groups, rows=srows))
    plain_ms = time_ms(lambda: H.cumhist_sparse01_reference(stats, node,
                                                            X01, A))
    NS = torch.zeros((N, A, C), dtype=torch.bfloat16, device=dev)
    live = (node < A).nonzero().squeeze(1)
    NS[live, node[live].long()] = stats[live].to(torch.bfloat16)
    NS = NS.reshape(N, A * C)
    Xt = X01.t().to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(NS.t(), Xt))
    del NS, Xt
    out_bytes = A * C * 2 * FB * 4
    nbytes = N * 4 + live.numel() * (C * 4 + FB) + out_bytes
    old_bytes = N * C * 4 + N * 4 + FB * N + out_bytes
    # each live row adds its C stats into its slot's total and into the
    # nonzero side of each of its ones; t=0 is one subtraction per output
    nnz_live = float(X01[:, live].sum(dtype=torch.int64).item())
    adds = C * (nnz_live + live.numel()) + A * C * FB
    rows["cumhist_sparse01"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:220",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound=(nbytes / HBM_BPS, adds / F32_FLOPS))
    print(f"cumhist_sparse01 A={A} C={C} Fb={FB}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms, bound "
          f"{1e3 * max(nbytes / HBM_BPS, adds / F32_FLOPS):.5f} ms (all-rows "
          f"bound: "
          f"{1e3 * max(old_bytes / HBM_BPS, adds / F32_FLOPS):.5f} ms)")

    # -- both histograms at several groups of output rows -----------------
    for name, e in check_wide(H, dev, np.random.default_rng(1), put).items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)

    # -- split_scan: criteria x slots x shapes x masks, and ties ----------
    check_scans(H, dev, rng, put)
    ms = time_scans(H, dev)[(F, B, 128)]
    A, C = 128, 4
    cum = H.cumhist_reference(stats, put(rng.integers(0, A + 1, size=N,
                                                      dtype=np.int32)),
                              XbT, A, B)
    plain_ms = time_ms(lambda: H.split_scan_reference(cum, "variance", 10.0))
    ncand = A * (B - 1) * F
    rows["split_scan"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:504",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound=((A * C * B * F * 4 + A * 9) / HBM_BPS,
               12.0 * ncand / F32_FLOPS))
    print(f"split_scan variance A={A}: plain {plain_ms:.4f} ms")

    # -- route_level: A_parent in {1, 64, 128} ----------------------------
    for A in (1, 64, 128):
        A_next = min(2 * A, 128)
        slot = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        g = put(rng.integers(0, 1 << 8, size=N, dtype=np.int32))
        split = rng.random(A) > 0.3
        order = rng.permutation(A)
        ok = split & (order < A_next // 2)
        tabs = [put(rng.integers(0, F, A, dtype=np.int32)),
                put(rng.integers(0, B - 1, A, dtype=np.int32)),
                put(np.where(ok, 2 * order, A_next).astype(np.int32)),
                put(np.where(ok, 2 * order + 1, A_next).astype(np.int32)),
                put(split)]
        s2, g2 = H.route_level(XbT, slot, g, *tabs, A, A_next)
        rs2, rg2 = H.route_level_reference(XbT, slot, g, *tabs, A, A_next)
        torch.cuda.synchronize()
        if not (torch.equal(s2, rs2) and torch.equal(g2, rg2)):
            fail(f"route_level differs (A={A})")
    print("route_level: slots and g exact (A = 1, 64, 128)")
    ms = time_ms(lambda: H.route_level(XbT, slot, g, *tabs, A, A_next))
    plain_ms = time_ms(lambda: H.route_level_reference(XbT, slot, g, *tabs,
                                                       A, A_next))
    live = int((slot < A).sum().item())
    rows["route_level"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:389",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound=((4 * N * 4 + 4 * live + 5 * A * 4) / HBM_BPS,
               8.0 * N / F32_FLOPS))
    print(f"route_level A={A}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")

    # -- predict_trees: T=20 trees of depth 9 -----------------------------
    T, D, K = 20, 9, 1
    NN, L = (1 << D) - 1, 1 << D
    X = put(rng.normal(size=(N, F)).astype(np.float32))
    feat = put(rng.integers(0, F, size=(T, NN), dtype=np.int32))
    thr_np = rng.normal(size=(T, NN)).astype(np.float32)
    thr_np[rng.random((T, NN)) < 0.2] = np.inf          # dead splits
    thr = put(thr_np)
    leaf = put(rng.normal(size=(T, L, K)).astype(np.float32))
    out = H.predict_trees(X, feat, thr, leaf, D)
    ref = H.predict_trees_reference(X, feat, thr, leaf, D)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if rel_err(out, ref) > REL_TOL:
        fail(f"predict_trees differs: max abs err {err:.3g}")
    print(f"predict_trees T={T} D={D}: within {REL_TOL:g} "
          f"(max abs err {err:.3g})")
    ms = time_ms(lambda: H.predict_trees(X, feat, thr, leaf, D))
    plain_ms = time_ms(lambda: H.predict_trees_reference(X, feat, thr, leaf,
                                                         D), reps=5)
    rows["predict_trees"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:674",
        max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound=((N * F * 4 + T * NN * 8 + T * L * K * 4 + N * K * 4)
               / HBM_BPS, float(N) * T * (D + K) / F32_FLOPS))
    print(f"predict_trees: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return rows


def profile_path(name, fn):
    """One main path once more under ``torch.profiler``: device time per
    kernel and the device's busy share of the wall clock. Only device
    activity is recorded (kernels, copies, fills), so each device
    interval counts once in the busy share; a host operator's self
    device time would count its kernels a second time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    print(f"profile {name}: wall {wall:.3f} s, device busy {busy:.3f} s "
          f"({100 * busy / wall:.1f}%), idle {100 * (1 - busy / wall):.1f}%")
    for dev_us, count, key in rows[:15]:
        print(f"profile {name}: {dev_us / 1e3:10.1f} ms {count:7d}x  "
              f"{key[:90]}")
    # the level histograms: both grouped products, their reduce passes
    # and group_rows' three kernels
    hist = [r for r in rows if "grouped::" in r[2] or "group_" in r[2]]
    for dev_us, count, key in hist:
        print(f"profile {name} histograms: {dev_us / 1e3:10.1f} ms "
              f"{count:7d}x  {key[:70]}")
    print(f"profile {name}: histogram device time "
          f"{sum(r[0] for r in hist) / 1e3:.1f} ms")
    # the split scans, and every uint8 → bool copy (one followed each scan
    # while the scan wrote uint8 valid flags)
    for what, sel in (("split_scan", lambda k: "split_scan" in k),
                      ("bool conversion",
                       lambda k: "copy" in k and "(bool)" in k)):
        found = [r for r in rows if sel(r[2])]
        for dev_us, count, key in found:
            print(f"profile {name} {what}: {dev_us / 1e3:10.3f} ms "
                  f"{count:7d}x  {key}")
        print(f"profile {name}: {what} device time "
              f"{sum(r[0] for r in found) / 1e3:.3f} ms, "
              f"{sum(r[1] for r in found)} launches")


def counted(H, fn, kernels):
    """Run ``fn`` with every launch count set to 0 just before it; fail
    unless each of ``kernels`` launched. Returns (result, counts)."""
    H.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(H.KERNEL_LAUNCHES)
    missing = [k for k in kernels if launches[k] == 0]
    if missing:
        fail(f"main path never launched {missing}")
    return out, launches


def once_per_level(launches, what):
    """Each tree level routes its rows once and groups them once; no fit
    passes the precomputed indicator (``bc=``)."""
    if launches["group_rows"] != launches["route_level"]:
        fail(f"{what}: {launches['group_rows']} group_rows launches for "
             f"{launches['route_level']} levels")
    if launches["cumhist_bc"]:
        fail(f"{what}: {launches['cumhist_bc']} cumhist(bc=) launches")


def check_scored(out, n, what):
    aupr = out["metrics"]["AuPR"]
    scored = out["scored"][out["prediction"].name]
    if not (len(scored) == n and np.isfinite(scored.probability).all()
            and 0.0 < aupr <= 1.0):
        fail(f"{what}: scored predictions are not finite or of the wrong "
             "shape")
    return aupr


def agree(runs, what):
    """The card's and the CPU's run pick one model, AuPR within 1e-4."""
    a, b = runs["cuda"], runs["cpu"]
    if (a["summary"].best_model_name != b["summary"].best_model_name
            or a["summary"].best_model_params
            != b["summary"].best_model_params):
        fail(f"cuda and cpu picked different models ({what})")
    d_aupr = abs(a["metrics"]["AuPR"] - b["metrics"]["AuPR"])
    if d_aupr > 1e-4:
        fail(f"cuda and cpu AuPR differ by {d_aupr:.3g} ({what})")
    print(f"{what}: same model on cuda and cpu, |dAuPR| = {d_aupr:.3g}")


def timings(H, dev, BP, run):
    """``--timings-only``: split_scan's times at its shapes, then each main
    path run once and profiled once; nothing is checked and no result
    line is printed. It calls only what every version of the port has, so
    a copy of this script placed in another checkout times that
    checkout's kernels: two versions compare in one call, in turns."""
    time_scans(H, dev)
    run(N, device="cuda")
    profile_path("sweep", lambda: run(N, device="cuda"))
    records = BP.synthesize_records(N, seed=42)
    BP.run(N, device="cuda", records=records)
    profile_path("BigPassenger", lambda: BP.run(N, device="cuda",
                                                records=records))
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from transmogrifai_tpu_torch import big_passenger as BP
    from transmogrifai_tpu_torch.models import _hist as H
    from transmogrifai_tpu_torch.ops.hashing import load_native
    from transmogrifai_tpu_torch.synthetic_trees import (default_families,
                                                         run)
    profile = "--profile" in sys.argv[1:]
    timings_only = "--timings-only" in sys.argv[1:]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    H.build_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if not load_native():
        fail("the native text hasher (native/fasthash.cc) did not build")
    print(f"native hasher build: {time.perf_counter() - t0:.1f} s")
    if timings_only:
        return timings(H, dev, BP, run)

    rows = check_kernels(H, dev)

    # -- phase 3: the synthetic tree sweep, every launch counted ----------
    tree_kernels = ("cumhist", "group_rows", "split_scan", "route_level",
                    "predict_trees")
    out, launches = counted(H, lambda: run(N, device="cuda"), tree_kernels)
    once_per_level(launches, "synthetic sweep")
    aupr = check_scored(out, N, "synthetic sweep")
    s = out["summary"]
    print(f"sweep {N} rows: train {out['train_s']:.2f} s, evaluate "
          f"{out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, AuPR {aupr:.6f}")
    print(f"synthetic-sweep launches: {launches}")
    if profile:
        profile_path("sweep", lambda: run(N, device="cuda"))
    agree({d: run(20_000, device=d,
                  families=default_families((3, 6), (3, 6)))
           for d in ("cuda", "cpu")}, "synthetic sweep, 20000 rows")

    # -- phase 4: the BigPassenger workflow, every launch counted ---------
    t0 = time.perf_counter()
    records = BP.synthesize_records(N, seed=42)
    records_s = time.perf_counter() - t0
    out, launches = counted(H, lambda: BP.run(N, device="cuda",
                                              records=records),
                            tree_kernels + ("cumhist_sparse01",))
    once_per_level(launches, "BigPassenger")
    aupr = check_scored(out, N, "BigPassenger")
    s = out["summary"]
    print(f"BigPassenger {N} rows: blocks {out['blocks']} (continuous "
          "32-bin block, 2-bin indicator block)")
    print(f"BigPassenger {N} rows: records {records_s:.2f} s, extract "
          f"{out['extract_s']:.2f} s, vectorize {out['vectorize_s']:.2f} s, "
          f"SanityChecker {out['sanity_s']:.2f} s, selector "
          f"{out['selector_s']:.2f} s, train {out['train_s']:.2f} s, "
          f"evaluate {out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, AuPR {aupr:.6f}")
    print(f"BigPassenger launches: {launches}")
    if profile:
        profile_path("BigPassenger", lambda: BP.run(N, device="cuda",
                                                    records=records))
    small = BP.synthesize_records(2_000, seed=42)
    agree({d: BP.run(2_000, num_folds=2, device=d, records=small,
                     families=default_families((3,), (3,), rounds=5))
           for d in ("cuda", "cpu")}, "BigPassenger, 2000 rows")

    kernels = []
    names = ("cumhist", "cumhist_bc", "cumhist_sparse01", "group_rows",
             "split_scan", "route_level", "predict_trees")
    for name in names:
        r = rows[name]
        t_bytes, t_ops = r["bound"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": r.get("source",
                            f"transmogrifai_tpu_torch/csrc/{name}.cu"),
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"]})
    if not all(math.isfinite(k[key]) for k in kernels
               for key in ("ms", "plain_ms", "bound_ms")):
        fail("a kernel time is not finite")
    print("kernels: " + ", ".join(names))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
