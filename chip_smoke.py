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
   (duplicate feature columns; the lowest flat index wins). The level
   epilogue's every output (slots, g, sibling masks, gpos, alive, rank,
   and the feat/thr/gain/leaf records) is bitwise equal to its plain
   version at A ∈ {1, 64, 128}, variance, xgb and gini (C = 3 and 5), one
   block and two (the 2-bin block's winners included), both drivers'
   levels, a level past the depth limit, a last level, a level where every
   slot dies, and gain ties. The random forest's draws (bootstrap uniforms,
   per-node feature masks) made on the card equal the CPU's bit for bit,
   and ``split_scan`` under gini with those masks equals its plain version
   bitwise. ``predict_trees`` is held at the sweep's ensemble (F=20, T=20,
   D=9), the text path's (F=451, T=20, D=6), one of several tree chunks,
   and the forest's (T=50, D=12, two class shares) at F=20 and at
   Titanic's F=498. Times each (median of 20 launches, CUDA events) beside its
   plain version and one PyTorch call computing the same function where
   there is one (a bf16 ``torch.matmul`` of the histograms' materialized
   operands, a stable ``torch.argsort`` for ``group_rows``); the
   histograms (``cumhist`` from the bins and from ``bc=``,
   ``cumhist_sparse01``) at A ∈ {1, 16, 32, 64} slots as the level loop
   calls them (rows grouped once per level, the row-major copy made once
   per fit), the first two also grouping their own rows, and the per-fit
   copies on their own lines; ``split_scan`` at each of its shapes at A ∈
   {1, 128}; the level epilogue (variance, and gini at C = 3) and the route
   alone (one launch) at A=128 with their bounds; ``predict_trees`` at
   every path's shape. Then the
   histograms at blocks with several groups of output rows (``cumhist``
   at F ∈ {40, 600, 1100} features, B ∈ {32, 2, 1}; ``cumhist(bc=)`` at
   F=40, B=32; ``cumhist_sparse01`` at Fb=1,500) against their plain
   versions at 20,000 rows, timed at 200,000.
3. The tree-model AutoML sweep — GBT maxDepth {3, 6, 9} and XGBoost
   maxDepth {3, 6}, 20 rounds, 5-fold CV on AuPR, refit, scoring — through
   ``Workflow.train`` and ``WorkflowModel.evaluate`` on 200,000 rows, with
   every kernel launch counted (one ``level_epilogue`` and one
   ``group_rows`` a level, no route-only ``route_level``, no
   ``cumhist(bc=)``); then the same sweep at 20,000 rows (depths {3, 6})
   on the card and on the CPU, which must pick the same model with AuPR
   within 1e-4.
4. The BigPassenger workflow (``big_passenger.py``): 200,000 typed records
   → transmogrify → SanityChecker → GBT + XGBoost maxDepth {3, 6}, 20
   rounds, 3-fold CV → refit → evaluate, with every kernel launch counted
   (the main-path kernels must launch, one ``level_epilogue`` and one
   ``group_rows`` a level, no ``route_level``, no ``cumhist(bc=)``); then
   the same workflow at 2,000 rows (GBT {3} + XGBoost {3}, 5 rounds, 2
   folds) on the card and on the CPU, which must pick the same model with
   AuPR within 1e-4.
5. rf-200k: the synthetic sweep's data (200,000 rows, F=20) under a
   random forest (50 trees, per-node draws of 4 features) and a decision
   tree at maxDepth {3, 6, 12}, 5-fold CV, refit, scoring, with every
   launch counted (one ``level_epilogue`` and one ``group_rows`` a level);
   then RF (5 trees) and DT at maxDepth {3, 6} on 20,000 rows on the card
   and on the CPU: the same model, AuPR within 1e-4.
6. titanic (``titanic.py``, the reference's hello-world): the bundled CSV
   read through ``DataReaders.simple.csv``, the derived features,
   transmogrify → SanityChecker → 3-fold CV over the binary selector's
   default families (logistic regression, random forest, GBT, linear SVC)
   → refit → evaluate, with every launch counted (``cumhist_sparse01``
   must launch: Titanic's indicator columns); then one grid point of each
   family on the card and on the CPU: the same model, AuPR within 1e-4.
7. serve: ``tests/resources/golden_model_v1`` loaded and scored on the
   card (predictions exact, probability within rtol 1e-6 of
   ``expected.json``); then phase 4's workflow and 200,000 records through
   ``OpWorkflowRunner``: Train (saves the model in the JAX package's
   format), Score (a fresh ``WorkflowModel.load``, the scoring engine:
   24 chunks of 8,192 rows and one of 3,392 in the 4,096 bucket, a CUDA
   graph per bucket) and Evaluate, then ``stream_score_overlapped`` over
   25 batches of 8,000 records, with every launch counted (``predict_trees``
   once a chunk in Score). Checks: Evaluate's AuPR equals phase 4's;
   Score's columns bitwise equal the trained model's layer-path score on
   the card; graph replays bitwise equal the eager program at each
   bucket; the stream equals Score; the saved model loaded for the CPU
   scores 2,000 records bitwise as the card does. Prints save, load,
   Score and layer-path seconds, rows/s, the buckets and graphs. Phase 2
   also holds ``predict_trees`` at the bucket shape (n = 8,192 and 4,096,
   F=451, T=20, D=6) bitwise against its plain version and times it.

8. multiclass and regression: the kernels at the new shapes against
   their plain versions — the histograms at gini C=8, ``split_scan``
   under gini at C = 4 (iris: three classes and the count) and C = 8 (the
   most the kernels take) at every slot count and the sweep's and iris's
   block shapes, bitwise; the level epilogue under gini at C = 4 and 8 in
   every case of phase 2, bitwise; ``predict_trees`` at the iris forest's
   F=8, T=50, D=12, K=3 — each timed beside its plain version. Then
   iris-200k (``iris.py``: 200,000 generated rows in bezdekIris.data's
   format, the species indexed, transmogrify, the multiclass selector's
   default families under 3-fold CV on F1 with a DataCutter, the
   prediction de-indexed) and boston-200k (``boston.py``: 200,000
   generated rows in housing.data's format, the random forest and GBT
   regressors under 3-fold CV on RMSE with a DataSplitter) through
   ``Workflow.train`` and evaluate, every launch counted (the tree
   kernels must launch; ``predict_trees`` wherever a tree model wins);
   each at 2,000 rows, one grid point a family, on the card and on the
   CPU: the same model, |ΔF1| ≤ 1e-4 and |ΔRMSE| / RMSE ≤ 1e-4. Then the
   iris-200k model saved, loaded afresh and its rows scored through the
   scoring engine (the predictor and the de-indexer's label codes in one
   program, a CUDA graph per bucket): species names and predictions equal
   to the layer path's. Last, the label mapping on the card: the species
   as numeric codes {1, 4, 6}, which the DataCutter re-indexes, scored
   through the engine's graphs as the layer path scores them.

``--profile`` runs each main path (the four, serve's Score, iris-200k and
boston-200k) once more under ``torch.profiler`` and prints its device-time
table: the busy share, the device operations a tree level, the histogram
kernels, the split scans, the route or level epilogue, the predict and the
uint8 → bool copies.
``--timings-only`` skips every check and prints only the times of
``split_scan``, the route alone and ``predict_trees``, the sweep's and
BigPassenger's train seconds and both paths' profiles, with no result
line; it uses only what every version of
the port has, so a copy of this script in another checkout times that
checkout.

Any failure exits non-zero before the result line. With no CUDA device it
exits 2 and prints no result. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists each kernel's numbers as JSON (launches summed
over the main paths' runs, phases 3–8).
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
#: Titanic's transmogrified width (its 2-bin block holds 470 of them)
TITANIC_F = 498
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


def check_forest_scans(H, TF, dev, rng, put, XbT):
    """The random forest's draws and split scans. ``forest_draws`` on the
    card equals its draw on the CPU (bootstrap uniforms and per-node
    masks, bitwise); then ``split_scan`` under gini with those masks —
    the sweep's 32-bin block and a 2-bin block of FB indicator columns,
    levels 0, 5 and 11 of a depth-12 tree at A ∈ {1, 64, 128} — holds
    bitwise against its plain version."""
    X01 = (rng.random((FB, N)) < 0.3).astype(np.int32)
    Xfull = torch.cat([XbT, put(X01)])
    bmask = np.r_[np.zeros(F, bool), np.ones(FB, bool)]
    blocks = TF.prepare_blocks(Xfull, B, bmask)
    draws = TF.forest_draws(7, 3, N, "classification", 12, 128, blocks,
                            torch.float32, dev)
    cpu = TF.forest_draws(7, 3, N, "classification", 12, 128,
                          TF.prepare_blocks(Xfull.cpu(), B, bmask),
                          torch.float32, "cpu")
    if not (torch.equal(draws.boot_u.cpu(), cpu.boot_u) and all(
            torch.equal(a.cpu(), b) for a, b in zip(draws.masks,
                                                      cpu.masks))):
        fail("forest_draws on the card differ from the CPU's")
    k = TF.forest_k("classification", F + FB)
    per_slot = sum(m[0, 5].sum(1) for m in draws.masks)
    if not bool((per_slot == k).all()):
        fail(f"per-node masks do not draw exactly {k} features")
    st = put(scan_stats(rng, "gini", 3, N))
    for A in (1, 64, 128):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        cums = [H.cumhist(st, node, blocks[0].mat, A, B),
                H.cumhist_sparse01(st, node, blocks[1].mat, A)]
        for d in (0, 5, 11):
            for bi, cum in enumerate(cums):
                scan_holds(H, cum, "gini", draws.masks[bi][1, d, :A],
                           f"gini forest mask block {bi} A={A} d={d}")
    print(f"forest draws: card equals CPU bitwise (bootstrap uniforms, "
          f"per-node masks of {k} of {F + FB} features); split_scan gini "
          f"under those masks bitwise equal to the plain version (32-bin "
          f"and 2-bin blocks, A = 1, 64, 128, levels 0, 5, 11)")


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


def check_kernels(H, TF, dev):
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
    check_forest_scans(H, TF, dev, rng, put, XbT)
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

    # -- route_level and the level epilogue -------------------------------
    for A in (1, 64, 128):
        A_next = min(2 * A, 128)
        slot = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        g = put(rng.integers(0, 1 << 8, size=N, dtype=np.int32))
        tabs = route_tables(rng, put, A, A_next)
        s2, g2 = H.route_level(XbT, slot, g, *tabs, A, A_next)
        rs2, rg2 = H.route_level_reference(XbT, slot, g, *tabs, A, A_next)
        torch.cuda.synchronize()
        if not (torch.equal(s2, rs2) and torch.equal(g2, rg2)):
            fail(f"route_level differs (A={A})")
    print("route_level: slots and g exact (A = 1, 64, 128)")
    rows.update(check_epilogue(H, dev, rng, put, XbT))

    rows["predict_trees"] = check_predict(H, rng, put)
    return rows


def check_predict(H, rng, put):
    """predict_trees against its plain version at each of PREDICT_SHAPES
    (N rows, within REL_TOL), timed at all but the chunked one; returns
    the result line's row (the sweep's shape)."""
    worst = 0.0
    for Fp, T, D, K in PREDICT_SHAPES:
        X, feat, thr, leaf = predict_inputs(rng, put, Fp, T, D, K)
        out = H.predict_trees(X, feat, thr, leaf, D)
        ref = H.predict_trees_reference(X, feat, thr, leaf, D)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if rel_err(out, ref) > REL_TOL:
            fail(f"predict_trees differs (F={Fp} T={T} D={D} K={K}): max "
                 f"abs err {err:.3g}")
        chunk = H.predict_trees_chunk(Fp, D, K)
        print(f"predict_trees F={Fp} T={T} D={D} K={K} ({-(-T // chunk)} "
              f"chunk(s) of up to {chunk} trees): within {REL_TOL:g} (max "
              f"abs err {err:.3g}, bitwise equal: {torch.equal(out, ref)})")
        worst = max(worst, err)
    for Fp, T, D, K in PREDICT_SHAPES:
        if (Fp, T, D) == (F, 50, 9):
            continue
        X, feat, thr, leaf = predict_inputs(rng, put, Fp, T, D, K)
        ms = time_ms(lambda: H.predict_trees(X, feat, thr, leaf, D))
        plain_ms = time_ms(lambda: H.predict_trees_reference(
            X, feat, thr, leaf, D), reps=5)
        bound = predict_bound(Fp, T, D, K)
        print(f"predict_trees F={Fp} T={T} D={D} K={K}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {1e3 * max(bound):.5f} ms")
        if (Fp, T, D) == (F, 20, 9):
            row = dict(replaces="transmogrifai_tpu/models/_pallas_hist.py:674",
                       ms=ms, plain_ms=plain_ms, library_ms=None, bound=bound)
        del X
    row["max_abs_err"] = worst
    # the scoring engine's shape: one bucket chunk of the text path's rows
    for n in SERVE_BUCKETS:
        X, feat, thr, leaf = predict_inputs(rng, put, 451, 20, 6, n=n)
        out = H.predict_trees(X, feat, thr, leaf, 6)
        ref = H.predict_trees_reference(X, feat, thr, leaf, 6)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            fail(f"predict_trees at the bucket shape (n={n}, F=451, T=20, "
                 f"D=6) is not bitwise equal to its plain version")
        ms = time_ms(lambda: H.predict_trees(X, feat, thr, leaf, 6))
        plain_ms = time_ms(lambda: H.predict_trees_reference(
            X, feat, thr, leaf, 6), reps=5)
        print(f"predict_trees bucket n={n} F=451 T=20 D=6: bitwise equal to "
              f"its plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, bound {1e3 * max(predict_bound(451, 20, 6, n=n)):.5f} ms")
    return row


def route_tables(rng, put, A, A_next):
    """Random slot tables of one level: features, bin thresholds, children
    (2·position of the splitting slots under A_next / 2, else the sink)
    and do_split."""
    split = rng.random(A) > 0.3
    order = rng.permutation(A)
    ok = split & (order < A_next // 2)
    return [put(rng.integers(0, F, A, dtype=np.int32)),
            put(rng.integers(0, B - 1, A, dtype=np.int32)),
            put(np.where(ok, 2 * order, A_next).astype(np.int32)),
            put(np.where(ok, 2 * order + 1, A_next).astype(np.int32)),
            put(split)]


#: predict_trees' (F, T, D, K): the sweep's deepest ensemble, the text
#: path's (F = 451 features scored at maxDepth 6), an ensemble of several
#: tree chunks whose T is not a multiple of the chunk, and the random
#: forest's (50 trees of depth 12, two class shares) at rf-200k's width and
#: at Titanic's
PREDICT_SHAPES = ((F, 20, 9, 1), (451, 20, 6, 1), (F, 50, 9, 1),
                  (F, 50, 12, 2), (TITANIC_F, 50, 12, 2))
#: card/CPU probabilities of one f32 model: the head's exp on the card and
#: on the CPU round an ulp apart, which 1 − p doubles (2^-22: two ulps)
PROB_ATOL = 2.0 ** -22
#: the scoring engine's buckets on the serve path: 24 chunks of 8,192 rows
#: and a last one of 3,392 rows in the 4,096 bucket
SERVE_BUCKETS = (8192, 4096)


def predict_inputs(rng, put, Fp, T, D, K=1, n=N):
    NN, L = (1 << D) - 1, 1 << D
    X = put(rng.normal(size=(n, Fp)).astype(np.float32))
    feat = put(rng.integers(0, Fp, size=(T, NN), dtype=np.int32))
    thr_np = rng.normal(size=(T, NN)).astype(np.float32)
    thr_np[rng.random((T, NN)) < 0.2] = np.inf          # dead splits
    leaf = put(rng.normal(size=(T, L, K)).astype(np.float32))
    return X, feat, put(thr_np), leaf


def predict_bound(Fp, T, D, K=1, n=N):
    """(bytes, operations) seconds of predict_trees: the rows, the trees
    and the sums moved once; D compares and K adds a tree and row."""
    NN, L = (1 << D) - 1, 1 << D
    return ((n * Fp * 4 + T * NN * 8 + T * L * K * 4 + n * K * 4) / HBM_BPS,
            float(n) * T * (D + K) / F32_FLOPS)


def epilogue_inputs(H, dev, rng, put, XbT, X01, kind, A, nblk, d, D,
                    C=3):
    """One level's epilogue inputs at N rows: the histograms and split
    scans of the sweep's 32-bin block (and, with two blocks, of a 2-bin
    0/1 block of FB columns after it) from the kernels, a label that reads
    both blocks, random live slots and positions, fresh records. Slot 1
    copies slot 0's histograms and scores (a gain tie), and at slot 2 the
    second block ties the first's score (the lower concatenated index
    wins). Gini takes ``C`` channels: C − 1 class weights (integer
    bootstrap-like weights 0..2 on a one-hot class) and the count."""
    C = {"variance": 4, "xgb": 3}.get(kind, C)
    y = ((X01[3] > 0) | (XbT[0] > 24)).float()
    u = put(rng.random(N).astype(np.float32))
    if kind == "variance":
        w = u + 0.5
        st = torch.stack([w, w * y, w * y * y, torch.ones_like(w)], 1)
    elif kind == "gini":
        if C in (3, 5):
            cls = y + (2.0 * (XbT[1] > B // 2).float() if C == 5 else 0.0)
        else:           # every one of the C − 1 classes holds rows
            cls = torch.remainder(y.long() + XbT[1].long(), C - 1)
        w = torch.floor(3.0 * u)
        onehot = torch.nn.functional.one_hot(cls.long(), C - 1).float()
        st = torch.cat([onehot * w[:, None], (w > 0).float()[:, None]], 1)
    else:
        st = torch.stack([u - y, u * (1 - u) + 1e-6, torch.ones_like(u)], 1)
    slot = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
    cums = [H.cumhist(st, slot, XbT, A, B)]
    cols = [torch.arange(F, device=dev)]
    if nblk == 2:
        cums.append(H.cumhist_sparse01(st, slot, X01, A))
        cols.append(torch.arange(F, F + FB, device=dev))
        Xfull = torch.cat([XbT, X01.to(torch.int32)])
    else:
        Xfull = XbT
    score = torch.empty((nblk, A), dtype=torch.float32, device=dev)
    idx = torch.empty((nblk, A), dtype=torch.int32, device=dev)
    valid = torch.empty((nblk, A), dtype=torch.bool, device=dev)
    for b, cumb in enumerate(cums):
        H.split_scan(cumb, kind, 10.0, lam=1.0, min_child_weight=1.0,
                     out=(score[b], idx[b], valid[b]))
    if A >= 2:
        for cumb in cums:
            cumb[1] = cumb[0]
        for t in (score, idx, valid):
            t[:, 1] = t[:, 0]
    if A >= 3 and nblk == 2:
        score[1, 2] = score[0, 2]
    edges = torch.sort(torch.randn((Xfull.shape[0], B - 1), device=dev),
                       dim=1).values
    alive = put(rng.random(A) > 0.2)
    alive[:2] = True
    gpos = put(rng.permutation(1 << d)[:A].astype(np.int32))
    g = put(rng.integers(0, 1 << d, size=N, dtype=np.int32))
    return (score, idx, valid, cums, cols, [False, True][:nblk], edges,
            alive, gpos, Xfull, slot, g)


def level_records(D, C, dev):
    """A tree's fresh records as grow_tree makes them: feat, thr, gain
    [2^D] and the leaf stats [2^D + 1, C] (the last entry a sink)."""
    return (torch.zeros(1 << D, dtype=torch.int32, device=dev),
            torch.full((1 << D,), float("inf"), device=dev),
            torch.zeros(1 << D, device=dev),
            torch.zeros(((1 << D) + 1, C), device=dev))


#: the gain floor as grow_tree computes it from min_info_gain = 0
MIG = torch.clamp(torch.tensor(0.0), min=1e-10)
#: the epilogue's criteria and channel counts (gini: 2 and 4 classes)
EPILOGUE_KINDS = (("variance", 4), ("xgb", 3), ("gini", 3), ("gini", 5))


def epilogue_pair(H, args, records, kw):
    """The epilogue kernel and its plain version on the same inputs, each
    on its own copy of the records; fails unless every output and record
    (but the records' sink entries) is bitwise equal. Returns the plain
    version's (outputs, records)."""
    got_rec = [r.clone() for r in records]
    ref_rec = [r.clone() for r in records]
    got = H.level_epilogue(*args, *got_rec, **kw)
    ref = H.level_epilogue_reference(*args, *ref_rec, **kw)
    torch.cuda.synchronize()
    names = ("slot2", "g2", "node_even2", "gpos2", "alive2", "rank")
    for name, a, b in zip(names, got, ref):
        if (a is None) != (b is None) or (a is not None
                                          and not torch.equal(a, b)):
            fail(f"level_epilogue: {name} differs ({kw})")
    # the last entry of each record is a sink: the plain version writes
    # its dropped entries there, the kernel leaves it
    for name, a, b in zip(("feat", "thr", "gain", "leaf_stats"), got_rec,
                          ref_rec):
        if not torch.equal(a[:-1], b[:-1]):
            fail(f"level_epilogue: {name} differs ({kw})")
    return ref, ref_rec


def epilogue_timed(H, dev, rng, put, XbT, X01, kind, C):
    """The sweep's level at A = 128, one block, the next level's sibling
    mask, under ``kind`` at C channels: checked bitwise, then timed with
    its plain version. Returns (ms, plain ms, (bytes s, operations s),
    inputs)."""
    A, d, D = 128, 7, 9
    args = epilogue_inputs(H, dev, rng, put, XbT, X01, kind, A, 1, d, D,
                           C=C)
    records = level_records(D, C, dev)
    kw = dict(kind=kind, lam=0.0, mig=MIG, d=d, max_depth=D, A_next=A,
              node_even=True)
    _out, rec = epilogue_pair(H, args, records, kw)
    ms = time_ms(lambda: H.level_epilogue(*args, *records, **kw))
    plain_ms = time_ms(lambda: H.level_epilogue_reference(*args, *records,
                                                          **kw))
    slot, gpos, alive = args[10], args[8], args[7]
    split = alive & torch.isfinite(rec[1][(1 << d) - 1 + gpos.long()])
    live = slot < A
    split_rows = int(split[slot[live].long()].sum().item())
    n_split = int(split.sum().item())
    n_dying = int((alive & ~split).sum().item())
    emit = n_split - min(n_split, A // 2)
    # rows: slot and g read, one bin where the slot splits, slot', g' and
    # node_even' written; the plan: the block winners (9 bytes a slot),
    # the winner's left stats and the totals, alive and gpos, the column
    # and edge; gpos', alive', rank; the records and leaves written
    plan = (A * 9 + A * C * 8 + A * 5 + A * 12 + A * 5 + (A // 2) * 8
            + int(alive.sum().item()) * 12 + (n_dying + 2 * emit) * C * 4)
    nbytes = N * 8 + split_rows * 4 + N * 12 + plan
    # the rank's A^2 compares, ~10 operations a row, the gains (a few
    # dozen operations a slot)
    ebound = (nbytes / HBM_BPS, (A * A + 10.0 * N + 40.0 * A) / F32_FLOPS)
    print(f"level_epilogue {kind} A={A} C={C} (one block, sibling mask): "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{1e3 * max(ebound):.5f} ms ({nbytes} bytes, {plan} of them the "
          f"plan's)")
    return ms, plain_ms, ebound, args


def epilogue_cases(H, dev, rng, put, XbT, X01, kinds):
    """The level epilogue against its plain version at A ∈ {1, 64, 128}
    under each (kind, C) of ``kinds``, one block and two, in every case of
    :func:`check_epilogue`; returns the slots whose winner was in the
    2-bin block."""
    block1_wins = 0
    for A in (1, 64, 128):
        d, D = (A - 1).bit_length(), 9
        for kind, Ck in kinds:
            for nblk in (1, 2):
                args = epilogue_inputs(H, dev, rng, put, XbT, X01, kind, A,
                                       nblk, d, D, C=Ck)
                C = args[3][0].shape[1]
                lam = 1.0 if kind == "xgb" else 0.0
                cases = [dict(A_next=min(2 * A, 128), node_even=True),
                         dict(A_next=A)]
                if nblk == 2:
                    block1_wins += int((args[0][1] > args[0][0]).sum())
                    cases += [dict(A_next=A, split_ok=False),
                              dict(A_next=min(2 * A, 128), last=True),
                              dict(A_next=A, mig=torch.tensor(3e38))]
                for case in cases:
                    depth = d + 1 if case.get("last") else D
                    kw = dict(kind=kind, lam=lam, mig=case.get("mig", MIG),
                              d=d, max_depth=depth, A_next=case["A_next"],
                              split_ok=case.get("split_ok", True),
                              node_even=case.get("node_even", False))
                    epilogue_pair(H, args, level_records(depth, C, dev), kw)
    return block1_wins


def check_epilogue(H, dev, rng, put, XbT):
    """The level epilogue against its plain version, every output bitwise:
    A ∈ {1, 64, 128} parent slots; variance and xgb; one block and two
    (the 2-bin block's winners at threshold 0.5); the unrolled driver's
    level (A_next = min(2A, 128), the next level's sibling mask) and the
    constant-slot driver's (A_next = A, no mask, more splitting slots than
    A_next / 2); and, with two blocks, a level past the depth limit, a
    last level (two leaves a split) and a level where every slot dies.
    Gini (random forests) at C = 3 (binary) and C = 5 (four classes) in
    every one of those cases. Then the route-only call and the epilogue
    timed at A = 128 (variance, and gini at C = 3). Returns the result
    line's rows of both, and the gini time."""
    X01 = put((rng.random((FB, N)) < 0.3).astype(np.uint8))
    block1_wins = epilogue_cases(H, dev, rng, put, XbT, X01, EPILOGUE_KINDS)
    if not block1_wins:
        fail("level_epilogue: no winner in the 2-bin block was checked")
    print(f"level_epilogue: slots, g, sibling masks, gpos, alive, rank and "
          f"the feat/thr/gain/leaf records bitwise equal to the plain "
          f"version (A = 1, 64, 128; variance, xgb, gini at C = 3 and 5; "
          f"1 and 2 blocks, "
          f"{block1_wins} slots won in the 2-bin block; both drivers; "
          f"depth-limit, last and all-dying levels; gain ties)")

    # the main path's call: the sweep's level at A = 128 (one block,
    # variance, the next level's sibling mask); the forest's, gini at C = 3
    A = 128
    ms, plain_ms, ebound, args = epilogue_timed(H, dev, rng, put, XbT, X01,
                                                "variance", 4)
    out = {"level_epilogue": dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:389 and "
                 "transmogrifai_tpu/models/_treefit.py:876",
        source="transmogrifai_tpu_torch/csrc/route_level.cu",
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound=ebound)}
    g_ms, g_plain, gbound, _ = epilogue_timed(H, dev, rng, put, XbT, X01,
                                              "gini", 3)
    print(f"level_epilogue gini beside variance at A={A}: {g_ms:.4f} ms "
          f"against {ms:.4f} ms")
    out["level_epilogue"]["gini"] = dict(ms=g_ms, plain_ms=g_plain,
                                         bound_ms=1e3 * max(gbound))
    slot, live = args[10], args[10] < A

    # the route alone, as the JAX route_level's signature takes it
    g = args[11]
    tabs = route_tables(rng, put, A, A)
    r_ms = time_ms(lambda: H.route_level(XbT, slot, g, *tabs, A, A))
    r_plain = time_ms(lambda: H.route_level_reference(XbT, slot, g, *tabs,
                                                      A, A))
    live_n = int(live.sum().item())
    rbound = ((4 * N * 4 + 4 * live_n + 5 * A * 4) / HBM_BPS,
              8.0 * N / F32_FLOPS)
    print(f"route_level A={A}: kernel {r_ms:.4f} ms (one launch), plain "
          f"{r_plain:.4f} ms, bound {1e3 * max(rbound):.5f} ms; the "
          f"epilogue beside it {ms:.4f} ms, bound {1e3 * max(ebound):.5f} ms")
    out["route_level"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:389",
        max_abs_err=0.0, ms=r_ms, plain_ms=r_plain, library_ms=None,
        bound=rbound)
    return out


def profile_path(H, name, fn):
    """One main path once more under ``torch.profiler``: device time per
    kernel, the device's busy share of the wall clock, and the device
    operations a tree level (every kernel, copy and fill over the levels,
    counted as ``group_rows``' launches: one a level in every version of
    the port). Only device activity is recorded, so each device interval
    counts once in the busy share; a host operator's self device time
    would count its kernels a second time."""
    from torch.profiler import ProfilerActivity, profile
    H.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    levels = H.KERNEL_LAUNCHES["group_rows"]
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
    ops = sum(r[1] for r in rows)
    copies = sum(r[1] for r in rows if r[2].startswith(("Memcpy", "Memset")))
    print(f"profile {name}: {ops} device operations ({ops - copies} kernels, "
          f"{copies} copies and fills) over {levels} levels: "
          f"{ops / max(levels, 1):.1f} device launches a level")
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
    # the split scans, the route or level epilogue, the predict, and every
    # uint8 → bool copy
    for what, sel in (("split_scan", lambda k: "split_scan" in k),
                      ("route/epilogue", lambda k: "route_level" in k
                       or "level_epilogue" in k),
                      ("predict_trees", lambda k: "predict_trees" in k),
                      ("bool conversion",
                       lambda k: "copy" in k and "(bool)" in k)):
        found = [r for r in rows if sel(r[2])]
        for dev_us, count, key in found:
            print(f"profile {name} {what}: {dev_us / 1e3:10.3f} ms "
                  f"{count:7d}x  {key[:90]}")
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
    """Each tree level ends in one epilogue launch (which routes its rows;
    no route-only call) and groups its rows once; no fit passes the
    precomputed indicator (``bc=``)."""
    if launches["group_rows"] != launches["level_epilogue"]:
        fail(f"{what}: {launches['group_rows']} group_rows launches for "
             f"{launches['level_epilogue']} levels")
    for k in ("cumhist_bc", "route_level"):
        if launches[k]:
            fail(f"{what}: {launches[k]} {k} launches")


def check_scored(out, n, what):
    aupr = out["metrics"]["AuPR"]
    scored = out["scored"][out["prediction"].name]
    if not (len(scored) == n and np.isfinite(scored.probability).all()
            and 0.0 < aupr <= 1.0):
        fail(f"{what}: scored predictions are not finite or of the wrong "
             "shape")
    return aupr


def titanic_one_point():
    """One grid point of each default family (the forest at 5 trees): the
    titanic card/CPU agreement."""
    from transmogrifai_tpu_torch.models import (GBTFamily,
                                                LinearSVCFamily,
                                                LogisticRegressionFamily,
                                                RandomForestFamily)
    tree = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}
    return [LogisticRegressionFamily(grid=[{"regParam": 0.01,
                                            "elasticNetParam": 0.1}]),
            RandomForestFamily(grid=[dict(tree)], num_trees=5),
            GBTFamily(grid=[dict(tree, maxDepth=3)]),
            LinearSVCFamily(grid=[{"regParam": 0.01}])]


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


def layer_evaluate(out, what):
    """The path's evaluate again on the layer path (no scoring engine), on
    the card: its seconds beside the engine's, and the same AuPR."""
    t0 = time.perf_counter()
    metrics = out["model"].evaluate(out["data"], out["evaluator"],
                                    device="cuda", engine=False)
    layer_s = time.perf_counter() - t0
    if metrics["AuPR"] != out["metrics"]["AuPR"]:
        fail(f"{what}: the layer path's AuPR differs from the engine's")
    print(f"{what}: evaluate {out['eval_s']:.2f} s through the scoring "
          f"engine, {layer_s:.2f} s on the layer path (same AuPR)")


def same_predictions(a, b, what, prob_atol=0.0):
    """Two prediction columns bitwise equal, every column; with
    ``prob_atol`` the probabilities within it."""
    for col in ("prediction", "raw_prediction", "probability"):
        x, y = getattr(a, col), getattr(b, col)
        if col == "probability" and prob_atol:
            err = float(np.max(np.abs(x - y), initial=0.0))
            if err > prob_atol:
                fail(f"{what}: probability differs by {err:.3g}")
        elif not np.array_equal(x, y):
            fail(f"{what}: {col} differs")


def serve(H, BP, records, text_aupr, dev="cuda", profile=False):
    """Phase 7: the golden model on the card, then BigPassenger through the
    runner's Train (saves), Score (a fresh load, the scoring engine, a CUDA
    graph per bucket) and Evaluate, and the overlapped stream, with every
    launch counted; then the checks. Returns the path's launches. ``dev``
    "cpu" rehearses the phase on the host (no graphs, no kernels)."""
    import shutil

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.runner import (OpParams, OpWorkflowRunner,
                                                RunType)
    from transmogrifai_tpu_torch.scoring import stream_score_overlapped
    from transmogrifai_tpu_torch.workflow import Workflow

    root = os.path.dirname(os.path.abspath(__file__))
    golden = os.path.join(root, "tests", "resources", "golden_model_v1")
    expected = json.load(open(os.path.join(golden, "expected.json")))
    gm = WorkflowModel.load(golden)
    for engine in (False, True):
        p = gm.score(expected["rows"], device=dev,
                     engine=engine)[expected["pred_name"]]
        if not (np.array_equal(p.prediction, expected["expected_pred"])
                and np.allclose(p.probability[:, 1],
                                expected["expected_prob1"], rtol=1e-6,
                                atol=0.0)):
            fail(f"golden model: scores differ from expected.json "
                 f"(engine={engine})")
    print("golden model on the card: predictions exact, probability[:, 1] "
          "within rtol 1e-6 of expected.json (layer path and engine)")

    survived, _checked, selector, prediction = BP.build_selection()
    wf = (Workflow().set_result_features(prediction)
          .set_splitter(selector.splitter))
    reader = DataReaders.simple.records(records)
    runner = OpWorkflowRunner(
        wf, training_reader=reader, scoring_reader=reader,
        evaluator=Evaluators.BinaryClassification.auPR().set_columns(
            survived, prediction), device=dev)
    path = os.path.join(root, "build", "serve", "big_passenger")
    shutil.rmtree(path, ignore_errors=True)
    params = OpParams(model_location=path)
    n = len(records)
    chunks = -(-n // 8192)

    H.reset_launch_counts()
    t0 = time.perf_counter()
    trained = runner.run(RunType.TRAIN, params)
    train_s = time.perf_counter() - t0
    before = dict(H.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    scored = runner.run(RunType.SCORE, params)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    score_launches = {k: v - before[k] for k, v in H.KERNEL_LAUNCHES.items()}
    t0 = time.perf_counter()
    ev = runner.run(RunType.EVALUATE, params)
    eval_s = time.perf_counter() - t0
    batches = [records[i:i + 8000] for i in range(0, n, 8000)]
    t0 = time.perf_counter()
    streamed = list(stream_score_overlapped(scored.model, batches,
                                            device=dev))
    stream_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = dict(H.KERNEL_LAUNCHES)
    for k in ("cumhist", "cumhist_sparse01", "group_rows", "split_scan",
              "level_epilogue", "predict_trees"):
        if launches[k] == 0:
            fail(f"serve path never launched {k}")
    once_per_level(launches, "serve path")
    if score_launches["predict_trees"] != chunks:
        fail(f"Score launched predict_trees {score_launches['predict_trees']}"
             f" times for {chunks} bucket chunks")
    eng = scored.model.scoring_engine(dev)
    print(f"serve-200k: train (runner, saves) {train_s:.2f} s, Score "
          f"(fresh load, engine) {score_s:.2f} s = {n / score_s:,.0f} rows/s, "
          f"Evaluate {eval_s:.2f} s, overlapped stream ({len(batches)} "
          f"batches of 8000) {stream_s:.2f} s = {n / stream_s:,.0f} rows/s; "
          f"buckets used {eng.buckets_used()}, graphs captured "
          f"{eng.graphs_captured}, predict_trees launches in Score "
          f"{score_launches['predict_trees']} ({chunks} chunks)")
    aupr = ev.metrics["AuPR"]
    if aupr != text_aupr:
        fail(f"serve path: Evaluate AuPR {aupr!r} is not phase 4's "
             f"{text_aupr!r}")
    print(f"serve-200k: Evaluate AuPR {aupr:.6f}, equal to phase 4's")
    print(f"serve-200k launches: {launches}")

    # -- checks (not counted) ---------------------------------------------
    t0 = time.perf_counter()
    trained.model.save(os.path.join(root, "build", "serve", "again"),
                       overwrite=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = WorkflowModel.load(path)
    load_s = time.perf_counter() - t0
    got = scored.scores[prediction.name]
    t0 = time.perf_counter()
    eager = trained.model.score(records, device=dev, engine=False)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    same_predictions(got, eager[prediction.name],
                     "Score (engine) against the trained model's eager score")
    print(f"serve-200k: save {save_s:.2f} s, load {load_s:.2f} s; Score "
          f"{score_s:.2f} s against the layer path's {eager_s:.2f} s; "
          "Score's columns bitwise equal to the layer path's")
    warm = scored.model.scoring_engine(dev, graphs=False)
    same_predictions(got, warm.score_store(records)[prediction.name],
                     "graph replays at 8192 against the eager program")
    tail = records[(chunks - 1) * 8192:]
    want = warm.score_store(tail)[prediction.name]
    for _ in range(2):      # capture and replay at 4096, then a replay
        same_predictions(eng.score_store(tail, use_cache=False)[
            prediction.name], want,
            "graph replays at 4096 against the eager program")
    print(f"serve-200k: graph replays bitwise equal to the eager program at "
          f"buckets {eng.buckets_used()} ({eng.graphs_captured} graphs)")
    for name in ("prediction", "raw_prediction", "probability"):
        col = np.concatenate([getattr(s[prediction.name], name)
                              for s in streamed])
        if not np.array_equal(col, getattr(got, name)):
            fail(f"overlapped stream: {name} differs from Score's")
    print("serve-200k: the overlapped stream equals Score's output bitwise")
    if profile:
        profile_path(H, "serve-200k Score",
                     lambda: runner.run(RunType.SCORE, params))
    cpu = loaded.score(records[:2000], device="cpu")[prediction.name]
    card = scored.model.score(records[:2000], device=dev,
                              engine=True)[prediction.name]
    # predictions and margins bitwise (the kernel is bitwise to its plain
    # version); the sigmoid's exp rounds apart on the card and the CPU
    same_predictions(card, cpu, "card/CPU agreement (2000 records)",
                     prob_atol=PROB_ATOL)
    err = float(np.max(np.abs(card.probability - cpu.probability)))
    print(f"serve-200k: the saved model scores 2000 records alike on cuda "
          f"(engine) and cpu: predictions and margins bitwise, "
          f"probabilities within {err:.3g} (limit {PROB_ATOL:.3g})")
    return launches


#: phase 8's gini channel counts: iris's (three classes and the count)
#: and the most the card's tree kernels take (seven classes)
WIDE_GINI = (4, 8)
#: the iris forest's ensemble as scoring runs it: (F, T, D, K) = the eight
#: transmogrified columns, 50 trees of depth 12, three class shares
IRIS_PREDICT = (8, 50, 12, 3)
#: split_scan's (F, B) at the wide gini: the sweep's block and iris's two
#: (four values in 32 bins, four null indicators in 2)
WIDE_SCAN_SHAPES = ((F, B), (4, B), (4, 2))
#: iris species → the numeric codes of the label-mapping check
IRIS_CODES = {"Iris-setosa": 1.0, "Iris-versicolor": 4.0,
              "Iris-virginica": 6.0}
TREE_WINNERS = ("OpRandomForestClassifier", "OpDecisionTreeClassifier")


def gini_stats(rng, C, n):
    """[n, C] f32 gini stats: a one-hot of C − 1 classes (every class
    present) times an integer bootstrap-like weight 0..2, and the count."""
    cls = rng.integers(0, C - 1, n)
    w = rng.integers(0, 3, n).astype(np.float32)
    st = np.zeros((n, C), np.float32)
    st[np.arange(n), cls] = w
    st[:, -1] = w > 0
    return st


def check_multiclass_kernels(H, dev):
    """Phase 8's kernels at the multiclass shapes, each against its plain
    version: the histograms at C = 8 (``cumhist`` and ``cumhist_sparse01``,
    A ∈ {1, 64, 128}); ``split_scan`` under gini at C ∈ WIDE_GINI, every
    slot count of SCAN_SLOTS, the sweep's and iris's block shapes, masked
    and not, bitwise; the level epilogue under gini at C ∈ WIDE_GINI in
    every case of :func:`check_epilogue`, bitwise; ``predict_trees`` at
    IRIS_PREDICT within REL_TOL. Each is timed beside its plain version
    (split_scan and the epilogue at A = 128). Returns the printed times."""
    rng = np.random.default_rng(8)

    def put(a):
        return torch.as_tensor(a, device=dev)

    XbT = put(rng.integers(0, B, size=(F, N), dtype=np.int32))
    X01 = put((rng.random((FB, N)) < 0.3).astype(np.uint8))
    hrows = H.hist_rows(XbT)
    for A in (1, 64, 128):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        st = put(gini_stats(rng, 8, N))
        hold(H.cumhist(st, node, XbT, A, B, rows=hrows),
             H.cumhist(st, node, XbT, A, B),
             [H.cumhist_reference(st, node, XbT, A, B)],
             f"cumhist gini A={A} C=8")
        hold(H.cumhist_sparse01(st, node, X01, A),
             H.cumhist_sparse01(st, node, X01, A),
             [H.cumhist_sparse01_reference(st, node, X01, A)],
             f"cumhist_sparse01 gini A={A} C=8")
    print("cumhist, cumhist_sparse01 at gini C=8 (A = 1, 64, 128): counts "
          f"exact, class channels within {REL_TOL:g}, two calls bitwise "
          "equal")
    times = {}
    for C in WIDE_GINI:
        st = put(gini_stats(rng, C, N))
        for Fs, Bs in WIDE_SCAN_SHAPES:
            Xs = XbT[:Fs] if Bs == B else torch.remainder(XbT[:Fs], Bs)
            srows = H.hist_rows(Xs)
            for A in SCAN_SLOTS:
                node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
                cum = H.cumhist(st, node, Xs, A, Bs, rows=srows)
                what = f"gini C={C} F={Fs} B={Bs} A={A}"
                mask = put((rng.random((A, Fs)) > 0.2).astype(np.float32))
                scan_holds(H, cum, "gini", mask, f"{what} masked")
                scan_holds(H, cum, "gini", None, what)
        node = put(rng.integers(0, 129, size=N, dtype=np.int32))
        cum = H.cumhist(st, node, XbT, 128, B, rows=hrows)
        ms = time_ms(lambda: H.split_scan(cum, "gini", 10.0))
        plain_ms = time_ms(lambda: H.split_scan_reference(cum, "gini",
                                                          10.0))
        # as phase 2's row: the histogram read once, three outputs a slot
        # written; each candidate's two sides' gini, six operations a class
        # and six more
        sbound = ((cum.numel() * 4 + 128 * 9) / HBM_BPS,
                  (6.0 * (C - 1) + 6.0) * 128 * (B - 1) * F / F32_FLOPS)
        times[f"split_scan gini C={C}"] = (ms, plain_ms, max(sbound))
        print(f"split_scan gini C={C}: selections and scores bitwise equal "
              f"to the plain version (F, B in {WIDE_SCAN_SHAPES}; A = "
              f"{', '.join(map(str, SCAN_SLOTS))}; masked and not); A=128 "
              f"F={F} B={B}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {1e3 * max(sbound):.5f} ms")
    wins = epilogue_cases(H, dev, rng, put, XbT, X01,
                          [("gini", C) for C in WIDE_GINI])
    if not wins:
        fail("level_epilogue gini: no winner in the 2-bin block was checked")
    print(f"level_epilogue gini at C = {WIDE_GINI}: every output bitwise "
          f"equal to the plain version (A = 1, 64, 128; 1 and 2 blocks, "
          f"{wins} slots won in the 2-bin block; both drivers; depth-limit, "
          f"last and all-dying levels; gain ties)")
    for C in WIDE_GINI:
        ms, plain_ms, ebound, _args = epilogue_timed(H, dev, rng, put, XbT,
                                                     X01, "gini", C)
        times[f"level_epilogue gini C={C}"] = (ms, plain_ms, max(ebound))
    Fp, T, D, K = IRIS_PREDICT
    X, feat, thr, leaf = predict_inputs(rng, put, Fp, T, D, K)
    out = H.predict_trees(X, feat, thr, leaf, D)
    ref = H.predict_trees_reference(X, feat, thr, leaf, D)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if rel_err(out, ref) > REL_TOL:
        fail(f"predict_trees differs at {IRIS_PREDICT}: max abs err "
             f"{err:.3g}")
    ms = time_ms(lambda: H.predict_trees(X, feat, thr, leaf, D))
    plain_ms = time_ms(lambda: H.predict_trees_reference(X, feat, thr,
                                                         leaf, D), reps=5)
    pbound = max(predict_bound(Fp, T, D, K))
    times["predict_trees F=8 T=50 D=12 K=3"] = (ms, plain_ms, pbound)
    print(f"predict_trees F={Fp} T={T} D={D} K={K} ("
          f"{-(-T // H.predict_trees_chunk(Fp, D, K))} chunk(s)): within "
          f"{REL_TOL:g} of the plain version (max abs err {err:.3g}, "
          f"bitwise equal: {torch.equal(out, ref)}); kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {1e3 * pbound:.5f} ms")
    return times


def iris_one_point():
    """One grid point of each multiclass default family (the forest at 5
    trees): the iris card/CPU agreement."""
    from transmogrifai_tpu_torch.models import (DecisionTreeFamily,
                                                LogisticRegressionFamily,
                                                NaiveBayesFamily,
                                                RandomForestFamily)
    tree = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}
    return [LogisticRegressionFamily(grid=[{"regParam": 0.01,
                                            "elasticNetParam": 0.1}]),
            NaiveBayesFamily(),
            RandomForestFamily(grid=[dict(tree)], num_trees=5),
            DecisionTreeFamily(grid=[dict(tree)])]


def boston_one_point():
    """One grid point of each of boston's families: its agreement."""
    from transmogrifai_tpu_torch.models import GBTFamily, RandomForestFamily
    tree = {"maxDepth": 6, "minInstancesPerNode": 10, "minInfoGain": 0.001}
    return [RandomForestFamily(grid=[dict(tree)], task="regression",
                               num_trees=5),
            GBTFamily(grid=[dict(tree, maxDepth=3)], task="regression")]


def agree_metric(runs, metric, limit, what, relative=False):
    """The card's and the CPU's run pick one model, ``metric`` within
    ``limit`` (of the CPU's value when ``relative``), and so does every
    family's CV metric in every fold: the losers' fits are held too."""
    a, b = runs["cuda"], runs["cpu"]
    if ((a["summary"].best_model_name, a["summary"].best_model_params)
            != (b["summary"].best_model_name,
                b["summary"].best_model_params)):
        fail(f"cuda and cpu picked different models ({what})")

    def diff(x, y):
        return abs(x - y) / (abs(y) if relative else 1.0)
    d = diff(a["metrics"][metric], b["metrics"][metric])
    if not d <= limit:
        fail(f"cuda and cpu {metric} differ by {d:.3g} ({what})")
    ra = a["summary"].validator_summary.results
    rb = b["summary"].validator_summary.results
    if [(r.family_name, r.hparams) for r in ra] != \
            [(r.family_name, r.hparams) for r in rb]:
        fail(f"cuda and cpu validated different grids ({what})")
    folds = {}
    for x, y in zip(ra, rb):
        folds[x.family_name] = max([folds.get(x.family_name, 0.0)] + [
            diff(u, v) for u, v in zip(x.metric_values, y.metric_values)])
    if not all(v <= limit for v in folds.values()):
        fail(f"cuda and cpu CV fold metrics differ ({what}): {folds}")
    rel = "/" + metric if relative else ""
    print(f"{what}: same model on cuda and cpu "
          f"({a['summary'].best_model_name}), |d{metric}|{rel} = {d:.3g}; "
          f"largest CV fold |d{metric}|{rel} by family "
          f"{ {k: float(f'{v:.3g}') for k, v in folds.items()} } "
          f"(limit {limit:g})")


def multiclass_paths(H, IR, BO, data_dir, profile=False, dev="cuda"):
    """Phase 8's two paths through ``Workflow.train`` with every launch
    counted: iris-200k (the multiclass selector's default families, a
    DataCutter, the prediction de-indexed) and boston-200k (the random
    forest and GBT regressors), each evaluated; then each at 2,000 rows,
    one grid point a family, on the card and on the CPU, with all the
    families and with each tree family alone. Returns
    ({path: launches}, iris-200k's run). ``dev`` "cpu" rehearses the
    phase on the host."""
    t0 = time.perf_counter()
    iris_path = IR.generate_csv(os.path.join(data_dir, "iris-200k.data"), N,
                                seed=42)
    boston_path = BO.generate_data(os.path.join(data_dir,
                                                "boston-200k.data"), N,
                                   seed=42)
    print(f"phase 8 data: {N} iris and {N} boston rows written in "
          f"{time.perf_counter() - t0:.2f} s")
    tree_kernels = ("cumhist", "cumhist_sparse01", "group_rows",
                    "split_scan", "level_epilogue")
    launches_by = {}
    iris, launches = counted(H, lambda: IR.run(iris_path, device=dev),
                             tree_kernels)
    once_per_level(launches, "iris-200k")
    s = iris["summary"]
    tree_won = s.best_model_name in TREE_WINNERS
    if tree_won and not launches["predict_trees"]:
        fail("iris-200k: a tree model won and predict_trees never launched")
    f1, err = iris["metrics"]["F1"], iris["metrics"]["Error"]
    names = iris["predicted_labels"].values
    if not (len(names) == N and set(names) <= set(IR.IRIS_CLASSES)
            and 0.0 < f1 <= 1.0 and np.isfinite(
                iris["scored"][iris["prediction"].name].probability).all()):
        fail("iris-200k: scores are not finite, of the wrong shape, or "
             "name no species")
    print(f"iris-200k {N} rows: train {iris['train_s']:.2f} s, "
          f"{launches['group_rows']} levels, evaluate {iris['eval_s']:.2f} "
          f"s, best {s.best_model_name} {s.best_model_params}, F1 "
          f"{f1:.6f}, Error {err:.6f}; holdout F1 "
          f"{s.holdout_evaluation['F1']:.6f}")
    print(f"iris-200k CV seconds by family: "
          f"{s.validator_summary.family_seconds}")
    print(f"iris-200k launches: {launches}")
    launches_by["iris-200k"] = launches
    iris["data_path"] = iris_path
    if profile:
        profile_path(H, "iris-200k", lambda: IR.run(iris_path,
                                                    device="cuda"))

    boston, launches = counted(H, lambda: BO.run(boston_path, device=dev),
                               tree_kernels + ("predict_trees",))
    once_per_level(launches, "boston-200k")
    s = boston["summary"]
    rmse, r2 = (boston["metrics"]["RootMeanSquaredError"],
                boston["metrics"]["R2"])
    pred = boston["scored"][boston["prediction"].name].prediction
    if not (len(pred) == N and np.isfinite(pred).all()
            and 0.0 < rmse < 50.0 and 0.0 < r2 <= 1.0):
        fail("boston-200k: predictions are not finite or of the wrong "
             "shape, or RMSE / R2 out of range")
    print(f"boston-200k {N} rows: train {boston['train_s']:.2f} s, "
          f"{launches['group_rows']} levels, evaluate "
          f"{boston['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, RMSE {rmse:.6f}, R2 {r2:.6f}; holdout "
          f"RMSE {s.holdout_evaluation['RootMeanSquaredError']:.6f}")
    print(f"boston-200k CV seconds by family: "
          f"{s.validator_summary.family_seconds}")
    print(f"boston-200k launches: {launches}")
    launches_by["boston-200k"] = launches
    if profile:
        profile_path(H, "boston-200k", lambda: BO.run(boston_path,
                                                      device="cuda"))

    t0 = time.perf_counter()
    small = IR.generate_csv(os.path.join(data_dir, "iris-2k.data"), 2_000,
                            seed=42)
    # all the families, then each tree family alone: every tree family's
    # refit and scoring (predict_trees at K=3, and the GBT regressor at
    # K=1) is held on the path too
    for fams, which in ((iris_one_point(), "one grid point a family"),
                        (iris_one_point()[2:3], "the forest alone"),
                        (iris_one_point()[3:], "the decision tree alone")):
        agree_metric({k: IR.run(small, device=d, families=fams)
                      for k, d in (("cuda", dev), ("cpu", "cpu"))}, "F1",
                     1e-4, f"iris, 2000 rows, {which}")
    small = BO.generate_data(os.path.join(data_dir, "boston-2k.data"),
                             2_000, seed=42)
    for fams, which in ((boston_one_point(), "one grid point a family"),
                        (boston_one_point()[1:], "GBT alone")):
        agree_metric({k: BO.run(small, device=d, families=fams)
                      for k, d in (("cuda", dev), ("cpu", "cpu"))},
                     "RootMeanSquaredError", 1e-4,
                     f"boston, 2000 rows, {which}", relative=True)
    print(f"phase 8 agreements: {time.perf_counter() - t0:.2f} s")
    return launches_by, iris


def coded_iris_model(iris_path, dev):
    """The iris data with the species as numeric codes (IRIS_CODES) and
    no indexer: the DataCutter re-indexes {1, 4, 6} to classes 0..2 and
    the selected model (a 5-tree forest) maps them back through its
    ``label_mapping``. Returns (model, prediction feature, reader)."""
    from transmogrifai_tpu_torch import FeatureBuilder, Workflow
    from transmogrifai_tpu_torch.dsl import transmogrify
    from transmogrifai_tpu_torch.models import (
        DataCutter, MultiClassificationModelSelector, RandomForestFamily)
    from transmogrifai_tpu_torch.readers import DataReaders

    def num(n):
        return lambda r: float(r[n]) if r.get(n) not in (None, "") else None
    code = (FeatureBuilder.RealNN("irisCode")
            .extract(lambda r: IRIS_CODES[r["irisClass"]], "irisClass")
            .as_response())
    names = ["sepalLength", "sepalWidth", "petalLength", "petalWidth"]
    vec = transmogrify([FeatureBuilder.Real(n).extract(num(n), n)
                        .as_predictor() for n in names])
    sel = MultiClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[RandomForestFamily(
            grid=[{"maxDepth": 6, "minInstancesPerNode": 10,
                   "minInfoGain": 0.001}], num_trees=5)],
        splitter=DataCutter(reserve_test_fraction=0.2, seed=42))
    pred = code.transform_with(sel, vec)
    reader = DataReaders.simple.csv(iris_path, names + ["irisClass"])
    model = (Workflow().set_reader(reader).set_result_features(pred)
             .set_splitter(sel.splitter).train(device=dev))
    mapping = model.fitted_stages[sel.uid].label_mapping
    if mapping != sorted(IRIS_CODES.values()):
        fail(f"coded iris: label mapping {mapping} is not the codes")
    return model, pred, reader


def serve_iris(H, iris, root, dev="cuda"):
    """Phase 8's serving: the iris-200k model saved, loaded in a fresh
    ``WorkflowModel`` and its 200,000 rows scored through the scoring
    engine (the model's predict and the de-indexer's codes in one
    program, a CUDA graph per bucket), counted; the species names and the
    predictions must equal the layer path's. Then the label mapping on
    the card: the coded-species model scored alike through the engine
    and the layer path, its predictions the original codes. Returns the
    launches of the engine's scores of each model."""
    import shutil

    from transmogrifai_tpu_torch import WorkflowModel
    path = os.path.join(root, "build", "serve", "iris")
    shutil.rmtree(path, ignore_errors=True)
    t0 = time.perf_counter()
    iris["model"].save(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = WorkflowModel.load(path)
    load_s = time.perf_counter() - t0
    store = iris["data"]
    pred, de = iris["prediction"].name, iris["deindexed"].name
    chunks = -(-N // 8192)
    H.reset_launch_counts()
    t0 = time.perf_counter()
    scored = loaded.score(store, device=dev, engine=True)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    launches = dict(H.KERNEL_LAUNCHES)
    eng = loaded.scoring_engine(dev)
    kinds = [it.kind for it in eng._plan]
    if kinds[-2:] != ["predict", "deindex"]:
        fail(f"iris serve: the engine's program is {kinds}, not ending in "
             "the predictor and the de-indexer")
    tree_won = iris["summary"].best_model_name in TREE_WINNERS
    if tree_won and launches["predict_trees"] != chunks:
        fail(f"iris serve: predict_trees launched {launches['predict_trees']}"
             f" times for {chunks} chunks")
    t0 = time.perf_counter()
    layer = iris["model"].score(store, device=dev, engine=False)
    torch.cuda.synchronize()
    layer_s = time.perf_counter() - t0
    if not np.array_equal(scored[de].values, layer[de].values):
        fail("iris serve: species names differ from the layer path's")
    same_predictions(scored[pred], layer[pred],
                     "iris serve: engine against the layer path")
    again = loaded.score(store, device=dev, engine=True)
    if not np.array_equal(again[de].values, scored[de].values):
        fail("iris serve: a replay's species names differ")
    print(f"iris serve: save {save_s:.2f} s, load {load_s:.2f} s, Score "
          f"(fresh load, engine, de-indexer in the program) {score_s:.2f} s "
          f"= {N / score_s:,.0f} rows/s against the layer path's "
          f"{layer_s:.2f} s; species names and predictions equal to the "
          f"layer path's (and a replay's); program {kinds}, buckets "
          f"{eng.buckets_used()}, graphs {eng.graphs_captured}, "
          f"predict_trees launches {launches['predict_trees']}")

    model, cpred, reader = coded_iris_model(iris["data_path"], dev)
    cstore = reader.generate_store(cpred.raw_features())
    model.save(os.path.join(root, "build", "serve", "iris-coded"),
               overwrite=True)
    coded = WorkflowModel.load(os.path.join(root, "build", "serve",
                                            "iris-coded"))
    H.reset_launch_counts()
    got = coded.score(cstore, device=dev, engine=True)[cpred.name]
    got = coded.score(cstore, device=dev, engine=True)[cpred.name]
    torch.cuda.synchronize()
    coded_launches = dict(H.KERNEL_LAUNCHES)
    if coded_launches["predict_trees"] != 2 * chunks:
        fail(f"coded iris: predict_trees launched "
             f"{coded_launches['predict_trees']} times for 2 × {chunks} "
             "chunks")
    want = model.score(cstore, device=dev, engine=False)[cpred.name]
    same_predictions(got, want, "coded iris: engine against the layer path")
    if not set(np.unique(got.prediction)) <= set(IRIS_CODES.values()):
        fail("coded iris: predictions are not the original codes")
    print(f"iris label mapping on the card: the coded-species model "
          f"(mapping {sorted(IRIS_CODES.values())}) scores {N} rows through "
          f"the engine's graphs (two passes, "
          f"{coded_launches['predict_trees']} predict_trees launches) as "
          f"the layer path does; predictions are the codes")
    return launches, coded_launches


def timings(H, dev, BP, run):
    """``--timings-only``: split_scan's times at its shapes, then each main
    path run once and profiled once; nothing is checked and no result
    line is printed. It calls only what every version of the port has, so
    a copy of this script placed in another checkout times that
    checkout's kernels: two versions compare in one call, in turns."""
    time_scans(H, dev)
    rng = np.random.default_rng(4)

    def put(a):
        return torch.as_tensor(a, device=dev)

    XbT = put(rng.integers(0, B, size=(F, N), dtype=np.int32))
    for A in (1, 128):
        slot = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        g = put(rng.integers(0, 1 << 8, size=N, dtype=np.int32))
        tabs = route_tables(rng, put, A, min(2 * A, 128))
        ms = time_ms(lambda: H.route_level(XbT, slot, g, *tabs, A,
                                           min(2 * A, 128)))
        print(f"route_level A={A}: {ms:.4f} ms")
    for Fp, T, D, K in PREDICT_SHAPES[:2]:
        X, feat, thr, leaf = predict_inputs(rng, put, Fp, T, D, K)
        ms = time_ms(lambda: H.predict_trees(X, feat, thr, leaf, D))
        print(f"predict_trees F={Fp} T={T} D={D}: {ms:.4f} ms, bound "
              f"{1e3 * max(predict_bound(Fp, T, D, K)):.5f} ms")
    del XbT, X
    records = BP.synthesize_records(N, seed=42)
    for what, fn in (("sweep", lambda: run(N, device="cuda")),
                     ("BigPassenger", lambda: BP.run(N, device="cuda",
                                                     records=records))):
        t0 = time.perf_counter()
        out = fn()
        print(f"{what}: train {out['train_s']:.2f} s (run "
              f"{time.perf_counter() - t0:.2f} s)")
        profile_path(H, what, fn)
    return 0


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from transmogrifai_tpu_torch import big_passenger as BP
    from transmogrifai_tpu_torch import boston as BO
    from transmogrifai_tpu_torch import iris as IR
    from transmogrifai_tpu_torch import titanic as TT
    from transmogrifai_tpu_torch.models import _hist as H
    from transmogrifai_tpu_torch.models import _treefit as TF
    from transmogrifai_tpu_torch.ops.hashing import load_native
    from transmogrifai_tpu_torch.synthetic_trees import (default_families,
                                                         forest_families,
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

    rows = check_kernels(H, TF, dev)
    path_launches = {}

    # -- phase 3: the synthetic tree sweep, every launch counted ----------
    tree_kernels = ("cumhist", "group_rows", "split_scan", "level_epilogue",
                    "predict_trees")
    out, launches = counted(H, lambda: run(N, device="cuda"), tree_kernels)
    once_per_level(launches, "synthetic sweep")
    aupr = check_scored(out, N, "synthetic sweep")
    s = out["summary"]
    print(f"sweep {N} rows: train {out['train_s']:.2f} s, evaluate "
          f"{out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, AuPR {aupr:.6f}")
    print(f"synthetic-sweep launches: {launches}")
    path_launches["sweep-200k"] = launches
    layer_evaluate(out, "sweep-200k")
    if profile:
        profile_path(H, "sweep", lambda: run(N, device="cuda"))
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
    path_launches["text-200k"] = launches
    text_aupr = aupr
    layer_evaluate(out, "text-200k")
    if profile:
        profile_path(H, "BigPassenger", lambda: BP.run(N, device="cuda",
                                                       records=records))
    small = BP.synthesize_records(2_000, seed=42)
    agree({d: BP.run(2_000, num_folds=2, device=d, records=small,
                     families=default_families((3,), (3,), rounds=5))
           for d in ("cuda", "cpu")}, "BigPassenger, 2000 rows")

    # -- phase 5: rf-200k, the random forest and decision tree sweep -----
    out, launches = counted(H, lambda: run(N, device="cuda",
                                           families=forest_families()),
                            tree_kernels)
    once_per_level(launches, "rf-200k")
    aupr = check_scored(out, N, "rf-200k")
    s = out["summary"]
    print(f"rf-200k {N} rows: train {out['train_s']:.2f} s, evaluate "
          f"{out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, AuPR {aupr:.6f}, CV seconds by family "
          f"{s.validator_summary.family_seconds}")
    print(f"rf-200k launches: {launches}")
    path_launches["rf-200k"] = launches
    layer_evaluate(out, "rf-200k")
    if profile:
        profile_path(H, "rf-200k", lambda: run(N, device="cuda",
                                               families=forest_families()))
    agree({d: run(20_000, device=d,
                  families=forest_families((3, 6), num_trees=5))
           for d in ("cuda", "cpu")}, "rf-200k, 20000 rows (RF 5 trees, DT)")

    # -- phase 6: titanic with the default families ------------------------
    out, launches = counted(H, lambda: TT.run(device="cuda"),
                            tree_kernels + ("cumhist_sparse01",))
    once_per_level(launches, "titanic")
    aupr = check_scored(out, out["n_rows"], "titanic")
    s = out["summary"]
    print(f"titanic {out['n_rows']} rows: train {out['train_s']:.2f} s, "
          f"evaluate {out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, train AuPR "
          f"{s.train_evaluation['AuPR']:.6f}, holdout AuPR "
          f"{s.holdout_evaluation['AuPR']:.6f}, full-file AuPR {aupr:.6f}")
    print(f"titanic CV seconds by family: "
          f"{s.validator_summary.family_seconds}")
    print(f"titanic launches: {launches}")
    path_launches["titanic"] = launches
    if profile:
        profile_path(H, "titanic", lambda: TT.run(device="cuda"))
    agree({d: TT.run(device=d, families=titanic_one_point())
           for d in ("cuda", "cpu")},
          "titanic, one grid point a family")

    # -- phase 7: save, load and serve (the runner, the scoring engine) --
    path_launches["serve-200k"] = serve(H, BP, records, text_aupr,
                                        profile=profile)

    # -- phase 8: multiclass and regression (iris, boston) ---------------
    wide = check_multiclass_kernels(H, dev)
    root = os.path.dirname(os.path.abspath(__file__))
    data_dir = os.path.join(root, "build", "data")
    launches_by, iris = multiclass_paths(H, IR, BO, data_dir, profile)
    path_launches.update(launches_by)
    (path_launches["serve-iris"],
     path_launches["serve-iris-coded"]) = serve_iris(H, iris, root)

    kernels = []
    names = ("cumhist", "cumhist_bc", "cumhist_sparse01", "group_rows",
             "split_scan", "route_level", "level_epilogue", "predict_trees")
    for name in names:
        r = rows[name]
        t_bytes, t_ops = r["bound"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": r.get("source",
                            f"transmogrifai_tpu_torch/csrc/{name}.cu"),
            "replaces": r["replaces"],
            "launches": sum(c[name] for c in path_launches.values()),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"]})
    if not all(math.isfinite(k[key]) for k in kernels
               for key in ("ms", "plain_ms", "bound_ms")):
        fail("a kernel time is not finite")
    print("kernels: " + ", ".join(names) + "; launches summed over the "
          "main paths " + ", ".join(path_launches))
    gini = rows["level_epilogue"]["gini"]
    print(f"level_epilogue gini (A=128, C=3): {gini['ms']:.4f} ms, plain "
          f"{gini['plain_ms']:.4f} ms, bound {gini['bound_ms']:.5f} ms")
    for what, (ms, plain_ms, bound) in wide.items():
        print(f"{what} (phase 8): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {1e3 * bound:.5f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
