#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``transmogrifai_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py             # add --profile for device-time tables

1. Prints the card's name and power limit and builds the five tree-engine
   kernels from ``transmogrifai_tpu_torch/csrc`` (one ``nvcc`` each, in
   parallel) and the native text hasher (``native/fasthash.cc``, ``g++``).
2. Holds each kernel against its plain PyTorch version on the card at the
   main paths' shapes (n=200,000 rows; F=20 features, B=32 bins; the 2-bin
   indicator block at Fb=512 columns): counts, selected indices, valid
   flags, routes and g bit-identical (``cumhist_sparse01``'s counts also
   equal ``cumhist``'s at B=2 on the same bins); weighted histogram
   channels and predict sums within 2e-5 of the channel's max |value|.
   Times each (median of 20 launches, CUDA events) beside its plain
   version and, for the histograms, one bf16 ``torch.matmul`` of the same
   operands.
3. The tree-model AutoML sweep — GBT maxDepth {3, 6, 9} and XGBoost
   maxDepth {3, 6}, 20 rounds, 5-fold CV on AuPR, refit, scoring — through
   ``Workflow.train`` and ``WorkflowModel.evaluate`` on 200,000 rows, with
   every kernel launch counted; then the same sweep at 20,000 rows (depths
   {3, 6}) on the card and on the CPU, which must pick the same model with
   AuPR within 1e-4.
4. The BigPassenger workflow (``big_passenger.py``): 200,000 typed records
   → transmogrify → SanityChecker → GBT + XGBoost maxDepth {3, 6}, 20
   rounds, 3-fold CV → refit → evaluate, with every kernel launch counted
   (all five must launch); then the same workflow at 2,000 rows (GBT {3} +
   XGBoost {3}, 5 rounds, 2 folds) on the card and on the CPU, which must
   pick the same model with AuPR within 1e-4.

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


def check_kernels(H, dev):
    """Phase 2: every kernel against its plain version; returns the per-
    kernel numbers of the result line."""
    rng = np.random.default_rng(0)

    def put(a):
        return torch.as_tensor(a, device=dev)

    XbT = put(rng.integers(0, B, size=(F, N), dtype=np.int32))
    bc = H.make_bc(XbT, B)
    rows = {}

    # -- cumhist (generic and bc=): every channel, A in {1, 64, 128} ------
    worst = 0.0
    for A in (1, 64, 128):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        for C in (3, 4):
            st = rng.normal(size=(N, C)).astype(np.float32)
            st[:, -1] = rng.random(N) > 0.1             # count channel
            stats = put(st)
            ref = H.cumhist_reference(stats, node, XbT, A, B)
            for use_bc in (False, True):
                out = H.cumhist(stats, node, XbT, A, B,
                                bc=bc if use_bc else None)
                torch.cuda.synchronize()
                if not torch.equal(out[:, -1], ref[:, -1]):
                    fail(f"cumhist counts differ (A={A} C={C} bc={use_bc})")
                for c in range(C - 1):
                    e = rel_err(out[:, c], ref[:, c])
                    worst = max(worst, (out[:, c] - ref[:, c]).abs().max()
                                .item())
                    if e > REL_TOL:
                        fail(f"cumhist channel {c} rel err {e:.3g} "
                             f"(A={A} C={C} bc={use_bc})")
            print(f"cumhist A={A:3d} C={C}: counts exact, weighted "
                  f"channels within {REL_TOL:g} (generic and bc=)")
    # the two operand variants across the main path's slot counts
    for A in (1, 16, 64):
        nd = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        st4 = put(rng.normal(size=(N, 4)).astype(np.float32))
        g_ms = time_ms(lambda: H.cumhist(st4, nd, XbT, A, B))
        b_ms = time_ms(lambda: H.cumhist(st4, nd, XbT, A, B, bc=bc))
        print(f"cumhist A={A:3d} C=4: generic {g_ms:.4f} ms, "
              f"bc= {b_ms:.4f} ms")
    # the main path's call: the sibling half of a 128-slot level, GBT
    # stats, bins read directly (the fits pass no bc)
    A, C = 64, 4
    node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
    st = rng.normal(size=(N, C)).astype(np.float32)
    st[:, -1] = 1.0
    stats = put(st)
    ms = time_ms(lambda: H.cumhist(stats, node, XbT, A, B))
    plain_ms = time_ms(lambda: H.cumhist_reference(stats, node, XbT, A, B))
    NS = torch.zeros((N, A, C), dtype=torch.bfloat16, device=dev)
    live = (node < A).nonzero().squeeze(1)
    NS[live, node[live].long()] = stats[live].to(torch.bfloat16)
    NS = NS.reshape(N, A * C)
    Bc = bc.t().to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(NS.t(), Bc))
    nbytes = N * C * 4 + N * 4 + F * N * 4 + A * C * B * F * 4
    # what these inputs need: each live row adds its C stats into the
    # B − bin cumulative columns of each feature, f32 adds (the one-hot
    # product's zeros are the kernel's choice, not the function's work)
    adds = C * float((B - XbT[:, live]).sum().item())
    rows["cumhist"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:160",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound=(nbytes / HBM_BPS, adds / F32_FLOPS))
    print(f"cumhist A={A} C={C}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms")

    # the bc= variant at the same call: its plain version and bound
    bc_ms = time_ms(lambda: H.cumhist(stats, node, XbT, A, B, bc=bc))
    bc_plain_ms = time_ms(lambda: H.cumhist_reference(stats, node, XbT, A,
                                                      B, bc=bc))
    bc_bytes = N * C * 4 + N * 4 + B * F * N + A * C * B * F * 4
    by_bytes = bc_bytes / HBM_BPS >= adds / F32_FLOPS
    print(f"cumhist(bc=) A={A} C={C}: kernel {bc_ms:.4f} ms, plain "
          f"{bc_plain_ms:.4f} ms, bound "
          f"{1e3 * max(bc_bytes / HBM_BPS, adds / F32_FLOPS):.5f} ms "
          f"({'bytes' if by_bytes else 'operations'})")

    # -- cumhist_sparse01: the 2-bin indicator block ----------------------
    X01 = put((rng.random((FB, N)) < DENSITY).astype(np.uint8))
    X01_bins = X01.to(torch.int32)
    worst = 0.0
    for A in (1, 64, 128):
        node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
        for C in (3, 4):
            st = rng.normal(size=(N, C)).astype(np.float32)
            st[:, -1] = rng.random(N) > 0.1             # count channel
            stats = put(st)
            out = H.cumhist_sparse01(stats, node, X01, A)
            ref = H.cumhist_sparse01_reference(stats, node, X01, A)
            dense = H.cumhist(stats, node, X01_bins, A, 2)
            torch.cuda.synchronize()
            if not (torch.equal(out[:, -1], ref[:, -1])
                    and torch.equal(out[:, -1], dense[:, -1])):
                fail(f"cumhist_sparse01 counts differ (A={A} C={C})")
            for c in range(C - 1):
                worst = max(worst, (out[:, c] - ref[:, c]).abs().max()
                            .item())
                e = rel_err(out[:, c], ref[:, c])
                if e > REL_TOL:
                    fail(f"cumhist_sparse01 channel {c} rel err {e:.3g} "
                         f"(A={A} C={C})")
        print(f"cumhist_sparse01 A={A:3d}: counts equal the plain version "
              f"and cumhist at B=2, weighted channels within {REL_TOL:g} "
              "(C = 3, 4)")
    A, C = 64, 4
    node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
    st = rng.normal(size=(N, C)).astype(np.float32)
    st[:, -1] = 1.0
    stats = put(st)
    ms = time_ms(lambda: H.cumhist_sparse01(stats, node, X01, A))
    plain_ms = time_ms(lambda: H.cumhist_sparse01_reference(stats, node,
                                                            X01, A))
    NS = torch.zeros((N, A, C), dtype=torch.bfloat16, device=dev)
    live = (node < A).nonzero().squeeze(1)
    NS[live, node[live].long()] = stats[live].to(torch.bfloat16)
    NS = NS.reshape(N, A * C)
    Xt = X01.t().to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.matmul(NS.t(), Xt))
    del NS, Xt
    nbytes = N * C * 4 + N * 4 + FB * N + A * C * 2 * FB * 4
    # each live row adds its C stats into its slot's total and into the
    # nonzero side of each of its ones; t=0 is one subtraction per output
    nnz_live = float(X01[:, live].sum(dtype=torch.int64).item())
    adds = C * (nnz_live + live.numel()) + A * C * FB
    rows["cumhist_sparse01"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:220",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
        bound=(nbytes / HBM_BPS, adds / F32_FLOPS))
    print(f"cumhist_sparse01 A={A} C={C} Fb={FB}: kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bf16 matmul {lib_ms:.4f} ms")

    # -- split_scan: three criteria, masks, A in {1, 64, 128} -------------
    worst = 0.0
    for kind, C in (("variance", 4), ("gini", 3), ("xgb", 3)):
        for A in (1, 64, 128):
            node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
            st = np.empty((N, C), np.float32)
            yv = (rng.random(N) > 0.7).astype(np.float32)
            if kind == "variance":
                wv = rng.random(N).astype(np.float32) + 0.5
                st[:, 0], st[:, 1], st[:, 2] = wv, wv * yv, wv * yv * yv
            elif kind == "gini":
                st[:, 0], st[:, 1] = 1.0 - yv, yv
            else:
                p = rng.random(N).astype(np.float32)
                st[:, 0], st[:, 1] = p - yv, p * (1.0 - p) + 1e-6
            st[:, -1] = 1.0
            cum = H.cumhist_reference(put(st), node, XbT, A, B)
            mask = (put((rng.random((A, F)) > 0.2).astype(np.float32))
                    if A == 64 else None)
            kw = dict(lam=1.0, min_child_weight=1.0, mask=mask)
            s, i, v = H.split_scan(cum, kind, 10.0, **kw)
            rs, ri, rv = H.split_scan_reference(cum, kind, 10.0, **kw)
            torch.cuda.synchronize()
            if not (torch.equal(i.long(), ri.long()) and torch.equal(v, rv)):
                fail(f"split_scan selection differs ({kind} A={A})")
            worst = max(worst, (s - rs).abs().max().item())
            if rel_err(s, rs) > REL_TOL:
                fail(f"split_scan scores differ ({kind} A={A})")
        print(f"split_scan {kind}: selections and valid flags exact "
              "(A = 1, 64, 128; masked at 64)")
    A, C = 128, 4
    cum = H.cumhist_reference(stats, put(rng.integers(0, A + 1, size=N,
                                                      dtype=np.int32)),
                              XbT, A, B)
    ms = time_ms(lambda: H.split_scan(cum, "variance", 10.0))
    plain_ms = time_ms(lambda: H.split_scan_reference(cum, "variance", 10.0))
    ncand = A * (B - 1) * F
    rows["split_scan"] = dict(
        replaces="transmogrifai_tpu/models/_pallas_hist.py:504",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, library_ms=None,
        bound=((A * C * B * F * 4 + A * 9) / HBM_BPS,
               12.0 * ncand / F32_FLOPS))
    print(f"split_scan variance A={A}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms")

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
    kernel and the device's busy share of the wall clock."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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

    rows = check_kernels(H, dev)

    # -- phase 3: the synthetic tree sweep, every launch counted ----------
    tree_kernels = ("cumhist", "split_scan", "route_level", "predict_trees")
    out, launches = counted(H, lambda: run(N, device="cuda"), tree_kernels)
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
                            tuple(H.KERNEL_LAUNCHES))
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
    names = ("cumhist", "cumhist_sparse01", "split_scan", "route_level",
             "predict_trees")
    for name in names:
        r = rows[name]
        t_bytes, t_ops = r["bound"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"transmogrifai_tpu_torch/csrc/{name}.cu",
            "replaces": r["replaces"], "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": r["library_ms"]})
    if not all(math.isfinite(k["ms"]) for k in kernels):
        fail("a kernel time is not finite")
    print("kernels: " + ", ".join(names))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
