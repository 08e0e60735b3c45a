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
   AuPR within 1e-4. After the 200k train, its seconds by stage and by
   layer (:func:`stage_table`: each stage's fit and layer-transform
   seconds, the fused statistics pass's tier, stages, requests, seconds
   and bytes scanned, the fused transform's seconds and copies, the top
   stages) and :func:`check_fusion` on its training split: each layer's
   statistics on the device tier against the host tier (counts exact,
   minima and maxima those of the f32-rounded values, the other moments
   within FUSED_RTOL), every opted-in stage fitted from the host tier's
   values equal to its sequential fit, each fill the card's f32 moments
   moved printed with both values, and the fused layer transform bitwise
   equal to the per-model path on the card with one upload and one pull
   (counted where they are issued, the profiler's memcpy records beside).
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
   F=8, T=50, D=12, K=3 — each timed beside its plain version, as are
   both histograms at gini C=8 (A=64). Then
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
9. every feature type (``transmogrify``'s whole dispatch): a
   200,000-row store, made in bulk from a seed, with one feature of each
   type this phase adds — MultiPickList, Geolocation, DateList, RealMap,
   IntegralMap, TextMap, MultiPickListMap, GeolocationMap, DateMap — a
   Real through ``bucketize`` and ``auto_bucketize`` and a raw vector
   through the standard scaler, fitted on the card and on the CPU: every
   fitted state equal, every stage's vector and metadata bitwise equal,
   each vectorizer's block computed on the card but where the stage
   builds it on the host (the pivots, the smart text map), the transform
   seconds printed for the stages on the card and the host stages apart
   (both trains on the host tier with per-model transforms: the row
   floor ``workflow.FUSE_MIN_ROWS`` raised past the store); the card's
   default train (device tier, fused transform) held against it, every
   fitted state within FUSED_RTOL and the vector within FUSED_RTOL, and
   :func:`check_fusion` on it. Then mapprep-200k (``mapprep.py``: 200,000 records
   from seed 7, generated once and reused below; logistic regression,
   3-fold CV on AuPR), counted; its records, vectorize, selector, train
   and evaluate seconds, width, best model and AuPR, and no column of the
   blocked key; its :func:`stage_table` and :func:`check_fusion`. The binary selector's default families, one grid point
   each, on the first 20,000 records, on the card (counted: the tree
   kernels, ``cumhist_sparse01`` included, must launch) and on the CPU:
   the same model, every family's fold metrics within 1e-4. Then every
   kernel of that run at the shapes its vector gives it, against its plain
   version on one fold's training rows: the 32-bin and 2-bin blocks (their
   widths read off the vector), ``group_rows``, the histograms, the split
   scans and the level epilogue under gini and variance, ``predict_trees``
   at the GBT's and the forest's ensembles. Last, the
   mapprep-200k model saved, loaded afresh and scored through the engine:
   predictions equal to the layer path's, probabilities within 2^-22;
   Score seconds and rows/s.
10. the guard rails (mapprep-guarded-200k): phase 9's 200,000 records
   through mapprep's workflow with the default families at one grid point
   each, behind the RawFeatureFilter (scoring data: 50,000 records from
   seed 8 whose attrs lost their "region" key) and under workflow-level
   CV (3 folds: the label-aware stages refit in each fold, each fold's
   matrix binned and swept on the card), counted; then ModelInsights over
   the training records, LOCO (top 20) of the selected model and the corr
   insights over 20,000 scoring records, and LOCO of a GBT fitted on the
   training vector (``predict_trees`` at 113 · 20,000 rows). Fails unless
   ``(attrs, region)`` is excluded, no region column reaches the vector,
   the summary is a ``WorkflowCV:`` one, every tree family's every fold
   launched each tree kernel, and ``predict_trees`` launched in LOCO.
   Prints the exclusions, the width, the *during* stages, each family's
   fold metrics, the winner, the train seconds by phase (filter,
   vectorize, sweep, refit), the insights, LOCO and corr seconds and the
   top five contributions, its :func:`stage_table` and
   :func:`check_fusion` (on the filtered records). Then the same at
   20,000 records (5,000 scoring
   records) on the card and the CPU: the filter's results JSON equal, the
   blacklist, the width, the winner and every family's fold metrics
   within 1e-4, the contributions within 1e-5 of the largest, the card
   model's LOCO (selected and GBT) on the card and the CPU within 1e-6
   with the top-K names equal but at ties, the corr importances within
   1e-5; every kernel held at one workflow-CV fold's matrix
   (``check_mapprep_kernels``); ``predict_trees`` at the LOCO batch
   against its plain version, timed with its bound; and the guarded
   model with its LOCO stage saved, loaded (the filter's results and the
   blacklist equal, LOCO re-attached) and scored through the engine as
   the layer path scores it.
11. the event-time readers (eventlog-200k): ``bench.py``'s event log (16
   Avro files of 10,000 rows over 5,000 users, seed 47) written by the
   port's ``write_avro_records``, joined to its users table and
   aggregated twice — ``read_avro_records`` into the row-wise join and
   fold under ``aggregateColumnar`` false, ``read_avro_table`` into the
   columnar path — every column's values and mask bitwise equal, events/s
   for each tier. Then ``dataprep.make_event_log`` (200,000 users, 20
   events each, seed 47) through ``dataprep.build_workflow``: the
   ``JoinedAggregateDataReader`` (the columnar join and aggregation,
   timed) → transmogrify → SanityChecker → the default families at one
   grid point each, 3-fold CV, trained on the card, counted (the
   temporal tallies must show a columnar aggregate and no row-wise one;
   every tree family's every fold must launch ``group_rows``, ``cumhist``,
   ``split_scan`` and ``level_epilogue``; ``predict_trees`` must launch);
   prints the width, each family's fold metrics, the winner and its AuPR,
   the train seconds by phase (aggregate, vectorize, sweep, refit) and
   :func:`stage_table`. The model saved, loaded afresh and the aggregated
   store scored through the engine: predictions equal to the layer
   path's, probabilities within 2^-22. The same at 20,000 users on the
   card and the CPU: the aggregated stores bitwise equal, the same
   winner, every family's fold metrics within 1e-4. Last, the dataprep
   walkthrough's rows (``dataprep.run()``) against those
   ``examples/dataprep.py`` prints, written here as data.
12. serving artifacts at serve-200k: phase 7's saved model (text-200k's
   GBT maxDepth 6 over the 451-wide vector) through
   ``serving.export_scoring_fn`` on the card with its program bank
   (``build/serve/export``, the whole ladder 8 … 8,192); a cold process
   (a fresh interpreter importing torch, numpy and the port) loads the
   model, preloads the bank into a fresh engine and scores one record,
   then the 200,000: no program built, 25 ``predict_trees`` launches,
   the columns bitwise equal to phase 7's Score. ``load_scoring_fn``
   through the bank at 8,192 and 3,392 rows and through the
   batch-polymorphic ``scoring_fn.pt2`` at n ∈ {1, 7, 3,392, 8,192},
   each bitwise equal to the engine's eager program, and the 200,000
   rows' prepared blocks through the bank, equal to Score.
   ``export_prediction_fn`` at F=451, loaded, bitwise equal to
   ``predict_device`` on 8,192 rows of the vector. One byte of
   ``bucket_8192.pt2`` changed: a TMG502 finding, and the bucket built by
   the engine and served by the polymorphic program, bitwise on the
   card. Then ``tmog_torch::predict_trees`` bitwise against its plain
   version at n=8,192, F=451, T=20, D=6, timed beside the direct launch
   (device time, and host time a call at n=8). Counted: the export, the
   cold process, the loaders and the head.
13. the remaining estimators and the rich DSL: boston-glm-200k (linear
   regression and GLM at their default grids on boston-200k's data, 3-fold
   CV on RMSE; CV seconds by family), iris-mlp-200k (LR and the MLP at
   their default grids on iris-200k's data, the prediction de-indexed by
   the DSL; the MLP winner, forced when LR wins, saved, loaded and its
   200,000 rows scored through the engine against the layer path, rows/s
   and graphs captured), each at 2,000 rows on the card and the CPU (the
   same winner; every family's fold RMSE within 1e-4 relative, F1 within
   ``MLP_AGREE``); every-surface-200k (``every_surface.py``: 200,000
   records, seed 13, through every new DSL surface → SanityChecker → LR
   and GBT at one grid point, the MLP at its default grid, 3-fold CV;
   counted: GBT's fits must launch the tree kernels; ``random.categorical``'s
   fast Gumbel noise held within its margin of XLA's on the card; seconds
   by stage and family, LDA's and Word2Vec's fits, Word2Vec's pairs,
   chunk and peak memory, the width, winner, AuPR and Brier score; the
   model with the prediction alone saved, loaded and scored through the
   engine, its plan holding the count vectorizer as "vec" and the
   predictor as "predict" and every other new stage on the host, records/s;
   on 20,000 records a replay, the layer path and the model with its
   tupled columns give the same predictions; GBT refit on them so
   ``predict_trees`` launches; then 2,000 records on the card and the CPU:
   host stages and the count block bitwise, LDA and Word2Vec within
   ``TOPIC_ATOL``, the same winner) and taggers-20k (entities, languages,
   sentences and POS tags of 20,000 notes → LR; seconds by stage). Each
   path's seconds.
14. the pre-flight, the planner and the run summary: (a) plan-200k,
   phase 4's records through ``OpWorkflowRunner`` with the default
   ``customParams`` (the pre-flight and the plan on) and a cost database
   in ``build/plan``: Train twice (the second with the first's database;
   the pre-flight's findings, no error; the plans' counts and tiers and
   the fit plan's sources, measured on the second; the database written;
   both models equal and Evaluate's AuPR equal to phase 4's), then the
   second model loaded and its records scored through the engine under
   the model's plan and without one: predictions bitwise equal, every
   bucket a CUDA graph launching ``predict_trees``; the pruned columns,
   the CSE merges, rows/s both ways, ``plan_model`` and ``check_model``
   seconds. (b) phase 6's titanic model (F = 498) planned and its 891
   rows scored the same way, bitwise; its pruned columns (the
   SanityChecker's drops). (c) ``lint.check_model(device=True)`` over
   every model the run trained on the card: the findings by rule, no
   error and no TMG201, no kernel launched. (d) the host-to-device rate
   from pageable and pinned memory and the device-to-device copy rate,
   beside the card's name and power limit.

``--profile`` runs each main path (the four, serve's Score, iris-200k,
boston-200k, mapprep-200k, mapprep-guarded-200k and eventlog-200k) once
more under ``torch.profiler`` and
prints its device-time table: the busy share, the device operations a tree level, the histogram
kernels, the split scans, the route or level epilogue, the predict and the
uint8 → bool copies.
``--stage-seconds`` trains text-200k, mapprep-200k,
mapprep-guarded-200k and eventlog-200k twice each and prints :func:`stage_table` after each
train, nothing else; like ``--timings-only`` it calls only what every
version of the port has, so a copy of this script times another
checkout's stages.
``--timings-only`` skips every check and prints only the times of
``split_scan``, the route alone and ``predict_trees``, the sweep's and
BigPassenger's train seconds and both paths' profiles, and serve-200k's
Score seconds twice (BigPassenger's model saved, loaded afresh and
scored through the engine), with no result line; it uses only what every version of
the port has, so a copy of this script in another checkout times that
checkout.

Any failure exits non-zero before the result line. With no CUDA device it
exits 2 and prints no result. The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it lists each kernel's numbers as JSON (launches summed
over the main paths' runs, phases 3–14).
``--serve-export-only`` runs phase 7 (without its comparison with phase
4's AuPR) and phase 12 alone, and prints no result line.
``--every-surface-only`` runs phase 13 alone and prints no result line.
``--plan-only`` trains titanic and runs phase 14 alone (its pre-flight
over the models it trains) and prints no result line.
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
    blocks = [(XbT, torch.arange(F, device=dev), False)]
    Xfull = XbT
    if nblk == 2:
        blocks.append((X01, torch.arange(F, F + FB, device=dev), True))
        Xfull = torch.cat([XbT, X01.to(torch.int32)])
    edges = torch.sort(torch.randn((Xfull.shape[0], B - 1), device=dev),
                       dim=1).values
    return level_inputs(H, dev, rng, put, kind, st, slot, A, d, blocks,
                        Xfull, edges)


def level_inputs(H, dev, rng, put, kind, st, slot, A, d, blocks, Xfull,
                 edges):
    """One level's epilogue inputs over ``blocks`` ((bins, global column
    indices, 2-bin?) each, in the fit's candidate order) of the full bins
    ``Xfull``: each block's histogram of ``st`` over ``slot`` and its
    split scan from the kernels, random live slots and positions. Slot 1
    copies slot 0's histograms and scores (a gain tie), and at slot 2 the
    second block ties the first's score (the lower concatenated index
    wins)."""
    nblk = len(blocks)
    cums = [H.cumhist_sparse01(st, slot, mat, A) if s01
            else H.cumhist(st, slot, mat, A, B) for mat, _c, s01 in blocks]
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
    alive = put(rng.random(A) > 0.2)
    alive[:2] = True
    gpos = put(rng.permutation(1 << d)[:A].astype(np.int32))
    g = put(rng.integers(0, 1 << d, size=slot.shape[0], dtype=np.int32))
    return (score, idx, valid, cums, [c for _m, c, _s in blocks],
            [s01 for *_, s01 in blocks], edges, alive, gpos, Xfull, slot, g)


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


def epilogue_cases(H, dev, make, kinds, slots=(1, 64, 128),
                   nblks=(1, 2), tree_depth=9):
    """The level epilogue against its plain version at each of ``slots``
    under each (kind, C) of ``kinds``, with each of ``nblks`` blocks, in
    every case of :func:`check_epilogue`, under trees of ``tree_depth``;
    ``make(kind, A, nblk, d, D, C)`` gives a level's inputs. Returns the
    slots whose winner was in the 2-bin block."""
    block1_wins = 0
    for A in slots:
        d, D = (A - 1).bit_length(), tree_depth
        for kind, Ck in kinds:
            for nblk in nblks:
                args = make(kind, A, nblk, d, D, Ck)
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


def sweep_levels(H, dev, rng, put, XbT, X01):
    """:func:`epilogue_cases`' ``make`` over the sweep's block (and a
    2-bin block of FB columns after it)."""
    return lambda kind, A, nblk, d, D, C: epilogue_inputs(
        H, dev, rng, put, XbT, X01, kind, A, nblk, d, D, C=C)


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
    block1_wins = epilogue_cases(
        H, dev, sweep_levels(H, dev, rng, put, XbT, X01), EPILOGUE_KINDS)
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
    launch counted; then the checks. Returns the path's launches and
    Score's prediction column. ``dev`` "cpu" rehearses the phase on the
    host (no graphs, no kernels); ``text_aupr`` None skips the check of
    Evaluate against phase 4 (``--serve-export-only``)."""
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
    if text_aupr is not None and aupr != text_aupr:
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
    return launches, got


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
    # both histograms timed at gini C=8 as phase 2's rows are (A=64, the
    # level loop's call), their bounds by phase 2's counts
    A, C = 64, 8
    node = put(rng.integers(0, A + 1, size=N, dtype=np.int32))
    groups = H.group_rows(node, A)
    st = put(gini_stats(rng, C, N))
    live = (node < A).nonzero().squeeze(1)
    ms = time_ms(lambda: H.cumhist(st, node, XbT, A, B, groups=groups,
                                   rows=hrows))
    plain_ms = time_ms(lambda: H.cumhist_reference(st, node, XbT, A, B))
    hbound = ((N * 4 + live.numel() * (C * 4 + F) + A * C * B * F * 4)
              / HBM_BPS,
              C * float((B - XbT[:, live]).sum().item()) / F32_FLOPS)
    times["cumhist gini C=8"] = (ms, plain_ms, max(hbound))
    srows = H.sparse01_rows(X01)
    s_ms = time_ms(lambda: H.cumhist_sparse01(st, node, X01, A,
                                              groups=groups, rows=srows))
    s_plain_ms = time_ms(lambda: H.cumhist_sparse01_reference(st, node,
                                                              X01, A))
    nnz_live = float(X01[:, live].sum(dtype=torch.int64).item())
    sbound = ((N * 4 + live.numel() * (C * 4 + FB) + A * C * 2 * FB * 4)
              / HBM_BPS,
              (C * (nnz_live + live.numel()) + A * C * FB) / F32_FLOPS)
    times["cumhist_sparse01 gini C=8"] = (s_ms, s_plain_ms, max(sbound))
    print(f"cumhist gini A={A} C={C}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {1e3 * max(hbound):.5f} ms; "
          f"cumhist_sparse01 gini A={A} C={C} Fb={FB} (density 0.3): kernel "
          f"{s_ms:.4f} ms, plain {s_plain_ms:.4f} ms, bound "
          f"{1e3 * max(sbound):.5f} ms")
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
    wins = epilogue_cases(H, dev, sweep_levels(H, dev, rng, put, XbT, X01),
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


# -- phase 9: transmogrify for every feature type; mapprep-200k ----------
#: the features of phase 9's every-type store: (name, type, bulk maker)
MAPPREP_SEED = 7
MAPPREP_AGREE_N = 20_000
TYPE_KEYS = ("k0", "k1", "k2")
CATS = np.array(["red", "green", "blue", "teal", "plum", "gold"],
                dtype=object)
EPOCH_2020_MS = 1_577_836_800_000


def every_type_store(n, seed=11):
    """A store of ``n`` rows with one feature of each type phase 9 adds to
    ``transmogrify``, made in bulk with numpy (no per-row Python for the
    numeric kinds): MultiPickList, Geolocation, DateList, RealMap,
    IntegralMap, TextMap, MultiPickListMap, GeolocationMap and DateMap;
    a Real ``r`` and its RealNN label ``y`` (for ``bucketize`` and
    ``auto_bucketize``) and a raw OPVector ``v`` (for the standard
    scaler)."""
    from transmogrifai_tpu_torch.columns import (ColumnStore, GeoColumn,
                                                 MapColumn, NumericColumn,
                                                 RaggedColumn, TextColumn,
                                                 TextSetColumn, VectorColumn)
    from transmogrifai_tpu_torch.types import feature_types as ft
    from transmogrifai_tpu_torch.vector_metadata import (
        VectorColumnMetadata, VectorMetadata)
    rng = np.random.default_rng(seed)

    def present(p=0.8):
        return rng.random(n) < p

    def reals():
        return NumericColumn(ft.Real, np.round(rng.normal(size=n) * 10, 3),
                             present())

    def ints(date=False):
        if date:
            v = EPOCH_2020_MS + rng.integers(0, 400 * 86_400_000, n)
            return NumericColumn(ft.Date, v.astype(np.int64), present())
        return NumericColumn(ft.Integral, rng.integers(0, 6, n), present())

    def texts():
        v = CATS[rng.integers(0, len(CATS), n)].copy()
        v[~present()] = None
        return TextColumn(ft.Text, v)

    def sets():
        a = CATS[rng.integers(0, len(CATS), n)]
        b = CATS[rng.integers(0, len(CATS), n)]
        k = rng.integers(0, 3, n)
        return [set() if c == 0 else {x} if c == 1 else {x, y}
                for x, y, c in zip(a.tolist(), b.tolist(), k.tolist())]

    def geos():
        v = np.stack([np.round(rng.uniform(-60, 60, n), 4),
                      np.round(rng.uniform(-170, 170, n), 4),
                      rng.integers(1, 10, n).astype(np.float64)], axis=1)
        m = present()
        v[~m] = 0.0
        return GeoColumn(ft.Geolocation, v, m)

    def a_map(ftype, child):
        return MapColumn(ftype, {k: child() for k in TYPE_KEYS}, n)

    lengths = rng.integers(0, 4, n)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
    flat = (EPOCH_2020_MS
            + rng.integers(0, 400 * 86_400_000, int(offsets[-1])))
    x = rng.normal(size=n) * 10
    cols = {
        "mpl": TextSetColumn(ft.MultiPickList, sets()),
        "geo": geos(),
        "dates": RaggedColumn(ft.DateList, flat.astype(np.int64), offsets),
        "realMap": a_map(ft.RealMap, reals),
        "intMap": a_map(ft.IntegralMap, ints),
        "textMap": a_map(ft.TextMap, texts),
        "mplMap": a_map(ft.MultiPickListMap, lambda: TextSetColumn(
            ft.MultiPickList, sets())),
        "geoMap": a_map(ft.GeolocationMap, geos),
        "dateMap": a_map(ft.DateMap, lambda: ints(date=True)),
        "r": NumericColumn(ft.Real, np.round(x, 3), present(0.9)),
        "y": NumericColumn(ft.RealNN, ((x > 2) ^ (rng.random(n) < 0.1))
                           .astype(np.float64), np.ones(n, bool)),
        "v": VectorColumn(ft.OPVector, rng.normal(
            size=(n, 4)).astype(np.float32), VectorMetadata("v", [
                VectorColumnMetadata(parent_feature_name="v",
                                     parent_feature_type="OPVector",
                                     descriptor_value=f"v{i}")
                for i in range(4)])),
    }
    types = {"mpl": "MultiPickList", "geo": "Geolocation",
             "dates": "DateList", "realMap": "RealMap",
             "intMap": "IntegralMap", "textMap": "TextMap",
             "mplMap": "MultiPickListMap", "geoMap": "GeolocationMap",
             "dateMap": "DateMap"}
    return ColumnStore(cols, n), types


def every_type_vector(types):
    """The phase's feature: each new type through ``transmogrify``, the
    Real bucketized at fixed splits and by a decision tree against the
    label, and the raw vector through the standard scaler."""
    from transmogrifai_tpu_torch import FeatureBuilder
    from transmogrifai_tpu_torch.dsl import transmogrify
    from transmogrifai_tpu_torch.ops.vectors import StandardScalerEstimator
    feats = [getattr(FeatureBuilder, t)(name).from_column().as_predictor()
             for name, t in types.items()]
    r = FeatureBuilder.Real("r").from_column().as_predictor()
    y = FeatureBuilder.RealNN("y").from_column().as_response()
    v = FeatureBuilder.OPVector("v").from_column().as_predictor()
    return transmogrify(feats + [
        r.bucketize(splits=[-15.0, -5.0, 0.0, 5.0, 15.0],
                    track_invalid=True),
        r.auto_bucketize(y),
        v.transform_with(StandardScalerEstimator())])


def same_column(a, b, what):
    """Two vector columns bitwise equal, metadata included."""
    if a.values.dtype != b.values.dtype or not np.array_equal(a.values,
                                                              b.values):
        fail(f"{what}: the card's vector differs from the CPU's")
    if [c.to_json() for c in a.metadata.columns] != \
            [c.to_json() for c in b.metadata.columns]:
        fail(f"{what}: the card's vector metadata differs from the CPU's")


def check_every_type(n=N, dev="cuda"):
    """Phase 9, part 1: the new vectorizers fitted and applied on the card
    and on the CPU over one ``n``-row store: every fitted state, every
    stage's vector and the combined vector equal bit for bit. Prints each
    stage's transform seconds in the card's run, the stages on the card
    apart from the host stages."""
    from transmogrifai_tpu_torch import Workflow
    from transmogrifai_tpu_torch.model_io import _encode_param
    from transmogrifai_tpu_torch.stages.base import FittedModel
    from transmogrifai_tpu_torch.ops.vectorizer_base import (
        VectorizerModel, canonicalize_prepared)
    t0 = time.perf_counter()
    store, types = every_type_store(n)
    make_s = time.perf_counter() - t0
    vec = every_type_vector(types)
    on = {"card": dev, "cpu": "cpu"}
    # like tiers: the card's statistics on the host tier and its layers
    # per model, as the CPU's (the row floor raised past the store)
    from transmogrifai_tpu_torch import workflow as W
    floor, W.FUSE_MIN_ROWS = W.FUSE_MIN_ROWS, n + 1
    try:
        models = {k: Workflow().set_input_store(store).set_result_features(
            vec).train(device=d) for k, d in on.items()}
    finally:
        W.FUSE_MIN_ROWS = floor
    fused = Workflow().set_input_store(store).set_result_features(
        vec).train(device=dev)
    seconds, stores = {"card": {}, "host": {}}, {k: store for k in on}
    for mc, mp in zip(*(sum(models[k]._resolved_dag(), []) for k in on)):
        arrays = ({}, {})
        states = [json.dumps(_encode_param(
            m.get_model_state() if isinstance(m, FittedModel) else {}, a,
            "s"), sort_keys=True) for m, a in zip((mc, mp), arrays)]
        if states[0] != states[1] or any(
                not np.array_equal(arrays[0][k], arrays[1][k])
                for k in arrays[0]):
            fail(f"{mc.stage_name()}: fitted state differs, card vs CPU")
        for k, m in (("card", mc), ("cpu", mp)):
            kw = {"device": on[k]} if getattr(m, "uses_device",
                                              False) else {}
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            stores[k] = m.transform(stores[k], **kw)
            torch.cuda.synchronize()
            if k == "card":
                # a host stage's output is built on the host whatever the
                # device: a row transformer, or a block that is its host
                # preparation as it stands (``device_math`` False: the
                # pivots, and the smart text map's delegate)
                where = ("card" if getattr(m, "uses_device", False)
                         and getattr(m, "device_math", True) else "host")
                seconds[where][f"{type(m).__name__}[{m.uid[-4:]}]"
                               f"({m.input_features[0].name})"] = \
                    time.perf_counter() - t1
        a, b = stores["card"][mc.output_name], stores["cpu"][mc.output_name]
        if getattr(a, "metadata", None) is not None:
            same_column(a, b, mc.stage_name())
        if isinstance(mc, VectorizerModel) and mc.device_math:
            # the block comes off the card: device_compute ran there
            prepared = canonicalize_prepared(mc.host_prepare(stores["card"]))
            out = mc.device_compute({
                k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                for k, v in prepared.items()})
            if out.device.type != torch.device(dev).type:
                fail(f"{mc.stage_name()}: device_compute left the card")
    final = stores["card"][vec.name]
    same_column(final, stores["cpu"][vec.name], "every-type vector")
    if not np.isfinite(final.values).all():
        fail("every-type vector: values not finite")
    print(f"every-type store {n} rows ({len(types)} new types, a Real "
          f"bucketized twice, a vector scaled; made in {make_s:.2f} s): "
          f"width {final.values.shape[1]}, card == cpu bitwise, fitted "
          "state equal (both on the host tier, per-model transforms)")
    # across tiers: the card's default train (the device tier's f32
    # moments, the fused transform) against the like-tier card's
    worst = 0.0
    for uid, m in models["card"].fitted_stages.items():
        d = numbers_close(json.loads(model_state(m)[0]),
                          json.loads(model_state(fused.fitted_stages[uid])[0]),
                          FUSED_RTOL)
        if d > FUSED_RTOL:
            fail(f"every-type: {m.stage_name()} moved by {d:.3g} across "
                 "tiers")
        worst = max(worst, d)
    got = fused.transform(store, device=dev, engine=False)[vec.name].values
    diff = np.abs(got.astype(np.float64) - final.values)
    if not np.allclose(got, final.values, rtol=FUSED_RTOL, atol=0.0):
        fail("every-type: the fused train's vector moved past FUSED_RTOL")
    print(f"every-type across tiers (device-tier moments, fused transform "
          f"vs host tier, per model): fitted states within {worst:.3g} "
          f"relative, vector elements differing {int((diff > 0).sum())}, "
          f"largest {diff.max():.3g}")
    check_fusion(fused, store, "every-type-200k", dev)
    for where, what in (("card", "stages on the card"),
                        ("host", "host stages (their blocks built on the "
                                 "host)")):
        print(f"every-type transform seconds, {what}: "
              + ", ".join(f"{k} {v:.3f}" for k, v in seconds[where].items()))


#: the default families' trees on the mapprep vector, (T, D, K): the GBT
#: (20 rounds of depth 3, a margin) and the forest (5 trees of depth 6,
#: two class shares); the slot counts their levels reach; the criteria
#: and channel counts (the forest's gini, the GBT's variance)
MAPPREP_TREES = ((20, 3, 1), (5, 6, 2))
MAPPREP_SLOTS = (1, 4, 32)
MAPPREP_KINDS = (("gini", 3), ("variance", 4))
#: one CV fold's training rows of the agreement (two folds of three)
MAPPREP_FOLD_ROWS = MAPPREP_AGREE_N - MAPPREP_AGREE_N // 3


def mapprep_stats(rng, kind, y):
    """[n, C] f32 stats of the label ``y``: the forest's gini channels
    (class weights from integer bootstrap-like weights 0..2, the count)
    or the GBT's variance channels of a residual."""
    n = len(y)
    st = np.empty((n, 3 if kind == "gini" else 4), np.float32)
    if kind == "gini":
        w = rng.integers(0, 3, n).astype(np.float32)
        st[:, 0], st[:, 1], st[:, 2] = (1.0 - y) * w, y * w, w > 0
    else:
        r = (y - rng.random(n)).astype(np.float32)
        st[:, 0], st[:, 1], st[:, 2], st[:, 3] = 1.0, r, r * r, 1.0
    return st


def check_mapprep_kernels(H, TF, dev, X, y, run="mapprep"):
    """Phase 9's kernels at the shapes the mapprep vector gives them, each
    against its plain version on the card. ``X`` [n, F] is the combined
    vector of one CV fold's training rows (``run`` names the run), ``y``
    its label. Binned as the tree families bin it (its
    indicator columns in the 2-bin block, the rest in the 32-bin block;
    both widths read off the vector): ``group_rows`` exact; ``cumhist``
    and ``cumhist_sparse01`` on each block (counts exact, weighted
    channels within REL_TOL, two calls bitwise) and ``split_scan`` on
    each histogram (masked and not, bitwise) under the forest's gini and
    the GBT's variance at MAPPREP_SLOTS; the level epilogue over both
    blocks with the fit's edges, bitwise, in every case of
    :func:`epilogue_cases` (the odd slots' rows labelled by an indicator
    column, so that the 2-bin block wins some slots); ``predict_trees`` on ``X`` at MAPPREP_TREES
    within REL_TOL. Returns each kernel's max abs error."""
    from transmogrifai_tpu_torch.models.trees import detect_binary_columns
    rng = np.random.default_rng(9)

    def put(a):
        return torch.as_tensor(a, device=dev)

    n, Fm = X.shape
    bmask = detect_binary_columns(X)
    Xd = put(X.astype(np.float32))
    XbT, edges = TF.compute_bins(Xd, B, bmask)
    blocks = TF.prepare_blocks(XbT, B, bmask)
    if [b.sparse01 for b in blocks] != [False, True]:
        fail(f"{run} vector: not one 32-bin and one 2-bin block")
    widths = [len(b.cols) for b in blocks]
    worst = {"cumhist": 0.0, "cumhist_sparse01": 0.0, "predict_trees": 0.0}
    for A in MAPPREP_SLOTS:
        node = put(rng.integers(0, A + 1, size=n, dtype=np.int32))
        groups = H.group_rows(node, A)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in
                   zip(groups, H.group_rows_reference(node, A))):
            fail(f"group_rows differs at the mapprep shape (A={A})")
        for kind, C in MAPPREP_KINDS:
            st = put(mapprep_stats(rng, kind, y))
            for blk, Fb in zip(blocks, widths):
                what = f"mapprep {kind} F={Fb} A={A}"
                if blk.sparse01:
                    name = "cumhist_sparse01"
                    cum = H.cumhist_sparse01(st, node, blk.mat, A,
                                             groups=groups, rows=blk.rows)
                    again = H.cumhist_sparse01(st, node, blk.mat, A)
                    ref = H.cumhist_sparse01_reference(st, node, blk.mat, A)
                else:
                    name = "cumhist"
                    cum = H.cumhist(st, node, blk.mat, A, B, groups=groups,
                                    rows=blk.rows)
                    again = H.cumhist(st, node, blk.mat, A, B)
                    ref = H.cumhist_reference(st, node, blk.mat, A, B)
                worst[name] = max(worst[name], hold(
                    cum, again, [ref], f"{name} {what}"))
                mask = put((rng.random((A, Fb)) > 0.2).astype(np.float32))
                scan_holds(H, cum, kind, mask, f"{what} masked")
                scan_holds(H, cum, kind, None, what)
    cols = [(b.mat, b.cols, b.sparse01) for b in blocks]
    # the 2-bin block's most even column: the label of the odd slots'
    # rows, so that both blocks hold winners in one level (the real label
    # splits best on a usage count, in the 32-bin block, at every slot)
    dens = blocks[1].mat.float().mean(1)
    y_ind = blocks[1].mat[int(torch.argmin((dens - 0.5).abs()))].cpu()

    def make(kind, A, nblk, d, D, C):
        slot = rng.integers(0, A + 1, size=n, dtype=np.int32)
        lab = np.where(slot % 2 == 1, y_ind.numpy(), y)
        st = put(mapprep_stats(rng, kind, lab))
        return level_inputs(H, dev, rng, put, kind, st, put(slot), A, d,
                            cols, XbT, edges)
    wins = epilogue_cases(H, dev, make, MAPPREP_KINDS, slots=MAPPREP_SLOTS,
                          nblks=(2,), tree_depth=6)
    for T, D, K in MAPPREP_TREES:
        _X, feat, thr, leaf = predict_inputs(rng, put, Fm, T, D, K, n=1)
        out = H.predict_trees(Xd, feat, thr, leaf, D)
        ref = H.predict_trees_reference(Xd, feat, thr, leaf, D)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if rel_err(out, ref) > REL_TOL:
            fail(f"predict_trees differs at the mapprep shape (F={Fm} T={T} "
                 f"D={D} K={K}): max abs err {err:.3g}")
        worst["predict_trees"] = max(worst["predict_trees"], err)
    print(f"{run} kernels at the vector's shapes ({n} rows, F={Fm}: "
          f"{widths[0]} columns in the 32-bin block, {widths[1]} in the "
          f"2-bin block): group_rows exact; cumhist and cumhist_sparse01 "
          f"counts exact, weighted channels within {REL_TOL:g}, two calls "
          f"bitwise; split_scan bitwise, masked and not (gini C=3, "
          f"variance C=4; A = {', '.join(map(str, MAPPREP_SLOTS))}); "
          f"level_epilogue bitwise over both blocks with the fit's edges "
          f"({wins} slots won in the 2-bin block); predict_trees within "
          f"{REL_TOL:g} at (T, D, K) = {MAPPREP_TREES} (max abs err "
          f"{worst['predict_trees']:.3g})")
    if not wins:
        fail(f"level_epilogue at the {run} shape: no winner in the 2-bin "
             "block was checked")
    return worst


def mapprep_paths(H, TF, MP, root, profile=False, dev="cuda", records=None,
                  records_s=0.0):
    """Phase 9, parts 2-4: mapprep-200k (the example's logistic regression,
    3-fold CV, AuPR) counted; the default families at one grid point each
    on the first 20,000 records, card against CPU, counted on the card
    (the tree kernels must launch), and the kernels held at that vector's
    shapes (:func:`check_mapprep_kernels`); and the 200k model saved,
    loaded and scored through the engine against the layer path.
    ``records``: the path's (made here from MAPPREP_SEED when None, in
    ``records_s`` seconds). Returns ({path: launches}, each kernel's max
    abs error at those shapes)."""
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    t_phase = time.perf_counter()
    if records is None:
        t0 = time.perf_counter()
        records = MP.make_records(N, MAPPREP_SEED)
        records_s = time.perf_counter() - t0
    out, launches = counted(H, lambda: MP.run(
        N, seed=MAPPREP_SEED, device=dev, records=records), ())
    s, aupr = out["summary"], out["metrics"]["AuPR"]
    groups = {c.grouping for c in out["vector_meta"].columns}
    if out["blocked_cols"] or MP.BLOCKED_KEY in groups:
        fail("mapprep-200k: the blocked key reached the vector")
    if not 0.0 < aupr <= 1.0:
        fail("mapprep-200k: AuPR out of range")
    print(f"mapprep-200k {N} records: records {records_s:.2f} s, "
          f"vectorize {out['vectorize_s']:.2f} s, selector "
          f"{out['selector_s']:.2f} s, train {out['train_s']:.2f} s, "
          f"evaluate {out['eval_s']:.2f} s, width {out['width']}, best "
          f"{s.best_model_name} {s.best_model_params}, AuPR {aupr:.6f}, "
          f"no {MP.BLOCKED_KEY} column")
    print(f"mapprep-200k launches: {launches}")
    stage_table(out["model"], "mapprep-200k")
    check_fusion(out["model"], out["store"], "mapprep-200k", dev)
    paths = {"mapprep-200k": launches}
    if profile:
        profile_path(H, "mapprep-200k", lambda: MP.run(
            N, seed=MAPPREP_SEED, device=dev, records=records))

    t0 = time.perf_counter()
    small = records[:MAPPREP_AGREE_N]
    tree_kernels = ("cumhist", "cumhist_sparse01", "group_rows",
                    "split_scan", "level_epilogue")
    runs = {}
    runs["cuda"], launches = counted(H, lambda: MP.run(
        MAPPREP_AGREE_N, seed=MAPPREP_SEED, device=dev, records=small,
        families=titanic_one_point()), tree_kernels)
    runs["cpu"] = MP.run(MAPPREP_AGREE_N, seed=MAPPREP_SEED, device="cpu",
                         records=small, families=titanic_one_point())
    agree_metric(runs, "AuPR", 1e-4,
                 f"mapprep default families, {MAPPREP_AGREE_N} records")
    print(f"mapprep-families-20k launches (card): {launches}; "
          f"{time.perf_counter() - t0:.2f} s")
    paths["mapprep-families-20k"] = launches
    cuda = runs["cuda"]
    fold = cuda["store"].take(np.arange(MAPPREP_FOLD_ROWS))
    X = cuda["model"].transform(fold, device=dev, up_to=cuda["features"])[
        cuda["features"].name].values
    worst = check_mapprep_kernels(H, TF, dev, X, fold["churned"].values)

    model = out["model"]
    path = os.path.join(root, "build", "serve", "mapprep")
    t0 = time.perf_counter()
    model.save(path, overwrite=True)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loaded = WorkflowModel.load(path)
    load_s = time.perf_counter() - t0
    store = out["store"]
    pred = out["prediction"].name

    def score():
        return loaded.score(store, device=dev)
    # warm-up: the engine's first program runs eagerly, then captures
    loaded.score(store.take(np.arange(min(N, 8192))), device=dev)
    H.reset_launch_counts()
    t0 = time.perf_counter()
    scored = score()
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    paths["serve-mapprep"] = dict(H.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    layer = model.score(store, device=dev, engine=False)
    layer_s = time.perf_counter() - t0
    same_predictions(scored[pred], layer[pred], "mapprep Score",
                     prob_atol=PROB_ATOL)
    print(f"mapprep serve: save {save_s:.2f} s, load {load_s:.2f} s, Score "
          f"{score_s:.2f} s through the engine ({N / score_s:.0f} rows/s), "
          f"layer path {layer_s:.2f} s; predictions equal, probabilities "
          f"within 2^-22")
    print(f"phase 9 mapprep: {time.perf_counter() - t_phase:.2f} s")
    return paths, worst


# -- phase 10: the guard rails; mapprep-guarded-200k -----------------------
#: the filter's scoring records: seed 8, every record's attrs without the
#: "region" key (a key that disappeared upstream)
GUARD_SCORE_N, GUARD_SCORE_SEED = 50_000, 8
#: scoring records explained by LOCO and corr on the path
LOCO_ROWS = 20_000
#: the agreement's scoring records (its training records: the first
#: MAPPREP_AGREE_N of the path's)
GUARD_AGREE_SCORE_N = 5_000
#: card/CPU LOCO diffs of one f32 model: each probability within 2^-22
LOCO_ATOL = 1e-6
GUARD_KERNELS = ("cumhist", "cumhist_sparse01", "group_rows", "split_scan",
                 "level_epilogue")


def guard_scoring_records(MP, n):
    recs = MP.make_records(n, GUARD_SCORE_SEED)
    for r in recs:
        r["attrs"].pop("region", None)
    return recs


def spy_folds(H, validator, keep_fold=False):
    """Wrap ``validator``'s per-fold sweep: every (family, fold)'s kernel
    launches, and with ``keep_fold`` fold 0's (X, y) training rows, under
    workflow-level CV or the selector's own CV."""
    per_fold, fold0 = [], {}
    sweep, per_fold_fn = validator._sweep_fold, validator.validate_per_fold
    validate = validator.validate

    def keep_rows(X, y, w):
        if keep_fold and not fold0:
            fold0["X"], fold0["y"] = X[w > 0], y[w > 0]

    def spy(family, groups, metric_fn, Xarg, yd, w, v, y, vm, metrics, k):
        torch.cuda.synchronize()
        before = dict(H.KERNEL_LAUNCHES)
        sweep(family, groups, metric_fn, Xarg, yd, w, v, y, vm, metrics, k)
        torch.cuda.synchronize()
        per_fold.append((family.name, k, {
            n: H.KERNEL_LAUNCHES[n] - before[n] for n in before}))

    def keep(families, fold_data, **kw):
        keep_rows(*fold_data[0][:3])
        return per_fold_fn(families, fold_data, **kw)

    def keep_cv(families, X, y, base_weights=None, **kw):
        w = validator._splits(y)[0][0]
        keep_rows(X, y, w if base_weights is None else w * base_weights)
        return validate(families, X, y, base_weights=base_weights, **kw)
    validator._sweep_fold = spy
    validator.validate_per_fold = keep
    validator.validate = keep_cv
    return per_fold, fold0


def guarded_run(H, MP, records, score_records, dev, loco_rows,
                keep_fold=False):
    """mapprep's workflow with the default families at one grid point
    each, behind the RawFeatureFilter (scoring data: ``score_records``)
    and under workflow-level CV, trained on ``dev``; then its insights
    over the training records, a LOCO (top 20) of the selected model and
    the corr insights (fitted on the training records) over the first
    ``loco_rows`` scoring records, and LOCO of the GBT of
    :func:`titanic_one_point` fitted by ``OpGBTClassifier`` on the
    training vector. Every part timed; the workflow's per-fold launches
    recorded (:func:`spy_folds`)."""
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.filters import RawFeatureFilter
    from transmogrifai_tpu_torch.insights import (RecordInsightsCorr,
                                                  RecordInsightsLOCO)
    from transmogrifai_tpu_torch.models import OpGBTClassifier
    store = MP.records_store(records)
    sstore = MP.records_store(score_records)
    wf = MP.build_workflow(store, families=titanic_one_point(),
                           seed=MAPPREP_SEED)
    wf["workflow"].with_raw_feature_filter(
        RawFeatureFilter(scoring_data=sstore)).with_workflow_cv()
    per_fold, fold0 = spy_folds(H, wf["selector"].validator, keep_fold)
    out = {"store": store, "per_fold": per_fold, "fold0": fold0,
           "prediction": wf["prediction"], "label": wf["label"],
           "workflow": wf["workflow"]}
    t0 = time.perf_counter()
    model = out["model"] = wf["workflow"].train(device=dev)
    torch.cuda.synchronize()
    out["train_s"] = time.perf_counter() - t0
    sel = out["selected"] = model.fitted_stages[wf["selector"].uid]
    out["summary"] = sel.selector_summary
    vec = out["vector"] = sel.input_features[1]
    t0 = time.perf_counter()
    out["insights"] = model.model_insights(wf["prediction"], store=store,
                                           device=dev)
    out["insights_s"] = time.perf_counter() - t0
    head = sstore.take(np.arange(min(loco_rows, sstore.n_rows)))
    scored = out["scored"] = model.transform(head, device=dev, engine=False)
    out["X"] = np.asarray(scored[vec.name].values, dtype=np.float64)
    out["width"] = out["X"].shape[1]
    loco = out["loco"] = RecordInsightsLOCO(model=sel, top_k=20)
    loco.set_input(vec)
    t0 = time.perf_counter()
    out["loco_cells"] = loco.transform_columns(scored, device=dev)
    torch.cuda.synchronize()
    out["loco_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trained = model.transform(store, device=dev, engine=False)
    out["transform_s"] = time.perf_counter() - t0
    evaluator = Evaluators.BinaryClassification.auPR().set_columns(
        wf["label"], wf["prediction"])
    out["metrics"] = evaluator.evaluate_all(trained)
    t0 = time.perf_counter()
    corr = RecordInsightsCorr(top_k=20)
    corr.set_input(wf["prediction"], vec)
    out["corr"] = corr.fit(trained, device=dev)
    out["corr_cells"] = out["corr"].transform_columns(scored, device=dev)
    torch.cuda.synchronize()
    out["corr_s"] = time.perf_counter() - t0
    est = OpGBTClassifier(max_depth=3, min_instances_per_node=10,
                          min_info_gain=0.001)
    est.set_input(wf["label"], vec)
    out["gbt"] = est.fit(trained, device=dev)
    gloco = out["gbt_loco"] = RecordInsightsLOCO(model=out["gbt"], top_k=20)
    gloco.set_input(vec)
    torch.cuda.synchronize()
    before = H.KERNEL_LAUNCHES["predict_trees"]
    t0 = time.perf_counter()
    out["gbt_loco_cells"] = gloco.transform_columns(scored, device=dev)
    torch.cuda.synchronize()
    out["gbt_loco_s"] = time.perf_counter() - t0
    out["gbt_loco_launches"] = H.KERNEL_LAUNCHES["predict_trees"] - before
    return out


def fold_launches(out, what, kernels=GUARD_KERNELS):
    """Every tree family's every fold launched each of ``kernels``;
    returns the sweep's launches summed by kernel."""
    trees = [(f, k, c) for f, k, c in out["per_fold"]
             if f in ("OpRandomForestClassifier", "OpGBTClassifier")]
    folds = {(f, k) for f, k, _ in trees}
    if len(folds) != 6:
        fail(f"{what}: {len(folds)} tree family folds swept, not 2 x 3")
    for f, k, c in trees:
        missing = [n for n in kernels if c[n] == 0]
        if missing:
            fail(f"{what}: {f} fold {k} never launched {missing}")
    return {n: sum(c[n] for _f, _k, c in out["per_fold"])
            for n in kernels + ("predict_trees",)}


def top_names_agree(loco, X, tol, what, dev="cuda"):
    """One model's LOCO on the card against the CPU: diffs within ``tol``;
    the card's top K the stable descending order of its own |diffs|; each
    row's top-K names the CPU's wherever neighbouring |diffs| differ by
    more than ``tol``. Returns the max abs difference."""
    da = loco.loco_diffs(X, device=dev)
    db = loco.loco_diffs(X, device="cpu")
    err = float(np.max(np.abs(da - db), initial=0.0))
    if not err <= tol:
        fail(f"{what}: LOCO diffs differ by {err:.3g} between the card and "
             "the CPU")
    oa, _va = loco.top_diffs(X, device=dev)
    ob, _vb = loco.top_diffs(X, device="cpu")
    k = oa.shape[0]
    if not np.array_equal(oa, np.argsort(-np.abs(da), axis=0,
                                         kind="stable")[:k]):
        fail(f"{what}: the card's top-K order is not the stable order of "
             "its |diffs|")
    s = -np.sort(-np.abs(db), axis=0)                  # [d, n] descending
    gap = s[:-1] - s[1:]
    near = np.zeros((k, s.shape[1]), dtype=bool)
    near[:] = gap[:k] <= tol
    near[1:] |= gap[:k - 1] <= tol
    if np.any((oa != ob) & ~near):
        fail(f"{what}: the top-K names differ where the |diffs| do not tie")
    return err


def guard_agreement(H, MP, records, dev="cuda"):
    """Phase 10's card/CPU agreement: the guarded workflow on the first
    MAPPREP_AGREE_N training records and GUARD_AGREE_SCORE_N scoring
    records on the card (counted: the tree kernels in every fold) and on
    the CPU. The filter's results JSON exactly equal; the blacklist and
    the width; the winner and every family's fold metrics within 1e-4;
    the insights' contributions within 1e-5 of the largest; the card
    model's LOCO (selected and GBT) on the card against the CPU (diffs
    within LOCO_ATOL, top-K names); the corr importances within 1e-5.
    Returns (card launches, LOCO and corr max abs differences)."""
    small = records[:MAPPREP_AGREE_N]
    srecs = guard_scoring_records(MP, GUARD_AGREE_SCORE_N)
    runs = {}
    runs["cuda"], launches = counted(H, lambda: guarded_run(
        H, MP, small, srecs, dev, GUARD_AGREE_SCORE_N),
        GUARD_KERNELS + ("predict_trees",))
    fold_launches(runs["cuda"], "guarded 20k (card)")
    runs["cpu"] = guarded_run(H, MP, small, srecs, "cpu",
                              GUARD_AGREE_SCORE_N)
    a, b = runs["cuda"], runs["cpu"]
    if json.dumps(a["model"].rff_results.to_json(), sort_keys=True) != \
            json.dumps(b["model"].rff_results.to_json(), sort_keys=True):
        fail("guarded 20k: the filter's results differ on the card and "
             "the CPU")
    if ([f.name for f in a["model"].blacklisted_features],
            a["width"]) != ([f.name for f in b["model"].blacklisted_features],
                            b["width"]):
        fail("guarded 20k: blacklist or width differs on the card and CPU")
    agree_metric(runs, "AuPR", 1e-4,
                 f"guarded mapprep, {MAPPREP_AGREE_N} records")

    def contribs(o):
        return np.array([d.contribution or 0.0 for f in o["insights"].features
                         for d in f.derived])
    ca, cb = contribs(a), contribs(b)
    d_contrib = float(np.max(np.abs(ca - cb), initial=0.0)
                      / max(np.abs(cb).max(initial=0.0), 1e-300))
    if ca.shape != cb.shape or not d_contrib <= 1e-5:
        fail(f"guarded 20k: contributions differ by {d_contrib:.3g} of the "
             "largest")
    X = a["X"]
    err = {"loco": top_names_agree(a["loco"], X, LOCO_ATOL,
                                   "guarded 20k LOCO", dev),
           "gbt_loco": top_names_agree(a["gbt_loco"], X, LOCO_ATOL,
                                       "guarded 20k GBT LOCO", dev)}
    ia = a["corr"].importances(X, device=dev)[1]
    ib = b["corr"].importances(X, device="cpu")[1]
    err["corr"] = float(np.max(np.abs(ia - ib), initial=0.0))
    if not err["corr"] <= 1e-5:
        fail(f"guarded 20k: corr importances differ by {err['corr']:.3g}")
    print(f"guarded mapprep {MAPPREP_AGREE_N} records: filter results JSON "
          f"equal, width {a['width']}, contributions within "
          f"{d_contrib:.3g} of the largest, LOCO max |d| {err['loco']:.3g} "
          f"(GBT {err['gbt_loco']:.3g}; limit {LOCO_ATOL:g}), top-K names "
          f"equal but at ties, corr max |d| {err['corr']:.3g} (limit 1e-5)")
    return launches, err


def check_loco_predict(H, gbt, X, dev):
    """``predict_trees`` at the LOCO batch: the GBT's trees over the
    [C·n, d] zeroed rows (C = d columns of ``X``, one chunk), against its
    plain version on the card, timed beside it, with its bound (the rows'
    bytes, n·F·4, and the trees', over the memory rate). Returns
    (max abs err, ms, plain ms, (bytes s, operations s), n)."""
    tabs = gbt._tables(dev)
    leaf = tabs["leaf"] * tabs["tree_w"][:, None, None]
    Xd = torch.as_tensor(X, dtype=torch.float32, device=dev)
    n, d = Xd.shape
    C = min(128, d)
    Xz = Xd.unsqueeze(0).expand(C, n, d).clone()
    Xz[torch.arange(C, device=dev), :, torch.arange(C, device=dev)] = 0.0
    Xb = Xz.reshape(C * n, d)
    del Xz
    D, (T, _NN) = gbt.max_depth, tabs["feat"].shape

    def kernel():
        return H.predict_trees(Xb, tabs["feat"], tabs["thr"], leaf, D)

    def plain():
        return H.predict_trees_reference(Xb, tabs["feat"], tabs["thr"],
                                         leaf, D)
    out, ref = kernel(), plain()
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if rel_err(out, ref) > REL_TOL:
        fail(f"predict_trees at the LOCO batch (n={C * n}, F={d}, T={T}, "
             f"D={D}): max abs err {err:.3g}")
    ms, plain_ms = time_ms(kernel, reps=5), time_ms(plain, reps=3)
    bound = predict_bound(d, T, D, 1, n=C * n)
    print(f"predict_trees at the LOCO batch n={C * n} F={d} T={T} D={D}: "
          f"within {REL_TOL:g} of its plain version (max abs err "
          f"{err:.3g}, bitwise equal: {torch.equal(out, ref)}); kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{1e3 * max(bound):.5f} ms ({'bytes' if bound[0] >= bound[1] else 'operations'})")
    return err, ms, plain_ms, bound, C * n


def guard_second_life(H, out, root, dev="cuda"):
    """The guarded 200k model with its LOCO stage saved, loaded afresh:
    the filter's results and the blacklist equal, LOCO re-attached to the
    loaded selected model, and LOCO_ROWS scoring records scored through
    the engine equal to the saved model's layer path (predictions; the
    probabilities within PROB_ATOL; each row's LOCO cell with the same
    names, but where the K-th |diff| ties, and the diffs within
    LOCO_ATOL)."""
    from transmogrifai_tpu_torch.insights import parse_insights
    from transmogrifai_tpu_torch.workflow import WorkflowModel
    model, loco, sel = out["model"], out["loco"], out["selected"]
    pred, cells = out["prediction"], loco.get_output()
    saved = WorkflowModel([pred, cells],
                          {**model.fitted_stages, loco.uid: loco},
                          blacklisted_features=model.blacklisted_features,
                          rff_results=model.rff_results)
    path = os.path.join(root, "build", "serve", "mapprep-guarded")
    t0 = time.perf_counter()
    saved.save(path, overwrite=True)
    loaded = WorkflowModel.load(path)
    io_s = time.perf_counter() - t0
    if json.dumps(loaded.rff_results.to_json(), sort_keys=True) != \
            json.dumps(model.rff_results.to_json(), sort_keys=True):
        fail("guarded model: the filter's results changed in the save")
    if [f.uid for f in loaded.blacklisted_features] != \
            [f.uid for f in model.blacklisted_features]:
        fail("guarded model: the blacklist changed in the save")
    stage = next(f for f in loaded.result_features
                 if f.name == cells.name).origin_stage
    if stage.model is not loaded.fitted_stages.get(sel.uid):
        fail("guarded model: LOCO is not re-attached to the loaded "
             "selected model")
    head = out["scored"]
    raw = head.select([f.name for f in model.result_features[0]
                       .raw_features()])
    t0 = time.perf_counter()
    got = loaded.score(raw, device=dev, engine=True)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    want = saved.score(raw, device=dev, engine=False)
    same_predictions(got[pred.name], want[pred.name], "guarded Score",
                     prob_atol=PROB_ATOL)
    worst, tied = 0.0, 0
    K = min(loco.top_k, out["width"])
    for i in range(raw.n_rows):
        x = parse_insights(got[cells.name].get_raw(i))
        y = parse_insights(want[cells.name].get_raw(i))
        for k in set(x) & set(y):
            worst = max(worst, abs(x[k] - y[k]))
        # a cell holds the top K nonzero diffs: a column in one cell only
        # lies at most at the other's K-th |diff| (at 0 where the other
        # holds fewer than K)
        for a, b in ((x, y), (y, x)):
            edge = min(map(abs, b.values())) if len(b) == K else 0.0
            for k in set(a) - set(b):
                if not abs(a[k]) <= edge + LOCO_ATOL:
                    fail(f"guarded Score: row {i}'s LOCO names differ "
                         f"where the |diffs| do not tie ({k})")
        tied += set(x) != set(y)
    if not worst <= LOCO_ATOL:
        fail(f"guarded Score: LOCO cells differ by {worst:.3g}")
    print(f"guarded serve: save + load {io_s:.2f} s; filter results and "
          f"blacklist equal; LOCO re-attached; Score of {raw.n_rows} "
          f"records with LOCO {score_s:.2f} s through the engine, "
          f"predictions equal to the layer path's, probabilities within "
          f"2^-22, LOCO cells within {worst:.3g} with the same names but "
          f"at ties ({tied} rows)")


def guarded_paths(H, TF, MP, records, root, profile=False, dev="cuda"):
    """Phase 10: mapprep-guarded-200k counted (the tree kernels in every
    fold, ``predict_trees`` in LOCO); its kernels at the path's shapes;
    the card/CPU agreement at 20,000 records; the second life. Returns
    ({path: launches}, each kernel's max abs error, the LOCO-batch
    ``predict_trees`` row)."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    srecs = guard_scoring_records(MP, GUARD_SCORE_N)
    score_records_s = time.perf_counter() - t0
    out, launches = counted(H, lambda: guarded_run(
        H, MP, records, srecs, dev, LOCO_ROWS, keep_fold=True),
        GUARD_KERNELS + ("predict_trees",))
    sweep = fold_launches(out, "mapprep-guarded-200k")
    model, s = out["model"], out["summary"]
    excluded = [(r.name, r.key) for r in model.rff_results.exclusion_reasons
                if r.excluded]
    if ("attrs", "region") not in excluded:
        fail("mapprep-guarded-200k: (attrs, region) was not excluded")
    names = out["scored"][out["vector"].name].metadata.column_names()
    if any("region" in nm for nm in names):
        fail("mapprep-guarded-200k: a region column reached the vector")
    vtype = s.validator_summary.validation_type
    if not vtype.startswith("WorkflowCV:"):
        fail(f"mapprep-guarded-200k: summary type {vtype}")
    if out["gbt_loco_launches"] < 1:
        fail("mapprep-guarded-200k: predict_trees never launched in LOCO")
    from transmogrifai_tpu_torch.graph import cut_dag
    _ms, _b, during, _a = cut_dag(model.result_features)
    ph = model.phase_seconds
    print(f"mapprep-guarded-200k: filter excluded {excluded}, blacklisted "
          f"{[f.name for f in model.blacklisted_features]}; width "
          f"{out['width']}; during stages "
          f"{[sorted(type(x).__name__ for x in layer) for layer in during]}")
    for r in s.validator_summary.results:
        print(f"mapprep-guarded-200k fold metrics: {r.family_name} "
              f"{r.hparams} {r.metric_values} mean {r.mean_metric:.6f}")
    print(f"mapprep-guarded-200k: {vtype}, best {s.best_model_name} "
          f"{s.best_model_params}, AuPR {out['metrics']['AuPR']:.6f}; "
          f"scoring records {score_records_s:.2f} s; train "
          f"{out['train_s']:.2f} s (filter {ph['rawFeatureFilter']:.2f}, "
          f"vectorize {ph['before'] + ph['foldFeatures']:.2f} = before "
          f"{ph['before']:.2f} + fold features {ph['foldFeatures']:.2f}, "
          f"workflow-CV sweep {ph['cvSweep']:.2f}, refit "
          f"{ph['final']:.2f}); insights {out['insights_s']:.2f} s, LOCO "
          f"{out['loco_s']:.2f} s, training transform "
          f"{out['transform_s']:.2f} s, corr {out['corr_s']:.2f} s, GBT "
          f"LOCO {out['gbt_loco_s']:.2f} s ({out['gbt_loco_launches']} "
          f"predict_trees launches); CV s by family "
          f"{s.validator_summary.family_seconds}")
    top = sorted(((d.contribution, d.column_name) for f in
                  out["insights"].features for d in f.derived
                  if d.contribution is not None), reverse=True)[:5]
    print(f"mapprep-guarded-200k top contributions: "
          f"{[(nm, round(c, 6)) for c, nm in top]}")
    print(f"mapprep-guarded-200k launches: {launches}; the sweep's: {sweep}")
    stage_table(model, "mapprep-guarded-200k")
    check_fusion(model, training_store(
        model, out["store"], rff=out["workflow"].raw_feature_filter),
        "mapprep-guarded-200k", dev)
    paths = {"mapprep-guarded-200k": launches}
    if profile:
        profile_path(H, "mapprep-guarded-200k", lambda: guarded_run(
            H, MP, records, srecs, dev, LOCO_ROWS))

    paths["mapprep-guarded-20k"], errs = guard_agreement(H, MP, records,
                                                         dev)
    fold0 = out.pop("fold0")
    worst = check_mapprep_kernels(H, TF, dev, fold0["X"], fold0["y"],
                                  "mapprep-guarded-200k workflow-CV fold 0")
    del fold0
    err, ms, plain_ms, bound, n_loco = check_loco_predict(
        H, out["gbt"], out["X"], dev)
    worst["predict_trees"] = max(worst["predict_trees"], err)
    guard_second_life(H, out, root, dev)
    print(f"phase 10: {time.perf_counter() - t_phase:.2f} s")
    return paths, worst, {"ms": ms, "plain_ms": plain_ms, "bound": bound,
                          "n": n_loco, "max_abs_err": err, **errs}


# -- phase 11: the event-time readers; eventlog-200k ---------------------
#: eventlog-200k: users, events a user, the seed of ``dataprep.
#: make_event_log``; the card/CPU agreement's users
EVENT_USERS, EVENTS_PER_USER, EVENT_SEED = 200_000, 20, 47
EVENT_AGREE_USERS = 20_000
#: ``bench.py``'s event log: files, rows a file, users
BENCH_FILES, BENCH_FILE_ROWS, BENCH_USERS = 16, 10_000, 5_000
#: the kernels every tree family's every fold must launch on the path
EVENT_KERNELS = ("cumhist", "group_rows", "split_scan", "level_epilogue")
#: ``examples/dataprep.py``'s rows: user b (no purchase) dropped, user a's
#: minutes before its first purchase, user c bought at its first visit
DATAPREP_ROWS = {0: {"minutes": 10.0, "purchase": False},
                 1: {"minutes": None, "purchase": True}}


class _Src:
    """A reader handing a decoded source to the join, keyed by user."""

    def __init__(self, data):
        from transmogrifai_tpu_torch import temporal
        self._data = data
        self.key_fn = temporal.field("user")

    def read_records(self):
        return self._data


def same_store(a, b, names, what):
    """Two raw stores with the same rows, every column's values and mask
    bitwise equal."""
    if a.n_rows != b.n_rows:
        fail(f"{what}: {a.n_rows} rows against {b.n_rows}")
    for n in names:
        if (a[n].values.dtype != b[n].values.dtype
                or a[n].values.tobytes() != b[n].values.tobytes()
                or not np.array_equal(a[n].mask, b[n].mask)):
            fail(f"{what}: column {n} differs")


def bench_event_log(DP, root):
    """Phase 11 (a): ``bench.py``'s event log — BENCH_FILES Avro files of
    BENCH_FILE_ROWS rows over BENCH_USERS users, seed 47, the bench's draws
    — written by the port's ``write_avro_records``, then joined to the
    users table and aggregated twice: ``read_avro_records`` into the
    row-wise join and fold under ``aggregateColumnar`` false, and
    ``read_avro_table`` into the columnar path. Every column's values and
    mask bitwise equal; events/s for each tier."""
    import shutil

    from transmogrifai_tpu_torch import temporal
    from transmogrifai_tpu_torch.readers import (CutOffTime,
                                                 JoinedAggregateDataReader)
    from transmogrifai_tpu_torch.readers.avro import (read_avro_records,
                                                      read_avro_table,
                                                      write_avro_records)
    work = os.path.join(root, "build", "eventlog")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    rng = np.random.default_rng(EVENT_SEED)
    t0 = time.perf_counter()
    files = []
    for i in range(BENCH_FILES):
        uid = rng.integers(0, BENCH_USERS, BENCH_FILE_ROWS).astype(float)
        recs = [{"user": float(uid[r]),
                 "ts": float(rng.uniform(0, 1000.0)),
                 "amount": float(rng.gamma(2.0, 10.0)),
                 "flag": bool(rng.random() < 0.05)}
                for r in range(BENCH_FILE_ROWS)]
        files.append(os.path.join(work, f"e{i:04d}.avro"))
        write_avro_records(files[-1], recs)
    write_s = time.perf_counter() - t0
    users = [{"user": float(u), "seg": float(u % 7)}
             for u in range(BENCH_USERS)]
    label, preds = DP.event_features()
    feats = [label] + preds
    ts, cutoff = temporal.field("ts"), CutOffTime.at(DP.CUTOFF)
    rows = BENCH_FILES * BENCH_FILE_ROWS

    prev = temporal.set_run_defaults(columnar=False)
    try:
        before = temporal.temporal_stats()
        t0 = time.perf_counter()
        recs = [r for fp in files for r in read_avro_records(fp)]
        row = JoinedAggregateDataReader(_Src(recs), _Src(users), ts,
                                        cutoff).generate_store(feats)
        row_s = time.perf_counter() - t0
        mid = temporal.temporal_stats()
    finally:
        temporal.set_run_defaults(**prev)
    t0 = time.perf_counter()
    tables = [read_avro_table(fp) for fp in files]
    col = JoinedAggregateDataReader(
        _Src(temporal.concat_tables(tables)),
        _Src(temporal.table_from_records(users)), ts,
        cutoff).generate_store(feats)
    col_s = time.perf_counter() - t0
    after = temporal.temporal_stats()
    if mid["rowwise_aggregates"] != before["rowwise_aggregates"] + 1 \
            or after["columnar_aggregates"] != mid["columnar_aggregates"] + 1:
        fail(f"event log: the tiers did not serve as asked ({after})")
    if not all(type(t).__name__ == "ColumnarRecords" for t in tables):
        fail("event log: a file did not decode by the columnar path")
    same_store(row, col, [f.name for f in feats],
               "event log: row-wise against columnar")
    print(f"event log (bench.py's: {BENCH_FILES} Avro files x "
          f"{BENCH_FILE_ROWS} rows, {BENCH_USERS} users): written in "
          f"{write_s:.2f} s; decode + join + aggregate row-wise {row_s:.3f} s"
          f" = {rows / row_s:,.0f} events/s, columnar {col_s:.3f} s = "
          f"{rows / col_s:,.0f} events/s ({row_s / col_s:.2f}x); {row.n_rows}"
          f" keys, every column's values and mask bitwise equal")
    shutil.rmtree(work, ignore_errors=True)


def tree_refits(wf, model, store, dev):
    """The selector's tree families at their grid point, each refit by its
    estimator on the whole aggregated vector and scored over it, so that
    ``predict_trees`` runs whichever family the selector picked. Returns
    {estimator: AuPR over the store}."""
    from transmogrifai_tpu_torch.evaluators.metrics import aupr
    from transmogrifai_tpu_torch.models import (GBTFamily, OpGBTClassifier,
                                                OpRandomForestClassifier,
                                                RandomForestFamily)
    vec = model.fitted_stages[wf["selector"].uid].input_features[1]
    trained = model.transform(store, device=dev, engine=False)
    y = np.asarray(trained[wf["label"].name].values, dtype=np.float64)
    out = {}
    for fam in wf["selector"].families:
        if not isinstance(fam, (RandomForestFamily, GBTFamily)):
            continue
        g = fam.grid[0]
        kw = dict(max_depth=g["maxDepth"],
                  min_instances_per_node=g["minInstancesPerNode"],
                  min_info_gain=g["minInfoGain"],
                  max_active_nodes=fam.max_active_nodes)
        est = (OpRandomForestClassifier(num_trees=fam.num_trees,
                                        seed=fam.seed, **kw)
               if isinstance(fam, RandomForestFamily)
               else OpGBTClassifier(max_iter=fam.max_iter, **kw))
        est.set_input(wf["label"], vec)
        scored = est.fit(trained, device=dev).transform_columns(
            trained, device=dev)
        out[fam.name] = aupr(y, scored.probability[:, 1])
    return out


def eventlog_run(H, DP, n_users, dev, events=None, keep_fold=False):
    """``dataprep``'s event log of ``n_users`` users (EVENTS_PER_USER each,
    EVENT_SEED) joined, aggregated through the columnar engine and trained
    on ``dev`` with the default families at one grid point each; the
    model evaluated on the aggregated store, and the tree families refit
    and scored over it (:func:`tree_refits`). Returns the model, the store
    the train aggregated, the summary, metrics, the refits' AuPR, the
    per-fold launches (with ``keep_fold`` fold 0's training rows;
    :func:`spy_folds`), the temporal tallies and the seconds."""
    from transmogrifai_tpu_torch import temporal
    from transmogrifai_tpu_torch.evaluators import Evaluators
    t0 = time.perf_counter()
    if events is None:
        events = DP.make_event_log(n_users, EVENTS_PER_USER, EVENT_SEED)
    make_s = time.perf_counter() - t0
    wf = DP.build_workflow(*events)
    kept = {}
    generate = wf["reader"].generate_store

    def keep(raw):
        kept["store"] = generate(raw)
        return kept["store"]
    wf["reader"].generate_store = keep
    per_fold, fold0 = spy_folds(H, wf["selector"].validator, keep_fold)
    temporal.reset_temporal_stats()
    t0 = time.perf_counter()
    model = wf["workflow"].train(device=dev)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    stats = temporal.temporal_stats()
    store, sel = kept["store"], model.fitted_stages[wf["selector"].uid]
    evaluator = Evaluators.BinaryClassification.auPR().set_columns(
        wf["label"], wf["prediction"])
    t0 = time.perf_counter()
    metrics = model.evaluate(store, evaluator, device=dev)
    eval_s = time.perf_counter() - t0
    before = H.KERNEL_LAUNCHES["predict_trees"]
    t0 = time.perf_counter()
    refits = tree_refits(wf, model, store, dev)
    refit_s = time.perf_counter() - t0
    refit_launches = H.KERNEL_LAUNCHES["predict_trees"] - before
    head = store.take(np.arange(min(256, store.n_rows)))
    vec = sel.input_features[1]
    width = model.transform(head, device=dev, engine=False)[
        vec.name].values.shape[1]
    return {"model": model, "store": store, "summary": sel.selector_summary,
            "metrics": metrics, "refits": refits,
            "refit_launches": refit_launches, "per_fold": per_fold,
            "fold0": fold0, "temporal": stats,
            "prediction": wf["prediction"], "raw": wf["raw"],
            "selector": sel, "width": width, "events": events,
            "make_s": make_s, "train_s": train_s, "eval_s": eval_s,
            "refit_s": refit_s}


def eventlog_paths(H, TF, DP, root, profile=False, dev="cuda"):
    """Phase 11: the two tiers at the bench's size; eventlog-200k
    aggregated columnar and trained on the card, counted (the tree
    refits launch ``predict_trees``, whichever family wins); its kernels
    at the shapes of its CV fold 0 (:func:`check_mapprep_kernels`); the
    model saved, loaded and scored through the engine against the layer
    path; the card against the CPU at EVENT_AGREE_USERS users; the
    dataprep walkthrough's rows. Returns ({path: launches}, each kernel's
    max abs error at the fold's shapes)."""
    from transmogrifai_tpu_torch import WorkflowModel
    t_phase = time.perf_counter()
    bench_event_log(DP, root)

    out, launches = counted(H, lambda: eventlog_run(
        H, DP, EVENT_USERS, dev, keep_fold=True),
        EVENT_KERNELS + ("predict_trees",))
    sweep = fold_launches(out, "eventlog-200k", EVENT_KERNELS)
    st = out["temporal"]
    n_events = EVENT_USERS * EVENTS_PER_USER
    if st["columnar_aggregates"] < 1 or st["rowwise_aggregates"] \
            or st["columnar_joins"] < 1:
        fail(f"eventlog-200k: not aggregated columnar ({st})")
    if out["store"].n_rows != EVENT_USERS or \
            out["model"].train_rows != EVENT_USERS:
        fail(f"eventlog-200k: {out['store'].n_rows} keys aggregated, "
             f"{out['model'].train_rows} rows trained, not {EVENT_USERS}")
    aupr = out["metrics"]["AuPR"]
    if not all(0.0 < a <= 1.0 for a in [aupr, *out["refits"].values()]):
        fail(f"eventlog-200k: AuPR {aupr}, tree refits {out['refits']}")
    if out["refit_launches"] < 1:
        fail("eventlog-200k: the tree refits never launched predict_trees")
    model, s = out["model"], out["summary"]
    ph, sec = model.phase_seconds, model.stage_seconds
    sel_s = sec.get(out["selector"].uid, 0.0)
    sweep_s = sum(s.validator_summary.family_seconds.values())
    for r in s.validator_summary.results:
        print(f"eventlog-200k fold metrics: {r.family_name} {r.hparams} "
              f"{r.metric_values} mean {r.mean_metric:.6f}")
    print(f"eventlog-200k: {n_events} events over {EVENT_USERS} users made "
          f"in {out['make_s']:.2f} s; join + aggregate (columnar) "
          f"{ph['aggregate']:.2f} s = {n_events / ph['aggregate']:,.0f} "
          f"events/s; width {out['width']}; best {s.best_model_name} "
          f"{s.best_model_params}, AuPR {aupr:.6f} over the aggregated "
          f"store; train {out['train_s']:.2f} s (aggregate "
          f"{ph['aggregate']:.2f}, vectorize "
          f"{sum(sec.values()) - sel_s:.2f}, sweep {sweep_s:.2f}, refit "
          f"{sel_s - sweep_s:.2f}); evaluate {out['eval_s']:.2f} s; CV s by "
          f"family {s.validator_summary.family_seconds}; temporal {st}")
    print(f"eventlog-200k tree refits over the aggregated store: AuPR "
          f"{ {k: round(v, 6) for k, v in out['refits'].items()} } in "
          f"{out['refit_s']:.2f} s ({out['refit_launches']} predict_trees "
          f"launches)")
    print(f"eventlog-200k launches: {launches}; the sweep's: {sweep}")
    stage_table(model, "eventlog-200k")
    paths = {"eventlog-200k": launches}
    if profile:
        events = out["events"]
        profile_path(H, "eventlog-200k", lambda: eventlog_run(
            H, DP, EVENT_USERS, dev, events=events))
    fold0 = out.pop("fold0")
    worst = check_mapprep_kernels(H, TF, dev, fold0["X"], fold0["y"],
                                  "eventlog-200k CV fold 0")
    del fold0

    # the second life: saved, loaded afresh, the aggregated store scored
    # through the engine as the saved model's layer path scores it
    path = os.path.join(root, "build", "serve", "eventlog")
    t0 = time.perf_counter()
    model.save(path, overwrite=True)
    loaded = WorkflowModel.load(path)
    io_s = time.perf_counter() - t0
    store, pred = out["store"], out["prediction"].name
    t0 = time.perf_counter()
    got = loaded.score(store, device=dev, engine=True)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = model.score(store, device=dev, engine=False)
    torch.cuda.synchronize()
    layer_s = time.perf_counter() - t0
    same_predictions(got[pred], want[pred], "eventlog serve",
                     prob_atol=PROB_ATOL)
    print(f"eventlog serve: save + load {io_s:.2f} s; Score of "
          f"{store.n_rows} users through the engine {score_s:.2f} s = "
          f"{store.n_rows / score_s:,.0f} rows/s against the layer path's "
          f"{layer_s:.2f} s; predictions equal, probabilities within 2^-22")
    del out, model, loaded, store, got, want

    t0 = time.perf_counter()
    events = DP.make_event_log(EVENT_AGREE_USERS, EVENTS_PER_USER,
                               EVENT_SEED)
    runs = {}
    runs["cuda"], paths["eventlog-20k"] = counted(
        H, lambda: eventlog_run(H, DP, EVENT_AGREE_USERS, "cuda", events),
        EVENT_KERNELS)
    fold_launches(runs["cuda"], "eventlog-20k (card)", EVENT_KERNELS)
    runs["cpu"] = eventlog_run(H, DP, EVENT_AGREE_USERS, "cpu", events)
    same_store(runs["cuda"]["store"], runs["cpu"]["store"],
               [f.name for f in runs["cpu"]["raw"]],
               "eventlog-20k: the card's store against the CPU's")
    agree_metric(runs, "AuPR", 1e-4,
                 f"eventlog, {EVENT_AGREE_USERS} users (stores bitwise "
                 "equal)")
    refit_d = {k: abs(v - runs["cpu"]["refits"][k])
               for k, v in runs["cuda"]["refits"].items()}
    if not max(refit_d.values()) <= 1e-4:
        fail(f"eventlog-20k: the tree refits' AuPR differ {refit_d}")
    print(f"eventlog-20k tree refits: card/CPU |dAuPR| "
          f"{ {k: float(f'{v:.3g}') for k, v in refit_d.items()} } "
          f"(limit 1e-4)")
    print(f"eventlog agreement: {time.perf_counter() - t0:.2f} s")

    _store, rows = DP.run()
    if rows != DATAPREP_ROWS:
        fail(f"dataprep walkthrough: rows {rows}, not {DATAPREP_ROWS}")
    print(f"dataprep walkthrough: {rows}, the rows examples/dataprep.py "
          "prints")
    print(f"phase 11: {time.perf_counter() - t_phase:.2f} s")
    return paths, worst


# -- phase 12: serving artifacts at serve-200k ---------------------------
#: the buckets phase 12 banks (None: the whole ladder, 8 … 8,192)
EXPORT_LADDER = None
#: the cold process: a fresh interpreter that imports torch, numpy and
#: the port, loads the saved model, preloads the bank into a fresh engine
#: and scores the records (one record first, then all of them), printing
#: its numbers as one JSON line and saving the columns beside the export
COLD_SCRIPT = r"""
import json, os, sys, time
t0 = time.perf_counter()
import numpy as np
import torch
root, model_dir, export, n, dev = sys.argv[1:6]
sys.path.insert(0, root)
from transmogrifai_tpu_torch import WorkflowModel, aot
from transmogrifai_tpu_torch import big_passenger as BP
from transmogrifai_tpu_torch.models import _hist as H
from transmogrifai_tpu_torch.types.feature_types import Prediction


def sync():
    if dev == "cuda":
        torch.cuda.synchronize()


model = WorkflowModel.load(model_dir)
eng = model.scoring_engine(dev)
report = aot.load_program_bank(eng, export)
sync()
load_s = time.perf_counter() - t0
records = BP.synthesize_records(int(n), seed=42)
H.reset_launch_counts()
t1 = time.perf_counter()
eng.score_store(records[:1])
sync()
first_ms = 1e3 * (time.perf_counter() - t1)
launches = dict(H.KERNEL_LAUNCHES)
H.reset_launch_counts()
t1 = time.perf_counter()
out = eng.score_store(records, use_cache=False)
sync()
score_s = time.perf_counter() - t1
pred = next(f.name for f in model.result_features if f.ftype is Prediction)
col = out[pred]
np.savez(os.path.join(export, "cold_score.npz"), prediction=col.prediction,
         raw=col.raw_prediction, prob=col.probability)
print(json.dumps({"load_s": load_s, "first_ms": first_ms,
                  "first_launches": launches,
                  "launches": dict(H.KERNEL_LAUNCHES), "score_s": score_s,
                  "rows": out.n_rows, "compile_count": eng.compile_count,
                  "loaded": report["loaded"],
                  "findings": [f.format() for f in report["findings"]],
                  "graphs": eng.graphs_captured}))
"""


def flat_blocks(eng, records):
    """The host-prepared blocks of ``records`` keyed as a scoring
    artifact's loader takes them (``uid/name``, upload names)."""
    from transmogrifai_tpu_torch.workflow import _raw_store
    _, prepared, uploads = eng.host_blocks(_raw_store(records,
                                                      eng._raw_features))
    out = {f"{uid}/{k}": v for uid, bl in prepared.items()
           for k, v in bl.items()}
    out.update(uploads)
    return out


def artifact_equal(got, want, name, what):
    """An artifact's flat outputs (f32) against an engine's prediction
    column (f64), every column bitwise."""
    for key, col in (("prediction", "prediction"),
                     ("rawPrediction", "raw_prediction"),
                     ("probability", "probability")):
        a = np.asarray(got[f"{name}.{key}"], dtype=np.float64)
        if not np.array_equal(a, getattr(want, col)):
            err = float(np.max(np.abs(a - getattr(want, col)), initial=0.0))
            fail(f"{what}: {key} differs (max abs {err:.3g})")


def serve_export(H, records, score_col, dev="cuda"):
    """Phase 12: phase 7's saved model (text-200k's GBT over the 451-wide
    vector) exported with its program bank, loaded in a cold process and
    through the loaders, the head exported, a corrupted bucket degraded,
    the operator held on the card. Returns the path's launches (this
    process's and the cold process's). ``dev`` "cpu" rehearses the phase
    on the host."""
    import shutil

    from transmogrifai_tpu_torch import WorkflowModel, aot, serving
    from transmogrifai_tpu_torch.scoring import ScoringEngine
    from transmogrifai_tpu_torch.types.feature_types import Prediction

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    t_phase = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    model_dir = os.path.join(root, "build", "serve", "big_passenger")
    export = os.path.join(root, "build", "serve", "export")
    head_dir = os.path.join(export, "head")
    shutil.rmtree(export, ignore_errors=True)
    model = WorkflowModel.load(model_dir)
    pred = next(f for f in model.result_features if f.ftype is Prediction)
    predictor = model.stage_of(pred)
    n = len(records)
    chunks = -(-n // 8192)
    tail = records[(chunks - 1) * 8192:]
    # the polymorphic program's batch sizes: one row, a few, Score's last
    # chunk (3,392 rows at 200,000) and a full bucket
    cases = {1: records[:1], 7: records[:7], len(tail): tail,
             8192: records[:8192]}

    # references and host blocks, not counted: the engine's eager program
    warm = ScoringEngine(model, device=dev, graphs=False)
    refs = {k: warm.score_store(v, use_cache=False)[pred.name]
            for k, v in cases.items()}
    blocks = {k: flat_blocks(warm, v) for k, v in cases.items()}
    all_blocks = [flat_blocks(warm, records[i:i + 8192])
                  for i in range(0, n, 8192)]
    vec = predictor.input_features[1].name
    X = np.asarray(warm.transform_store(records[:8192])[vec].values,
                   dtype=np.float32)
    head_ref = [o.detach().to("cpu", torch.float64).numpy()
                for o in predictor.predict_device(torch.as_tensor(
                    X, device=dev))]
    sync()

    H.reset_launch_counts()
    # (a) the scoring chain with its bank
    t0 = time.perf_counter()
    meta = serving.export_scoring_fn(model, export, records[:64],
                                     device=dev, aot_ladder=EXPORT_LADDER)
    sync()
    export_s = time.perf_counter() - t0
    ladder = meta["aot"]["bucketLadder"]
    print(f"serve-export: export_scoring_fn {export_s:.2f} s, ladder "
          f"{ladder}, scoring_fn.pt2 {meta['blobBytes']:,} bytes, bank "
          f"{meta['aot']['programs']} programs {meta['aot']['bytes']:,} "
          f"bytes, {len(meta['inputs'])} input blocks, "
          f"{meta['fusedStages']} fused stages")
    # (b) a cold process loads the model and the bank and scores
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", COLD_SCRIPT, root, model_dir, export,
         str(n), dev], capture_output=True, text=True, timeout=900,
        cwd=root)
    cold_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"serve-export: the cold process failed:\n"
             f"{proc.stderr[-4000:]}")
    cold = json.loads(proc.stdout.strip().splitlines()[-1])
    # (c) the loaders: the bank, then the polymorphic program
    banked = serving.load_scoring_fn(export, device=dev)
    plain = serving.load_scoring_fn(export, prefer_bank=False, device=dev)
    outs = {("bank", k): banked(blocks[k]) for k in (8192, len(tail))}
    outs.update({("plain", k): plain(blocks[k]) for k in cases})
    sync()
    t0 = time.perf_counter()
    whole = [banked(b) for b in all_blocks]
    sync()
    artifact_s = time.perf_counter() - t0
    # (d) the prediction head
    t0 = time.perf_counter()
    hmeta = serving.export_prediction_fn(model, head_dir, device=dev)
    head = serving.load_prediction_fn(head_dir, device=dev)
    head_out = head(X)
    sync()
    head_s = time.perf_counter() - t0
    launches = dict(H.KERNEL_LAUNCHES)
    for k, v in cold["launches"].items():
        launches[k] += v + cold["first_launches"][k]

    # -- checks (not counted) ---------------------------------------------
    if cold["compile_count"] != 0:
        fail(f"cold process built {cold['compile_count']} programs")
    if cold["loaded"] != ladder or cold["findings"]:
        fail(f"cold process bank: loaded {cold['loaded']}, findings "
             f"{cold['findings']}")
    if cold["launches"]["predict_trees"] != chunks:
        fail(f"cold process launched predict_trees "
             f"{cold['launches']['predict_trees']} times for {chunks} "
             "chunks")
    saved = np.load(os.path.join(export, "cold_score.npz"))
    for key, col in (("prediction", "prediction"), ("raw", "raw_prediction"),
                     ("prob", "probability")):
        if not np.array_equal(saved[key], getattr(score_col, col)):
            fail(f"cold process: {col} differs from phase 7's Score")
    print(f"serve-export: cold process (fresh interpreter, bank preloaded) "
          f"import + load {cold['load_s']:.2f} s, first request (1 record) "
          f"{cold['first_ms']:.2f} ms, {cold['rows']:,} records "
          f"{cold['score_s']:.2f} s = {cold['rows'] / cold['score_s']:,.0f} "
          f"rows/s, compile_count 0, predict_trees {chunks} launches, "
          f"{cold['graphs']} graphs, columns bitwise equal to phase 7's "
          f"Score (process wall {cold_wall:.2f} s)")
    for (how, k), got in outs.items():
        artifact_equal(got, refs[k], pred.name,
                       f"load_scoring_fn ({how}, n={k})")
    if banked.bank_buckets != ladder:
        fail(f"load_scoring_fn took bank buckets {banked.bank_buckets}")
    for key, col in (("prediction", "prediction"),
                     ("rawPrediction", "raw_prediction"),
                     ("probability", "probability")):
        a = np.concatenate([w[f"{pred.name}.{key}"] for w in whole])
        if not np.array_equal(a.astype(np.float64), getattr(score_col, col)):
            fail(f"load_scoring_fn over {n} rows: {key} differs from "
                 "phase 7's Score")
    print(f"serve-export: load_scoring_fn bitwise equal to the engine's "
          f"eager program through the bank at 8192 and {len(tail)} and the "
          f"polymorphic program at n = {list(cases)}; {n:,} rows of "
          f"prepared blocks through the bank {artifact_s:.2f} s = "
          f"{n / artifact_s:,.0f} rows/s, equal to phase 7's Score")
    for got, want, key in zip((head_out["prediction"],
                               head_out["rawPrediction"],
                               head_out["probability"]), head_ref,
                              ("prediction", "rawPrediction",
                               "probability")):
        if not np.array_equal(np.asarray(got, dtype=np.float64), want):
            fail(f"export_prediction_fn: {key} differs from predict_device")
    print(f"serve-export: export_prediction_fn at F={hmeta['featureDim']} "
          f"({hmeta['blobBytes']:,} bytes), loaded, {len(X)} rows bitwise "
          f"equal to predict_device ({head_s:.2f} s export + load + call)")

    # (e) one byte of the 8192 program changed: a TMG502 finding, and the
    # bucket still scores on the device
    bad = os.path.join(root, "build", "serve", "export_bad")
    shutil.rmtree(bad, ignore_errors=True)
    shutil.copytree(export, bad)
    f = os.path.join(aot.bank_dir(bad), "bucket_8192.pt2")
    blob = bytearray(open(f, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(f, "wb").write(bytes(blob))
    eng = ScoringEngine(model, device=dev)
    report = aot.load_program_bank(eng, bad)
    rules = {x.rule for x in report["findings"]}
    if rules != {"TMG502"} or list(report["skipped"]) != [8192] \
            or 8192 in report["loaded"]:
        fail(f"corrupted bucket: report {report}")
    before = H.KERNEL_LAUNCHES["predict_trees"]
    for _ in range(3):          # eager, then captured and replayed
        same_predictions(eng.score_store(records[:8192], use_cache=False)[
            pred.name], refs[8192], "corrupted bucket, built by the engine")
    sync()
    if eng.compile_count != 1 or (
            dev == "cuda"
            and H.KERNEL_LAUNCHES["predict_trees"] - before != 3):
        fail(f"corrupted bucket: compile_count {eng.compile_count}")
    fn = serving.load_scoring_fn(bad, device=dev)
    if 8192 in fn.bank_buckets:
        fail("load_scoring_fn served a corrupted bucket")
    artifact_equal(fn(blocks[8192]), refs[8192], pred.name,
                   "corrupted bucket through the polymorphic program")
    print(f"serve-export: bucket_8192.pt2 with one byte changed: "
          f"{sorted(rules)} ({report['findings'][0].message[:60]}...); the "
          f"engine built that bucket (compile_count 1) and the loader served "
          f"it by the polymorphic program, both bitwise on {dev}")
    print(f"serve-export launches: {launches}")
    print(f"phase 12: {time.perf_counter() - t_phase:.2f} s")
    return launches


def check_predict_op(H, dev):
    """Phase 12 (f): ``tmog_torch::predict_trees`` against its plain
    version at the bucket shape, bitwise; its time beside the direct
    launch's, device time and host time a call."""
    rng = np.random.default_rng(12)

    def put(a):
        return torch.as_tensor(a, device=dev)

    X, feat, thr, leaf = predict_inputs(rng, put, 451, 20, 6, n=8192)
    out = torch.ops.tmog_torch.predict_trees(X, feat, thr, leaf, 6)
    ref = H.predict_trees_reference(X, feat, thr, leaf, 6)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        fail("tmog_torch::predict_trees at n=8192 F=451 T=20 D=6 is not "
             "bitwise equal to its plain version")
    op_ms = time_ms(lambda: H.predict_trees(X, feat, thr, leaf, 6))
    direct_ms = time_ms(lambda: H._predict_trees_launch(X, feat, thr,
                                                        leaf, 6))
    Xs = X[:8].contiguous()
    host = {}
    for name, fn in (("op", H.predict_trees),
                     ("direct", H._predict_trees_launch),
                     ("op", H.predict_trees),
                     ("direct", H._predict_trees_launch)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            fn(Xs, feat, thr, leaf, 6)
        torch.cuda.synchronize()
        host[name] = 1e6 * (time.perf_counter() - t0) / 2000
    print(f"predict_trees op (n=8192, F=451, T=20, D=6): bitwise equal to "
          f"its plain version; device {op_ms:.4f} ms through "
          f"tmog_torch::predict_trees, {direct_ms:.4f} ms by the direct "
          f"launch; host a call at n=8: op {host['op']:.2f} us, direct "
          f"{host['direct']:.2f} us (dispatch {host['op'] - host['direct']:.2f} "
          "us)")


def stage_table(model, what):
    """Print a trained model's seconds by stage and by layer: each stage's
    fit seconds, its layer's transform seconds (``layerTransformSeconds``)
    and its ``stage_seconds`` (its fit and its share of the transforms),
    and each layer's total of ``stage_seconds``. Under workflow CV the
    table is the final fit's; the folds' are in ``phase_seconds``. Where
    the stage metrics hold the fused statistics pass and the fused layer
    transform, their lines follow each layer's."""
    m, sec = model.stage_metrics, model.stage_seconds
    for li, layer in enumerate(model.dag):
        total = sum(sec.get(s.uid, 0.0) for s in layer)
        print(f"{what} layer {li}: {total:.4f} s over {len(layer)} "
              f"stage(s)")
        for s in layer:
            mm = m.get(s.uid, {})
            fused = " fusedStats" if mm.get("fusedStats") else ""
            print(f"  {mm.get('stageName', s.stage_name())}: fit "
                  f"{mm.get('fitSeconds', 0.0)} s, layer transform "
                  f"{mm.get('layerTransformSeconds', '-')} s, stage "
                  f"{sec.get(s.uid, 0.0):.4f} s{fused}")
        for key in ("statsPass", "fusedTransform"):
            info = next((m[s.uid][key] for s in layer
                         if key in m.get(s.uid, {})), None)
            if info is not None:
                print(f"  {key}: {info}")
    if model.phase_seconds:
        print(f"{what} phases: " + ", ".join(
            f"{k} {v:.4f} s" for k, v in model.phase_seconds.items()))
    top = sorted(((v, m.get(u, {}).get("stageName", u))
                  for u, v in sec.items()), reverse=True)[:5]
    print(f"{what} top stages: "
          f"{[(nm, round(v, 4)) for v, nm in top]}")


#: the card's f32 moment fold (Chan-merged in f64) against the host
#: tier's f64 numpy, relative: f32 sums of 200,000 values, ~1e-7 seen
FUSED_RTOL = 1e-5


def model_state(m):
    """A fitted stage's state as sorted JSON (arrays listed)."""
    from transmogrifai_tpu_torch.model_io import _encode_param
    from transmogrifai_tpu_torch.stages.base import FittedModel
    arrays = {}
    doc = json.dumps(_encode_param(
        m.get_model_state() if isinstance(m, FittedModel) else {}, arrays,
        "s"), sort_keys=True)
    return doc, {k: v.tolist() for k, v in arrays.items()}


def numbers_close(a, b, rtol):
    """Two JSON-like values: equal but for floats within ``rtol``;
    returns the largest relative difference (inf where they differ
    otherwise)."""
    if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
        return max([numbers_close(a[k], b[k], rtol) for k in a] + [0.0])
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        return max([numbers_close(x, y, rtol) for x, y in zip(a, b)]
                   + [0.0])
    if isinstance(a, float) and isinstance(b, float):
        if a == b:
            return 0.0
        return abs(a - b) / max(abs(a), abs(b))
    return 0.0 if a == b else math.inf


def transfers(fn):
    """The copies between the host and the card that ``fn()`` issues:
    (uploads, pulls) counted where they are made (a ``Tensor.to`` or
    ``copy_`` whose source and destination devices differ), and the
    profiler's (HtoD, DtoH) memcpy records of the same call."""
    from torch.profiler import ProfilerActivity, profile
    to, copy_ = torch.Tensor.to, torch.Tensor.copy_
    made = {"up": 0, "down": 0}

    def count(src, dst):
        if src.type != dst.type:
            made["up" if dst.type == "cuda" else "down"] += 1

    def counted_to(t, *args, **kw):
        out = to(t, *args, **kw)
        count(t.device, out.device)
        return out

    def counted_copy(t, src, *args, **kw):
        count(src.device, t.device)
        return copy_(t, src, *args, **kw)
    torch.cuda.synchronize()
    torch.Tensor.to, torch.Tensor.copy_ = counted_to, counted_copy
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        torch.Tensor.to, torch.Tensor.copy_ = to, copy_
    seen = {"HtoD": 0, "DtoH": 0}
    for e in prof.key_averages():
        for k in seen:
            if e.key.startswith(f"Memcpy {k}"):
                seen[k] += e.count
    return made["up"], made["down"], seen["HtoD"], seen["DtoH"]


def selector_splitter(model):
    """The splitter of ``model``'s selector (BigPassenger's workflow holds
    out its rows)."""
    return next(s.splitter for layer in model.dag for s in layer
                if getattr(s, "splitter", None) is not None)


def training_store(model, data, splitter=None, rff=None):
    """The store a trained ``model``'s first layer read: ``data``'s raw
    columns, through the filter ``rff`` and the holdout ``splitter``
    where the workflow had them."""
    from transmogrifai_tpu_torch.workflow import _raw_features_of, _raw_store
    raw_features = _raw_features_of(model.result_features)
    store = _raw_store(data, raw_features)
    if rff is not None:
        store = rff.filter_raw(store, raw_features).clean_store
    if splitter is not None:
        store = splitter.reserve_split(store)[0]
    return store


def check_fusion(model, store, what, dev="cuda"):
    """Phases 4, 9 and 10: the fused statistics pass and the fused layer
    transform of a trained ``model`` on its training ``store``, layer by
    layer (each layer's input made by the per-model path on ``dev``).
    Where a layer's estimators ask for statistics: their plan on the host
    tier against the device tier (counts exact, minima and maxima those
    of the f32-rounded host values, the other moments within FUSED_RTOL;
    the worst printed), each opted-in stage fitted from the host tier's
    values against its sequential fit (every state equal: fills, splits,
    vocabularies), and the trained stage against the host tier's fit
    (any moved fill printed with both values). Where a layer has
    device-math vectorizers: the fused transform against the per-model
    path on the card, bitwise, with one upload and one pull (counted where
    they are issued; the profiler's memcpy records printed beside)."""
    from transmogrifai_tpu_torch import fitstats as FS, workflow as W
    from transmogrifai_tpu_torch.ops.vectorizer_base import VectorizerModel
    from transmogrifai_tpu_torch.stages.base import Estimator
    resolved = model._resolved_dag()
    for li, (layer, fitted) in enumerate(zip(model.dag, resolved)):
        opted = [s for s in layer if isinstance(s, Estimator)
                 and s.stat_requests(store) is not None]
        reqs = [r for s in opted for r in s.stat_requests(store)]
        if reqs:
            plan = FS.LayerStatsPlan(reqs, n_stages=len(opted))
            t0 = time.perf_counter()
            host = plan.run(store, device=False, workflow_device=dev)
            host_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            card = plan.run(store, device=True, workflow_device=dev)
            torch.cuda.synchronize()
            card_s = time.perf_counter() - t0
            worst = 0.0
            for r in plan.requests:
                if r.kind not in ("count", "mean", "variance", "std", "min",
                                  "max"):
                    continue
                a, b = host.for_request(r), card.for_request(r)
                if r.kind == "count" or a is None:
                    ok = a == b
                elif r.kind in ("min", "max"):
                    ok = b == float(np.float32(a))
                else:
                    err = abs(a - b) / max(abs(a), 1e-300)
                    worst, ok = max(worst, err), err <= FUSED_RTOL
                if not ok:
                    fail(f"{what} layer {li}: {r.kind}({r.column}) device "
                         f"tier {b!r}, host tier {a!r}")
            moved = []
            for s in opted:
                fused = s.fit(store, stats=host)
                seq = s.fit(store, **({"device": dev, "dtype": torch.float32}
                                      if getattr(s, "uses_device", False)
                                      else {}))
                if model_state(fused) != model_state(seq):
                    fail(f"{what} layer {li}: {s.stage_name()} fitted from "
                         "the host tier differs from its sequential fit")
                trained = model.fitted_stages[s.uid]
                if model_state(trained) != model_state(fused):
                    d = numbers_close(json.loads(model_state(trained)[0]),
                                      json.loads(model_state(fused)[0]),
                                      FUSED_RTOL)
                    if d > FUSED_RTOL:
                        fail(f"{what} layer {li}: {s.stage_name()} moved "
                             f"by {d:.3g} from its host-tier fit")
                    moved.append(f"{s.stage_name()} (largest relative "
                                 f"change {d:.3g}): trained "
                                 f"{model_state(trained)[0]} host tier "
                                 f"{model_state(fused)[0]}")
            print(f"{what} layer {li} stats: {len(opted)} opted-in "
                  f"stage(s), {plan.n_requests} request(s); host tier "
                  f"{host_s:.4f} s, device tier {card_s:.4f} s, moments "
                  f"within {worst:.3g} relative; every opted-in stage's "
                  "host-tier fit equal to its sequential fit")
            for line in moved:
                print(f"{what} layer {li} fill moved by the card's f32 "
                      f"moments: {line}")
        vecs = [m for m in fitted
                if isinstance(m, VectorizerModel) and m.device_math]
        if vecs:
            W.apply_layer(vecs, store, dev, fuse=True)      # the tables
            fused = W.apply_layer(vecs, store, dev, fuse=True)
            plain = W.apply_layer(vecs, store, dev, fuse=False)
            for m in vecs:
                if not np.array_equal(fused[m.output_name].values,
                                      plain[m.output_name].values):
                    fail(f"{what} layer {li}: the fused transform of "
                         f"{m.stage_name()} differs from the per-model path")
            t0 = time.perf_counter()
            W.apply_layer(vecs, store, dev, fuse=True)
            fused_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            W.apply_layer(vecs, store, dev, fuse=False)
            plain_s = time.perf_counter() - t0
            up, down, rec_up, rec_down = transfers(
                lambda: W.apply_layer(vecs, store, dev, fuse=True))
            pup, pdown, prec_up, prec_down = transfers(
                lambda: W.apply_layer(vecs, store, dev, fuse=False))
            if (up, down) != (1, 1):
                fail(f"{what} layer {li}: the fused transform made {up} "
                     f"uploads and {down} pulls")
            print(f"{what} layer {li} transform: {len(vecs)} vectorizer(s) "
                  f"fused {fused_s:.4f} s ({up} upload, {down} pull; the "
                  f"profiler's memcpy records {rec_up} HtoD, {rec_down} "
                  f"DtoH), per-model {plain_s:.4f} s ({pup} uploads, {pdown} "
                  f"pulls; records {prec_up} HtoD, {prec_down} DtoH); "
                  "bitwise equal")
        if li < len(resolved) - 1:
            store = W.apply_layer(fitted, store, dev, fuse=False)


def stage_seconds(BP, MP, DP, dev="cuda"):
    """``--stage-seconds``: text-200k, mapprep-200k, mapprep-guarded-200k
    and eventlog-200k's training (no insights, no checks) twice each,
    with :func:`stage_table` after each train. A copy of this script in
    another checkout that has these paths reads that checkout's stages:
    two versions compare in one call, in turns."""
    from transmogrifai_tpu_torch.filters import RawFeatureFilter
    records = BP.synthesize_records(N, seed=42)
    mrecords = MP.make_records(N, MAPPREP_SEED)
    srecs = guard_scoring_records(MP, GUARD_SCORE_N)
    events = DP.make_event_log(EVENT_USERS, EVENTS_PER_USER, EVENT_SEED)
    for rep in range(2):
        out = BP.run(N, device=dev, records=records)
        print(f"text-200k rep {rep}: train {out['train_s']:.4f} s, "
              f"vectorize {out['vectorize_s']:.4f} s, SanityChecker "
              f"{out['sanity_s']:.4f} s, AuPR {out['metrics']['AuPR']:.6f}")
        stage_table(out["model"], f"text-200k rep {rep}")
        out = MP.run(N, seed=MAPPREP_SEED, device=dev, records=mrecords)
        print(f"mapprep-200k rep {rep}: train {out['train_s']:.4f} s, "
              f"vectorize {out['vectorize_s']:.4f} s, AuPR "
              f"{out['metrics']['AuPR']:.6f}")
        stage_table(out["model"], f"mapprep-200k rep {rep}")
        store, sstore = MP.records_store(mrecords), MP.records_store(srecs)
        wf = MP.build_workflow(store, families=titanic_one_point(),
                               seed=MAPPREP_SEED)
        wf["workflow"].with_raw_feature_filter(
            RawFeatureFilter(scoring_data=sstore)).with_workflow_cv()
        t0 = time.perf_counter()
        model = wf["workflow"].train(device=dev)
        torch.cuda.synchronize()
        s = model.fitted_stages[wf["selector"].uid].selector_summary
        print(f"mapprep-guarded-200k rep {rep}: train "
              f"{time.perf_counter() - t0:.4f} s, best {s.best_model_name}")
        stage_table(model, f"mapprep-guarded-200k rep {rep}")
        wf = DP.build_workflow(*events)
        t0 = time.perf_counter()
        model = wf["workflow"].train(device=dev)
        torch.cuda.synchronize()
        s = model.fitted_stages[wf["selector"].uid].selector_summary
        print(f"eventlog-200k rep {rep}: train "
              f"{time.perf_counter() - t0:.4f} s, best {s.best_model_name}")
        stage_table(model, f"eventlog-200k rep {rep}")
    return 0


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
    # serve-200k's Score: BigPassenger's model saved, loaded afresh and
    # its 200,000 records scored through the engine, twice
    from transmogrifai_tpu_torch import WorkflowModel
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "build", "serve", "timings")
    out["model"].save(path, overwrite=True)
    for _ in range(2):
        loaded = WorkflowModel.load(path)
        t0 = time.perf_counter()
        loaded.score(records, device="cuda")
        torch.cuda.synchronize()
        print(f"serve-200k: Score (fresh load, engine) "
              f"{time.perf_counter() - t0:.2f} s")
    return 0


# -- phase 13: the remaining estimators and the rich DSL -----------------
#: every-surface-200k's records, and the rows of each card/CPU agreement
SURFACE_SEED = 13
SURFACE_AGREE_N = 2_000
#: every-surface-200k's records compared engine against layer path
SURFACE_SERVE_N = 20_000
#: taggers-20k's records: both packages tag one Python call a token on
#: the host (NER ~0.7 ms and POS ~0.3 ms a 20-token note), so this path
#: is cut from 200,000 records (PERF.md §4)
TAGGER_N = 20_000
TAGGER_SEED = 17
#: the MLP's card/CPU agreement (F1, AuPR): full-batch Adam scales each
#: gradient coordinate by its own magnitude, so f32 rounding of a
#: cancelling sum becomes a step of full size; a row or two in 2,000 may
#: flip
MLP_AGREE = 2e-3
#: LDA's θ and Word2Vec's vectors, card against CPU (f32 both): products
#: and sums in another order over 60 EM iterations / 100 gradient steps
TOPIC_ATOL = 1e-4
#: the new stages that stay on the host in the scoring engine's plan
HOST_STAGES = ("EmailParser", "UrlParser", "PhoneNumberParser",
               "MimeTypeDetector", "NGramSimilarity", "LDAModel",
               "Word2VecModel", "MathUnaryTransformer",
               "PercentileCalibratorModel", "IsotonicRegressionModel",
               "OPMapTransformer", "OPListTransformer", "ValueOpTransformer",
               "IsSubstringTransformer", "MapTransformer",
               "PredictionPartTransformer")


def glm_path(BO, data_dir, dev="cuda"):
    """boston-glm-200k: boston-200k's data, linear regression and GLM at
    their default grids, 3-fold CV on RMSE; then 2,000 rows on the card
    and the CPU (same winner, every fold's RMSE within 1e-4 relative)."""
    from transmogrifai_tpu_torch.models import (GLMRegressionFamily,
                                                LinearRegressionFamily)

    def fams():
        return [LinearRegressionFamily(), GLMRegressionFamily()]
    path = BO.generate_data(os.path.join(data_dir, "boston-200k.data"), N,
                            seed=42)
    t0 = time.perf_counter()
    out = BO.run(path, device=dev, families=fams())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    s = out["summary"]
    rmse = out["metrics"]["RootMeanSquaredError"]
    pred = out["scored"][out["prediction"].name].prediction
    if not (len(pred) == N and np.isfinite(pred).all()
            and 0.0 < rmse < 50.0):
        fail("boston-glm-200k: predictions not finite or RMSE out of range")
    print(f"boston-glm-200k {N} rows: train {out['train_s']:.2f} s, "
          f"evaluate {out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, RMSE {rmse:.6f}; CV seconds by family "
          f"{s.validator_summary.family_seconds}")
    small = BO.generate_data(os.path.join(data_dir, "boston-2k.data"),
                             2_000, seed=42)
    agree_metric({k: BO.run(small, device=d, families=fams())
                  for k, d in (("cuda", dev), ("cpu", "cpu"))},
                 "RootMeanSquaredError", 1e-4,
                 "boston-glm, 2000 rows, default grids", relative=True)
    return wall


def mlp_path(H, IR, data_dir, root, dev="cuda"):
    """iris-mlp-200k: iris-200k's data, LR and the MLP at their default
    grids, 3-fold CV on F1, the prediction de-indexed by the DSL's
    ``deindexed``; the MLP winner (forced where LR wins) saved, loaded
    and its 200,000 rows scored through the engine against the layer
    path; 2,000 rows on the card and the CPU."""
    import shutil

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.models import (LogisticRegressionFamily,
                                                MLPFamily)

    def fams():
        return [LogisticRegressionFamily(), MLPFamily(n_classes=3)]
    path = IR.generate_csv(os.path.join(data_dir, "iris-200k.data"), N,
                           seed=42)
    t0 = time.perf_counter()
    out = IR.run(path, device=dev, families=fams())
    torch.cuda.synchronize()
    s = out["summary"]
    print(f"iris-mlp-200k {N} rows: train {out['train_s']:.2f} s, "
          f"evaluate {out['eval_s']:.2f} s, best {s.best_model_name} "
          f"{s.best_model_params}, F1 {out['metrics']['F1']:.6f}; CV "
          f"seconds by family {s.validator_summary.family_seconds}")
    mlp = out
    if s.best_model_name != MLPFamily.name:
        mlp = IR.run(path, device=dev, families=[MLPFamily(n_classes=3)])
        print(f"iris-mlp-200k: LR won; the MLP alone: F1 "
              f"{mlp['metrics']['F1']:.6f}, "
              f"{mlp['summary'].best_model_params}")
    save = os.path.join(root, "build", "serve", "iris-mlp")
    shutil.rmtree(save, ignore_errors=True)
    mlp["model"].save(save)
    loaded = WorkflowModel.load(save)
    store = mlp["data"]
    pred, de = mlp["prediction"].name, mlp["deindexed"].name
    loaded.score(store, device=dev, engine=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scored = loaded.score(store, device=dev, engine=True)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t1
    eng = loaded.scoring_engine(dev)
    kinds = [it.kind for it in eng._plan]
    if kinds[-2:] != ["predict", "deindex"]:
        fail(f"iris-mlp serve: the engine's program is {kinds}")
    layer = loaded.score(store, device=dev, engine=False)
    same_names = bool(np.array_equal(scored[de].values, layer[de].values))
    if not same_names:
        fail("iris-mlp serve: species names differ from the layer path's")
    same_predictions(scored[pred], layer[pred],
                     "iris-mlp serve: engine against the layer path")
    print(f"iris-mlp serve: Score (loaded MLP, engine, second call) "
          f"{score_s:.3f} s = {N / score_s:,.0f} rows/s; program {kinds}, "
          f"graphs captured {eng.graphs_captured}, buckets "
          f"{eng.buckets_used()}; species names equal to the layer path's: "
          f"{same_names}")
    small = IR.generate_csv(os.path.join(data_dir, "iris-2k.data"), 2_000,
                            seed=42)
    agree_metric({k: IR.run(small, device=d, families=fams())
                  for k, d in (("cuda", dev), ("cpu", "cpu"))}, "F1",
                 MLP_AGREE, "iris-mlp, 2000 rows, default grids")
    return time.perf_counter() - t0


def _w2v_peak(TP, dev):
    """Wrap Word2Vec's training to keep its pair count, chunk and the
    card's peak memory over it (``stats``)."""
    stats = {}
    inner = TP.w2v_train

    def wrapped(*a, **kw):
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated() \
            if torch.device(dev).type == "cuda" else 0
        kw["stats"] = stats
        t0 = time.perf_counter()
        out = inner(*a, **kw)
        if torch.device(dev).type == "cuda":
            torch.cuda.synchronize()
            stats["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        stats["train_s"] = time.perf_counter() - t0
        return out
    return stats, inner, wrapped


class PredCols:
    """The first ``n`` rows of a prediction column's three arrays."""

    def __init__(self, col, n):
        self.prediction = col.prediction[:n]
        self.raw_prediction = col.raw_prediction[:n]
        self.probability = col.probability[:n]


def check_gumbel_noise(dev):
    """``random.categorical``'s fast Gumbel noise (``torch.log`` on the
    card) against XLA's f32 ``log`` written out: the gap must stay far
    inside ``CATEGORICAL_MARGIN``, the band whose rows are drawn again
    exactly. Returns the max |gap|."""
    from transmogrifai_tpu_torch import random as R
    u = R._gumbel_uniform(R.PRNGKey(9), torch.arange(
        4_000_000, dtype=torch.int64, device=dev))
    gap = (torch.log(-torch.log(u))
           - R.xla_log_f32(-R.xla_log_f32(u))).abs().max().item()
    if not gap < R.CATEGORICAL_MARGIN / 50:
        fail(f"Gumbel noise: torch.log against XLA's log {gap:.3g}")
    print(f"Gumbel noise on {dev}: |torch.log − XLA log| ≤ {gap:.3g} over "
          f"4,000,000 uniforms (margin {R.CATEGORICAL_MARGIN:g})")
    return gap


def surface_agreement(ES, dev="cuda"):
    """2,000 records on the card and on the CPU (f32 both): each host
    stage's column and the count block bitwise, LDA's θ and Word2Vec's
    vectors within ``TOPIC_ATOL``, the same winner."""
    raw = ES.make_raw(SURFACE_AGREE_N, SURFACE_SEED)
    runs = {k: ES.run(raw, device=d) for k, d in (("cuda", dev),
                                                  ("cpu", "cpu"))}
    cols = {}
    for k, r in runs.items():
        st = r["workflow"]["stages"]
        out = r["model"].transform(r["store"], device=dev if k == "cuda"
                                   else "cpu", engine=False)
        cols[k] = {name: out[f.name] for name, f in st.items()}
    worst = {}
    for name in cols["cpu"]:
        a, b = cols["cuda"][name], cols["cpu"][name]
        if name in ("topics", "embedding"):
            err = float(np.abs(np.asarray(a.values, np.float64)
                               - np.asarray(b.values, np.float64)).max())
            worst[name] = err
            if err > TOPIC_ATOL:
                fail(f"every-surface agreement: {name} differs by {err:.3g}")
        elif name == "counts_vec":
            if not np.array_equal(a.values, b.values):
                fail("every-surface agreement: the count block differs")
        elif [a.get_raw(i) for i in range(len(a))] != \
                [b.get_raw(i) for i in range(len(b))]:
            fail(f"every-surface agreement: {name} differs")
    sa, sb = runs["cuda"]["summary"], runs["cpu"]["summary"]
    if (sa.best_model_name, sa.best_model_params) != \
            (sb.best_model_name, sb.best_model_params):
        fail("every-surface agreement: cuda and cpu picked different models")
    d_aupr = abs(runs["cuda"]["metrics"]["AuPR"]
                 - runs["cpu"]["metrics"]["AuPR"])
    print(f"every-surface, {SURFACE_AGREE_N} records: host stages and the "
          f"count block bitwise on cuda and cpu, LDA / Word2Vec max |d| "
          f"{ {k: float(f'{v:.3g}') for k, v in worst.items()} } (limit "
          f"{TOPIC_ATOL:g}), same model ({sa.best_model_name}), |dAuPR| "
          f"{d_aupr:.3g}")


def surface_path(H, TF, ES, root, dev="cuda"):
    """every-surface-200k: the rich-DSL workflow trained on 200,000
    records with every launch counted (GBT's histogram, scan and epilogue
    kernels), its stage and family seconds, LDA's and Word2Vec's fits,
    Word2Vec's pairs, chunk and peak memory, the width, winner, AuPR and
    Brier score; the model saved, loaded and scored through the engine
    against the layer path (the tupled columns equal to the prediction's
    parts; the count vectorizer fused as "vec", the predictor as
    "predict", every other new stage on the host); the tree kernels at
    the shapes of the selector's CV fold 0 (:func:`check_mapprep_kernels`);
    then the 2,000-record agreement. Returns (launches, seconds, each
    kernel's max abs error at the fold's shapes)."""
    import shutil

    from transmogrifai_tpu_torch import WorkflowModel
    from transmogrifai_tpu_torch.ops import topics as TP
    t0 = time.perf_counter()
    check_gumbel_noise(dev)
    raw = ES.make_raw(N, SURFACE_SEED)
    print(f"every-surface-200k: {N} records made in "
          f"{time.perf_counter() - t0:.2f} s")
    t0_store = time.perf_counter()
    store = ES.raw_store(raw)
    store_s = time.perf_counter() - t0_store
    wf = ES.build_workflow(store)
    _, fold0 = spy_folds(H, wf["selector"].validator, keep_fold=True)
    stats, inner, wrapped = _w2v_peak(TP, dev)
    TP.w2v_train = wrapped
    try:
        out, launches = counted(
            H, lambda: ES.train(store, wf, device=dev),
            ("cumhist", "group_rows", "split_scan", "level_epilogue"))
    finally:
        TP.w2v_train = inner
    once_per_level(launches, "every-surface-200k")
    model, s = out["model"], out["summary"]
    aupr, brier = out["metrics"]["AuPR"], out["bin_score"]["BrierScore"]
    if not (0.5 < aupr <= 1.0 and 0.0 < brier < 0.25):
        fail(f"every-surface-200k: AuPR {aupr} / Brier {brier} out of range")
    st = out["workflow"]["stages"]
    fit = {k: model.stage_metrics.get(st[k].origin_stage.uid, {}).get(
        "fitSeconds") for k in ("counts_vec", "topics", "embedding")}
    print(f"every-surface-200k {N} records: store {store_s:.2f} s, train "
          f"{out['train_s']:.2f} s, "
          f"evaluate {out['eval_s']:.2f} s, width {out['width']}, best "
          f"{s.best_model_name} {s.best_model_params}, AuPR {aupr:.6f}, "
          f"Brier {brier:.6f}; CV seconds by family "
          f"{s.validator_summary.family_seconds}")
    print(f"every-surface-200k fits: count vectorizer {fit['counts_vec']} "
          f"s, LDA {fit['topics']} s, Word2Vec {fit['embedding']} s "
          f"(training {stats.get('train_s', 0.0):.2f} s: "
          f"{stats.get('pairs')} pairs, {stats.get('chunk_pairs')} a chunk, "
          f"{stats.get('chunks_per_epoch')} chunks an epoch, peak "
          f"{stats.get('peak_bytes', 0) / 2**20:.1f} MiB over the "
          f"allocations before it)")
    print(f"every-surface-200k training launches: {launches}")
    stage_table(model, "every-surface-200k")

    # the prediction alone as the result (the same fitted stages): the
    # engine's fused program, timed over the 200,000 records; then the
    # model as trained, whose tupled columns are host stages that read
    # the prediction (so nothing upstream of them fuses), and the layer
    # path, each on SURFACE_SERVE_N records: the host stages dominate
    # every pass (~8,000 records/s)
    from transmogrifai_tpu_torch.graph import compute_dag
    store = out["store"]
    pred_f = out["workflow"]["prediction"]
    pred = pred_f.name
    loaded = {}
    for name, m in (("every-surface", model),
                    ("every-surface-pred", WorkflowModel(
                        [pred_f], model.fitted_stages,
                        compute_dag([pred_f])))):
        save = os.path.join(root, "build", "serve", name)
        shutil.rmtree(save, ignore_errors=True)
        m.save(save)
        loaded[name] = WorkflowModel.load(save)
    lp = loaded["every-surface-pred"]
    t1 = time.perf_counter()
    scored = lp.score(store, device=dev, engine=True)
    torch.cuda.synchronize()
    score_s = time.perf_counter() - t1
    eng = lp.scoring_engine(dev)
    plan = {}
    for it in eng._plan:
        plan.setdefault(type(it.model).__name__, set()).add(it.kind)
    host = {type(m).__name__ for layer in lp._resolved_dag()
            for m in layer} - set(plan)
    if plan.get("CountVectorizerModel") != {"vec"} or \
            plan.get("SelectedModel") != {"predict"}:
        fail(f"every-surface serve: the engine's plan is {plan}")
    if any(k in plan for k in HOST_STAGES):
        fail(f"every-surface serve: a host stage is in the plan {plan}")
    sub = store.take(np.arange(SURFACE_SERVE_N))
    replay = lp.score(sub, device=dev, engine=True)[pred]
    full = loaded["every-surface"].score(sub, device=dev, engine=True)
    layer = lp.score(sub, device=dev, engine=False)[pred]
    head = PredCols(scored[pred], SURFACE_SERVE_N)
    for a, b, what in ((replay, head, "a replay against the first pass"),
                       (layer, head, "the layer path against the engine"),
                       (full[pred], head, "the model with tupled columns")):
        same_predictions(a, b, f"every-surface serve: {what}")
    p, rawp, prob = out["workflow"]["tupled"]
    for f, part in ((p, "prediction"), (rawp, "raw_prediction"),
                    (prob, "probability")):
        if not np.array_equal(np.asarray(full[f.name].values),
                              getattr(full[pred], part)):
            fail(f"every-surface serve: tupled {part} differs")
    print(f"every-surface serve: Score of the loaded model, prediction "
          f"alone, through the engine {score_s:.2f} s = "
          f"{N / score_s:,.0f} records/s; plan "
          f"{ {k: sorted(v) for k, v in plan.items()} }; host stages "
          f"{sorted(host)}; graphs {eng.graphs_captured}; on "
          f"{SURFACE_SERVE_N} records a replay, the layer path and the "
          f"model with its tupled columns (host, plan "
          f"{[it.kind for it in loaded['every-surface'].scoring_engine(dev)._plan]})"
          f" give the same predictions, the tupled columns the "
          f"prediction's parts")
    refits = tree_refits(out["workflow"], model, sub, dev)
    torch.cuda.synchronize()
    launches = dict(H.KERNEL_LAUNCHES)
    if not launches["predict_trees"]:
        fail("every-surface-200k: predict_trees never launched")
    print(f"every-surface GBT refit on {SURFACE_SERVE_N} records (so "
          f"predict_trees runs whichever family won): AuPR {refits}; "
          f"launches over training, serving and the refit: {launches}")
    if not fold0:
        fail("every-surface-200k: the selector's CV kept no fold")
    worst = check_mapprep_kernels(H, TF, dev, fold0.pop("X"),
                                  fold0.pop("y"),
                                  "every-surface-200k CV fold 0")
    surface_agreement(ES, dev)
    return launches, time.perf_counter() - t0, worst


def tagger_path(ES, dev="cuda"):
    """taggers-20k: entities, languages, sentences and POS tags of 20,000
    notes, transmogrified, one LR point; seconds by stage."""
    t0 = time.perf_counter()
    raw = ES.make_tagger_raw(TAGGER_N, TAGGER_SEED)
    out = ES.run_taggers(raw, device=dev)
    aupr = out["metrics"]["AuPR"]
    if not 0.5 < aupr <= 1.0:
        fail(f"taggers-20k: AuPR {aupr} out of range")
    print(f"taggers-20k {TAGGER_N} records: train {out['train_s']:.2f} s, "
          f"best {out['summary'].best_model_name}, train AuPR {aupr:.6f}")
    stage_table(out["model"], "taggers-20k")
    return time.perf_counter() - t0


def rich_dsl_paths(H, TF, BO, IR, root, dev="cuda"):
    """Phase 13: boston-glm-200k, iris-mlp-200k, every-surface-200k and
    taggers-20k, with each path's seconds. Returns ({path: launches},
    each kernel's max abs error at every-surface-200k's fold shapes)."""
    from transmogrifai_tpu_torch import every_surface as ES
    data_dir = os.path.join(root, "build", "data")
    seconds, launches_by = {}, {}
    for name, fn in (("boston-glm-200k", lambda: glm_path(BO, data_dir,
                                                          dev)),
                     ("iris-mlp-200k", lambda: mlp_path(H, IR, data_dir,
                                                        root, dev))):
        out, launches = counted(H, fn, ())
        seconds[name], launches_by[name] = out, launches
    (launches_by["every-surface-200k"], seconds["every-surface-200k"],
     worst) = surface_path(H, TF, ES, root, dev)
    out, launches_by["taggers-20k"] = counted(H, lambda: tagger_path(ES,
                                                                     dev), ())
    seconds["taggers-20k"] = out
    print(f"phase 13 seconds by path: "
          f"{ {k: round(v, 2) for k, v in seconds.items()} }, total "
          f"{sum(seconds.values()):.2f} s")
    return launches_by, worst


# -- phase 14: the pre-flight, the planner and the run summary -----------
#: every WorkflowModel ``Workflow.train`` returned on the card in this run
#: (phase 14's pre-flight goes over each)
TRAINED = []


def keep_trained_models():
    """From here on, keep every model ``Workflow.train`` returns on the
    card in :data:`TRAINED`."""
    from transmogrifai_tpu_torch.workflow import Workflow
    train = Workflow.train

    def keeping(self, device=None, dtype=torch.float32):
        model = train(self, device=device, dtype=dtype)
        if torch.device(device or "cuda").type == "cuda":
            TRAINED.append(model)
        return model

    Workflow.train = keeping


def plan_summary(plan_doc):
    """A plan block's counts and tiers, for a line of output."""
    c = plan_doc["counts"]
    return (f"{c['stages']} stages {c['tiers']}, pruned columns "
            f"{c['prunedColumns']}, CSE merges {c['cseMerges']}, tiers "
            f"{plan_doc['tiers']}, link {plan_doc['link']}")


def planned_scores(H, model, data, plan, dev, what, reps=3):
    """``data`` through ``model``'s engine under ``plan`` and through an
    engine without one, on the same model: each scored ``reps`` times
    (the first two passes run each bucket's program eagerly and capture
    it, the last replays). Fails unless the last passes' predictions are
    bitwise equal and, on the card, every program captured a CUDA graph
    that launches ``predict_trees``. Returns (planned engine, seconds and
    ``predict_trees`` launches of each last pass)."""
    from transmogrifai_tpu_torch.types.feature_types import Prediction
    pred = next(f.name for f in model.result_features
                if f.ftype is Prediction)
    model.attach_plan(plan)
    engines = {"planned": model.scoring_engine(dev),
               "unplanned": model.scoring_engine(dev, plan=None)}
    cols, seconds, launches = {}, {}, {}
    for name, eng in engines.items():
        for _ in range(reps):
            before = H.KERNEL_LAUNCHES["predict_trees"]
            t0 = time.perf_counter()
            out = eng.score_store(data, use_cache=False)
            if dev == "cuda":
                torch.cuda.synchronize()
            seconds[name] = time.perf_counter() - t0
            launches[name] = H.KERNEL_LAUNCHES["predict_trees"] - before
        cols[name] = out[pred]
        if dev == "cuda":
            progs = list(eng._programs.values())
            if not progs or any(p.graph is None
                                or not p.launches.get("predict_trees")
                                for p in progs):
                fail(f"{what} ({name}): a bucket's program has no CUDA "
                     "graph launching predict_trees")
    same_predictions(cols["planned"], cols["unplanned"],
                     f"{what}: planned against unplanned scores")
    model.attach_plan(None)
    return engines["planned"], seconds, launches


def prune_line(plan, eng):
    """The plan's pruned columns and merges, and whether the engine
    applied them."""
    dead = {uid: int(plan.widths[uid] - len(live))
            for uid, live in sorted(plan.prune.items())}
    off = (" (pruning switched off by _disable; see the warning)"
           if plan.prune and not eng.pruned_columns else "")
    return (f"plan prunes {plan.counts()['prunedColumns']} columns of "
            f"{len(plan.prune)} vectorizers ({dead}), {len(plan.cse)} CSE "
            f"merges; the engine gathers away {eng.pruned_columns} "
            f"columns, {len(eng.cse_aliases)} aliases{off}")


def plan_path(H, BP, records, text_aupr, dev="cuda"):
    """Phase 14 (a), plan-200k: BigPassenger through the runner with the
    default customParams (pre-flight and plan on) and a cost database in
    ``build/plan``, trained twice (the second time with the database of
    the first), each Train's model evaluated; then the second model
    loaded and its records scored under its plan and without one.
    Returns the path's launches and the loaded model."""
    import shutil

    from transmogrifai_tpu_torch import WorkflowModel, lint, planner
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.readers import DataReaders
    from transmogrifai_tpu_torch.runner import (OpParams, OpWorkflowRunner,
                                                RunType)
    from transmogrifai_tpu_torch.workflow import Workflow

    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, "build", "plan")
    shutil.rmtree(work, ignore_errors=True)
    db_path = os.path.join(work, "tmog_cost_db.json")
    survived, _checked, selector, prediction = BP.build_selection()
    wf = (Workflow().set_result_features(prediction)
          .set_splitter(selector.splitter))
    reader = DataReaders.simple.records(records)
    runner = OpWorkflowRunner(
        wf, training_reader=reader, scoring_reader=reader,
        evaluator=Evaluators.BinaryClassification.auPR().set_columns(
            survived, prediction), device=dev)
    n = len(records)
    chunks = -(-n // 8192)
    H.reset_launch_counts()
    auprs = []
    for i in (1, 2):
        params = OpParams(model_location=os.path.join(work, f"model{i}"),
                          custom_params={"costDb": db_path})
        t0 = time.perf_counter()
        tr = runner.run(RunType.TRAIN, params)
        train_s = time.perf_counter() - t0
        pre = tr.metrics["preflight"]
        if pre is None or pre.get("error"):
            fail(f"plan-200k Train {i}: pre-flight {pre}")
        if not os.path.exists(db_path):
            fail(f"plan-200k Train {i}: no cost database at {db_path}")
        fit_plan = wf._exec_plan
        sources = {}
        for e in fit_plan.entries:
            sources[e.source] = sources.get(e.source, 0) + 1
        ev = runner.run(RunType.EVALUATE, params)
        auprs.append(ev.metrics["AuPR"])
        db = planner.CostDatabase.load(db_path)
        phases = {k[len("phase:"):]: sorted(v) for k, v in
                  sorted(db.doc["stages"].items()) if k.startswith("phase:")}
        print(f"plan-200k Train {i}: {train_s:.2f} s; pre-flight {pre}; "
              f"the fit's plan: {len(fit_plan.entries)} stages, sources "
              f"{sources}, tiers fitstats {fit_plan.fitstats_tier} "
              f"transform {fit_plan.transform_tier} aggregate "
              f"{fit_plan.aggregate_tier}; the model's plan: "
              f"{plan_summary(tr.metrics['plan'])}; cost database "
              f"{os.path.getsize(db_path):,} bytes, phases measured "
              f"{phases}; Evaluate (pre-flight {ev.metrics['preflight']}) "
              f"AuPR {ev.metrics['AuPR']:.6f}")
        if i == 2 and not sources.get("measured"):
            fail("plan-200k Train 2: no stage's fit cost was measured")
    if auprs[0] != auprs[1] or (text_aupr is not None
                                and auprs[0] != text_aupr):
        fail(f"plan-200k: AuPR {auprs} (phase 4: {text_aupr})")
    m1 = WorkflowModel.load(os.path.join(work, "model1"))
    model = WorkflowModel.load(os.path.join(work, "model2"))
    digests = [m.scoring_engine(dev, plan=None).state_digest()
               for m in (m1, model)]
    if digests[0] != digests[1]:
        fail("plan-200k: the two Trains fitted different models")
    t0 = time.perf_counter()
    plan = planner.plan_model(model, planner.CostDatabase.load(db_path))
    plan_s = time.perf_counter() - t0
    before = dict(H.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    findings = lint.check_model(model, device=True, target=dev)
    check_s = time.perf_counter() - t0
    if dict(H.KERNEL_LAUNCHES) != before:
        fail("plan-200k: the pre-flight launched a kernel")
    eng, seconds, launches = planned_scores(H, model, records, plan, dev,
                                            "plan-200k")
    if dev == "cuda" and launches["planned"] != chunks:
        fail(f"plan-200k: {launches['planned']} predict_trees launches "
             f"for {chunks} chunks")
    print(f"plan-200k: the models of both Trains equal (state digest), "
          f"AuPR {auprs[0]:.6f} both; plan_model {plan_s:.3f} s, "
          f"check_model {check_s:.3f} s ({len(findings)} findings); "
          + prune_line(plan, eng))
    print(f"plan-200k: Score of {n:,} records, planned "
          f"{seconds['planned']:.2f} s = {n / seconds['planned']:,.0f} "
          f"rows/s, unplanned {seconds['unplanned']:.2f} s = "
          f"{n / seconds['unplanned']:,.0f} rows/s; predictions bitwise "
          f"equal; predict_trees {launches['planned']} launches, all "
          f"replays of the {eng.graphs_captured} captured graphs")
    path_launches = dict(H.KERNEL_LAUNCHES)
    print(f"plan-200k launches: {path_launches}")
    return path_launches, model


def titanic_plan(H, TT, out, dev="cuda"):
    """Phase 14 (b): titanic's model (F = 498) planned, its 891 rows
    scored through the engine under the plan and without it, bitwise."""
    from transmogrifai_tpu_torch import planner
    from transmogrifai_tpu_torch.readers import DataReaders
    model = out["model"]
    reader = DataReaders.simple.csv(TT.BUNDLED_CSV, TT.TITANIC_SCHEMA,
                                    key_fn=lambda r: r["id"])
    store = reader.generate_store(out["prediction"].raw_features())
    t0 = time.perf_counter()
    plan = planner.plan_model(model)
    plan_s = time.perf_counter() - t0
    eng, seconds, launches = planned_scores(H, model, store, plan, dev,
                                            "titanic")
    if not plan.prune:
        fail("titanic: the SanityChecker's drops gave no dead columns")
    print(f"titanic plan: plan_model {plan_s:.3f} s; "
          + prune_line(plan, eng)
          + f"; {store.n_rows} rows planned {1e3 * seconds['planned']:.2f} "
          f"ms, unplanned {1e3 * seconds['unplanned']:.2f} ms, bitwise "
          f"equal, predict_trees {launches['planned']} launch a pass")


def preflight_all(H, dev="cuda"):
    """Phase 14 (c): ``check_model(device=True)`` on every model this run
    trained on the card: no error, no TMG201, no kernel launched."""
    from transmogrifai_tpu_torch import lint
    by_rule = {}
    before = dict(H.KERNEL_LAUNCHES)
    t0 = time.perf_counter()
    for model in TRAINED:
        findings = lint.check_model(model, device=True, target=dev)
        for f in findings:
            key = f"{f.rule} {f.severity}"
            by_rule[key] = by_rule.get(key, 0) + 1
            if f.severity == "error" or f.rule == "TMG201":
                fail(f"pre-flight of {[x.name for x in model.result_features]}"
                     f": {f.format()}")
    if dev == "cuda":
        torch.cuda.synchronize()
    if dict(H.KERNEL_LAUNCHES) != before:
        fail("the pre-flight launched a kernel")
    print(f"pre-flight over the {len(TRAINED)} models trained on the card: "
          f"{time.perf_counter() - t0:.2f} s, findings by rule "
          f"{dict(sorted(by_rule.items()))}, no error, no kernel launched")


def link_rates(dev="cuda", mib=256, reps=10):
    """Phase 14 (d): host-to-device copies of ``mib`` MiB from pageable
    and from pinned memory, and a device-to-device copy, each the median
    of ``reps`` by CUDA events: {what: GB/s} (the device copy counts its
    bytes read and written)."""
    n = mib << 20
    pageable = torch.ones(n, dtype=torch.uint8)
    pinned = torch.ones(n, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(n, dtype=torch.uint8, device=dev)
    dst2 = torch.empty_like(dst)
    rates = {}
    for what, fn, nbytes in (
            ("pageable", lambda: dst.copy_(pageable), n),
            ("pinned", lambda: dst.copy_(pinned, non_blocking=True), n),
            ("device", lambda: dst2.copy_(dst), 2 * n)):
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / 1e3)
        rates[what] = nbytes / float(np.median(times)) / 1e9
    return rates


def plan_phase(H, BP, TT, records, text_aupr, titanic_out, card,
               dev="cuda"):
    """Phase 14: (a) plan-200k, (b) titanic's plan, (c) the pre-flight
    over every model trained on the card, (d) the link's rates. Returns
    plan-200k's launches."""
    from transmogrifai_tpu_torch import planner
    t_phase = time.perf_counter()
    launches, _model = plan_path(H, BP, records, text_aupr, dev)
    titanic_plan(H, TT, titanic_out, dev)
    preflight_all(H, dev)
    rates = link_rates(dev)
    print(f"host-to-device ({card}): pageable {rates['pageable']:.2f} "
          f"GB/s, pinned {rates['pinned']:.2f} GB/s; device-to-device "
          f"copy {rates['device']:.1f} GB/s (read + write); the planner's "
          f"priors: link {planner.LINK_PRIOR_MBPS:.0f} MB/s, device "
          f"{planner.STATIC_DEVICE_GBPS:.0f} GB/s")
    print(f"phase 14: {time.perf_counter() - t_phase:.2f} s")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from transmogrifai_tpu_torch import big_passenger as BP
    from transmogrifai_tpu_torch import boston as BO
    from transmogrifai_tpu_torch import dataprep as DP
    from transmogrifai_tpu_torch import iris as IR
    from transmogrifai_tpu_torch import mapprep as MP
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
    print(f"torch {torch.__version__}, CUDA runtime {torch.version.cuda}")
    t0 = time.perf_counter()
    H.build_kernels()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    if not load_native():
        fail("the native text hasher (native/fasthash.cc) did not build")
    print(f"native hasher build: {time.perf_counter() - t0:.1f} s")
    if timings_only:
        return timings(H, dev, BP, run)
    keep_trained_models()
    if "--stage-seconds" in sys.argv[1:]:
        return stage_seconds(BP, MP, DP)
    if "--serve-export-only" in sys.argv[1:]:
        records = BP.synthesize_records(N, seed=42)
        _, score_col = serve(H, BP, records, None)
        serve_export(H, records, score_col)
        check_predict_op(H, dev)
        return 0
    root = os.path.dirname(os.path.abspath(__file__))
    if "--every-surface-only" in sys.argv[1:]:
        rich_dsl_paths(H, TF, BO, IR, root)
        return 0
    if "--plan-only" in sys.argv[1:]:
        plan_phase(H, BP, TT, BP.synthesize_records(N, seed=42), None,
                   TT.run(device="cuda"), card)
        return 0

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
    stage_table(out["model"], "text-200k")
    check_fusion(out["model"], training_store(
        out["model"], records, selector_splitter(out["model"])),
        "text-200k")
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
    titanic_out = out
    if profile:
        profile_path(H, "titanic", lambda: TT.run(device="cuda"))
    agree({d: TT.run(device=d, families=titanic_one_point())
           for d in ("cuda", "cpu")},
          "titanic, one grid point a family")

    # -- phase 7: save, load and serve (the runner, the scoring engine) --
    path_launches["serve-200k"], score_col = serve(H, BP, records, text_aupr,
                                                   profile=profile)

    # -- phase 8: multiclass and regression (iris, boston) ---------------
    wide = check_multiclass_kernels(H, dev)
    data_dir = os.path.join(root, "build", "data")
    launches_by, iris = multiclass_paths(H, IR, BO, data_dir, profile)
    path_launches.update(launches_by)
    (path_launches["serve-iris"],
     path_launches["serve-iris-coded"]) = serve_iris(H, iris, root)

    # -- phase 9: every feature type; mapprep-200k ------------------------
    t0 = time.perf_counter()
    check_every_type()
    t1 = time.perf_counter()
    mapprep_records = MP.make_records(N, MAPPREP_SEED)
    mapprep_launches, worst = mapprep_paths(
        H, TF, MP, root, profile, records=mapprep_records,
        records_s=time.perf_counter() - t1)
    path_launches.update(mapprep_launches)
    for name, err in worst.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
    print(f"phase 9: {time.perf_counter() - t0:.2f} s")

    # -- phase 10: the guard rails; mapprep-guarded-200k ------------------
    guard_launches, worst, loco_row = guarded_paths(
        H, TF, MP, mapprep_records, root, profile)
    path_launches.update(guard_launches)
    for name, err in worst.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    # -- phase 11: the event-time readers; eventlog-200k -----------------
    event_launches, worst = eventlog_paths(H, TF, DP, root, profile)
    path_launches.update(event_launches)
    for name, err in worst.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    # -- phase 12: serving artifacts at serve-200k ------------------------
    path_launches["serve-export"] = serve_export(H, records, score_col)
    check_predict_op(H, dev)

    # -- phase 13: GLM, the MLP and the rich DSL --------------------------
    surface_launches, worst = rich_dsl_paths(H, TF, BO, IR, root)
    path_launches.update(surface_launches)
    for name, err in worst.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)

    # -- phase 14: the pre-flight, the planner and the run summary --------
    path_launches["plan-200k"] = plan_phase(H, BP, TT, records, text_aupr,
                                            titanic_out, card)

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
    print(f"predict_trees at the LOCO batch (phase 10, n={loco_row['n']}): "
          f"{loco_row['ms']:.4f} ms, plain {loco_row['plain_ms']:.4f} ms, "
          f"bound {1e3 * max(loco_row['bound']):.5f} ms")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
