"""What each rank of the mesh tests' worlds computes (``_torch_world``):
the same seeded data on every rank, the port's sharded paths over
several meshes, the results returned for the test process to hold
against the single-process port and the JAX package. Imports the port
only."""
import numpy as np
import torch

F64 = torch.float64


def tree_data(n=480, Fc=14, Fb=6, seed=5):
    """[n, Fc + Fb] reals (the last Fb columns 0/1), 0/1 labels, the
    indicator mask."""
    rng = np.random.default_rng(seed)
    Xc = rng.normal(size=(n, Fc))
    Xb = rng.integers(0, 2, size=(n, Fb)).astype(np.float64)
    X = np.concatenate([Xc, Xb], axis=1)
    y = ((Xc[:, 0] + 0.5 * Xc[:, 1] - Xb[:, 0] + rng.normal(size=n)) > 0)
    bmask = np.array([False] * Fc + [True] * Fb)
    return X, y.astype(np.float64), bmask


def hist_data(n=480, F=12, A=6, B=8, C=3, seed=7):
    """Integer stats [n, C], slots [n] (idle = A), bins [F, n] and a 0/1
    block [F, n]."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=(n, C)).astype(np.float64),
            rng.integers(0, A + 1, size=n).astype(np.int32),
            rng.integers(0, B, size=(F, n)).astype(np.int32),
            rng.integers(0, 2, size=(F, n)).astype(np.uint8))


FOREST_KW = dict(task="classification", n_classes=2, max_depth=5, n_bins=16,
                 min_instances=2.0, min_info_gain=0.0, subsample_rate=1.0,
                 max_active_nodes=16, seed=11)


def fit_trees(X, y, bmask, n_trees, unroll):
    """One forest (or decision tree) under whatever scope is active:
    its tables as numpy, the training rows' leaf aggregate gathered
    whole."""
    from transmogrifai_tpu_torch.models import _treefit as TF
    Xd, yd = torch.as_tensor(X, dtype=F64), torch.as_tensor(y, dtype=F64)
    out = TF.fit_forest(Xd, yd, torch.ones_like(yd), n_trees=n_trees,
                        num_trees_used=float(n_trees), binary_mask=bmask,
                        unroll=unroll, **FOREST_KW)
    agg = TF.rf_train_aggregate(out["leaf"], out["train_node"],
                                out["tree_w"], "classification")
    sh = TF.row_shard(X.shape[0])
    if sh is not None:
        agg = sh.gather(agg)
    return {k: out[k].numpy() for k in ("feat", "thr", "leaf", "gain")} | {
        "agg": agg.numpy()}


def fit_gbt(X, y, bmask):
    from transmogrifai_tpu_torch.models import _treefit as TF
    Xd, yd = torch.as_tensor(X, dtype=F64), torch.as_tensor(y, dtype=F64)
    out = TF.fit_gbt(Xd, yd, torch.ones_like(yd), task="classification",
                     n_rounds=4, max_depth=4, n_bins=16, min_instances=2.0,
                     min_info_gain=0.0, step_size=0.1, num_rounds_used=4.0,
                     binary_mask=bmask)
    sh = TF.row_shard(X.shape[0])
    m = out["train_margin"]
    return {"feat": out["feat"].numpy(), "thr": out["thr"].numpy(),
            "margin": (m if sh is None else sh.gather(m)).numpy()}


def sweep(families, X, y, mesh, task="binary", metric="AuPR", folds=2):
    """The [grid, folds] metric matrices of a CV sweep, by family."""
    from transmogrifai_tpu_torch.models.tuning import CrossValidation
    cv = CrossValidation(num_folds=folds, metric_name=metric, task=task,
                         seed=3)
    _f, _h, summary = cv.validate(families, X, y, device="cpu", dtype=F64,
                                  mesh=mesh)
    out = {}
    for r in summary.results:
        out.setdefault(r.family_name, []).append(r.metric_values)
    return {k: np.asarray(v) for k, v in out.items()}


def sweep_per_fold(families, X, y, bmask, mesh):
    """The [grid, folds] metric matrices of workflow-level CV
    (``validate_per_fold``: a matrix a fold, here the same X scaled by
    the fold), by family."""
    from transmogrifai_tpu_torch.models.tuning import CrossValidation
    cv = CrossValidation(num_folds=2, metric_name="AuPR", seed=3)
    folds = [((1.0 + k) * X, y, tr, va, bmask)
             for k, (tr, va) in enumerate(cv._splits(y))]
    _f, _h, summary = cv.validate_per_fold(families, folds, device="cpu",
                                           dtype=F64, mesh=mesh)
    out = {}
    for r in summary.results:
        out.setdefault(r.family_name, []).append(r.metric_values)
    return {k: np.asarray(v) for k, v in out.items()}


def rf_families(forest=True):
    """A 2-tree forest at depth 4 and a decision tree at depths 3 and 4
    (the decision tree alone with ``forest=False``)."""
    from transmogrifai_tpu_torch.models.trees import (DecisionTreeFamily,
                                                       RandomForestFamily)
    grid = [{"maxDepth": d, "minInstancesPerNode": 2, "minInfoGain": 0.0}
            for d in (3, 4)]
    dt = DecisionTreeFamily(grid=grid, max_active_nodes=16)
    if not forest:
        return [dt]
    return [RandomForestFamily(grid=grid[1:], num_trees=2,
                               max_active_nodes=16), dt]


def linear_families():
    from transmogrifai_tpu_torch.models.linear import \
        LogisticRegressionFamily
    from transmogrifai_tpu_torch.models.svm import LinearSVCFamily
    return [LogisticRegressionFamily(grid=[
        {"regParam": r, "elasticNetParam": e}
        for r in (0.01, 0.1) for e in (0.1, 0.5)]),
        LinearSVCFamily(grid=[{"regParam": r} for r in (0.01, 0.1)])]


def replicated_families():
    from transmogrifai_tpu_torch.models.svm import MLPFamily
    return [MLPFamily(grid=[{"stepSize": 0.03, "layers": (4,)}],
                      max_iter=10)]


def fitstats_store(n=3000, seed=9):
    from transmogrifai_tpu_torch import ColumnStore
    from transmogrifai_tpu_torch.columns import column_from_values
    from transmogrifai_tpu_torch.types import feature_types as ft
    rng = np.random.default_rng(seed)
    cols = {}
    for j in range(3):
        v = rng.normal(loc=j, size=n) * (1 + j)
        vals = [None if rng.random() < 0.1 else float(x) for x in v]
        cols[f"c{j}"] = column_from_values(ft.Real, vals)
    return ColumnStore(cols)


def moment_states(mesh):
    from transmogrifai_tpu_torch import fitstats
    store = fitstats_store()
    kinds = {nm: {"mean": [()], "variance": [()], "min": [()], "max": [()],
                  "count": [()]} for nm in store.names()}
    _b, states = fitstats._device_moment_bundles(
        store, kinds, torch.device("cpu"), F64,
        None if mesh is None else mesh)
    return {nm: (s.count, s.mean, s.m2, s.min, s.max)
            for nm, s in states.items()}


# ---------------------------------------------------------------------------
# the worlds
# ---------------------------------------------------------------------------

def tree_world():
    """Four ranks: the (2, 2) mesh over all of them, and (2, 1) and (1, 2)
    over ranks 0 and 1 (ranks 2 and 3 compute those alone)."""
    from transmogrifai_tpu_torch.models import _hist as H
    from transmogrifai_tpu_torch.models import _treefit as TF
    from transmogrifai_tpu_torch.parallel import mesh as M
    meshes = {"2x2": M.make_mesh(grid_axis=2), "2x1": M.make_mesh(
        n_devices=2), "1x2": M.make_mesh(n_devices=2, grid_axis=2)}
    res = {"member": {k: m.member for k, m in meshes.items()},
           "coord": {k: m.coord for k, m in meshes.items()}}
    st, node, XbT, X01 = hist_data()
    A, B = 6, 8
    for name in ("2x2", "2x1"):
        with TF.tree_mesh_scope(meshes[name]):
            sh = TF.row_shard(len(node))
            take = (lambda t, axis=0: t) if sh is None else sh.take
            s_l = take(torch.as_tensor(st))
            n_l = take(torch.as_tensor(node))
            h, h01 = TF._hist_sums([
                H.cumhist(s_l, n_l, take(torch.as_tensor(XbT), axis=1), A,
                          B),
                H.cumhist_sparse01(s_l, n_l, take(torch.as_tensor(X01),
                                                  axis=1), A)])
            res[f"hist/{name}"], res[f"sparse01/{name}"] = (h.numpy(),
                                                            h01.numpy())
    X, y, bmask = tree_data()
    cases = [("2x1", 1), ("2x2", 1), ("1x2", 2), ("2x2", 2)]
    for name, fs in cases:
        for n_trees in (1, 3):
            for unroll in (False, True):
                with TF.tree_mesh_scope(meshes[name]), \
                        TF.feature_shards_scope(fs):
                    res[f"trees/{name}/fs{fs}/{n_trees}/{int(unroll)}"] = \
                        fit_trees(X, y, bmask, n_trees, unroll)
    with TF.tree_mesh_scope(meshes["2x1"]):
        res["gbt/2x1"] = fit_gbt(X, y, bmask)
    fams = rf_families()
    for f in fams:
        f.binary_mask = bmask
    res["cv_rf/2x2"] = sweep(fams, X, y, meshes["2x2"])
    res["cv_per_fold/2x2"] = sweep_per_fold(rf_families(forest=False), X,
                                            y, bmask, meshes["2x2"])
    res["cv_linear/2x1"] = sweep(linear_families(), X, y, meshes["2x1"],
                                 folds=3)
    res["cv_replicated/2x2"] = sweep(replicated_families(), X, y,
                                     meshes["2x2"])
    res["moments/2x1"] = moment_states(M.mesh_if_multi(meshes["2x1"]))
    res["collectives"] = M.collective_stats()
    return res


def parallel_world():
    """Two ranks: meshes (2, 1) and (1, 2), their topology, row slices,
    gathers and the errors of impossible splits."""
    from transmogrifai_tpu_torch.parallel import mesh as M
    from transmogrifai_tpu_torch.parallel import multihost
    res = {"summary": multihost.process_summary(),
           "backend": multihost.backend(),
           "coordinator": multihost.is_coordinator()}
    errs = {}
    for kw in ({"n_devices": 3}, {"n_devices": 0}, {"grid_axis": 3}):
        try:
            M.make_mesh(**kw)
        except ValueError as e:
            errs[str(kw)] = str(e)
    res["errors"] = errs
    m21, m12 = M.make_mesh(), M.make_mesh(grid_axis=2)
    auto = M.make_mesh(grid_size=8)
    res["shapes"] = {"2x1": m21.shape, "1x2": m12.shape, "auto": auto.shape}
    res["topology"] = M.mesh_topology(m21)
    res["multi"] = {k: M.mesh_if_multi(m) is m
                    for k, m in (("2x1", m21), ("1x2", m12))}
    res["coords"] = {"2x1": m21.coord, "1x2": m12.coord}
    res["device_mesh"] = (tuple(m21.device_mesh.mesh_dim_names),
                          tuple(m21.device_mesh.shape))
    X = np.arange(7 * 3, dtype=np.float64).reshape(7, 3)
    y = np.arange(7, dtype=np.float64)
    w = np.ones((2, 7))
    Xs, ys, ws, vs, n0 = M.shard_cv_inputs(m21, X, y, w, extra=w * 2)
    res["shard"] = (Xs, ys, ws, vs, n0)
    res["slice"] = M.data_sharding(m21, 7)
    t = torch.as_tensor(M.local_rows(m21, X))
    res["gathered"] = M.gather_rows(m21, t, 7).numpy()
    res["axis"] = M.gather_axis(m12, torch.tensor(
        [float(m12.axis_index("grid")), -0.5]), "grid").numpy()
    s = torch.tensor([1.0 + m21.axis_index("data")])
    res["sum"] = M.all_reduce(s, m21, "data").item()
    prev = M.set_process_mesh(m12)
    res["default_after_set"] = M.process_default_mesh() is m12
    M.set_process_mesh(prev)
    res["constructions"] = M.mesh_constructions()
    return res


def _runner_flow(root, n=200, seed=42):
    """A two-feature workflow (LR and a forest, 2-fold CV) through the
    port's runner on the CPU in f64."""
    from transmogrifai_tpu_torch import FeatureBuilder, Workflow
    from transmogrifai_tpu_torch.dsl import transmogrify
    from transmogrifai_tpu_torch.evaluators import Evaluators
    from transmogrifai_tpu_torch.models.linear import \
        LogisticRegressionFamily
    from transmogrifai_tpu_torch.models.selector import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.models.trees import RandomForestFamily
    from transmogrifai_tpu_torch.runner import OpWorkflowRunner
    from transmogrifai_tpu_torch.utils import uid
    uid.reset()
    rng = np.random.default_rng(seed)
    yv = rng.integers(0, 2, n).astype(float)
    x1 = rng.normal(size=n) + yv
    x2 = rng.normal(size=n) - yv
    records = [{"label": float(yv[i]), "x1": float(x1[i]),
                "x2": float(x2[i])} for i in range(n)]
    label = FeatureBuilder.RealNN("label").from_column().as_response()
    vec = transmogrify([FeatureBuilder.Real(k).from_column().as_predictor()
                        for k in ("x1", "x2")])
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, splitter=None, seed=5, families=[
            LogisticRegressionFamily(grid=[{"regParam": 0.01,
                                            "elasticNetParam": 0.1}]),
            RandomForestFamily(grid=[{"maxDepth": 3,
                                      "minInstancesPerNode": 2,
                                      "minInfoGain": 0.0}], num_trees=3,
                               max_active_nodes=8)])
    pred = label.transform_with(sel, vec)

    class Reader:
        def read_records(self):
            return list(records)
    return OpWorkflowRunner(
        Workflow().set_result_features(pred), training_reader=Reader(),
        scoring_reader=Reader(),
        evaluator=Evaluators.BinaryClassification.auPR().set_columns(
            label, pred), device="cpu", dtype=F64)


def multihost_world():
    """Two ranks: a runner Train with ``meshDevices: 2`` over a process
    mesh pinned to (1, 2) beforehand, each rank's sinks under a directory
    of its own (only rank 0's may fill), then the ``OpApp`` with
    ``--mesh-devices 2``."""
    import json
    import os

    import torch.distributed as dist
    from transmogrifai_tpu_torch.parallel import mesh as M
    from transmogrifai_tpu_torch.runner import OpApp, OpParams, RunType
    rank = dist.get_rank()
    root = os.path.join(os.environ["TMOG_WORLD_DIR"], f"rank{rank}")
    pinned = M.make_mesh(grid_axis=2)
    M.set_process_mesh(pinned)
    params = OpParams(
        model_location=os.path.join(root, "model"),
        metrics_location=os.path.join(root, "metrics.json"),
        trace_location=os.path.join(root, "trace.json"),
        custom_params={"meshDevices": 2, "traceDir": os.path.join(
            root, "traces")})
    out = _runner_flow(root).run(RunType.TRAIN, params)
    sel = [m for m in out.model.fitted_stages.values()
           if type(m).__name__ == "SelectedModel"][0]
    res = {"rank": rank, "mesh": out.metrics["mesh"],
           "process": out.metrics["process"],
           "restored": M.process_default_mesh() is pinned,
           "on_mesh": out.metrics["telemetry"]["mesh"],
           "gauges": {k: v for k, v in json.loads(json.dumps(
               out.metrics["telemetryMetrics"], default=str)).items()
               if "mesh" in k},
           "validator": sel.selector_summary.validator_summary.to_json(),
           "written": sorted(os.listdir(root)) if os.path.isdir(root)
           else []}
    M.set_process_mesh(None)

    class App(OpApp):
        def runner(self, p):
            return _runner_flow(root)
    res["app_mesh"] = App().main(["--run-type", "Train", "--quiet",
                                  "--mesh-devices", "2"]).metrics["mesh"]
    return res
