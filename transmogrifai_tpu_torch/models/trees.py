"""Tree stages: random forests, decision trees, GBT and XGBoost-style —
the port of ``transmogrifai_tpu/models/trees.py``.

Parity targets (reference): ``OpRandomForestClassifier``,
``OpDecisionTreeClassifier``, ``OpGBTClassifier``,
``OpXGBoostClassifier`` (``OpXGBoostClassifier.scala:46``) and their
regressors (a family's ``task="regression"``), fit with the
histogram engine in ``models/_treefit.py``. The JAX package vmaps the
grid into one program; here grid points are a Python loop. Below
``UNROLL_MIN_ROWS`` rows every point grows the family's deepest tree with
a depth gate (the constant-slot driver); at and above it a single-depth
group grows unrolled trees at its own depth, as the JAX CV engine's
static-depth groups do.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..parallel import mesh as _mesh
from ..stages.base import register_stage
from . import _treefit as TF
from .base import (ModelFamily, PredictorEstimator, PredictorModel,
                   device_table, extract_xy, resolve_device)

__all__ = ["TreeEnsembleModel", "RandomForestFamily", "DecisionTreeFamily",
           "GBTFamily", "XGBoostFamily", "OpRandomForestClassifier",
           "OpRandomForestRegressor", "OpDecisionTreeClassifier",
           "OpDecisionTreeRegressor", "OpGBTClassifier", "OpGBTRegressor",
           "OpXGBoostClassifier", "OpXGBoostRegressor",
           "tree_model_from_numpy",
           "detect_binary_columns", "UNROLL_MIN_ROWS"]

#: row count from which a single-depth fit grows unrolled trees (per-level
#: slot growth + sibling subtraction) instead of the gated constant-slot
#: driver
UNROLL_MIN_ROWS = 131_072

_MAX_DEPTH_DEFAULT = (3, 6, 12)        # DefaultSelectorParams.MaxDepth
_MIN_INST_DEFAULT = (10, 100)          # .MinInstancesPerNode
_MIN_GAIN_DEFAULT = (0.001, 0.01, 0.1)  # .MinInfoGain
#: fit-time caches that never leave the sweep
_CACHES = ("train_margin", "train_node")


def detect_binary_columns(X: np.ndarray) -> Optional[np.ndarray]:
    """Host-side [F] bool: columns whose values are all in {0, 1}."""
    mask = np.all((X == 0.0) | (X == 1.0), axis=0)
    return mask if mask.any() else None


# ---------------------------------------------------------------------------
# Fitted model
# ---------------------------------------------------------------------------

@register_stage
class TreeEnsembleModel(PredictorModel):
    """Stacked level-order trees + per-tree weights; ``kind`` selects the
    head (``rf_classification``, ``rf_regression``, ``gbt_classification``,
    ``xgb_classification``, ``gbt_regression``, ``xgb_regression``)."""

    operation_name = "trees"

    def __init__(self, kind: str = "gbt_classification", n_classes: int = 2,
                 max_depth: int = 6, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.kind = kind
        self.n_classes = int(n_classes)
        self.max_depth = int(max_depth)
        self.trees: Dict[str, np.ndarray] = {}

    def _tables(self, device: torch.device) -> Dict[str, torch.Tensor]:
        """The tables the descent reads, on ``device``: uploaded by the
        first call there, the features as int32."""
        out = {k: device_table(self, f"tree_{k}", lambda k=k: self.trees[k],
                               device) for k in ("thr", "leaf", "tree_w")}
        out["feat"] = device_table(
            self, "tree_feat", lambda: np.asarray(self.trees["feat"],
                                                  dtype=np.int32), device)
        return out

    def predict_device(self, Xd: torch.Tensor):
        """(prediction, raw, prob) tensors on ``Xd``'s device. The tables
        keep the trees' dtype and X follows it."""
        p = self._tables(Xd.device)
        Xd = Xd.to(p["leaf"].dtype)
        if self.kind == "rf_classification":
            return TF.predict_rf_classification(p, Xd, self.max_depth,
                                                self.n_classes)
        if self.kind == "rf_regression":
            return TF.predict_rf_regression(p, Xd, self.max_depth)
        if self.kind.endswith("_classification"):
            scale = 2.0 if self.kind.startswith("gbt") else 1.0
            return TF.predict_margin_classification(p, Xd, self.max_depth,
                                                    margin_scale=scale)
        return TF.predict_margin_regression(p, Xd, self.max_depth)

    def get_model_state(self) -> Dict[str, Any]:
        state = {f"tree_{k}": np.asarray(v) for k, v in self.trees.items()}
        state["kind"] = self.kind
        return state

    def apply_model_state(self, state: Dict[str, Any]) -> None:
        self.trees = {k[5:]: np.asarray(v) for k, v in state.items()
                      if k.startswith("tree_") and k[5:] not in _CACHES}
        if "kind" in state:
            self.kind = str(state["kind"])
        self.__dict__.pop("_device_tables", None)

    def summary(self) -> Dict[str, Any]:
        t = self.trees.get("tree_w")
        return {"model": "TreeEnsemble", "kind": self.kind,
                "numTrees": int(t.shape[0]) if t is not None else 0,
                "maxDepth": self.max_depth}


def tree_model_from_numpy(kind: str, n_classes: int, max_depth: int,
                          trees: Dict[str, Any]) -> TreeEnsembleModel:
    """A fitted ensemble from its numpy tables (``feat``, ``thr``,
    ``leaf``, ``tree_w``, ``gain``); the fit-time caches are dropped."""
    model = TreeEnsembleModel(kind=kind, n_classes=n_classes,
                              max_depth=max_depth)
    model.apply_model_state({f"tree_{k}": v for k, v in trees.items()})
    return model


# ---------------------------------------------------------------------------
# Families
# ---------------------------------------------------------------------------

class _TreeFamilyBase(ModelFamily):
    """Shared grid handling for the tree families."""

    task = "classification"
    row_sharded = True
    n_bins = 32                      # DefaultSelectorParams.MaxBin

    def __init__(self, grid=None, n_classes: int = 2,
                 max_active_nodes: int = 128, seed: int = 7):
        super().__init__(grid)
        self.n_classes = n_classes
        self.max_active_nodes = max_active_nodes
        self.seed = seed
        #: host-side [F] bool of indicator columns (set by the selector
        #: from its prepared matrix); they get the 2-bin sparse01 block
        self.binary_mask = None

    def _static_trees(self) -> int:
        raise NotImplementedError

    def _head(self) -> str:
        raise NotImplementedError

    def _fit_single(self, X, y, w, depth: int, n_trees: int,
                    hp: Dict[str, Any], depth_limit: Optional[int],
                    unroll: bool) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def global_depth(self) -> int:
        dflt = self.param_defaults()["maxDepth"]
        return int(max(int(g.get("maxDepth", dflt)) for g in self.grid))

    def device_prep(self, Xd: torch.Tensor) -> Dict[str, Any]:
        """Bin the feature matrix once per (data, binning config):
        ``{"XbT": [F, n] int32, "edges", "blocks", "shard"}`` (the
        histogram blocks of ``binary_mask``; over a tree mesh this rank's
        rows of the whole ``Xd``, its row shard in ``shard``, else None)
        — accepted by fit_batch and predict_batch in place of raw X. A
        forest of more classes than the card's kernels take raises here
        on the card, before the sweep launches anything."""
        if self._head() == "rf":
            TF.check_card_classes(self.task, self.n_classes, Xd.device)
        shard = TF.row_shard(Xd.shape[0])
        XbT, edges = TF.compute_bins(Xd, self.n_bins, self.binary_mask,
                                     shard)
        return {"XbT": XbT, "edges": edges,
                "blocks": TF.prepare_blocks(XbT, self.n_bins,
                                            self.binary_mask),
                "shard": shard}

    def _point(self, g: Dict[str, Any]) -> Dict[str, Any]:
        hp = dict(self.param_defaults())
        hp.update(g)
        return hp

    def fit_batch(self, X, y, w, grid=None,
                  static_depth: Optional[int] = None) -> List[Dict]:
        """One params dict per grid point. ``static_depth`` → unrolled
        trees of exactly that depth (every point must have it); otherwise
        the family's deepest tree with each point's ``maxDepth`` gate."""
        grid = self.grid if grid is None else grid
        unroll = static_depth is not None
        D = int(static_depth) if unroll else self.global_depth()
        n_trees = self._static_trees()
        return [self._fit_single(
            X, y, w, D, n_trees, self._point(g),
            None if unroll else int(self._point(g)["maxDepth"]), unroll)
            for g in grid]

    def fit_prepared(self, Xd: torch.Tensor, y, w, grid=None):
        """Bin once, then fit (unrolled at a single depth from
        ``UNROLL_MIN_ROWS`` rows). Returns (params list, binned X) — the
        binned X serves ``predict_batch(..., on_train=True)``."""
        grid = self.grid if grid is None else grid
        Xarg = self.device_prep(Xd)
        dflt = self.param_defaults().get("maxDepth", 0)
        depths = {int(g.get("maxDepth", dflt)) for g in grid}
        sd = (depths.pop() if len(depths) == 1
              and Xd.shape[0] >= UNROLL_MIN_ROWS else None)
        return self.fit_batch(Xarg, y, w, grid, static_depth=sd), Xarg

    def _prebinned(self, X):
        if isinstance(X, dict):
            return (X["XbT"], X["edges"], X["blocks"], X["shard"]), None
        return None, X

    def predict_batch(self, params: List[Dict], X, on_train: bool = False):
        """(prediction, raw, prob) per grid point. ``on_train=True`` (X IS
        the training matrix the fit saw) answers from the fit-time caches:
        leaf gathers at ``train_node`` (forests) or the margins
        (boosting), every rank's rows gathered over a tree mesh (``X``'s
        row shard); otherwise the trees route the raw X."""
        head = self._head()
        scale = 2.0 if head == "gbt" else 1.0
        if on_train:
            dt = X["edges"].dtype if isinstance(X, dict) else X.dtype
            shard = X.get("shard") if isinstance(X, dict) else None

            def whole(t):
                return t if shard is None else shard.gather(t)
            if head == "rf":
                return [TF.rf_head(whole(TF.rf_train_aggregate(
                    p["leaf"], p["train_node"], p["tree_w"], self.task)),
                    dt, self.task) for p in params]
            return [TF.margin_head(whole(p["train_margin"]), scale, dt,
                                   self.task) for p in params]
        if isinstance(X, dict):
            raise ValueError("routed prediction needs the raw feature matrix")
        D = self.global_depth()
        if head == "rf":
            if self.task == "classification":
                return [TF.predict_rf_classification(p, X, D, self.n_classes)
                        for p in params]
            return [TF.predict_rf_regression(p, X, D) for p in params]
        if self.task == "regression":
            return [TF.predict_margin_regression(p, X, D) for p in params]
        return [TF.predict_margin_classification(p, X, D, scale)
                for p in params]

    def realize(self, params, hparams) -> TreeEnsembleModel:
        return tree_model_from_numpy(
            f"{self._head()}_{self.task}", self.n_classes,
            self.global_depth(),
            {k: v.detach().cpu().numpy() for k, v in params.items()
             if k not in _CACHES})


class RandomForestFamily(_TreeFamilyBase):
    """RF grid = MaxDepth × MinInstancesPerNode × MinInfoGain
    (BinaryClassificationModelSelector.scala:52-128), numTrees = 50.

    Every fold and grid point of a sweep reads the same random draws
    (their keys depend on the seed and the tree alone), so the family
    keeps them per (rows, depth, slots, dtype, device) in ``_draws``."""

    name = "OpRandomForestClassifier"
    default_grid = [
        {"maxDepth": d, "minInstancesPerNode": mi, "minInfoGain": mg}
        for d in _MAX_DEPTH_DEFAULT for mi in _MIN_INST_DEFAULT
        for mg in _MIN_GAIN_DEFAULT
    ]

    def __init__(self, grid=None, task: Optional[str] = None,
                 n_classes: int = 2, num_trees: int = 50, seed: int = 7,
                 per_node_features: bool = True,
                 max_active_nodes: int = 128):
        super().__init__(grid, n_classes=n_classes,
                         max_active_nodes=max_active_nodes, seed=seed)
        self.num_trees = num_trees
        #: Spark-parity per-node candidate feature sampling (MLlib
        #: featureSubsetStrategy); False draws one mask per tree
        self.per_node_features = per_node_features
        if task == "regression":
            self.name = "OpRandomForestRegressor"
            self.task = "regression"
        self._draws: Dict[tuple, TF.ForestDraws] = {}

    def param_defaults(self):
        return {"maxDepth": 6, "minInstancesPerNode": 10,
                "minInfoGain": 0.001, "numTrees": self.num_trees,
                "subsamplingRate": 1.0}

    def _head(self) -> str:
        return "rf"

    def _static_trees(self) -> int:
        return int(max(int(g.get("numTrees", self.num_trees))
                       for g in self.grid))

    def _fit_single(self, X, y, w, depth, n_trees, hp, depth_limit, unroll):
        prebinned, Xraw = self._prebinned(X)
        draws = None
        if prebinned is not None:
            XbT, _edges, blocks, shard = prebinned
            # the draws are the whole input's (sliced per rank in the fit)
            n = XbT.shape[1] if shard is None else shard.n
            cap = TF.slot_cap(depth, self.max_active_nodes, unroll)
            key = (n, n_trees, depth, cap, w.dtype, w.device)
            draws = self._draws.get(key)
            if draws is None:
                draws = self._draws[key] = TF.forest_draws(
                    self.seed, n_trees, n, self.task, depth, cap,
                    blocks, w.dtype, w.device, self.per_node_features)
        return TF.fit_forest(
            Xraw, y, w, task=self.task, n_classes=self.n_classes,
            n_trees=n_trees, max_depth=depth, n_bins=self.n_bins,
            min_instances=float(hp["minInstancesPerNode"]),
            min_info_gain=float(hp["minInfoGain"]),
            num_trees_used=float(hp["numTrees"]),
            subsample_rate=float(hp["subsamplingRate"]),
            depth_limit=depth_limit, max_active_nodes=self.max_active_nodes,
            binary_mask=self.binary_mask, seed=self.seed,
            per_node_features=self.per_node_features, prebinned=prebinned,
            unroll=unroll, draws=draws)


class DecisionTreeFamily(RandomForestFamily):
    """Single unbagged tree, all features (OpDecisionTreeClassifier);
    inherits the RF MaxDepth × MinInstancesPerNode × MinInfoGain grid."""

    name = "OpDecisionTreeClassifier"

    def __init__(self, grid=None, task: Optional[str] = None,
                 n_classes: int = 2, seed: int = 7,
                 max_active_nodes: int = 128):
        super().__init__(grid, task=task, n_classes=n_classes, num_trees=1,
                         seed=seed, max_active_nodes=max_active_nodes)
        self.name = ("OpDecisionTreeRegressor" if self.task == "regression"
                     else "OpDecisionTreeClassifier")

    def param_defaults(self):
        d = super().param_defaults()
        d["numTrees"] = 1
        return d

    def _static_trees(self) -> int:
        return 1


class GBTFamily(_TreeFamilyBase):
    """GBT grid = MaxDepth × MinInstancesPerNode × MinInfoGain,
    maxIter=20 rounds, stepSize=0.1 (DefaultSelectorParams)."""

    name = "OpGBTClassifier"
    default_grid = [
        {"maxDepth": d, "minInstancesPerNode": mi, "minInfoGain": mg}
        for d in _MAX_DEPTH_DEFAULT for mi in _MIN_INST_DEFAULT
        for mg in _MIN_GAIN_DEFAULT
    ]

    def __init__(self, grid=None, task: Optional[str] = None,
                 n_classes: int = 2, max_iter: int = 20,
                 max_active_nodes: int = 128):
        super().__init__(grid, n_classes=n_classes,
                         max_active_nodes=max_active_nodes)
        self.max_iter = max_iter
        if task == "regression":
            self.name = "OpGBTRegressor"
            self.task = "regression"

    def param_defaults(self):
        return {"maxDepth": 6, "minInstancesPerNode": 10,
                "minInfoGain": 0.001, "maxIter": self.max_iter,
                "stepSize": 0.1}

    def _head(self) -> str:
        return "gbt"

    def _static_trees(self) -> int:
        return int(max(int(g.get("maxIter", self.max_iter))
                       for g in self.grid))

    def _fit_single(self, X, y, w, depth, n_trees, hp, depth_limit, unroll):
        prebinned, Xraw = self._prebinned(X)
        return TF.fit_gbt(
            Xraw, y, w, task=self.task, n_rounds=n_trees, max_depth=depth,
            n_bins=self.n_bins,
            min_instances=float(hp["minInstancesPerNode"]),
            min_info_gain=float(hp["minInfoGain"]),
            step_size=float(hp["stepSize"]),
            num_rounds_used=float(hp["maxIter"]), depth_limit=depth_limit,
            max_active_nodes=self.max_active_nodes,
            binary_mask=self.binary_mask, prebinned=prebinned, unroll=unroll)


class XGBoostFamily(_TreeFamilyBase):
    """XGB grid = NumRound × Eta × MaxDepth × MinChildWeight
    (BinaryClassificationModelSelector.scala:119-124)."""

    name = "OpXGBoostClassifier"
    default_grid = [
        {"maxDepth": d, "eta": e, "minChildWeight": mc, "numRound": 100}
        for d in _MAX_DEPTH_DEFAULT for e in (0.1, 0.3)
        for mc in (1.0, 5.0, 10.0)
    ]

    def __init__(self, grid=None, task: Optional[str] = None,
                 n_classes: int = 2, reg_lambda: float = 1.0,
                 max_active_nodes: int = 128):
        super().__init__(grid, n_classes=n_classes,
                         max_active_nodes=max_active_nodes)
        self.reg_lambda = reg_lambda
        if task == "regression":
            self.name = "OpXGBoostRegressor"
            self.task = "regression"

    def param_defaults(self):
        return {"maxDepth": 6, "eta": 0.3, "minChildWeight": 1.0,
                "numRound": 100}

    def _head(self) -> str:
        return "xgb"

    def _static_trees(self) -> int:
        return int(max(int(g.get("numRound", 100)) for g in self.grid))

    def _fit_single(self, X, y, w, depth, n_trees, hp, depth_limit, unroll):
        prebinned, Xraw = self._prebinned(X)
        return TF.fit_xgb(
            Xraw, y, w, task=self.task, n_rounds=n_trees, max_depth=depth,
            n_bins=self.n_bins, eta=float(hp["eta"]), lam=self.reg_lambda,
            min_child_weight=float(hp["minChildWeight"]),
            num_rounds_used=float(hp["numRound"]), depth_limit=depth_limit,
            max_active_nodes=self.max_active_nodes,
            binary_mask=self.binary_mask, prebinned=prebinned, unroll=unroll)


# ---------------------------------------------------------------------------
# Standalone estimator stages
# ---------------------------------------------------------------------------

class _TreeEstimatorBase(PredictorEstimator):
    task = "classification"
    #: the ranks the fit shards over: None resolves to the process-default
    #: mesh (a workflow assigns its resolved one), False forces the
    #: single-process path
    mesh = None

    def _family(self, n_classes: int) -> _TreeFamilyBase:
        raise NotImplementedError

    def fit_columns(self, store, device=None,
                    dtype: torch.dtype = torch.float32) -> TreeEnsembleModel:
        X, y = extract_xy(store, self.label_name, self.features_name)
        n_classes = (max(int(y.max()) + 1 if len(y) else 2, 2)
                     if self.task == "classification" else 2)
        fam = self._family(n_classes)
        fam.binary_mask = detect_binary_columns(X)
        dev = resolve_device(device)
        Xd = torch.as_tensor(X, dtype=dtype, device=dev)
        with TF.tree_mesh_scope(_mesh.stage_mesh(self)):
            params, _ = fam.fit_prepared(
                Xd, torch.as_tensor(y, dtype=dtype, device=dev),
                torch.ones((X.shape[0],), dtype=dtype, device=dev))
        return fam.realize(params[0], fam.grid[0])


@register_stage
class OpRandomForestClassifier(_TreeEstimatorBase):
    operation_name = "randomForest"

    def __init__(self, num_trees: int = 20, max_depth: int = 5,
                 min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, subsampling_rate: float = 1.0,
                 max_active_nodes: int = 128, seed: int = 7,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.num_trees = num_trees
        self.max_depth = max_depth
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.subsampling_rate = subsampling_rate
        self.max_active_nodes = max_active_nodes
        self.seed = seed

    def _family(self, n_classes):
        return RandomForestFamily(
            grid=[{"maxDepth": self.max_depth,
                   "minInstancesPerNode": self.min_instances_per_node,
                   "minInfoGain": self.min_info_gain,
                   "numTrees": self.num_trees,
                   "subsamplingRate": self.subsampling_rate}],
            task=self.task, n_classes=n_classes, num_trees=self.num_trees,
            max_active_nodes=self.max_active_nodes, seed=self.seed)


@register_stage
class OpRandomForestRegressor(OpRandomForestClassifier):
    operation_name = "randomForestReg"
    task = "regression"


@register_stage
class OpDecisionTreeClassifier(_TreeEstimatorBase):
    operation_name = "decisionTree"

    def __init__(self, max_depth: int = 5, min_instances_per_node: int = 1,
                 min_info_gain: float = 0.0, max_active_nodes: int = 128,
                 seed: int = 7, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_depth = max_depth
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.max_active_nodes = max_active_nodes
        self.seed = seed

    def _family(self, n_classes):
        return DecisionTreeFamily(
            grid=[{"maxDepth": self.max_depth,
                   "minInstancesPerNode": self.min_instances_per_node,
                   "minInfoGain": self.min_info_gain}],
            task=self.task, n_classes=n_classes,
            max_active_nodes=self.max_active_nodes, seed=self.seed)


@register_stage
class OpDecisionTreeRegressor(OpDecisionTreeClassifier):
    operation_name = "decisionTreeReg"
    task = "regression"


@register_stage
class OpGBTClassifier(_TreeEstimatorBase):
    operation_name = "gbtClassifier"

    def __init__(self, max_iter: int = 20, max_depth: int = 5,
                 min_instances_per_node: int = 1, min_info_gain: float = 0.0,
                 step_size: float = 0.1, max_active_nodes: int = 128,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.max_iter = max_iter
        self.max_depth = max_depth
        self.min_instances_per_node = min_instances_per_node
        self.min_info_gain = min_info_gain
        self.step_size = step_size
        self.max_active_nodes = max_active_nodes

    def _family(self, n_classes):
        return GBTFamily(
            grid=[{"maxDepth": self.max_depth,
                   "minInstancesPerNode": self.min_instances_per_node,
                   "minInfoGain": self.min_info_gain,
                   "maxIter": self.max_iter, "stepSize": self.step_size}],
            task=self.task, n_classes=n_classes, max_iter=self.max_iter,
            max_active_nodes=self.max_active_nodes)


@register_stage
class OpGBTRegressor(OpGBTClassifier):
    operation_name = "gbtRegressor"
    task = "regression"


@register_stage
class OpXGBoostClassifier(_TreeEstimatorBase):
    operation_name = "xgbClassifier"

    def __init__(self, num_round: int = 100, max_depth: int = 6,
                 eta: float = 0.3, min_child_weight: float = 1.0,
                 reg_lambda: float = 1.0, max_active_nodes: int = 128,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.num_round = num_round
        self.max_depth = max_depth
        self.eta = eta
        self.min_child_weight = min_child_weight
        self.reg_lambda = reg_lambda
        self.max_active_nodes = max_active_nodes

    def _family(self, n_classes):
        return XGBoostFamily(
            grid=[{"maxDepth": self.max_depth, "eta": self.eta,
                   "minChildWeight": self.min_child_weight,
                   "numRound": self.num_round}],
            task=self.task, n_classes=n_classes, reg_lambda=self.reg_lambda,
            max_active_nodes=self.max_active_nodes)


@register_stage
class OpXGBoostRegressor(OpXGBoostClassifier):
    operation_name = "xgbRegressor"
    task = "regression"
