"""The port's mesh (``transmogrifai_tpu_torch/parallel/mesh.py``) beside
``tests/test_parallel.py``: shapes, impossible splits, padding,
``shard_cv_inputs``, ``mesh_if_multi`` and the topology, in one process
(which never initializes ``torch.distributed``) and in one spawned gloo
world of two ranks (``tests/_torch_world.py``), whose every check runs in
one spawn."""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.parallel import mesh as jmesh
from transmogrifai_tpu_torch.parallel import mesh as M
from transmogrifai_tpu_torch.parallel import multihost

from _torch_world import run_world


@pytest.fixture(scope="module")
def world():
    """Both ranks' results of ``_torch_mesh_checks.parallel_world``."""
    return run_world(2, "_torch_mesh_checks:parallel_world", timeout=120)


@pytest.fixture
def _restore_process_mesh():
    prev = M.set_process_mesh(None)
    try:
        yield
    finally:
        M.set_process_mesh(prev)


# -- one process: the degenerate mesh, nothing initialized ------------------

def test_a_world_of_one_never_initializes_distributed(
        _restore_process_mesh):
    import torch.distributed as dist
    before = M.mesh_constructions()
    m = M.process_default_mesh()
    assert m is M.process_default_mesh()
    assert M.mesh_constructions() == before + 1
    assert m.shape == {"data": 1, "grid": 1} and m.size == 1
    assert M.mesh_if_multi(m) is None
    assert M.make_mesh(n_devices=1).shape == {"data": 1, "grid": 1}
    assert multihost.initialize() is False
    assert not dist.is_initialized()
    assert multihost.is_coordinator() and not multihost.is_distributed()
    assert multihost.process_summary()["process_count"] == 1


@pytest.mark.parametrize("kw, msg", [
    (dict(n_devices=4), r"n_devices=4 exceeds the world's 1 rank\(s\).*"
     r"torchrun --nproc-per-node 4"),
    (dict(n_devices=0), r"n_devices must be >= 1"),
    (dict(grid_axis=2), r"grid_axis=2 does not divide the 1 rank"),
])
def test_impossible_splits_raise_in_a_world_of_one(kw, msg):
    with pytest.raises(ValueError, match=msg):
        M.make_mesh(**kw)


def test_pad_rows_adds_zero_weight_rows_as_the_jax_package():
    rng = np.random.default_rng(0)
    X, y, w = rng.normal(size=(7, 3)), rng.normal(size=7), np.ones((2, 7))
    got = M.pad_rows(X, y, w, 4)
    want = jmesh.pad_rows(X, y, w, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[0].shape == (8, 3) and got[3] == 7
    assert not got[2][:, 7:].any()
    assert M.pad_rows(X[:4], y[:4], w[:, :4], 4)[3] == 4


@pytest.mark.parametrize("rank, data, grid", [(0, 2, 1), (1, 2, 1),
                                              (3, 2, 2), (2, 4, 1)])
def test_row_slices_cover_the_padded_rows(rank, data, grid):
    """A rank's rows (``data_sharding``, ``local_rows``) as the JAX
    package's ``P("data")`` gives them, padding zeros past n."""
    m = M.Mesh(np.arange(data * grid).reshape(data, grid), rank=rank)
    n = 11
    per = -(-n // data)
    di = rank // grid
    assert M.data_sharding(m, n) == slice(di * per, (di + 1) * per)
    X = np.arange(n * 2, dtype=np.float64).reshape(n, 2) + 1
    full = np.concatenate([X, np.zeros((per * data - n, 2))])
    np.testing.assert_array_equal(M.local_rows(m, X),
                                  full[di * per:(di + 1) * per])
    np.testing.assert_array_equal(
        M.local_rows(m, torch.as_tensor(X.T), axis=1).numpy(),
        full[di * per:(di + 1) * per].T)


def test_shard_cv_inputs_of_the_degenerate_mesh_are_the_inputs():
    m = M.make_mesh()
    X = np.arange(12.0).reshape(6, 2)
    y, w = np.arange(6.0), np.ones((3, 6))
    Xs, ys, ws, vs, n0 = M.shard_cv_inputs(m, X, y, w, extra=2 * w)
    assert n0 == 6
    for a, b in ((Xs, X), (ys, y), (ws, w), (vs, 2 * w)):
        np.testing.assert_array_equal(a, b)


def test_mesh_if_multi_and_the_topology_of_one_process():
    m = M.make_mesh()
    assert M.mesh_if_multi(None) is None and M.mesh_if_multi(False) is None
    assert M.mesh_if_multi(m) is None
    topo = M.mesh_topology(m)
    assert {k: topo[k] for k in ("devices", "data", "grid")} == \
        {"devices": 1, "data": 1, "grid": 1}
    assert topo["backend"] is None and topo["enabled"] is True
    assert set(jmesh.mesh_topology(jmesh.make_mesh(n_devices=1))) \
        <= set(topo)


def test_collectives_without_a_mesh_are_the_identity():
    t = torch.arange(6.0).reshape(3, 2)
    assert M.all_reduce(t, None) is t
    np.testing.assert_array_equal(M.gather_rows(None, t, 2).numpy(),
                                  t[:2].numpy())
    assert M.gather_axis(None, t).shape == (1, 3, 2)
    with M.sharded_scope(M.make_mesh()) as active:
        assert active is None and M.active_sharded_mesh() is None


def test_the_replicated_table_names_the_queued_items():
    assert sorted(M.REPLICATED.values()) == ["A6.6 (b) 1", "A6.6 (b) 2",
                                             "A6.6 (b) 3"]


# -- the world of two ranks -------------------------------------------------

def test_world_shapes(world):
    for r in world:
        assert r["shapes"] == {"2x1": {"data": 2, "grid": 1},
                               "1x2": {"data": 1, "grid": 2},
                               "auto": {"data": 1, "grid": 2}}
    assert [r["coords"] for r in world] == [
        {"2x1": (0, 0), "1x2": (0, 0)}, {"2x1": (1, 0), "1x2": (0, 1)}]


def test_world_rejects_impossible_splits(world):
    for r in world:
        errs = r["errors"]
        assert "n_devices=3 exceeds the world's 2 rank(s)" in \
            errs[str({"n_devices": 3})]
        assert "torchrun --nproc-per-node 3" in errs[str({"n_devices": 3})]
        assert "must be >= 1" in errs[str({"n_devices": 0})]
        assert "grid_axis=3 does not divide the 2 rank(s)" in \
            errs[str({"grid_axis": 3})]


def test_world_topology_backend_and_summary(world):
    for rank, r in enumerate(world):
        assert r["backend"] == "gloo"
        assert r["topology"] == {"devices": 2, "data": 2, "grid": 1,
                                 "platform": "cpu", "backend": "gloo",
                                 "enabled": True}
        assert r["summary"]["process_id"] == rank
        assert r["summary"]["process_count"] == 2
        assert r["coordinator"] is (rank == 0)
        assert r["multi"] == {"2x1": True, "1x2": True}
        assert r["device_mesh"] == (("data", "grid"), (2, 1))


def test_world_shard_cv_inputs_pads_and_slices(world):
    X = np.arange(7 * 3, dtype=np.float64).reshape(7, 3)
    y = np.arange(7, dtype=np.float64)
    Xp, yp, wp, n0 = M.pad_rows(X, y, np.ones((2, 7)), 2)
    for rank, r in enumerate(world):
        Xs, ys, ws, vs, n_orig = r["shard"]
        sl = slice(4 * rank, 4 * rank + 4)
        assert n_orig == 7 and r["slice"] == sl
        np.testing.assert_array_equal(Xs, Xp[sl])
        np.testing.assert_array_equal(ys, yp[sl])
        np.testing.assert_array_equal(ws, wp[:, sl])
        np.testing.assert_array_equal(vs, 2 * wp[:, sl])


def test_world_gathers_are_exact_and_alike(world):
    X = np.arange(7 * 3, dtype=np.float64).reshape(7, 3)
    for r in world:
        np.testing.assert_array_equal(r["gathered"], X)
        np.testing.assert_array_equal(r["axis"],
                                      [[0.0, -0.5], [1.0, -0.5]])
        assert r["sum"] == 3.0


def test_world_process_mesh_is_set_and_restored(world):
    for r in world:
        assert r["default_after_set"] is True
        assert r["constructions"] == 3


def test_workflow_set_mesh_and_its_resolution(_restore_process_mesh):
    """``Workflow.set_mesh(False)`` forces the single-process path; the
    default resolves the process mesh (1×1 here: None), and either way
    the DAG's selector is workflow-managed (``_mesh_auto``) with the
    resolved mesh, so a retrain re-resolves it."""
    from transmogrifai_tpu_torch import FeatureBuilder, Workflow
    from transmogrifai_tpu_torch.graph import compute_dag
    from transmogrifai_tpu_torch.models.linear import \
        LogisticRegressionFamily
    from transmogrifai_tpu_torch.models.selector import \
        BinaryClassificationModelSelector
    label = FeatureBuilder.RealNN("label").from_column().as_response()
    vec = FeatureBuilder.OPVector("v").from_column().as_predictor()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, families=[LogisticRegressionFamily()], splitter=None)
    pred = label.transform_with(sel, vec)
    wf = Workflow().set_result_features(pred)
    assert wf.mesh is None and wf.set_mesh(False) is wf
    stage = pred.origin_stage
    for mesh in (False, None):
        wf.set_mesh(mesh)
        wf._resolve_mesh(compute_dag(wf.result_features))
        assert wf._active_mesh is None
        assert stage.mesh is False and stage._mesh_auto is True
        assert M.stage_mesh(stage) is None
