"""The port's tree engine, CV sweep, linear solvers and statistics fold
over a mesh of ranks, beside ``tests/test_tree_mesh.py``: one spawned gloo
world of four ranks (``tests/_torch_world.py``) runs every check of this
file in one spawn over three meshes — (2, 2) over all four ranks, and
(2, 1) and (1, 2) over ranks 0 and 1, which ranks 2 and 3 are not part of
(they compute those alone) — and the test process holds the results
against the single-process port and the JAX package on one device (the
JAX package's sharded sweep is no oracle: ROADMAP C). Integer-weight
channels (gini counts, Poisson bootstrap counts) are held bitwise."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models import _treefit as JTF
from transmogrifai_tpu.parallel.mesh import make_mesh as jmake_mesh
from transmogrifai_tpu_torch.models import _hist as H
from transmogrifai_tpu_torch.models import _treefit as TF
from transmogrifai_tpu_torch.parallel import mesh as M

import _torch_mesh_checks as C
from _torch_world import run_world

TREE_CASES = [f"trees/{name}/fs{fs}/{t}/{u}"
              for name, fs in (("2x1", 1), ("2x2", 1), ("1x2", 2), ("2x2", 2))
              for t in (1, 3) for u in (0, 1)]


@pytest.fixture(scope="module")
def world():
    """The four ranks' results of ``_torch_mesh_checks.tree_world``."""
    return run_world(4, "_torch_mesh_checks:tree_world", timeout=240)


@pytest.fixture(scope="module")
def data():
    return C.tree_data()


def test_ranks_outside_a_mesh_compute_alone(world):
    assert [r["member"] for r in world] == [
        {"2x2": True, "2x1": True, "1x2": True}] * 2 + [
        {"2x2": True, "2x1": False, "1x2": False}] * 2
    assert [r["coord"]["2x2"] for r in world] == [(0, 0), (0, 1), (1, 0),
                                                  (1, 1)]
    for r in world:
        assert r["collectives"]["all_reduce"] > 0


@functools.lru_cache(maxsize=None)
def _histograms(kind):
    """(the single-process port's histogram, the JAX package's
    ``_sharded_cumhist`` on two devices) of ``kind``."""
    st, node, XbT, X01 = C.hist_data()
    A, B = 6, 8
    if kind == "hist":
        one = H.cumhist(torch.as_tensor(st), torch.as_tensor(node),
                        torch.as_tensor(XbT), A, B).numpy()
        jax_sharded = JTF._sharded_cumhist(
            jmake_mesh(n_devices=2), jnp.asarray(st), jnp.asarray(node),
            jnp.asarray(XbT), A, B)
    else:
        one = H.cumhist_sparse01(torch.as_tensor(st), torch.as_tensor(node),
                                 torch.as_tensor(X01), A).numpy()
        jax_sharded = JTF._sharded_cumhist(
            jmake_mesh(n_devices=2), jnp.asarray(st), jnp.asarray(node),
            jnp.asarray(X01.astype(np.int32)), A, 2, sparse01=True)
    return one, np.asarray(jax_sharded)


@pytest.mark.parametrize("kind", ["hist", "sparse01"])
@pytest.mark.parametrize("name", ["2x2", "2x1"])
def test_sharded_histograms_bitwise(world, kind, name):
    """Each rank's histogram of its rows summed over the ``data`` group
    equals the single-process histogram and the JAX package's
    ``_sharded_cumhist`` on two devices, bit for bit (integer stats)."""
    one, jax_sharded = _histograms(kind)
    np.testing.assert_array_equal(one, jax_sharded)
    for r in world:
        np.testing.assert_array_equal(r[f"{kind}/{name}"], one)


@pytest.mark.parametrize("case", TREE_CASES)
def test_trees_bitwise_against_one_process(world, data, case):
    """Decision trees and forests under both level drivers, row-sharded
    (2x1), row- and grid-split (2x2), column-sharded (1x2, featureShards
    2) and both (2x2, featureShards 2): every table bitwise the
    single-process fit's on every rank, the gathered training aggregate
    too."""
    X, y, bmask = data
    _t, _name, _fs, n_trees, unroll = case.split("/")
    ref = C.fit_trees(X, y, bmask, int(n_trees), bool(int(unroll)))
    for r in world:
        for k, v in ref.items():
            np.testing.assert_array_equal(r[case][k], v, err_msg=k)


def test_single_process_trees_match_the_jax_package(data):
    """The single-process oracle above is the JAX package's forest on one
    device (f64, one tree, the constant-slot driver): the same splits
    and leaves."""
    X, y, bmask = data
    ref = C.fit_trees(X, y, bmask, 1, False)
    kw = dict(C.FOREST_KW)
    out = JTF.fit_forest(
        jnp.asarray(X), jnp.asarray(y), jnp.ones(len(y)),
        task=kw["task"], n_classes=2, n_trees=1, max_depth=kw["max_depth"],
        n_bins=kw["n_bins"], min_instances=jnp.asarray(2.0),
        min_info_gain=jnp.asarray(0.0), num_trees_used=jnp.asarray(1),
        subsample_rate=jnp.asarray(1.0), binary_mask=bmask,
        max_active_nodes=kw["max_active_nodes"], seed=kw["seed"])
    np.testing.assert_array_equal(np.asarray(out["feat"])[0], ref["feat"][0])
    np.testing.assert_allclose(np.asarray(out["thr"])[0], ref["thr"][0])
    np.testing.assert_allclose(np.asarray(out["leaf"])[0], ref["leaf"][0],
                               rtol=1e-12, atol=1e-12)


def test_gbt_float_channels_keep_their_splits(world, data):
    """GBT's weighted channels are float sums in another order: the same
    splits, the margins within 1e-9 (f64)."""
    X, y, bmask = data
    ref = C.fit_gbt(X, y, bmask)
    for r in world:
        np.testing.assert_array_equal(r["gbt/2x1"]["feat"], ref["feat"])
        np.testing.assert_array_equal(r["gbt/2x1"]["thr"], ref["thr"])
        np.testing.assert_allclose(r["gbt/2x1"]["margin"], ref["margin"],
                                   rtol=0, atol=1e-9)


def test_rf_cv_metric_matrix_exact(world, data):
    """A forest and a decision tree swept over the (2, 2) mesh (folds
    split over ``grid``, rows over ``data``): the [grid, folds] metric
    matrices exactly the single-process sweep's on every rank."""
    X, y, bmask = data
    fams = C.rf_families()
    for f in fams:
        f.binary_mask = bmask
    ref = C.sweep(fams, X, y, None)
    for r in world:
        assert set(r["cv_rf/2x2"]) == set(ref)
        for name, m in ref.items():
            np.testing.assert_array_equal(r["cv_rf/2x2"][name], m)


def test_workflow_cv_metric_matrix_exact(world, data):
    """Workflow-level CV (a matrix a fold) swept over the (2, 2) mesh: the
    metric matrices exactly the single-process ``validate_per_fold``'s."""
    X, y, bmask = data
    ref = C.sweep_per_fold(C.rf_families(forest=False), X, y, bmask, None)
    for r in world:
        for name, m in ref.items():
            np.testing.assert_array_equal(r["cv_per_fold/2x2"][name], m)


def test_linear_fold_metrics_within_1e9(world, data):
    """LR and LinearSVC (the sweep's families that are not trees) with
    every row sum all-reduced: fold metrics within 1e-9 (f64)."""
    X, y, _bmask = data
    ref = C.sweep(C.linear_families(), X, y, None, folds=3)
    for r in world:
        for name, m in ref.items():
            np.testing.assert_allclose(r["cv_linear/2x1"][name], m,
                                       rtol=0, atol=1e-9)


def test_replicated_families_are_bitwise_unsharded(world, data):
    """A family the mesh does not shard (the MLP, A6.6 (b)) runs
    replicated: every rank fits on all rows, bitwise the single-process
    sweep."""
    X, y, _bmask = data
    ref = C.sweep(C.replicated_families(), X, y, None)
    assert not any(f.row_sharded for f in C.replicated_families())
    for r in world:
        for name, m in ref.items():
            np.testing.assert_array_equal(r["cv_replicated/2x2"][name], m)


def test_fitstats_fold_over_the_data_ranks(world):
    """The fused statistics pass's device tier folds each rank's pieces:
    counts, minima and maxima exact, the moments within rtol 1e-9."""
    ref = C.moment_states(None)
    for r in world:
        for col, (cnt, mean, m2, mn, mx) in ref.items():
            g = r["moments/2x1"][col]
            assert (g[0], g[3], g[4]) == (cnt, mn, mx)
            np.testing.assert_allclose(g[1:3], (mean, m2), rtol=1e-9)


def test_every_rank_holds_the_same_tables(world):
    """Every rank of a mesh ends with the same bits (the ranks outside
    the (2, 1) mesh agree with it where the result is exact)."""
    def flat(r):
        return {k: v for k, v in r.items()
                if k not in ("member", "coord", "collectives")}
    base = flat(world[0])
    for r in world[1:]:
        other = flat(r)
        assert set(other) == set(base)
        for k in base:
            if k.startswith("moments/") and not r["member"]["2x1"]:
                continue
            a, b = base[k], other[k]
            if isinstance(a, dict):
                for kk in a:
                    np.testing.assert_array_equal(np.asarray(a[kk]),
                                                  np.asarray(b[kk]))
            else:
                np.testing.assert_array_equal(a, b)


def test_feature_shards_engage_only_on_an_equal_grid_axis():
    assert TF._feature_shard_count() == 1
    with TF.feature_shards_scope(2):
        assert TF.active_feature_shards() == 2
        assert TF._feature_shard_count() == 1       # no mesh: off
        with TF.tree_mesh_scope(M.make_mesh()):
            assert TF.active_tree_mesh() is None
            assert TF._feature_shard_count() == 1
    assert TF.active_feature_shards() == 1
    with pytest.raises(ValueError, match=">= 1"):
        TF.set_feature_shards(0)
    assert TF.row_shard(100) is None


def test_epilogue_reads_winner_stats_from_a_table(data):
    """The level epilogue's ``win_stats`` input (the column-sharded
    level's): given each block's (bins, width) and the winners' left stats
    and totals, it writes what it writes from the histograms."""
    X, y, bmask = data
    Xd = torch.as_tensor(X)
    XbT, edges = TF.compute_bins(Xd, 16, bmask)
    blocks = TF.prepare_blocks(XbT, 16, bmask)
    n, A, D = X.shape[0], 4, 4
    rng = np.random.default_rng(3)
    slot = torch.as_tensor(rng.integers(0, A + 1, n).astype(np.int32))
    onehot = torch.nn.functional.one_hot(torch.as_tensor(y).long(), 2)
    stats = torch.cat([onehot.double(), torch.ones((n, 1), dtype=torch.float64)],
                      1)
    cums = [H.cumhist_sparse01(stats, slot, b.mat, A) if b.sparse01 else
            H.cumhist(stats, slot, b.mat, A, b.n_bins) for b in blocks]
    scans = [H.split_scan(c, "gini", 1.0) for c in cums]
    score = torch.stack([s[0] for s in scans])
    idx = torch.stack([s[1] for s in scans])
    valid = torch.stack([s[2] for s in scans])

    def run(win):
        rec = (torch.zeros((1 << D) + 1, dtype=torch.int32),
               torch.full(((1 << D) + 1,), float("inf"), dtype=torch.float64),
               torch.zeros((1 << D) + 1, dtype=torch.float64),
               torch.zeros(((1 << D) + 1, 3), dtype=torch.float64))
        shapes = cums if win is None else [(c.shape[2], c.shape[3])
                                           for c in cums]
        out = H.level_epilogue(
            score, idx, valid, shapes, [b.cols for b in blocks],
            [b.sparse01 for b in blocks], edges,
            torch.ones(A, dtype=torch.bool), torch.arange(A, dtype=torch.int32),
            XbT, slot, torch.zeros(n, dtype=torch.int32), *rec, kind="gini",
            lam=0.0, mig=torch.tensor(1e-10, dtype=torch.float64), d=2,
            max_depth=D, A_next=A, win_stats=win)
        return out, rec
    ref_out, ref_rec = run(None)
    # the winners' stats, as the column-sharded level merges them
    off, s_best = 0, None
    for bi, c in enumerate(cums):
        size = (c.shape[2] - 1) * c.shape[3]
        gi = off + idx[bi].long()
        lb = c[:, :, :-1, :].reshape(A, 3, size).gather(
            2, idx[bi].long()[:, None, None].expand(A, 3, 1))[:, :, 0]
        if s_best is None:
            s_best, best, lst = score[bi], gi, lb
        else:
            take = (score[bi] > s_best) | ((score[bi] == s_best)
                                           & (gi < best))
            best = torch.where(take, gi, best)
            lst = torch.where(take[:, None], lb, lst)
            s_best = torch.where(take, score[bi], s_best)
        off += size
    win = torch.stack([lst, cums[0][:, :, -1, 0]])
    out, rec = run(win)
    for a, b in zip(out + rec, ref_out + ref_rec):
        if a is not None:
            torch.testing.assert_close(a, b, rtol=0, atol=0)
