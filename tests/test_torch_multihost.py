"""The port's multi-rank entry (``transmogrifai_tpu_torch/parallel/
multihost.py`` and the runner's mesh keys) beside
``tests/test_multihost.py``: one process joins nothing; a spawned gloo
world of two ranks (``tests/_torch_world.py``) trains through the runner
with ``meshDevices: 2``, each rank's sinks pointed at a directory of its
own, and only rank 0's fills; then ``OpApp --mesh-devices 2`` runs in
the same world."""
import os

import numpy as np
import pytest

from transmogrifai_tpu_torch.parallel import multihost
from transmogrifai_tpu_torch.runner import OpParams, RunType

import _torch_mesh_checks as C
from _torch_world import run_world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("world"))
    return root, run_world(2, "_torch_mesh_checks:multihost_world",
                           timeout=180, env={"TMOG_WORLD_DIR": root})


def test_one_process_joins_nothing(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False
    assert multihost.backend() is None
    assert multihost.is_coordinator() and not multihost.is_distributed()
    multihost.barrier()


def test_a_world_of_one_under_torchrun_joins_nothing(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert multihost.initialize() is False


def test_process_summary_shape():
    s = multihost.process_summary()
    assert set(s) >= {"process_id", "process_count", "local_devices",
                      "global_devices"}
    assert (s["process_id"], s["process_count"]) == (0, 1)


def test_a_worker_rank_fails_fast_without_a_complete_sibling(
        monkeypatch, tmp_path):
    """A rank other than the coordinator waits for a repaired checkpoint
    only while a complete ``.tmp`` / ``.old`` sibling exists."""
    import time

    from transmogrifai_tpu_torch import model_io
    monkeypatch.setattr(multihost, "is_coordinator", lambda: False)
    path = str(tmp_path / "ckpt")
    os.makedirs(path + ".tmp")              # torn: no MODEL_JSON
    t0 = time.perf_counter()
    assert model_io._recover_checkpoint(path) == path
    assert time.perf_counter() - t0 < 0.4
    os.makedirs(path + ".old")
    open(os.path.join(path + ".old", model_io.MODEL_JSON), "w").close()
    monkeypatch.setattr(time, "sleep", lambda s: None)
    assert model_io._recover_checkpoint(path) == path + ".old"


def test_only_rank_zero_writes(world):
    root, res = world
    assert res[0]["written"] == ["metrics.json", "model", "trace.json",
                                 "traces"]
    assert res[1]["written"] == []
    assert not os.path.exists(os.path.join(root, "rank1"))


def test_every_rank_trains_the_same_model(world):
    _root, res = world
    assert res[0]["validator"] == res[1]["validator"]


def test_the_world_trains_what_one_process_trains(world, tmp_path):
    """The two-rank Train's sweep against the same runner in one process:
    the same winner, the fold metrics within 1e-9 (f64)."""
    _root, res = world
    out = C._runner_flow(str(tmp_path)).run(RunType.TRAIN, OpParams())
    sel = [m for m in out.model.fitted_stages.values()
           if type(m).__name__ == "SelectedModel"][0]
    one = sel.selector_summary.validator_summary.to_json()
    got = res[0]["validator"]
    assert got["bestModelName"] == one["bestModelName"]
    assert got["bestModelParams"] == one["bestModelParams"]
    for a, b in zip(got["results"], one["results"]):
        assert a["model"] == b["model"]
        np.testing.assert_allclose(a["metricPerFold"], b["metricPerFold"],
                                   rtol=0, atol=1e-9)


def test_metrics_document_mesh_and_process_blocks(world):
    _root, res = world
    for rank, r in enumerate(res):
        assert r["mesh"] == {"devices": 2, "data": 2, "grid": 1,
                             "platform": "cpu", "backend": "gloo",
                             "enabled": True}
        assert r["process"]["process_id"] == rank
        assert r["process"]["process_count"] == 2
        assert r["process"]["backend"] == "gloo"


def test_the_previous_mesh_is_restored(world):
    _root, res = world
    assert [r["restored"] for r in res] == [True, True]


def test_mesh_devices_flag_runs_in_the_world(world):
    _root, res = world
    for r in res:
        assert (r["app_mesh"]["devices"], r["app_mesh"]["data"]) == (2, 2)


def test_train_reports_its_mesh_to_telemetry(world):
    """The workflow's ``on_mesh`` hook and the ``mesh.data_axis`` /
    ``mesh.grid_axis`` gauges carry the resolved mesh."""
    _root, res = world
    for r in res:
        assert r["on_mesh"] == {"devices": 2, "data": 2, "grid": 1,
                                "platform": "cpu"}
        assert r["gauges"] == {"mesh.data_axis": 2.0,
                               "mesh.grid_axis": 1.0}
