"""The port's serving artifacts (``transmogrifai_tpu_torch/serving.py``) and
``tmog_torch::predict_trees``, held against the JAX package on the CPU:
LR and GBT workflows the JAX package trained and saved, loaded into the
port; the head and the whole scoring chain exported with ``torch.export``
and loaded back, against the port's own scoring bitwise and against the
JAX package's engine and ``load_prediction_fn`` within its tolerance; the
operator's registration; the artifact's integrity errors; the device
tables under a trace."""
import json
import logging
import os
import shutil

import numpy as np
import pytest
import torch

from transmogrifai_tpu import serving as jserving
from transmogrifai_tpu.scoring import ScoringEngine as JEngine
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch import serving
from transmogrifai_tpu_torch.models import _hist as H
from transmogrifai_tpu_torch.scoring import ScoringEngine

from _torch_serving_data import (BUCKET_CAP, artifact_bitwise,
                                 assert_bitwise, flat_blocks, trained)

#: the JAX package's own tolerance for an exported chain against its
#: engine (tests/test_scoring_engine.py:281-286)
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", params=["lr", "gbt"])
def model(request, tmp_path_factory):
    root = tmp_path_factory.mktemp(f"serving_{request.param}")
    jm, pm, rows, name = trained(request.param, str(root / "model"))
    return request.param, jm, pm, rows, name, root


def _tree_inputs(rng, n, F, T, D, K, dtype):
    X = torch.tensor(rng.normal(size=(n, F)), dtype=dtype)
    feat = torch.tensor(rng.integers(0, F, size=(T, (1 << D) - 1)),
                        dtype=torch.int32)
    thr = torch.tensor(rng.normal(size=(T, (1 << D) - 1)), dtype=dtype)
    thr[torch.tensor(rng.random(thr.shape) < 0.2)] = float("inf")
    leaf = torch.tensor(rng.normal(size=(T, 1 << D, K)), dtype=dtype)
    return X, feat, thr, leaf


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_predict_trees_op_passes_opcheck(dtype):
    """``torch.library.opcheck``: the schema, the fake implementation
    against the CPU one, and the op under a dynamic-shape trace."""
    X, feat, thr, leaf = _tree_inputs(np.random.default_rng(0), 37, 9, 5,
                                      4, 2, dtype)
    torch.library.opcheck(torch.ops.tmog_torch.predict_trees.default,
                          (X, feat, thr, leaf, 4))


@pytest.mark.parametrize("n,F,T,D,K", [(1, 3, 1, 1, 1), (50, 20, 20, 6, 1),
                                       (33, 8, 7, 9, 3)])
def test_predict_trees_op_on_the_cpu_is_the_plain_version(n, F, T, D, K):
    rng = np.random.default_rng(n + D)
    for dtype in (torch.float32, torch.float64):
        args = _tree_inputs(rng, n, F, T, D, K, dtype)
        before = H.KERNEL_LAUNCHES["predict_trees"]
        out = torch.ops.tmog_torch.predict_trees(*args, D)
        assert torch.equal(out, H.predict_trees_reference(*args, D))
        assert torch.equal(H.predict_trees(*args, D), out)
        # the plain version launches nothing and counts nothing
        assert H.KERNEL_LAUNCHES["predict_trees"] == before
    assert H.PREDICT_TREES_OP == "tmog_torch::predict_trees"


def test_exported_tree_program_calls_the_op(model, tmp_path):
    kind, _jm, pm, rows, _name, _root = model
    meta = serving.export_scoring_fn(pm, str(tmp_path), rows[:8],
                                     aot=False, device="cpu")
    ep = torch.export.load(os.path.join(str(tmp_path), "scoring_fn.pt2"))
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert ("tmog_torch.predict_trees.default" in targets) == (kind == "gbt")
    assert meta["coverage"] == "fused_chain"


@pytest.mark.cuda
def test_predict_trees_op_matches_its_plain_version_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the operator's CUDA "
                    "implementation launches a kernel built for the card")
    rng = np.random.default_rng(13)
    X, feat, thr, leaf = (t.cuda() for t in _tree_inputs(
        rng, 8192, 451, 20, 6, 1, torch.float32))
    before = H.KERNEL_LAUNCHES["predict_trees"]
    out = torch.ops.tmog_torch.predict_trees(X, feat, thr, leaf, 6)
    assert H.KERNEL_LAUNCHES["predict_trees"] == before + 1
    assert torch.equal(out, H.predict_trees_reference(X, feat, thr, leaf, 6))
    # a trace launches nothing
    ep = torch.export.export(_OpModule(), (X, feat, thr, leaf),
                             strict=False)
    assert H.KERNEL_LAUNCHES["predict_trees"] == before + 1
    assert torch.equal(ep.module()(X, feat, thr, leaf), out)
    with pytest.raises(ValueError, match="unsupported K"):
        H.predict_trees(X, feat, thr, torch.zeros((20, 64, 9), device="cuda"),
                        6)


class _OpModule(torch.nn.Module):
    def forward(self, X, feat, thr, leaf):
        return H.predict_trees(X, feat, thr, leaf, 6)


# ---------------------------------------------------------------------------
# the prediction head
# ---------------------------------------------------------------------------


def test_export_prediction_fn_round_trip(model, tmp_path):
    """The head at n ∈ {1, 7, 33}: bitwise the port's ``predict_arrays``;
    against the JAX package's exported head, predictions equal and
    probabilities within its tolerance."""
    _kind, jm, pm, _rows, name, _root = model
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    meta = serving.export_prediction_fn(pm, pdir, device="cpu")
    jmeta = jserving.export_prediction_fn(jm, jdir)
    assert meta["featureDim"] == jmeta["featureDim"]
    assert set(meta) - {"environment"} == set(jmeta)
    for k in ("predFeature", "coverage", "outputs"):
        assert meta[k] == jmeta[k]
    fn = serving.load_prediction_fn(pdir, device="cpu")
    jfn = jserving.load_prediction_fn(jdir)
    predictor = pm.stage_of(next(f for f in pm.result_features
                                 if f.name == name))
    rng = np.random.default_rng(7)
    for n in (1, 7, 33):
        X = rng.normal(size=(n, meta["featureDim"])).astype(np.float32)
        out = fn(X)
        want = predictor.predict_arrays(X, device="cpu")
        for key, w in zip(("prediction", "rawPrediction", "probability"),
                          want):
            np.testing.assert_array_equal(
                np.asarray(out[key], np.float64), w, err_msg=key)
        jout = jfn(X)
        np.testing.assert_array_equal(out["prediction"],
                                      jout["prediction"])
        np.testing.assert_allclose(out["probability"], jout["probability"],
                                   rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="Expected"):
        fn(np.zeros((3, meta["featureDim"] + 1), np.float32))


# ---------------------------------------------------------------------------
# the scoring chain
# ---------------------------------------------------------------------------


def test_engine_export_identities_equal_the_jax_engines(model):
    """The block manifest field for field, and the plan and state
    digests (the JAX engine with no plan attached)."""
    _kind, jm, pm, rows, _name, _root = model
    jeng = JEngine(jm, gate_bandwidth=False, mesh=False,
                   bucket_cap=BUCKET_CAP)
    eng = ScoringEngine(pm, device="cpu", bucket_cap=BUCKET_CAP)
    assert eng.export_manifest(rows[:8]) == jeng.export_manifest(rows[:8])
    assert eng.rewrite_digest() == jeng.rewrite_digest()
    assert eng.state_digest() == jeng.state_digest()


def test_export_manifest_refuses_a_block_that_is_not_row_leading(model,
                                                                 monkeypatch):
    _kind, _jm, pm, rows, _name, _root = model
    eng = ScoringEngine(pm, device="cpu", bucket_cap=BUCKET_CAP)
    host_blocks = eng.host_blocks

    def broken(store):
        s, prepared, uploads = host_blocks(store)
        uid = sorted(prepared)[0]
        k = sorted(prepared[uid])[0]
        prepared[uid][k] = np.zeros((3,), np.float32)
        return s, prepared, uploads
    monkeypatch.setattr(eng, "host_blocks", broken)
    with pytest.raises(ValueError, match="not row-leading"):
        eng.export_manifest(rows[:8])


def test_export_scoring_fn_round_trip(model, tmp_path):
    """The whole chain at n ∈ {3, 17}: bitwise the port's engine, and
    within the JAX package's tolerance of its engine's ``score_store``;
    the metadata carries the JAX package's keys."""
    _kind, jm, pm, rows, name, _root = model
    meta = serving.export_scoring_fn(pm, str(tmp_path), rows[:8],
                                     bucket_cap=BUCKET_CAP, aot=False,
                                     device="cpu")
    jeng = JEngine(jm, gate_bandwidth=False, mesh=False,
                   bucket_cap=BUCKET_CAP)
    jmeta = jserving.export_scoring_fn(jm, str(tmp_path / "jax"), rows[:8],
                                       bucket_cap=BUCKET_CAP, aot=False)
    assert set(meta) == set(jmeta)
    for k in ("coverage", "fusedStages", "inputs", "resultFeatures",
              "bucketCap", "bucketLadder", "planDigest", "stateDigest",
              "aot"):
        assert meta[k] == jmeta[k], k
    assert meta["resultFeatures"] == [name]
    fn = serving.load_scoring_fn(str(tmp_path), device="cpu")
    assert fn.bank_buckets == []
    eng = ScoringEngine(pm, device="cpu", bucket_cap=BUCKET_CAP)
    for n in (3, 17):
        sub = rows[:n]
        out = fn(flat_blocks(eng, sub))
        artifact_bitwise(out, eng.score_store(sub)[name], name)
        ref = jeng.score_store(sub)[name]
        np.testing.assert_array_equal(
            np.asarray(out[f"{name}.prediction"], np.float64),
            ref.prediction)
        np.testing.assert_allclose(
            np.asarray(out[f"{name}.probability"], np.float64),
            ref.probability, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="missing input block"):
        fn({})


def test_load_scoring_fn_checks_the_batch(model, tmp_path):
    _kind, _jm, pm, rows, _name, _root = model
    serving.export_scoring_fn(pm, str(tmp_path), rows[:8], aot=False,
                              device="cpu")
    fn = serving.load_scoring_fn(str(tmp_path), device="cpu")
    blocks = flat_blocks(ScoringEngine(pm, device="cpu"), rows[:5])
    key = sorted(blocks)[0]
    blocks[key] = blocks[key][:4]
    with pytest.raises(ValueError, match="inconsistent batch sizes"):
        fn(blocks)


# ---------------------------------------------------------------------------
# integrity, version skew, devices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["missing_meta", "missing_blob",
                                  "truncated", "not_json", "altered",
                                  "non_numeric_bytes"])
def test_a_damaged_artifact_raises_a_descriptive_error(model, tmp_path,
                                                       case):
    _kind, _jm, pm, _rows, _name, _root = model
    d = str(tmp_path / "head")
    serving.export_prediction_fn(pm, d, device="cpu")
    blob, meta = (os.path.join(d, "prediction_fn.pt2"),
                  os.path.join(d, "export.json"))
    want = {"missing_meta": "no serving artifact",
            "missing_blob": "missing", "truncated": "truncated",
            "not_json": "not valid JSON", "altered": "digest",
            "non_numeric_bytes": "non-numeric blobBytes"}[case]
    if case == "missing_meta":
        os.remove(meta)
    elif case == "missing_blob":
        os.remove(blob)
    elif case == "truncated":
        data = open(blob, "rb").read()
        open(blob, "wb").write(data[:len(data) // 2])
    elif case == "not_json":
        open(meta, "w").write("{not json")
    elif case == "altered":
        data = bytearray(open(blob, "rb").read())
        data[len(data) // 2] ^= 0xFF
        open(blob, "wb").write(bytes(data))
    else:
        m = json.load(open(meta))
        m["blobBytes"] = "many"
        json.dump(m, open(meta, "w"))
    with pytest.raises(ValueError, match=want):
        serving.load_prediction_fn(d, device="cpu")


def test_version_skew_warns_tmg503_and_still_loads(model, tmp_path, caplog):
    _kind, _jm, pm, rows, _name, _root = model
    d = str(tmp_path / "chain")
    serving.export_scoring_fn(pm, d, rows[:8], aot=False, device="cpu")
    meta_path = os.path.join(d, "scoring_export.json")
    meta = json.load(open(meta_path))
    meta["environment"]["torch"] = "0.0.1"
    meta["environment"]["cuda"] = "1.0"
    json.dump(meta, open(meta_path, "w"))
    with caplog.at_level(logging.WARNING,
                         logger="transmogrifai_tpu_torch.serving"):
        fn = serving.load_scoring_fn(d, prefer_bank=False, device="cpu")
    msgs = [r.message for r in caplog.records if "TMG503" in r.message]
    assert msgs and "torch: exported '0.0.1'" in msgs[0] \
        and "cuda: exported '1.0'" in msgs[0]
    assert callable(fn)


def test_an_artifact_runs_only_on_its_platform(model, tmp_path):
    """A program exported for one platform is refused on another, by
    name; nothing moves it."""
    _kind, _jm, pm, _rows, _name, _root = model
    d = str(tmp_path / "head")
    serving.export_prediction_fn(pm, d, device="cpu")
    meta_path = os.path.join(d, "export.json")
    meta = json.load(open(meta_path))
    meta["environment"]["platform"] = "cuda"
    json.dump(meta, open(meta_path, "w"))
    with pytest.raises(ValueError, match="exported for 'cuda'"):
        serving.load_prediction_fn(d, device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is visible")
def test_export_and_load_without_a_card_raise_unless_cpu(model, tmp_path):
    _kind, _jm, pm, rows, _name, _root = model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.export_scoring_fn(pm, str(tmp_path / "a"), rows[:8])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.export_prediction_fn(pm, str(tmp_path / "b"))
    serving.export_prediction_fn(pm, str(tmp_path / "c"), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serving.load_prediction_fn(str(tmp_path / "c"))


# ---------------------------------------------------------------------------
# the device tables under a trace
# ---------------------------------------------------------------------------


def test_scoring_after_an_export_equals_scoring_before(model, tmp_path):
    """An export traces the program after one eager call: the cached
    device tables stay real tensors, and the model scores as before."""
    from torch._subclasses.fake_tensor import FakeTensor
    _kind, _jm, _pm, rows, name, root = model
    pm = PWorkflowModel.load(str(root / "model"))
    before = pm.score(rows, device="cpu", engine=False)[name]
    serving.export_scoring_fn(pm, str(tmp_path / "s"), rows[:8],
                              bucket_cap=16, device="cpu")
    serving.export_prediction_fn(pm, str(tmp_path / "h"), device="cpu")
    tables = [t for m in pm.fitted_stages.values()
              for t in getattr(m, "_device_tables", {}).values()]
    for m in pm.fitted_stages.values():
        inner = getattr(m, "inner", None)
        tables += list(getattr(inner, "_device_tables", {}).values())
    assert tables and not any(isinstance(t, FakeTensor) for t in tables)
    assert_bitwise(pm.score(rows, device="cpu", engine=False)[name], before)
    assert_bitwise(pm.score(rows, device="cpu", engine=True)[name], before)


def test_tracing_a_cold_device_table_raises(model):
    """A trace of a program whose tables were never uploaded raises and
    names the table; it caches nothing."""
    _kind, _jm, _pm, rows, _name, root = model
    pm = PWorkflowModel.load(str(root / "model"))
    eng = ScoringEngine(pm, device="cpu", bucket_cap=BUCKET_CAP)
    manifest = eng.export_manifest(rows[:8])
    module = eng.export_callable(manifest, eng._out_names(True))
    blocks = flat_blocks(eng, rows[:8])
    from transmogrifai_tpu_torch.serving import _block_key
    example = tuple(torch.from_numpy(np.ascontiguousarray(
        blocks[_block_key(s)])) for s in manifest)
    with pytest.raises(Exception, match=r"device table .* is not on cpu"):
        torch.export.export(module, example, strict=False)
    for m in pm.fitted_stages.values():
        for owner in (m, getattr(m, "inner", None)):
            assert not getattr(owner, "_device_tables", {})
    module(*example)                        # eager: fills the tables
    torch.export.export(module, example, strict=False)


def test_export_keeps_the_artifact_directory_to_its_files(model, tmp_path):
    """An export writes its program, its metadata and (with a bank) the
    bank directory, nothing else."""
    _kind, _jm, pm, rows, _name, _root = model
    d = str(tmp_path / "x")
    serving.export_scoring_fn(pm, d, rows[:8], bucket_cap=16, device="cpu")
    assert sorted(os.listdir(d)) == ["aot_bank", "scoring_export.json",
                                     "scoring_fn.pt2"]
    shutil.rmtree(d)
