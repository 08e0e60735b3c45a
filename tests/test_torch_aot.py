"""The port's program bank (``transmogrifai_tpu_torch/aot.py``) and the
engine's preload seam, on the CPU, after ``tests/test_aot.py``: a bank
load scores with no build and bitwise; a cold process; every corruption
and incompatibility degrading to a build with a TMG501/502 finding (the
JAX package's nine cases, its jax version skew read as a torch version
skew); the loader's bank path against the polymorphic program; stale
banks; the tallies; the lint vocabulary against the JAX package's; the
runner's ``aot`` block. The models are the JAX package's, saved and
loaded into the port."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from transmogrifai_tpu import lint as jlint
from transmogrifai_tpu_torch import aot, lint, serving
from transmogrifai_tpu_torch.scoring import PROGRAM_CACHE_CAP, ScoringEngine

from _torch_serving_data import (BUCKET_CAP, artifact_bitwise,
                                 assert_bitwise, flat_blocks, trained)


@pytest.fixture(scope="module", params=["lr", "gbt"])
def banked(request, tmp_path_factory):
    """One trained model and one banked export of it on the CPU."""
    root = tmp_path_factory.mktemp(f"aot_{request.param}")
    _jm, pm, rows, name = trained(request.param, str(root / "model"))
    export = str(root / "export")
    meta = serving.export_scoring_fn(pm, export, rows[:8],
                                     bucket_cap=BUCKET_CAP, device="cpu")
    return pm, rows, name, export, meta, root


def _cold_engine(model):
    return ScoringEngine(model, device="cpu", bucket_cap=BUCKET_CAP)


# ---------------------------------------------------------------------------
# the happy path
# ---------------------------------------------------------------------------


def test_bank_load_scores_with_zero_compiles(banked):
    pm, rows, name, export, meta, _root = banked
    assert meta["aot"]["programs"] == 4
    assert meta["aot"]["bucketLadder"] == [8, 16, 32, 64]
    eng = _cold_engine(pm)
    report = aot.load_program_bank(eng, export)
    assert report["present"] and report["compatible"]
    assert report["loaded"] == [8, 16, 32, 64]
    assert report["findings"] == [] and report["skipped"] == {}
    assert len(eng.programs()) == 4 and eng.buckets_used() == [8, 16, 32, 64]
    small = eng.score_store(rows[:5])
    big = eng.score_store(rows[:40])
    many = eng.score_store(rows[:150])          # chunks of 64, 64, 22
    assert eng.compile_count == 0
    built = _cold_engine(pm)
    assert_bitwise(small[name], built.score_store(rows[:5])[name])
    assert_bitwise(big[name], built.score_store(rows[:40])[name])
    assert_bitwise(many[name], built.score_store(rows[:150])[name])
    assert built.compile_count > 0


def test_bank_manifest_holds_what_a_loader_checks(banked):
    pm, _rows, name, export, meta, _root = banked
    manifest, findings = aot.read_manifest(export)
    assert findings == []
    eng = _cold_engine(pm)
    assert manifest["formatVersion"] == aot.FORMAT_VERSION
    assert manifest["bucketLadder"] == [8, 16, 32, 64]
    assert manifest["bucketCap"] == BUCKET_CAP
    assert manifest["outNames"] == [name]
    assert manifest["blocks"] == meta["inputs"]
    assert manifest["planDigest"] == eng.rewrite_digest()
    assert manifest["stateDigest"] == eng.state_digest()
    assert manifest["environment"] == aot.environment_fingerprint("cpu")
    assert set(manifest["environment"]) == {"torch", "cuda", "platform",
                                            "deviceKind"}
    for b in ("8", "16", "32", "64"):
        rec = manifest["programs"][b]
        path = os.path.join(aot.bank_dir(export), rec["file"])
        assert rec["file"] == f"bucket_{b}.pt2"
        assert rec["bytes"] == os.path.getsize(path) > 0
        assert len(rec["digest"]) == 32
    assert aot.bank_bytes(manifest) == meta["aot"]["bytes"]
    assert aot.bank_bytes(None) == 0 and aot.bank_bytes({"programs": 3}) == 0
    assert not os.path.exists(aot.manifest_path(export) + ".tmp")


def test_export_metadata_stamped_even_without_aot(banked, tmp_path):
    pm, rows, _name, _export, _meta, _root = banked
    meta = serving.export_scoring_fn(pm, str(tmp_path), rows[:8],
                                     bucket_cap=BUCKET_CAP, aot=False,
                                     device="cpu")
    assert meta["aot"] is None
    assert not os.path.isdir(aot.bank_dir(str(tmp_path)))
    assert meta["bucketCap"] == BUCKET_CAP
    assert meta["bucketLadder"] == [8, 16, 32, 64]
    env = meta["environment"]
    import torch
    assert env["torch"] == torch.__version__
    assert env["cuda"] == torch.version.cuda
    assert env["platform"] == "cpu"
    eng = _cold_engine(pm)
    assert meta["planDigest"] == eng.rewrite_digest()
    assert meta["stateDigest"] == eng.state_digest()
    assert serving.load_scoring_fn(str(tmp_path),
                                   device="cpu").bank_buckets == []


def test_cold_process_first_request_zero_compiles(banked, tmp_path):
    """A fresh interpreter that imports torch, numpy and the port loads
    the saved model and the bank and answers with no build, as the
    warm engine does."""
    pm, rows, name, export, _meta, root = banked
    with open(os.path.join(str(tmp_path), "req.json"), "w") as fh:
        json.dump(rows[:10], fh)
    script = r"""
import json, os, sys, time
for mod in ("jax", "jaxlib", "transmogrifai_tpu"):
    sys.modules[mod] = None
sys.path.insert(0, sys.argv[4])
import numpy as np
from transmogrifai_tpu_torch import WorkflowModel, aot
from transmogrifai_tpu_torch.scoring import ScoringEngine
model = WorkflowModel.load(sys.argv[1])
eng = ScoringEngine(model, device="cpu", bucket_cap=int(sys.argv[3]))
report = aot.load_program_bank(eng, sys.argv[2])
assert report["compatible"], report
records = json.load(open(os.path.join(sys.argv[5], "req.json")))
t0 = time.perf_counter()
out = eng.score_store(records)
ms = (time.perf_counter() - t0) * 1e3
assert eng.compile_count == 0, eng.compile_count
col = out[sys.argv[6]]
np.save(os.path.join(sys.argv[5], "prob.npy"), col.probability)
print(f"COLD_OK rows={out.n_rows} first_request_ms={ms:.2f}")
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", script, str(root / "model"), export,
         str(BUCKET_CAP), repo, str(tmp_path), name],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "COLD_OK rows=10" in proc.stdout, proc.stdout
    want = _cold_engine(pm).score_store(rows[:10])[name].probability
    np.testing.assert_array_equal(
        np.load(os.path.join(str(tmp_path), "prob.npy")), want)


# ---------------------------------------------------------------------------
# degradation: every corruption builds the bucket, with a finding
# ---------------------------------------------------------------------------


def _corrupt_manifest(export, mutate):
    mp = aot.manifest_path(export)
    with open(mp) as fh:
        manifest = json.load(fh)
    mutate(manifest)
    with open(mp, "w") as fh:
        json.dump(manifest, fh)


@pytest.mark.parametrize("case", [
    "truncated_manifest", "not_json_manifest", "wrong_device_kind",
    "torch_version_skew", "tampered_program", "missing_program",
    "plan_digest_mismatch", "state_digest_mismatch",
    "format_version_bump",
])
def test_bank_corruption_degrades_to_a_build(banked, tmp_path, case):
    pm, rows, name, export, _meta, _root = banked
    dst = str(tmp_path / "export_copy")
    shutil.copytree(export, dst)
    export = dst
    whole_bank_dead = True
    if case == "truncated_manifest":
        with open(aot.manifest_path(export), "w") as fh:
            fh.write('{"formatVersion": 1, "programs"')
    elif case == "not_json_manifest":
        with open(aot.manifest_path(export), "wb") as fh:
            fh.write(b"\x00\x01garbage")
    elif case == "wrong_device_kind":
        _corrupt_manifest(export, lambda m: m["environment"].update(
            deviceKind="NVIDIA H100 80GB HBM3"))
    elif case == "torch_version_skew":
        _corrupt_manifest(export, lambda m: m["environment"].update(
            torch="0.0.1"))
    elif case == "plan_digest_mismatch":
        _corrupt_manifest(export,
                          lambda m: m.update(planDigest="deadbeef" * 4))
    elif case == "state_digest_mismatch":
        _corrupt_manifest(export,
                          lambda m: m.update(stateDigest="deadbeef" * 4))
    elif case == "format_version_bump":
        _corrupt_manifest(export, lambda m: m.update(formatVersion=99))
    elif case == "tampered_program":
        f = os.path.join(aot.bank_dir(export), "bucket_16.pt2")
        blob = bytearray(open(f, "rb").read())
        blob[len(blob) // 2] ^= 0xFF
        open(f, "wb").write(bytes(blob))
        whole_bank_dead = False
    elif case == "missing_program":
        os.remove(os.path.join(aot.bank_dir(export), "bucket_32.pt2"))
        whole_bank_dead = False

    eng = _cold_engine(pm)
    report = aot.load_program_bank(eng, export)       # must not raise
    assert report["findings"], case
    rules = {f.rule for f in report["findings"]}
    assert rules <= {"TMG501", "TMG502"}, rules
    if whole_bank_dead:
        assert report["loaded"] == []
    else:
        assert report["loaded"] != []
        assert len(report["skipped"]) == 1
        assert rules == {"TMG502"}
    out = eng.score_store(rows[:12])                  # bucket 16
    built = _cold_engine(pm)
    assert_bitwise(out[name], built.score_store(rows[:12])[name])
    if whole_bank_dead:
        assert eng.compile_count > 0
    elif case == "tampered_program":
        assert eng.compile_count == 1                 # only bucket 16
    # the loader, too, serves the bucket by the polymorphic program
    fn = serving.load_scoring_fn(export, device="cpu")
    artifact_bitwise(fn(flat_blocks(built, rows[:12])),
                     built.score_store(rows[:12])[name], name)


def test_load_scoring_fn_warns_on_version_skew(banked, tmp_path, caplog):
    import logging
    _pm, _rows, _name, export, _meta, _root = banked
    dst = str(tmp_path / "export_copy")
    shutil.copytree(export, dst)
    meta_path = os.path.join(dst, "scoring_export.json")
    meta = json.load(open(meta_path))
    meta["environment"]["torch"] = "0.0.1"
    json.dump(meta, open(meta_path, "w"))
    with caplog.at_level(logging.WARNING,
                         logger="transmogrifai_tpu_torch.serving"):
        fn = serving.load_scoring_fn(dst, prefer_bank=False, device="cpu")
    assert any("TMG503" in r.message for r in caplog.records)
    assert callable(fn)


def test_flat_bank_path_matches_the_polymorphic_program(banked):
    """The loader's bank path (padded to the bucket, sliced back) gives
    the polymorphic program's arrays, and a batch past the bank's cap
    runs the polymorphic program."""
    pm, rows, name, export, _meta, _root = banked
    eng = _cold_engine(pm)
    banked_fn = serving.load_scoring_fn(export, device="cpu")
    plain_fn = serving.load_scoring_fn(export, prefer_bank=False,
                                       device="cpu")
    assert banked_fn.bank_buckets == [8, 16, 32, 64]
    assert plain_fn.bank_buckets == []
    for n in (1, 10, 64, 150):
        blocks = flat_blocks(eng, rows[:n])
        a, b = banked_fn(blocks), plain_fn(blocks)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[f"{name}.prediction"].shape == (n,)
        artifact_bitwise(a, eng.score_store(rows[:n])[name], name)


# ---------------------------------------------------------------------------
# the preload seam, stale banks, tallies
# ---------------------------------------------------------------------------


def test_preload_seam_and_the_cache_cap(banked):
    pm, _rows, _name, _export, _meta, _root = banked
    eng = _cold_engine(pm)
    assert eng.programs() == []
    sentinel = object()
    for i in range(PROGRAM_CACHE_CAP + 3):
        eng.preload((("fake-key", i),), sentinel)
    assert len(eng.programs()) == PROGRAM_CACHE_CAP
    assert (("fake-key", 0),) not in eng.programs()
    assert (("fake-key", PROGRAM_CACHE_CAP + 2),) in eng.programs()
    assert eng.compile_count == 0


def test_program_key_is_the_key_a_call_uses(banked):
    pm, rows, name, _export, _meta, _root = banked
    eng = _cold_engine(pm)
    eng.score_store(rows[:20])                         # bucket 32
    manifest = eng.export_manifest(rows[:8])
    prepared, uploads = aot._spec_blocks(manifest, 32)
    key = eng.program_key(prepared, uploads, [name])
    assert eng.programs() == [key]


def test_stale_bank_rejected_and_bankless_export_removes_bank(banked,
                                                              tmp_path):
    pm, rows, _name, export, _meta, _root = banked
    d = str(tmp_path / "roundtrip")
    shutil.copytree(export, d)
    assert os.path.isdir(aot.bank_dir(d))
    _jm2, pm2, rows2, _name2 = trained("lr", str(tmp_path / "model2"),
                                       seed=99)
    serving.export_scoring_fn(pm2, d, rows2[:8], bucket_cap=BUCKET_CAP,
                              aot=False, device="cpu")
    assert not os.path.isdir(aot.bank_dir(d))
    shutil.copytree(aot.bank_dir(export), aot.bank_dir(d))
    fn = serving.load_scoring_fn(d, device="cpu")
    assert fn.bank_buckets == []
    manifest, programs, findings = aot.load_flat_programs(
        d, expect_digests={"planDigest": fn.meta["planDigest"],
                           "stateDigest": fn.meta["stateDigest"]},
        device="cpu")
    assert programs == {}
    assert any(f.rule == "TMG501" and "STALE" in f.message
               for f in findings)


def test_aot_stats_tallies(banked, tmp_path):
    pm, _rows, _name, export, _meta, _root = banked
    rows = _rows
    before = aot.aot_stats()
    assert set(before) == {"banks_exported", "programs_exported",
                           "banks_loaded", "programs_loaded",
                           "programs_skipped", "banks_incompatible"}
    serving.export_scoring_fn(pm, str(tmp_path), rows[:8], bucket_cap=16,
                              device="cpu")
    eng = ScoringEngine(pm, device="cpu", bucket_cap=16)
    aot.load_program_bank(eng, str(tmp_path))
    os.remove(os.path.join(aot.bank_dir(str(tmp_path)), "bucket_8.pt2"))
    aot.load_program_bank(ScoringEngine(pm, device="cpu", bucket_cap=16),
                          str(tmp_path))
    aot.load_program_bank(_cold_engine(pm), str(tmp_path))   # cap differs
    after = aot.aot_stats()
    delta = {k: after[k] - before[k] for k in after}
    assert delta == {"banks_exported": 1, "programs_exported": 2,
                     "banks_loaded": 2, "programs_loaded": 3,
                     "programs_skipped": 1, "banks_incompatible": 1}
    aot.reset_aot_stats()
    assert set(aot.aot_stats().values()) == {0}


def test_no_bank_is_not_a_finding(banked, tmp_path):
    pm, _rows, _name, _export, _meta, _root = banked
    report = aot.load_program_bank(_cold_engine(pm), str(tmp_path))
    assert report == {"present": False, "compatible": False, "loaded": [],
                      "skipped": {}, "findings": []}
    assert aot.load_flat_programs(str(tmp_path), device="cpu") \
        == (None, {}, [])


# ---------------------------------------------------------------------------
# the lint vocabulary and the runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["TMG501", "TMG502", "TMG503"])
def test_findings_format_as_the_jax_packages(rule):
    assert lint.RULES[rule][0] == jlint.RULES[rule][0]
    for kw in ({}, {"location": "/x/aot_manifest.json"},
               {"stage": "s1", "feature": "f"}, {"feature": "f"}):
        ours = lint.Finding(rule, "message", **kw)
        theirs = jlint.Finding(rule, "message", **kw)
        assert ours.severity == theirs.severity == lint.Severity.WARNING
        assert ours.format() == theirs.format()
        assert ours.to_json() == theirs.to_json()


def test_runner_metrics_carry_the_aot_tallies(tmp_path):
    from transmogrifai_tpu_torch import FeatureBuilder as PFB
    from transmogrifai_tpu_torch import Workflow as PWorkflow
    from transmogrifai_tpu_torch.dsl import transmogrify
    from transmogrifai_tpu_torch.models.linear import \
        LogisticRegressionFamily
    from transmogrifai_tpu_torch.models.selector import \
        BinaryClassificationModelSelector
    from transmogrifai_tpu_torch.runner import (OpParams, OpWorkflowRunner,
                                                RunType)
    from _torch_serving_data import records

    rows = records(60, seed=4)
    y = PFB.RealNN("y").from_column().as_response()
    age = PFB.Real("age").from_column().as_predictor()
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2, splitter=None, families=[LogisticRegressionFamily(
            grid=[{"regParam": 0.1, "elasticNetParam": 0.0}])])
    pred = y.transform_with(sel, transmogrify([age]))

    class _Reader:
        def read_records(self):
            return list(rows)
    runner = OpWorkflowRunner(PWorkflow().set_result_features(pred),
                              training_reader=_Reader(), device="cpu")
    out = runner.run(RunType.TRAIN, OpParams(
        model_location=str(tmp_path / "m"),
        metrics_location=str(tmp_path / "metrics.json")))
    assert out.metrics["aot"] == aot.aot_stats()
    assert json.load(open(tmp_path / "metrics.json"))["aot"] \
        == aot.aot_stats()
