"""The port's command line (``python -m transmogrifai_tpu_torch``) against
the JAX package's ``cli.py``: type and problem inference on headed copies
of the bundled Titanic CSV and of generated iris and boston files,
``gen``'s four files equal once the package name is swapped, the
generated project trained on the CPU (LR only, 2 folds: the shrink
``tests/test_cli.py`` uses) with its model loading in both packages,
``check`` / ``plan`` / ``trace merge`` over it, ``fleet``, ``workload``
``trace analyze`` and ``tune`` on the arguments the JAX parser takes
(``tune`` in full: tests/test_torch_tuner.py)."""
import csv
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from transmogrifai_tpu import cli as jcli
from transmogrifai_tpu_torch import cli as pcli
from transmogrifai_tpu_torch import boston, iris, planner

ROOT = pathlib.Path(__file__).resolve().parents[1]
BUNDLED = ROOT / "tests" / "resources" / "PassengerDataAll.csv"
TITANIC_HEADER = ["PassengerId", "Survived", "Pclass", "Name", "Sex", "Age",
                  "SibSp", "Parch", "Ticket", "Fare", "Cabin", "Embarked"]


def _write(path, header, rows):
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(header)
        w.writerows(rows)
    return str(path)


@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    """Headed CSVs: the bundled Titanic file (all 891 rows, and its first
    200), and generated iris and boston rows."""
    root = tmp_path_factory.mktemp("cli_csvs")
    rows = list(csv.reader(open(BUNDLED, newline="")))
    out = {"titanic": _write(root / "titanic.csv", TITANIC_HEADER, rows),
           "titanic200": _write(root / "titanic200.csv", TITANIC_HEADER,
                                rows[:200])}
    iris.generate_csv(str(root / "iris.data"), 300, seed=4)
    out["iris"] = _write(root / "iris.csv", iris.IRIS_SCHEMA, (
        line.strip().split(",") for line in open(root / "iris.data")))
    boston.generate_data(str(root / "housing.data"), 300, seed=4)
    out["boston"] = _write(root / "boston.csv", boston.BOSTON_SCHEMA, (
        line.split() for line in open(root / "housing.data")))
    return out


#: (csv, response, id column) of each inference case
CASES = {"titanic": ("Survived", "PassengerId"),
         "iris": ("irisClass", None), "boston": ("medv", None)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_inference_equals_the_jax_packages(name, csvs):
    response, _id = CASES[name]
    header, types = pcli.infer_feature_types(csvs[name])
    assert (header, types) == jcli.infer_feature_types(csvs[name])
    kind = pcli.infer_problem_kind(csvs[name], response)
    assert kind == jcli.infer_problem_kind(csvs[name], response)
    assert kind == {"titanic": "binary", "iris": "multiclass",
                    "boston": "regression"}[name]
    with pytest.raises(ValueError, match="not in"):
        pcli.infer_problem_kind(csvs[name], "noSuchColumn")


@pytest.mark.parametrize("name", sorted(CASES))
def test_generated_files_equal_the_jax_packages(name, csvs, tmp_path):
    response, id_column = CASES[name]
    got = pcli.generate_project(csvs[name], response, str(tmp_path / "p"),
                                name="GenApp", id_column=id_column)
    want = jcli.generate_project(csvs[name], response, str(tmp_path / "j"),
                                 name="GenApp", id_column=id_column)
    assert set(got) == set(want) == {"features.py", "app.py",
                                     "params.json", "README.md"}
    for fname in got:
        jtext = open(want[fname]).read().replace("transmogrifai_tpu",
                                                 "transmogrifai_tpu_torch")
        assert open(got[fname]).read() == jtext, fname
    params = json.load(open(got["params.json"]))
    from transmogrifai_tpu_torch import config
    assert params["customParams"] == config.default_custom_params()


def _shrink(app_path, trace_dir):
    """LR only and 2 folds (the generated default is the full reference
    grid), on the CPU; the params file sets a trace directory."""
    text = app_path.read_text()
    text = text.replace(
        "BinaryClassificationModelSelector.with_cross_validation()",
        "BinaryClassificationModelSelector.with_cross_validation("
        "num_folds=2, families=[LogisticRegressionFamily()])")
    text = text.replace(
        "from transmogrifai_tpu_torch.models import "
        "BinaryClassificationModelSelector",
        "from transmogrifai_tpu_torch.models import "
        "BinaryClassificationModelSelector\n"
        "from transmogrifai_tpu_torch.models.linear import "
        "LogisticRegressionFamily")
    text = text.replace("evaluator=evaluator)",
                        "evaluator=evaluator, device='cpu')")
    app_path.write_text(text)
    params_path = app_path.parent / "params.json"
    params = json.load(open(params_path))
    params["customParams"]["traceDir"] = str(trace_dir)
    params_path.write_text(json.dumps(params, indent=1))


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.fixture(scope="module")
def trained(csvs, tmp_path_factory):
    """The project ``gen`` scaffolds from the first 200 Titanic rows,
    trained on the CPU by its own ``app.py`` (a subprocess)."""
    root = tmp_path_factory.mktemp("gen_project")
    proj = root / "proj"
    res = subprocess.run(
        [sys.executable, "-m", "transmogrifai_tpu_torch", "gen", "--input",
         csvs["titanic200"], "--response", "Survived", "--id",
         "PassengerId", "--name", "TitanicApp", "--output", str(proj)],
        capture_output=True, text=True, env=_env(), timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.count("generated ") == 4
    _shrink(proj / "app.py", root / "traces")
    res = subprocess.run(
        [sys.executable, "app.py", "--run-type", "Train", "--params",
         "params.json", "--quiet"], cwd=str(proj), capture_output=True,
        text=True, env=_env(), timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    return proj, root / "traces"


def test_the_generated_project_trains_and_loads_in_both_packages(trained,
                                                                  csvs):
    proj, _traces = trained
    model_dir = proj / "model"
    assert (model_dir / "model.json").exists()
    metrics = json.load(open(proj / "metrics.json"))
    assert metrics["effectiveConfig"]["traceDir"] is not None
    assert metrics["preflight"]["findings"] == 0
    from transmogrifai_tpu import WorkflowModel as JModel
    from transmogrifai_tpu_torch import WorkflowModel as PModel
    jcli._populate_stage_registry()
    pmodel, jmodel = PModel.load(str(model_dir)), JModel.load(str(model_dir))
    names = [f.name for f in pmodel.result_features]
    assert names == [f.name for f in jmodel.result_features]
    from transmogrifai_tpu_torch.readers import DataReaders
    records = DataReaders.simple.csv_auto(csvs["titanic200"]).read_records()
    got = pmodel.score(records, device="cpu")[names[0]]
    want = jmodel.score(records)[names[0]]
    assert np.array_equal(np.asarray(got.prediction),
                          np.asarray(want.prediction))
    assert np.allclose(np.asarray(got.probability),
                       np.asarray(want.probability), atol=1e-5)


def test_check_passes_the_project_and_fails_a_malformed_knob(trained,
                                                             capsys):
    proj, _traces = trained
    cwd = os.getcwd()
    os.chdir(proj)
    try:
        assert pcli.main(["check", "params.json"]) == 0
        out = capsys.readouterr().out
        assert "check: 0 error(s)" in out
        params = json.load(open("params.json"))
        params["customParams"]["batchSize"] = 2.5
        with open("bad.json", "w") as fh:
            json.dump(params, fh)
        assert pcli.main(["check", "bad.json", "--no-device"]) == 1
        out = capsys.readouterr().out
        assert "TMG001 error [bad.json:customParams.batchSize] params " \
            "file: customParams.batchSize must be an integer, got 2.5" in out
        assert pcli.main(["check", "--model", "nowhere"]) == 0
        assert "params-only check" in capsys.readouterr().out
    finally:
        os.chdir(cwd)


def test_plan_json_is_the_planners_plan(trained, capsys):
    proj, _traces = trained
    assert pcli.main(["plan", str(proj / "params.json"), "--model",
                      str(proj / "model"), "--json",
                      "--cost-db", str(proj / "costs.json")]) == 0
    printed = capsys.readouterr().out
    doc = json.loads(printed[:printed.rindex("}") + 1])
    from transmogrifai_tpu_torch import WorkflowModel
    model = WorkflowModel.load(str(proj / "model"))
    want = planner.plan_model(model, cost_db=planner.CostDatabase.load(
        str(proj / "costs.json"))).to_json()
    assert doc == json.loads(json.dumps(want, sort_keys=True))
    assert pcli.main(["plan", "--model", str(proj / "nowhere")]) == 1


def test_trace_merge_merges_the_runs_shards(trained, capsys, tmp_path):
    _proj, traces = trained
    out = tmp_path / "merged.json"
    assert pcli.main(["trace", "merge", str(traces), "-o", str(out)]) == 0
    line = capsys.readouterr().out
    assert line.startswith("trace merge: 1 shard(s)")
    doc = json.load(open(out))
    assert any(ev.get("name") == "run:Train" for ev in doc["traceEvents"])
    (traces / "shard-torn.trace.json").write_text("{")
    assert pcli.main(["trace", "merge", str(traces), "-o", str(out),
                      "--strict"]) == 1


#: the subcommands of the operations tier, with arguments the JAX parser
#: takes (``serve`` and ``registry``: tests/test_torch_server.py and
#: tests/test_torch_lifecycle.py; ``fleet``, ``workload`` and ``trace
#: analyze`` in full: tests/test_torch_fleet.py and
#: tests/test_torch_workload.py; ``tune``: tests/test_torch_tuner.py).
OPS_COMMANDS = {
    "fleet": ["fleet", "params.json", "--workers", "2"],
    "workload": ["workload", "merge", "dir"],
    "tune": ["tune", "params.json", "--workload", "w.json"],
    "trace analyze": ["trace", "analyze", "dir", "--top-k", "3"],
}


@pytest.mark.parametrize("name", sorted(OPS_COMMANDS))
def test_unported_subcommands_exit_nonzero_naming_their_item(
        name, capsys, tmp_path, monkeypatch):
    """The operations tier's commands on these arguments (the name is
    kept from when all four exited 2). Each runs on these
    arguments in a directory that holds them: ``workload merge dir`` over
    a recorded shard and ``trace analyze dir`` over a trace shard exit 0
    with the JAX command's output; ``fleet params.json`` with no such file
    exits 1 naming it, before any worker starts; ``tune params.json
    --workload w.json`` with no such workload exits 1 as the JAX command
    does, printing the same line."""
    monkeypatch.chdir(tmp_path)
    argv = OPS_COMMANDS[name]
    if name == "tune":
        assert pcli.main(argv) == 1
        got = capsys.readouterr().out
        assert jcli.main(argv) == 1
        assert got == capsys.readouterr().out
        assert "cannot load workload 'w.json'" in got
        return
    if name == "fleet":
        assert pcli.main(argv) == 1
        assert "cannot load" in capsys.readouterr().out
        return
    os.makedirs("dir")
    if name == "workload":
        from transmogrifai_tpu_torch import workload
        rec = workload.WorkloadRecorder("dir", role="worker")
        rec.record({"kind": "request", "tOffsetS": 1.0, "model": "m",
                    "rows": 2}, records=[{"x": 1.0}, {"x": 2.0}])
        rec.close()
    else:
        with open(os.path.join("dir", "shard-worker-1.trace.json"),
                  "w") as fh:
            json.dump({"traceEvents": [
                {"ph": "X", "name": "server:request", "ts": 0, "dur": 900,
                 "pid": 1, "tid": 1, "args": {"trace_id": "t1",
                                              "span_id": "s1"}}],
                "epochUnixS": 100.0, "role": "worker", "pid": 1}, fh)
    assert pcli.main(argv) == 0
    got = capsys.readouterr().out
    assert jcli.main(argv) == 0
    assert got == capsys.readouterr().out
    assert "1 request" in got


def test_python_dash_m_runs_the_command_line(tmp_path):
    res = subprocess.run([sys.executable, "-m", "transmogrifai_tpu_torch",
                          "tune", "params.json", "--workload", "w.json"],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode == 1 and "cannot load workload" in res.stdout
    res = subprocess.run([sys.executable, "-m", "transmogrifai_tpu_torch",
                          "registry", "list", "--registry",
                          str(tmp_path / "reg")],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert res.returncode == 0 and "registry: empty" in res.stdout
