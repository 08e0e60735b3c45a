"""The PyTorch port stands alone: importing it never loads ``jax`` or the
JAX package, and no source of it names either."""
import ast
import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "transmogrifai_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "transmogrifai_tpu")


def _modules():
    out = []
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_port_imports_with_jax_blocked():
    mods = _modules()
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'transmogrifai_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "loaded = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'transmogrifai_tpu') and sys.modules[m]]\n"
            "assert not loaded, loaded\n"
            "print('ok', len(" f"{mods!r}" "))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_source_names_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


@pytest.mark.parametrize("module", ["iris.py", "boston.py",
                                    "ops/indexers.py"])
def test_multiclass_and_regression_modules_are_scanned(module):
    """The iris and boston paths and the indexers are among the sources
    scanned above and the modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", [
    "mapprep.py", "feature_json.py", "ops/maps.py", "ops/geo.py",
    "ops/date_list.py", "ops/dt_bucketizer.py", "ops/list_ops.py",
    "ops/scalers.py"])
def test_feature_type_modules_are_scanned(module):
    """The map-feature path and the vectorizers of every feature type are
    among the sources scanned above and the modules imported with
    ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", [
    "filters/__init__.py", "filters/distribution.py",
    "filters/raw_feature_filter.py", "insights/__init__.py",
    "insights/model_insights.py", "insights/loco.py", "insights/corr.py"])
def test_guard_modules_are_scanned(module):
    """The RawFeatureFilter and the insights are among the sources scanned
    above and the modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    if dotted.endswith(".__init__"):
        dotted = dotted[:-len(".__init__")]
    assert dotted in _modules()


def test_scan_list_holds_the_fused_statistics_module():
    """The fused statistics pass is among the sources scanned above."""
    assert PORT / "fitstats.py" in SOURCES


@pytest.mark.parametrize("module", [
    "temporal.py", "dataprep.py", "utils/aggregators.py",
    "readers/avro.py", "readers/data_readers.py", "readers/__init__.py"])
def test_temporal_modules_are_scanned(module):
    """The event-time readers, the Avro codec, the temporal engine and
    the dataprep path are among the sources scanned above and the
    modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    if dotted.endswith(".__init__"):
        dotted = dotted[:-len(".__init__")]
    assert dotted in _modules()


@pytest.mark.parametrize("module", ["serving.py", "aot.py", "lint.py"])
def test_serving_modules_are_scanned(module):
    """The serving artifacts, the program bank and the findings they raise
    are among the sources scanned above and the modules imported with
    ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", [
    "random.py", "models/glm.py", "models/svm.py", "ops/calibrators.py",
    "ops/collections.py", "ops/text_suite.py", "ops/topics.py",
    "utils/taggers.py", "utils/fn_io.py", "every_surface.py", "dsl.py",
    "evaluators/__init__.py"])
def test_rich_dsl_modules_are_scanned(module):
    """GLM, the MLP, the text suite and its taggers, the topics, the
    calibrators, the collection lifts and the DSL are among the sources
    scanned above and the modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    assert ".".join(parts) in _modules()


@pytest.mark.parametrize("kind", ["ner", "pos", "sent"])
def test_tagger_weights_are_byte_identical_copies(kind):
    """The port carries its own copy of each tagger's weights, byte for
    byte the JAX package's, and loads it from its own tree."""
    mine = PORT / "resources" / "taggers" / f"{kind}.json.gz"
    ref = ROOT / "transmogrifai_tpu" / "resources" / "taggers" / \
        f"{kind}.json.gz"
    assert mine.read_bytes() == ref.read_bytes()
    from transmogrifai_tpu_torch.utils import taggers
    assert pathlib.Path(taggers.resource_dir()) == mine.parent


@pytest.mark.parametrize("module", ["planner.py", "utils/table.py",
                                    "lint.py", "runner.py"])
def test_preflight_and_planner_modules_are_scanned(module):
    """The planner, the summary table, the pre-flight and the runner that
    runs them are among the sources scanned above and the modules
    imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", ["telemetry.py", "utils/locks.py"])
def test_telemetry_modules_are_scanned(module):
    """Telemetry and its lock-order witness are among the sources scanned
    above and the modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", ["resilience.py", "pipeline.py",
                                    "readers/streaming.py"])
def test_ingest_modules_are_scanned(module):
    """The resilience layer, the input pipeline and the directory stream
    reader (host modules of the JAX package, copied into the port, never
    imported from it) are among the sources scanned above and the
    modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", ["server.py", "lifecycle.py", "cli.py",
                                    "workload.py", "fleet.py",
                                    "continual.py", "tuner.py"])
def test_serving_tier_modules_are_scanned(module):
    """The model server, the model lifecycle, the command line that
    serves them, the workload recorder, the serving fleet, continuous
    training and the offline autotuner are among the sources scanned
    above and the modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    assert dotted in _modules()


@pytest.mark.parametrize("module", ["parallel/__init__.py",
                                    "parallel/mesh.py",
                                    "parallel/multihost.py"])
def test_mesh_modules_are_scanned(module):
    """The mesh and the joining of ranks are among the sources scanned
    above and the modules imported with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    parts = path.relative_to(ROOT).with_suffix("").parts
    if parts[-1] == "__init__":
        parts = parts[:-1]
    assert ".".join(parts) in _modules()


def test_a_telemetry_on_train_runs_with_jax_blocked(tmp_path):
    """With ``jax`` and the JAX package blocked, the port trains through
    its runner on the CPU with telemetry on and writes its trace."""
    trace = tmp_path / "t.json"
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'transmogrifai_tpu'):\n"
        "    sys.modules[name] = None\n"
        "import json\n"
        "import numpy as np\n"
        "from transmogrifai_tpu_torch import FeatureBuilder as FB\n"
        "from transmogrifai_tpu_torch import Workflow\n"
        "from transmogrifai_tpu_torch.dsl import transmogrify\n"
        "from transmogrifai_tpu_torch.models.linear import "
        "LogisticRegressionFamily as LR\n"
        "from transmogrifai_tpu_torch.models.selector import "
        "BinaryClassificationModelSelector as S\n"
        "from transmogrifai_tpu_torch.readers import DataReaders\n"
        "from transmogrifai_tpu_torch.runner import (OpParams, "
        "OpWorkflowRunner, RunType)\n"
        "rng = np.random.default_rng(0)\n"
        "y = rng.integers(0, 2, 80).astype(float)\n"
        "recs = [{'label': float(v), 'x': float(rng.normal() + v)} "
        "for v in y]\n"
        "label = FB.RealNN('label').from_column().as_response()\n"
        "fx = FB.Real('x').from_column().as_predictor()\n"
        "sel = S.with_cross_validation(num_folds=2, families=[LR(grid=["
        "{'regParam': 0.01, 'elasticNetParam': 0.0}])], splitter=None, "
        "seed=5)\n"
        "pred = label.transform_with(sel, transmogrify([fx]))\n"
        "runner = OpWorkflowRunner(Workflow().set_result_features(pred), "
        "training_reader=DataReaders.simple.records(recs), device='cpu')\n"
        f"out = runner.run(RunType.TRAIN, OpParams(trace_location="
        f"{str(trace)!r}))\n"
        "assert out.metrics['telemetry']['fittedStages'] == 2\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'transmogrifai_tpu') and sys.modules[m]]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"run:Train", "workflow:train", "fit:stage"} <= names


@pytest.mark.parametrize("module", [
    "config.py", "cli.py", "__main__.py", "testkit/__init__.py",
    "repo_lint/__init__.py", "repo_lint/tmoglint.py",
    "repo_lint/concurrency_lint.py"])
def test_command_line_modules_are_scanned(module):
    """The knob registry, the command line, the testkit and the repo-rule
    linters are among the sources scanned above and the modules imported
    with ``jax`` blocked."""
    path = PORT / module
    assert path in SOURCES
    dotted = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    if dotted.endswith(".__init__"):
        dotted = dotted[:-len(".__init__")]
    assert dotted in _modules()


def test_the_command_line_runs_with_jax_blocked(tmp_path):
    """``gen``, ``check`` and ``lint`` in a process where ``jax`` and the
    JAX package cannot be imported."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'transmogrifai_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from transmogrifai_tpu_torch import cli\n"
        f"csv_path = {str(tmp_path / 'd.csv')!r}\n"
        "open(csv_path, 'w').write('x,y\\n1.5,0\\n2.5,1\\n3.5,0\\n')\n"
        f"out = {str(tmp_path / 'p')!r}\n"
        "assert cli.main(['gen', '--input', csv_path, '--response', 'y', "
        "'--output', out]) == 0\n"
        "assert cli.main(['check', out + '/params.json']) == 0\n"
        "assert cli.main(['lint', '--no-tests-check']) == 0\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'transmogrifai_tpu') and sys.modules[m]]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().endswith("ok")
