"""The PyTorch port stands alone: importing it never loads ``jax`` or the
JAX package, and no source of it names either."""
import ast
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
