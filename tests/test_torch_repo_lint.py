"""The port's repo-rule linters (``transmogrifai_tpu_torch/repo_lint``)
against the JAX package's ``tools/tmoglint.py`` and
``tools/concurrency_lint.py``: the same rule ids at the same lines on a
small fixture tree (the JAX constructs of TMG306, TMG311 and TMG312 beside
their torch counterparts), the fault-site coverage rule, the port's tree
clean under both (``python -m transmogrifai_tpu_torch lint``), and the
kernel build's compiler wait bounded by a timeout that names the source."""
import importlib.util
import os
import pathlib
import re
import stat

import pytest

from transmogrifai_tpu_torch import cli, resilience
from transmogrifai_tpu_torch.models import _hist
from transmogrifai_tpu_torch.repo_lint import concurrency_lint as pconc
from transmogrifai_tpu_torch.repo_lint import tmoglint as ptmog

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jtools():
    return _tool("tmoglint"), _tool("concurrency_lint")


#: one module tripping every per-line rule the two packages share
COMMON = '''\
import queue
import subprocess
import threading
import time

import numpy as np

from . import resilience, telemetry


def f(params, x):
    t = time.time()
    try:
        pass
    except Exception:
        pass
    resilience.inject("no.such.site")
    resilience.inject(x)
    telemetry.span("s")
    with telemetry.span("ok"):
        pass
    threading.Thread(target=loop)
    queue.Queue()
    queue.Queue(maxsize=0)
    subprocess.Popen(["true"])
    np.argsort([3, 1])
    np.searchsorted([1, 2], 1)
    telemetry.counter(f"a.{t}").inc()
    params.customParams["k"] = 1
    return params.custom_params.get("k"), params.custom_params["j"]


def loop():
    while True:
        pass


y = time.time()  # lint: wall-clock — a sink timestamp
z = 1  # lint: sort — nothing here sorts
'''

#: the rules whose construct is JAX's: the JAX spelling ...
JAX_CONSTRUCTS = '''\
import numpy as np
from jax.experimental import pallas as pl

from .parallel import mesh


def g(k, x):
    mesh.make_mesh()
    pl.pallas_call(k)
    return np.argsort(x)
'''

#: ... and the port's, at the same lines
PORT_CONSTRUCTS = '''\
import ctypes
import torch
from torch.distributed.device_mesh import init_device_mesh


def g(k, x):
    init_device_mesh("cuda", (2,))
    ctypes.CDLL(k)
    a = torch.argsort(x)
    b = torch.sort(x, stable=True)
    return a, b, torch.sort(x)
'''

#: a program tripping each whole-program rule
CONCURRENCY = '''\
import threading
import time

_A = threading.Lock()
_B = threading.Lock()
_STATE = {}


def one():
    with _A:
        with _B:
            pass


def two():
    with _B:
        with _A:
            pass


def blocking():
    with _A:
        time.sleep(1)


def writer(path):
    with open(path + "registry.json", "w") as fh:
        fh.write("x")


def worker():
    _STATE["k"] = 1


def locked_set():
    with _A:
        _STATE["j"] = 2


def start():
    threading.Thread(target=worker, name="w", daemon=True).start()


v = 1  # lint: lock-order — nothing here takes a lock
'''


def _rules(findings):
    return sorted((f.rule, int(f.location.rsplit(":", 1)[1]))
                  for f in findings)


def test_per_line_rules_equal_the_jax_tools(jtools, tmp_path):
    jtmog, _ = jtools
    path = tmp_path / "mod.py"
    path.write_text(COMMON)
    want = _rules(jtmog.lint_file(str(path)))
    assert _rules(ptmog.lint_file(str(path))) == want
    assert {r for r, _ in want} == {
        "TMG301", "TMG302", "TMG303", "TMG304", "TMG307", "TMG308",
        "TMG309", "TMG310", "TMG311", "TMG313", "TMG314", "TMG399"}
    bad = tmp_path / "broken.py"
    bad.write_text("def f(:\n")
    assert _rules(ptmog.lint_file(str(bad))) == \
        _rules(jtmog.lint_file(str(bad))) == [("TMG305", 1)]
    # the exempt homes: config.py reads customParams, tests do anything
    home = tmp_path / "config.py"
    home.write_text("def f(custom_params):\n"
                    "    return custom_params.get('k')\n")
    assert ptmog.lint_file(str(home)) == jtmog.lint_file(str(home)) == []


def test_ported_constructs_give_the_jax_rule_ids(jtools, tmp_path):
    """TMG306 (a torch.distributed mesh for make_mesh), TMG312 (a kernel
    bound outside models/_hist.py for pl.pallas_call outside
    _pallas_hist.py) and TMG311 (an unstable torch sort beside numpy's)
    fire where the JAX tool fires on the JAX constructs."""
    jtmog, _ = jtools
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jpath, ppath = tmp_path / "j" / "mod.py", tmp_path / "p" / "mod.py"
    jpath.write_text(JAX_CONSTRUCTS)
    ppath.write_text(PORT_CONSTRUCTS)
    want = _rules(jtmog.lint_file(str(jpath)))
    assert want == [("TMG306", 8), ("TMG311", 10), ("TMG312", 9)]
    got = _rules(ptmog.lint_file(str(ppath)))
    assert got == [("TMG306", 7), ("TMG311", 9), ("TMG311", 11),
                   ("TMG312", 8)]
    assert {r for r, _ in got} == {r for r, _ in want}
    # the kernels' module and parallel/ are the homes
    home = tmp_path / "models"
    home.mkdir()
    (home / "_hist.py").write_text(PORT_CONSTRUCTS)
    assert [r for r, _ in _rules(ptmog.lint_file(str(home / "_hist.py")))] \
        == ["TMG306", "TMG311", "TMG311"]
    (tmp_path / "parallel").mkdir()
    mesh = tmp_path / "parallel" / "mesh.py"
    mesh.write_text(PORT_CONSTRUCTS)
    assert [r for r, _ in _rules(ptmog.lint_file(str(mesh)))] == \
        ["TMG311", "TMG311", "TMG312"]
    marked = tmp_path / "p" / "marked.py"
    marked.write_text(PORT_CONSTRUCTS.replace(
        'ctypes.CDLL(k)', 'ctypes.CDLL(k)  # lint: pallas — a host library'))
    assert [r for r, _ in _rules(ptmog.lint_file(str(marked)))] == \
        ["TMG306", "TMG311", "TMG311"]


def test_whole_program_rules_equal_the_jax_tools(jtools, tmp_path):
    _, jconc = jtools
    path = str(tmp_path / "prog.py")
    want = _rules(jconc.analyze_sources({path: CONCURRENCY}))
    assert _rules(pconc.analyze_sources({path: CONCURRENCY})) == want
    assert {r for r, _ in want} == {"TMG399", "TMG801", "TMG802", "TMG803",
                                    "TMG804"}


def test_fault_site_coverage_reads_the_ports_tests(jtools, tmp_path):
    """TMG805 over a tests directory: the JAX tool's findings, but for the
    sites of modules not ported yet (``resilience.UNPORTED_SITES``, empty
    since the fleet and continual sites came with their modules), and
    only ``test_torch_*.py`` files count."""
    _, jconc = jtools
    (tmp_path / "test_torch_x.py").write_text(
        'SITES = ["stream.poll", \'csv.decode\']\n')
    want = {f.message.split("'")[1]
            for f in jconc.fault_coverage_findings(str(tmp_path))}
    got = {f.message.split("'")[1]
           for f in pconc.fault_coverage_findings(str(tmp_path))}
    assert got == want - set(resilience.UNPORTED_SITES)
    assert "stream.poll" not in got and "avro.decode" in got
    (tmp_path / "test_other.py").write_text('S = "avro.decode"\n')
    again = {f.message.split("'")[1]
             for f in pconc.fault_coverage_findings(str(tmp_path))}
    assert again == got


def test_the_ports_tree_is_clean_under_its_linters(capsys):
    assert cli.main(["lint"]) == 0
    assert "lint: 0 error(s), 0 warning(s), 0 info(s)" in \
        capsys.readouterr().out


def test_no_code_injects_a_site_of_an_unported_module():
    """The coverage rule skips ``UNPORTED_SITES`` only while nothing
    injects them; with every module ported the set is empty and the
    port's code injects every catalogued site."""
    assert set(resilience.UNPORTED_SITES) <= resilience.FAULT_SITES
    injected = set()
    for path in sorted(pathlib.Path(ptmog.PACKAGE_DIR).rglob("*.py")):
        injected |= set(re.findall(r'inject\(\s*"([^"]+)"',
                                   path.read_text()))
    assert injected and not injected & set(resilience.UNPORTED_SITES)
    assert resilience.UNPORTED_SITES == {}
    assert injected == resilience.FAULT_SITES


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body + "\n")
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_a_hung_compiler_raises_naming_the_kernel_source(tmp_path,
                                                         monkeypatch):
    """The kernel build waits for ``nvcc`` outside ``_BUILD_LOCK`` and at
    most ``NVCC_TIMEOUT_S``; a compiler past it is killed and the build
    raises naming the source, and a failing one names its source too."""
    src = tmp_path / "cumhist.cu"
    src.write_text("// a kernel\n")
    monkeypatch.setattr(_hist, "_nvcc",
                        lambda: _fake_nvcc(tmp_path, "exec sleep 30"))
    monkeypatch.setattr(_hist, "NVCC_TIMEOUT_S", 0.3)
    with pytest.raises(RuntimeError, match=r"cumhist\.cu did not finish "
                       r"within 0\.3 s"):
        _hist._compile([("cumhist", src, tmp_path / "cumhist-x.so")])
    monkeypatch.setattr(_hist, "_nvcc", lambda: _fake_nvcc(
        tmp_path, "echo 'error: bad kernel'; exit 3"))
    with pytest.raises(RuntimeError, match=r"(?s)build failed.*cumhist\.cu"
                       r".*bad kernel"):
        _hist._compile([("cumhist", src, tmp_path / "cumhist-x.so")])
    assert not _hist._BUILD_LOCK.locked()
    assert sorted(os.listdir(tmp_path)) == ["cumhist.cu", "nvcc"]
