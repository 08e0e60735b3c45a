#!/usr/bin/env python
"""tmoglint — AST-based repo self-lint enforcing project invariants; the
port of the JAX package's ``tools/tmoglint.py`` for this package's tree.

The rules are the TMG3xx family of the catalog in
``transmogrifai_tpu_torch/lint.py``, with the JAX tool's ids, allow
markers and messages. Three rules name a JAX construct in the JAX tool
and name this package's counterpart here: TMG306 (a ``torch.distributed``
mesh), TMG311 (``torch.argsort`` / ``torch.sort`` beside numpy's) and
TMG312 (where device kernels are bound):

* **TMG301** — monotonic timing must use ``time.perf_counter()``, never
  ``time.time()`` (the timing rule: an NTP step mid-run corrupts every
  ``time.time()`` duration). Legitimate wall-clock uses — mtime
  comparisons, epoch timestamps written to sinks — carry a
  ``# lint: wall-clock`` marker on the offending line.
* **TMG302** — ``except Exception`` (or ``BaseException``) appears only
  at allowlisted breaker/fallback/quarantine sites marked
  ``# lint: broad-except`` (ideally with a dash-reason). Everything
  else must catch the specific exceptions it can actually handle.
* **TMG303** — every ``resilience.inject(site)`` marker names a site
  registered in ``resilience.FAULT_SITES``: a typo'd site is a chaos
  test that silently never fires.
* **TMG304** — telemetry spans open via context managers
  (``with telemetry.span(...)``): a bare ``span(...)`` call is an
  unpaired begin/end that never records and silently corrupts the
  per-thread span stack.
* **TMG306** — runtime code must not construct a device mesh directly:
  ``torch.distributed``'s ``init_device_mesh()`` / ``DeviceMesh(...)``
  (and a ``make_mesh()`` of a mesh module) belong to ``parallel/``, so
  every consumer shares the one process mesh (a throwaway mesh per pass
  is the regression a mesh-construction count exists to catch).
  ``parallel/`` itself and tests are exempt; a deliberate explicit
  construction carries ``# lint: explicit-mesh — reason``.
* **TMG307** — ``threading.Thread(...)`` must pass ``name=`` and
  ``daemon=`` explicitly (the model-server rule: the telemetry
  tracer keys trace tracks by thread name, so an unnamed worker renders
  as ``Thread-7`` and an implicit daemon flag hides whether shutdown
  waits for it). A deliberate default carries
  ``# lint: thread — reason``.
* **TMG308** — ``queue.Queue()`` must pass an explicit ``maxsize=``
  (the input-pipeline rule: an unbounded queue between pipeline stages
  hides backpressure — a stalled consumer lets the producer eat the
  heap instead of slowing down; the staged pipeline's whole contract
  is bounded queues with explicit backpressure). A deliberate
  unbounded queue carries ``# lint: unbounded-queue — reason``.
* **TMG309** — product-code ``subprocess.Popen(...)`` must pass
  explicit ``stdout=`` and ``stderr=`` (the fleet-supervisor rule: an
  inherited stdout ties a long-lived child's output to whatever
  terminal started the parent, and a ``PIPE`` nobody drains deadlocks
  the child once the OS buffer fills — a supervisor must own its
  workers' streams). A deliberate inherit carries
  ``# lint: popen — reason``.
* **TMG310** — a function used as a ``threading.Thread`` ``target=``
  must not contain a ``while`` loop with no ``try`` anywhere in its
  body (the continual-tier rule: an uncaught exception kills the
  thread SILENTLY — the drift sentinel, a fleet monitor or a retrain
  supervisor keeps "running" with nobody home while its queue fills
  and its subsystem rots; long-lived loop bodies must catch-and-tally).
  A deliberately bare loop carries ``# lint: thread-loop — reason`` on
  the ``while`` line or the ``def`` line.
* **TMG311** — ``np.argsort(...)`` must pass an explicit ``kind=`` and
  ``np.searchsorted(...)`` an explicit ``side=``; ``torch.argsort(...)``
  and ``torch.sort(...)`` must pass ``stable=True`` (the temporal-tier
  rule: the columnar aggregation engine groups by key with a STABLE
  argsort precisely because order-dependent monoid folds — float sums,
  concat, first/last — silently change value under unstable sort ties,
  and an implicit ``side=`` hides which boundary of a cutoff window is
  inclusive; torch's sorts are unstable unless asked). A deliberate
  default carries ``# lint: sort — reason``. Only calls attributable to
  numpy or torch (module aliases / ``from numpy import argsort``) are
  checked; the method forms ``x.argsort()`` / ``x.sort()`` are out of
  scope.
* **TMG312** — device kernels are bound and launched only in
  ``models/_hist.py``, the kernels' module and the home of the
  ``tmog_torch::predict_trees`` operator (the tree-engine rule: every
  kernel lives behind that module's build, its launch counts and its
  rule that a CUDA tensor launches the kernel or raises — a kernel bound
  elsewhere escapes the counts and the plain-version checks). A bound
  kernel is a ``ctypes.CDLL(...)`` / ``ctypes.cdll.LoadLibrary(...)``,
  ``torch.ops.load_library(...)``, ``torch.library.custom_op(...)`` /
  ``torch.library.Library(...)``, ``torch.utils.cpp_extension.load(...)``
  / ``load_inline(...)`` or a ``@triton.jit`` function. Tests are exempt;
  a deliberate binding elsewhere carries ``# lint: pallas — reason``.
* **TMG313** — ``telemetry.counter/gauge/histogram(...)`` must pass a
  LITERAL metric name outside ``telemetry.py`` (the observability-plane
  rule: a dynamic name is unbounded registry AND ``/metrics``
  exposition cardinality — every distinct runtime value becomes a new
  instrument held for the process lifetime and a new family in every
  scrape; a per-entity name interpolated from unbounded input can eat
  the heap and flood the scrape surface). Tests are exempt; a
  deliberately dynamic name whose domain is provably bounded (a fixed
  tally catalog, the registered tenant roster) carries
  ``# lint: metric-name — reason``.
* **TMG314** — raw ``customParams`` READS (a Load-context subscript or
  ``.get()`` on a receiver named/ending ``custom_params``/
  ``customParams``) appear only in ``config.py`` (the declared-
  config rule: the knob registry owns types, bounds and error wording —
  a raw read elsewhere bypasses validation, drifts from the declared
  default, and is invisible to ``cli check``/the tuner's search space;
  route through ``config.numeric_param``/``bool_param``/
  ``string_param`` or the runner wrappers). Writes are exempt (the CLI
  legitimately ASSEMBLES customParams dicts); tests are exempt; a
  deliberate raw passthrough (a path/dict handed verbatim to its owner)
  carries ``# lint: knob — reason``.

Runs as a CLI over one or more paths (default: the
``transmogrifai_tpu_torch`` package this file is part of), through
``python -m transmogrifai_tpu_torch lint``, and as a tier-1 pytest
(``tests/test_torch_repo_lint.py`` asserts the port's tree is clean)::

    python -m transmogrifai_tpu_torch.repo_lint.tmoglint
    python -m transmogrifai_tpu_torch.repo_lint.tmoglint path/ --fail-on warning
"""
from __future__ import annotations

import argparse
import ast
import io
import os
import re
import sys
import tokenize
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ..lint import Finding, Severity, enforce

#: the package this linter belongs to: the default path it lints
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

__all__ = ["lint_source", "lint_file", "lint_paths", "main",
           "MARKER_RULES",
           "ALLOW_WALLCLOCK", "ALLOW_BROAD_EXCEPT", "ALLOW_EXPLICIT_MESH",
           "ALLOW_THREAD", "ALLOW_UNBOUNDED_QUEUE", "ALLOW_POPEN",
           "ALLOW_THREAD_LOOP", "ALLOW_SORT", "ALLOW_PALLAS",
           "ALLOW_METRIC_NAME", "ALLOW_KNOB", "PACKAGE_DIR"]

#: suppression markers, checked on the finding's own source line
ALLOW_WALLCLOCK = "lint: wall-clock"
ALLOW_BROAD_EXCEPT = "lint: broad-except"
ALLOW_EXPLICIT_MESH = "lint: explicit-mesh"
ALLOW_THREAD = "lint: thread"
ALLOW_UNBOUNDED_QUEUE = "lint: unbounded-queue"
ALLOW_POPEN = "lint: popen"
ALLOW_THREAD_LOOP = "lint: thread-loop"
ALLOW_SORT = "lint: sort"
ALLOW_PALLAS = "lint: pallas"
ALLOW_METRIC_NAME = "lint: metric-name"
ALLOW_KNOB = "lint: knob"

#: marker word → the ONE rule it silences. The stale-marker pass
#: (TMG399) flags any marker comment whose rule did not actually fire
#: on that line — suppressions must not outlive their findings. Only
#: THIS tool's vocabulary is checked here; the TMG8xx markers
#: (lock-order, thread-escape, lock-blocking, atomic-write) belong to
#: concurrency_lint.py beside this file, which runs its own stale pass.
MARKER_RULES: Dict[str, str] = {
    "wall-clock": "TMG301",
    "broad-except": "TMG302",
    "explicit-mesh": "TMG306",
    "thread": "TMG307",
    "unbounded-queue": "TMG308",
    "popen": "TMG309",
    "thread-loop": "TMG310",
    "sort": "TMG311",
    "pallas": "TMG312",
    "metric-name": "TMG313",
    "knob": "TMG314",
}

#: matches the marker word in a real COMMENT token (the word after
#: "lint:", as in the ALLOW_* strings above)
_MARKER_RE = re.compile(r"lint:\s*([a-z][a-z-]*)")

#: the ONE module sanctioned to build instrument names dynamically
#: (TMG313): the registry itself owns cardinality
METRICS_HOME = "telemetry.py"

#: the ONE module sanctioned to read customParams raw (TMG314): the
#: knob registry owns types, bounds, defaults and error wording
CONFIG_HOME = "config.py"

#: the ONE module sanctioned to bind device kernels (TMG312): the
#: kernels' build, launch counts and card-or-raise rule live there, and
#: so does the ``tmog_torch::predict_trees`` operator
KERNEL_HOME = ("models", "_hist.py")

#: mesh constructors of ``torch.distributed`` (TMG306)
_MESH_CTORS = ("init_device_mesh", "DeviceMesh")

#: ``torch.library`` / ``cpp_extension`` calls that register or build a
#: kernel (TMG312), and the ctypes loaders that bind a built one
_KERNEL_BINDERS = {"custom_op", "Library", "load", "load_inline",
                   "load_library"}
_CTYPES_LOADERS = ("CDLL", "LoadLibrary")


def _fault_sites() -> frozenset:
    from ..resilience import FAULT_SITES
    return FAULT_SITES


class _Visitor(ast.NodeVisitor):
    """One file's AST walk. Collects import aliases first (so ``import
    time as _time`` still triggers TMG301) and the set of Call nodes
    used as ``with``-item context expressions (TMG304)."""

    def __init__(self, path: str, lines: Sequence[str]):
        self.path = path
        self.lines = lines
        self.findings: List[Finding] = []
        #: local names bound to the time module / telemetry module /
        #: resilience module / mesh module / their relevant functions
        self.time_modules: Set[str] = set()
        self.time_funcs: Set[str] = set()       # from time import time [as x]
        self.telemetry_modules: Set[str] = set()
        self.span_funcs: Set[str] = set()
        self.resilience_modules: Set[str] = set()
        self.inject_funcs: Set[str] = set()
        self.mesh_modules: Set[str] = set()
        self.make_mesh_funcs: Set[str] = set()
        self.threading_modules: Set[str] = set()
        self.thread_funcs: Set[str] = set()      # from threading import Thread
        self.queue_modules: Set[str] = set()
        self.queue_funcs: Set[str] = set()       # from queue import Queue
        self.subprocess_modules: Set[str] = set()
        self.popen_funcs: Set[str] = set()       # from subprocess import Popen
        self.numpy_modules: Set[str] = set()
        self.np_sort_funcs: Dict[str, str] = {}  # from numpy import argsort
        #: TMG306/311/312: names bound to torch, torch.distributed (and
        #: its device_mesh), ctypes, triton, and their functions
        self.torch_modules: Set[str] = set()
        self.torch_sort_funcs: Dict[str, str] = {}  # from torch import sort
        self.dist_modules: Set[str] = set()
        self.mesh_ctor_funcs: Set[str] = set()      # from ... import init_device_mesh
        self.ctypes_modules: Set[str] = set()
        self.ctypes_funcs: Set[str] = set()         # from ctypes import CDLL
        self.triton_modules: Set[str] = set()
        self.binder_funcs: Set[str] = set()         # from torch.library import custom_op
        self.instrument_funcs: Dict[str, str] = {}  # from telemetry import counter
        self.with_contexts: Set[int] = set()
        #: TMG310 bookkeeping: names used as Thread(target=...) and the
        #: module's function defs by name (methods included; resolved in
        #: a post-pass so definition order never matters)
        self.thread_targets: Set[str] = set()
        self.func_defs: Dict[str, ast.AST] = {}
        #: TMG399 bookkeeping: line → rules a marker on that line
        #: actually silenced during this walk
        self.used_markers: Dict[int, Set[str]] = {}
        #: parallel/ owns mesh construction, tests may build explicit
        #: topologies — TMG306 exempts both by path
        parts = os.path.normpath(path).split(os.sep)
        self.mesh_exempt = ("parallel" in parts or "tests" in parts
                            or os.path.basename(path).startswith("test_"))
        #: models/_hist.py owns kernel binding (its build, counts and
        #: card-or-raise rule are the rule's point); tests may bind
        #: throwaway kernels
        self.pallas_exempt = (tuple(parts[-2:]) == KERNEL_HOME
                              or "tests" in parts
                              or os.path.basename(path).startswith("test_"))
        #: telemetry.py owns the registry (its factories RECEIVE the
        #: names); tests may build throwaway instruments — TMG313
        self.metric_exempt = (os.path.basename(path) == METRICS_HOME
                              or "tests" in parts
                              or os.path.basename(path).startswith("test_"))
        #: config.py owns raw customParams access (its registry
        #: accessors ARE the sanctioned read path); tests may poke raw
        #: dicts freely — TMG314
        self.knob_exempt = (os.path.basename(path) == CONFIG_HOME
                            or "tests" in parts
                            or os.path.basename(path).startswith("test_"))

    # -- helpers -----------------------------------------------------------
    def _marked(self, lineno: int, marker: str) -> bool:
        if 1 <= lineno <= len(self.lines):
            return marker in self.lines[lineno - 1]
        return False

    def _add(self, rule: str, lineno: int, message: str,
             severity: Optional[str] = None) -> None:
        self.findings.append(Finding(
            rule, message, severity=severity or "",
            location=f"{self.path}:{lineno}"))

    def _suppressible(self, rule: str, marker: str, lineno: int,
                      message: str,
                      lines: Optional[Sequence[int]] = None,
                      severity: Optional[str] = None) -> None:
        """Emit ``rule`` at ``lineno`` unless a ``marker`` on one of
        ``lines`` (default: the finding line) silences it. A silencing
        marker is recorded as USED so the stale-marker pass (TMG399)
        can flag the ones that no longer silence anything."""
        for ln in (lines or (lineno,)):
            if self._marked(ln, marker):
                self.used_markers.setdefault(ln, set()).add(rule)
                return
        self._add(rule, lineno, message, severity)

    # -- imports -----------------------------------------------------------
    def visit_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            local = alias.asname or alias.name.split(".")[0]
            if alias.name == "time":
                self.time_modules.add(local)
            if alias.name.endswith("telemetry"):
                self.telemetry_modules.add(local)
            if alias.name.endswith("resilience"):
                self.resilience_modules.add(local)
            if alias.name.endswith("mesh"):
                self.mesh_modules.add(local)
            if alias.name == "threading":
                self.threading_modules.add(local)
            if alias.name == "queue":
                self.queue_modules.add(local)
            if alias.name == "subprocess":
                self.subprocess_modules.add(local)
            if alias.name == "numpy":
                self.numpy_modules.add(local)
            if alias.name == "torch":
                self.torch_modules.add(local)
            if alias.name.startswith("torch.distributed") and alias.asname:
                # no-asname dotted imports bind only "torch" locally; the
                # call form torch.distributed.device_mesh.init_device_mesh
                # is matched as a dotted chain in _is_make_mesh instead
                self.dist_modules.add(local)
            if alias.name == "ctypes":
                self.ctypes_modules.add(local)
            if alias.name == "triton":
                self.triton_modules.add(local)
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        mod = node.module or ""
        for alias in node.names:
            local = alias.asname or alias.name
            if mod == "time" and alias.name == "time":
                self.time_funcs.add(local)
            if alias.name == "telemetry":
                self.telemetry_modules.add(local)
            if alias.name == "resilience":
                self.resilience_modules.add(local)
            if alias.name == "mesh":
                self.mesh_modules.add(local)
            if mod.endswith("telemetry") and alias.name == "span":
                self.span_funcs.add(local)
            if mod.endswith("resilience") and alias.name == "inject":
                self.inject_funcs.add(local)
            if mod.endswith("mesh") and alias.name == "make_mesh":
                self.make_mesh_funcs.add(local)
            if mod == "threading" and alias.name == "Thread":
                self.thread_funcs.add(local)
            if mod == "queue" and alias.name == "Queue":
                self.queue_funcs.add(local)
            if mod == "subprocess" and alias.name == "Popen":
                self.popen_funcs.add(local)
            if mod == "numpy" and alias.name in ("argsort",
                                                 "searchsorted"):
                self.np_sort_funcs[local] = alias.name
            if mod == "torch" and alias.name in ("argsort", "sort"):
                self.torch_sort_funcs[local] = alias.name
            if mod.startswith("torch.distributed"):
                if alias.name in _MESH_CTORS:
                    self.mesh_ctor_funcs.add(local)
                elif alias.name in ("device_mesh", "distributed"):
                    self.dist_modules.add(local)
            if mod == "torch" and alias.name == "distributed":
                self.dist_modules.add(local)
            if mod == "ctypes" and alias.name in _CTYPES_LOADERS + (
                    "cdll",):
                self.ctypes_funcs.add(local)
            if mod in ("torch.library", "torch.utils.cpp_extension") \
                    and alias.name in _KERNEL_BINDERS:
                self.binder_funcs.add(local)
            if mod.endswith("telemetry") and alias.name in (
                    "counter", "gauge", "histogram"):
                self.instrument_funcs[local] = alias.name
        self.generic_visit(node)

    # -- function defs: TMG310 target resolution ---------------------------
    def visit_FunctionDef(self, node) -> None:
        self.func_defs.setdefault(node.name, node)
        if not self.pallas_exempt:
            for deco in node.decorator_list:
                if self._is_triton_kernel(deco):
                    self._kernel_finding(deco.lineno)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- with: remember sanctioned context-manager calls -------------------
    def visit_With(self, node: ast.With) -> None:
        for item in node.items:
            if isinstance(item.context_expr, ast.Call):
                self.with_contexts.add(id(item.context_expr))
        self.generic_visit(node)

    visit_AsyncWith = visit_With

    # -- except Exception --------------------------------------------------
    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        names = []
        t = node.type
        if isinstance(t, ast.Tuple):
            names = [getattr(e, "id", getattr(e, "attr", "")) for e
                     in t.elts]
        elif t is not None:
            names = [getattr(t, "id", getattr(t, "attr", ""))]
        if any(n in ("Exception", "BaseException") for n in names):
            self._suppressible(
                "TMG302", ALLOW_BROAD_EXCEPT, node.lineno,
                "broad 'except Exception' outside the allowlist — catch "
                "the specific exceptions or mark the line "
                f"'# {ALLOW_BROAD_EXCEPT} — <reason>' if this is a "
                "deliberate breaker/fallback/quarantine site")
        self.generic_visit(node)

    # -- calls: time.time / inject / span ----------------------------------
    def _is_time_time(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "time" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.time_modules:
            return True
        return isinstance(f, ast.Name) and f.id in self.time_funcs

    def _is_inject(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "inject" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.resilience_modules:
            return True
        return isinstance(f, ast.Name) and f.id in self.inject_funcs

    def _is_span(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "span" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.telemetry_modules:
            return True
        return isinstance(f, ast.Name) and f.id in self.span_funcs

    def _is_make_mesh(self, node: ast.Call) -> bool:
        """A device mesh built here: ``torch.distributed``'s
        ``init_device_mesh`` / ``DeviceMesh`` (module alias, dotted chain
        or from-import), or a mesh module's ``make_mesh``."""
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "make_mesh" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.mesh_modules:
            return True
        if isinstance(f, ast.Attribute) and f.attr in _MESH_CTORS:
            if isinstance(f.value, ast.Name) \
                    and f.value.id in self.dist_modules:
                return True
            chain = self._dotted(f.value) or ""
            head = chain.split(".")[0]
            return head in self.torch_modules \
                and chain.startswith(f"{head}.distributed")
        return isinstance(f, ast.Name) and (f.id in self.make_mesh_funcs
                                            or f.id in self.mesh_ctor_funcs)

    def _is_thread(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "Thread" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.threading_modules:
            return True
        return isinstance(f, ast.Name) and f.id in self.thread_funcs

    def _is_queue(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "Queue" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.queue_modules:
            return True
        return isinstance(f, ast.Name) and f.id in self.queue_funcs

    def _is_popen(self, node: ast.Call) -> bool:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "Popen" \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.subprocess_modules:
            return True
        return isinstance(f, ast.Name) and f.id in self.popen_funcs

    @staticmethod
    def _dotted(node) -> Optional[str]:
        """'a.b.c' for a Name/Attribute chain, else None."""
        parts = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        return ".".join(reversed(parts))

    def _is_pallas_call(self, node: ast.Call) -> bool:
        """A device kernel bound here (TMG312): a ctypes loader, a
        ``torch.library`` registration, a ``cpp_extension`` build or
        ``torch.ops.load_library``."""
        f = node.func
        if isinstance(f, ast.Name):
            return f.id in self.binder_funcs or (
                f.id in self.ctypes_funcs and f.id in _CTYPES_LOADERS)
        if not isinstance(f, ast.Attribute):
            return False
        chain = self._dotted(f.value) or ""
        head = chain.split(".")[0]
        if f.attr in _CTYPES_LOADERS:
            return head in self.ctypes_modules or chain in self.ctypes_funcs
        if f.attr in _KERNEL_BINDERS and head in self.torch_modules:
            return chain[len(head):] in (".library", ".utils.cpp_extension",
                                         ".ops")
        return False

    def _is_triton_kernel(self, deco) -> bool:
        """``@triton.jit`` / ``@triton.autotune(...)`` on a function."""
        f = deco.func if isinstance(deco, ast.Call) else deco
        return isinstance(f, ast.Attribute) \
            and f.attr in ("jit", "autotune", "heuristics") \
            and isinstance(f.value, ast.Name) \
            and f.value.id in self.triton_modules

    def _instrument_kind(self, node: ast.Call) -> Optional[str]:
        """\"counter\"/\"gauge\"/\"histogram\" when the call is
        attributable to the telemetry module (module alias or
        from-import), else None."""
        f = node.func
        if isinstance(f, ast.Attribute) \
                and f.attr in ("counter", "gauge", "histogram") \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.telemetry_modules:
            return f.attr
        if isinstance(f, ast.Name):
            return self.instrument_funcs.get(f.id)
        return None

    def _np_sort_kind(self, node: ast.Call) -> Optional[str]:
        """\"argsort\"/\"searchsorted\" when the call is attributable to
        numpy, \"torch.argsort\"/\"torch.sort\" when it is attributable
        to torch (module alias or from-import), else None — the method
        forms ``x.argsort()`` / ``x.sort()`` are out of scope."""
        f = node.func
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
            if f.attr in ("argsort", "searchsorted") \
                    and f.value.id in self.numpy_modules:
                return f.attr
            if f.attr in ("argsort", "sort") \
                    and f.value.id in self.torch_modules:
                return f"torch.{f.attr}"
        if isinstance(f, ast.Name):
            if f.id in self.torch_sort_funcs:
                return f"torch.{self.torch_sort_funcs[f.id]}"
            return self.np_sort_funcs.get(f.id)
        return None

    # -- TMG314: raw customParams reads outside config.py ------------------
    @staticmethod
    def _is_knob_receiver(expr) -> bool:
        """True when ``expr`` names a customParams mapping: a bare
        ``custom_params``/``customParams`` Name or any Attribute chain
        ending in one (``params.custom_params``, ``self.customParams``)."""
        name = None
        if isinstance(expr, ast.Name):
            name = expr.id
        elif isinstance(expr, ast.Attribute):
            name = expr.attr
        if name is None:
            return False
        return name.endswith("custom_params") or name.endswith(
            "customParams")

    @staticmethod
    def _knob_lines(node) -> Tuple[int, int]:
        """The ``# lint: knob`` marker may sit on the read's FIRST or
        LAST physical line (a wrapped ``.get(...)`` continuation puts
        the comment after the closing paren, a line below where the
        expression starts)."""
        return (node.lineno,
                getattr(node, "end_lineno", node.lineno) or node.lineno)

    def visit_Subscript(self, node: ast.Subscript) -> None:
        # Load-context only: the CLI legitimately ASSEMBLES customParams
        # dicts (Store/Del writes stay clean); reads must route through
        # the registry accessors
        if isinstance(node.ctx, ast.Load) \
                and self._is_knob_receiver(node.value) \
                and not self.knob_exempt:
            self._suppressible(
                "TMG314", ALLOW_KNOB, node.lineno,
                "raw customParams subscript read outside config.py — "
                "the knob registry owns types, bounds, defaults and "
                "error wording; route through config.numeric_param/"
                "bool_param/string_param (or the runner wrappers), or "
                "mark a deliberate passthrough "
                f"'# {ALLOW_KNOB} — <reason>'",
                lines=self._knob_lines(node))
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call) -> None:
        f = node.func
        if isinstance(f, ast.Attribute) and f.attr == "get" \
                and self._is_knob_receiver(f.value) \
                and not self.knob_exempt:
            self._suppressible(
                "TMG314", ALLOW_KNOB, node.lineno,
                "raw customParams .get() outside config.py — the knob "
                "registry owns types, bounds, defaults and error "
                "wording (a raw .get() silently drifts from the "
                "declared default and skips validation); route through "
                "config.numeric_param/bool_param/string_param (or the "
                "runner wrappers), or mark a deliberate passthrough "
                f"'# {ALLOW_KNOB} — <reason>'",
                lines=self._knob_lines(node))
        if self._is_thread(node):
            # TMG310: remember the target's name whatever the TMG307
            # outcome — `target=self._loop` and `target=loop` both
            # resolve against the module's function defs in a post-pass
            for kw in node.keywords:
                if kw.arg == "target":
                    v = kw.value
                    if isinstance(v, ast.Name):
                        self.thread_targets.add(v.id)
                    elif isinstance(v, ast.Attribute):
                        self.thread_targets.add(v.attr)
        if self._is_time_time(node):
            self._suppressible(
                "TMG301", ALLOW_WALLCLOCK, node.lineno,
                "time.time() — durations must use time.perf_counter() "
                "(NTP steps corrupt wall-clock deltas); true wall-clock "
                "uses (mtime comparisons, sink timestamps) carry "
                f"'# {ALLOW_WALLCLOCK}'")
        elif self._is_inject(node):
            if node.args and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                site = node.args[0].value
                if site not in _fault_sites():
                    self._add(
                        "TMG303", node.lineno,
                        f"inject site {site!r} is not registered in "
                        "resilience.FAULT_SITES — a typo'd site is a "
                        "chaos test that never fires; register it (and "
                        "document it in docs/robustness.md)")
            elif node.args:
                self._add(
                    "TMG303", node.lineno,
                    "inject() must name its site as a string literal so "
                    "the catalog check (and grep) can see it",
                    severity=Severity.WARNING)
        elif self._is_span(node) and id(node) not in self.with_contexts:
            self._add(
                "TMG304", node.lineno,
                "telemetry span opened outside a 'with' statement — a "
                "span only records on __exit__, so an unpaired call "
                "never lands in the trace and corrupts the per-thread "
                "span stack")
        elif self._is_make_mesh(node) and not self.mesh_exempt:
            self._suppressible(
                "TMG306", ALLOW_EXPLICIT_MESH, node.lineno,
                "direct mesh construction (torch.distributed "
                "init_device_mesh()/DeviceMesh(), make_mesh()) outside "
                "parallel/ — runtime code shares the ONE process mesh "
                "(a throwaway mesh per pass is the mesh-construction "
                "regression); mark a deliberate explicit topology "
                f"'# {ALLOW_EXPLICIT_MESH} — <reason>'")
        elif self._is_thread(node):
            kws = {kw.arg for kw in node.keywords}
            missing = [f"{k}=" for k in ("name", "daemon")
                       if k not in kws]
            if missing:
                self._suppressible(
                    "TMG307", ALLOW_THREAD, node.lineno,
                    f"threading.Thread() without explicit "
                    f"{' and '.join(missing)} — telemetry trace tracks "
                    "are keyed by thread name and implicit daemonness "
                    "hides shutdown semantics; pass name= and daemon= "
                    "(or mark a deliberate default "
                    f"'# {ALLOW_THREAD} — <reason>')")
        elif self._is_queue(node):
            size = None
            for kw in node.keywords:
                if kw.arg == "maxsize":
                    size = kw.value
            if size is None and node.args:
                size = node.args[0]
            # a LITERAL maxsize <= 0 (incl. -1 spelled as UnaryOp) is
            # unbounded in queue semantics — same defect as omitting it
            literal_unbounded = (
                isinstance(size, ast.Constant)
                and isinstance(size.value, int) and size.value <= 0) \
                or (isinstance(size, ast.UnaryOp)
                    and isinstance(size.op, ast.USub)
                    and isinstance(size.operand, ast.Constant))
            if size is None or literal_unbounded:
                self._suppressible(
                    "TMG308", ALLOW_UNBOUNDED_QUEUE, node.lineno,
                    "queue.Queue() without an explicit positive "
                    "maxsize= (maxsize<=0 means UNBOUNDED) — an "
                    "unbounded queue between pipeline stages hides "
                    "backpressure (a stalled consumer lets the producer "
                    "eat the heap instead of slowing down); pass "
                    "maxsize= (or mark a deliberate unbounded queue "
                    f"'# {ALLOW_UNBOUNDED_QUEUE} — <reason>')")
        elif self._is_popen(node):
            kws = {kw.arg for kw in node.keywords}
            # a **kwargs splat may well carry stdout/stderr — the
            # static check cannot see inside it, so don't false-ERROR a
            # dynamically configured Popen
            missing = [] if None in kws else \
                [f"{k}=" for k in ("stdout", "stderr") if k not in kws]
            if missing:
                self._suppressible(
                    "TMG309", ALLOW_POPEN, node.lineno,
                    f"subprocess.Popen() without explicit "
                    f"{' and '.join(missing)} — an inherited stdout "
                    "ties a long-lived child's output to whatever "
                    "terminal started the parent, and a PIPE nobody "
                    "drains deadlocks the child once the OS buffer "
                    "fills; a supervisor must own its workers' "
                    "streams (or mark a deliberate inherit "
                    f"'# {ALLOW_POPEN} — <reason>')")
        elif self._is_pallas_call(node) and not self.pallas_exempt:
            self._kernel_finding(node.lineno)
        elif self._instrument_kind(node) is not None \
                and not self.metric_exempt:
            inst_kind = self._instrument_kind(node)
            name_arg = node.args[0] if node.args else None
            for kw in node.keywords:
                if kw.arg == "name":
                    name_arg = kw.value
            if not (isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)):
                self._suppressible(
                    "TMG313", ALLOW_METRIC_NAME, node.lineno,
                    f"telemetry.{inst_kind}() with a non-literal metric "
                    "name outside telemetry.py — a dynamic name is "
                    "unbounded registry/exposition cardinality (every "
                    "distinct runtime value is a new instrument held "
                    "for the process lifetime and a new /metrics "
                    "family); use a literal name, or mark a "
                    "deliberately dynamic-but-BOUNDED name "
                    f"'# {ALLOW_METRIC_NAME} — <reason>'")
        else:
            sort_kind = self._np_sort_kind(node)
            if sort_kind is not None and sort_kind.startswith("torch."):
                stable = [kw.value for kw in node.keywords
                          if kw.arg == "stable"]
                unstable = (not stable and None not in
                            {kw.arg for kw in node.keywords}) or (
                    stable and isinstance(stable[0], ast.Constant)
                    and stable[0].value is not True)
                if unstable:
                    self._suppressible(
                        "TMG311", ALLOW_SORT, node.lineno,
                        f"{sort_kind}() without stable=True — "
                        "order-dependent monoid folds (float sums, "
                        "concat, first/last) silently change value "
                        "under unstable sort ties, and torch sorts are "
                        "unstable unless asked; pass stable=True (or "
                        "mark a deliberate default "
                        f"'# {ALLOW_SORT} — <reason>')")
            elif sort_kind is not None:
                need = "kind" if sort_kind == "argsort" else "side"
                kws = {kw.arg for kw in node.keywords}
                if need not in kws and None not in kws:
                    self._suppressible(
                        "TMG311", ALLOW_SORT, node.lineno,
                        f"np.{sort_kind}() without explicit {need}= — "
                        "order-dependent monoid folds (float sums, "
                        "concat, first/last) silently change value "
                        "under unstable sort ties, and an implicit "
                        "side= hides which window boundary is "
                        f"inclusive; pass {need}= explicitly (or mark "
                        "a deliberate default "
                        f"'# {ALLOW_SORT} — <reason>')")
        self.generic_visit(node)

    def _kernel_finding(self, lineno: int) -> None:
        self._suppressible(
            "TMG312", ALLOW_PALLAS, lineno,
            "device kernel bound outside models/_hist.py — kernels live "
            "behind that module's build, launch counts and card-or-raise "
            "rule (a CUDA tensor launches the kernel or raises): a "
            "kernel bound elsewhere escapes the counts and the plain-"
            "version checks; move it (or mark a deliberate binding "
            f"'# {ALLOW_PALLAS} — <reason>')")


def _check_thread_loops(v: _Visitor) -> None:
    """TMG310 post-pass: every function the module hands to
    ``threading.Thread(target=...)`` is a long-lived loop body — each of
    its ``while`` loops must contain a ``try`` somewhere (catch-and-
    tally), or the first uncaught exception kills the thread silently
    while its subsystem keeps 'running' with nobody home."""
    for name in sorted(v.thread_targets):
        fn = v.func_defs.get(name)
        if fn is None:
            continue                # library callable (serve_forever, …)
        for node in ast.walk(fn):
            if not isinstance(node, ast.While):
                continue
            if any(isinstance(x, ast.Try) for x in ast.walk(node)):
                continue
            v._suppressible(
                "TMG310", ALLOW_THREAD_LOOP, node.lineno,
                f"'while' loop in thread target {name!r} has no "
                "try/except anywhere in its body — an uncaught "
                "exception kills the thread SILENTLY and the subsystem "
                "it drives keeps 'running' with nobody home; "
                "catch-and-tally in the loop body (or mark a "
                "deliberately bare loop "
                f"'# {ALLOW_THREAD_LOOP} — <reason>')",
                lines=(node.lineno, fn.lineno))


def _stale_marker_findings(src: str, path: str,
                           v: _Visitor) -> List[Finding]:
    """TMG399: every real COMMENT carrying a ``lint: <marker>`` from
    THIS tool's vocabulary must have silenced its rule on that line
    during the walk — a leftover marker is camouflage for the next
    real finding there. Rules path-exempt in this file (TMG306/312/
    313/314 homes, tests) are skipped: their markers are inert, not
    stale. Marker text inside string literals never counts (the
    catalog and fixtures SPELL markers without placing them)."""
    exempt: Set[str] = set()
    if v.mesh_exempt:
        exempt.add("TMG306")
    if v.pallas_exempt:
        exempt.add("TMG312")
    if v.metric_exempt:
        exempt.add("TMG313")
    if v.knob_exempt:
        exempt.add("TMG314")
    findings: List[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(src).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return findings                 # parse-adjacent breakage → TMG305's job
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _MARKER_RE.search(tok.string)
        if m is None:
            continue
        rule = MARKER_RULES.get(m.group(1))
        if rule is None or rule in exempt:
            continue                    # foreign vocabulary (TMG8xx) / inert
        lineno = tok.start[0]
        if rule in v.used_markers.get(lineno, ()):
            continue
        findings.append(Finding(
            "TMG399",
            f"stale suppression: 'lint: {m.group(1)}' silences {rule} "
            "but nothing on this line triggers that rule anymore — "
            "delete the marker (or fix it if it names the wrong rule)",
            location=f"{path}:{lineno}"))
    return findings


def lint_source(src: str, path: str = "<string>",
                stale_markers: bool = True) -> List[Finding]:
    """Lint one module's source text; returns TMG3xx findings (plus
    TMG399 stale-suppression warnings unless ``stale_markers=False``)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Finding("TMG305", f"file does not parse: {e}",
                        location=f"{path}:{e.lineno or 0}")]
    v = _Visitor(path, src.splitlines())
    v.visit(tree)
    _check_thread_loops(v)
    findings = v.findings
    if stale_markers:
        findings = findings + _stale_marker_findings(src, path, v)
    return sorted(findings, key=lambda f: f.location or "")


def lint_file(path: str, stale_markers: bool = True) -> List[Finding]:
    with open(path, encoding="utf-8") as fh:
        return lint_source(fh.read(), path, stale_markers=stale_markers)


def lint_paths(paths: Sequence[str],
               stale_markers: bool = True) -> List[Finding]:
    """Lint every ``.py`` file under the given files/directories
    (``__pycache__`` skipped), findings sorted by location."""
    findings: List[Finding] = []
    for p in paths:
        if os.path.isfile(p):
            findings.extend(lint_file(p, stale_markers=stale_markers))
            continue
        for root, dirs, files in os.walk(p):
            dirs[:] = sorted(d for d in dirs if d != "__pycache__")
            for fn in sorted(files):
                if fn.endswith(".py"):
                    findings.extend(lint_file(
                        os.path.join(root, fn),
                        stale_markers=stale_markers))
    return findings


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="tmoglint",
        description="AST self-lint for project invariants (TMG3xx)")
    ap.add_argument("paths", nargs="*", default=[PACKAGE_DIR],
                    help="files/directories to lint (default: the "
                         "transmogrifai_tpu_torch package)")
    ap.add_argument("--fail-on", choices=("error", "warning"),
                    default="error",
                    help="exit non-zero when findings reach this "
                         "severity (default: error)")
    ap.add_argument("--no-stale-markers", action="store_true",
                    help="skip the TMG399 stale-suppression pass")
    args = ap.parse_args(argv)
    findings = lint_paths(args.paths,
                          stale_markers=not args.no_stale_markers)
    for f in findings:
        print(f.format())
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    summary = ", ".join(f"{counts.get(s, 0)} {s}(s)"
                        for s in (Severity.ERROR, Severity.WARNING,
                                  Severity.INFO))
    print(f"tmoglint: {summary}")
    try:
        enforce(findings, fail_on=args.fail_on)
    except Exception:   # lint: broad-except — CLI boundary: findings already printed
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
