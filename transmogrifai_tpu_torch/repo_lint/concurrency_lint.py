#!/usr/bin/env python
"""concurrency_lint — whole-program concurrency & crash-safety analysis
(the TMG8xx family of the catalog in ``transmogrifai_tpu_torch/lint.py``);
the port of the JAX package's ``tools/concurrency_lint.py`` for this
package's tree, with its rule ids, allow markers and messages. TMG805
reads the port's tests, ``tests/test_torch_*.py``.

Unlike tmoglint's per-line TMG3xx rules, these properties are only
visible with the WHOLE package in view at once: a deadlock is two
call paths in different modules, a data race is one mutation site
missing the lock its siblings hold. The pass therefore parses every
product module, resolves lock OBJECTS (module globals, ``self.x``
instance attributes, function locals, ``fcntl.flock`` sites) to
program-wide identities, and checks:

* **TMG801** — lock-order cycles. Every nested ``with <lock>`` body,
  every ``fcntl.flock`` site and every call made while holding a lock
  (one call level deep, cross-module) contributes an ordered
  acquisition edge; any cycle in the resulting graph is a potential
  deadlock and is reported with BOTH acquisition paths quoted.
  Re-acquiring an RLock is not an edge. Escape:
  ``# lint: lock-order — reason`` on any quoted line.
* **TMG802** — thread-escape. A module global or shared-object
  attribute whose OTHER mutation sites hold a guarding lock, mutated
  lock-free from a function reachable as a ``threading.Thread``
  target (tmoglint TMG310's target resolution, made transitive over
  the module call graph). Both the unlocked and a locked site are
  quoted. Escape: ``# lint: thread-escape — reason``.
* **TMG803** — blocking call while holding a lock: ``queue.get/put``
  without ``block=False``/``timeout=``, bare ``.join()``/``.wait()``,
  ``.communicate()`` without timeout, ``subprocess.*``, socket/HTTP,
  ``time.sleep`` inside a lock body (including one call level deep:
  a lock-free blocking site in a callee fires when some caller holds
  a lock across the call). Escape:
  ``# lint: lock-blocking — reason`` on the blocking line.
* **TMG804** — atomic-write discipline: product-code
  ``open(path, "w"/"wb")`` into a shared-artifact path family
  (registry records, CURRENT pointer, cost db, trace/workload shards,
  AOT manifests, …) in a function with no ``os.replace`` and no tmp
  staging — a crash mid-write leaves a torn file every reader then
  trusts. Escape: ``# lint: atomic-write — reason``.
* **TMG805** — fault-site coverage: every site registered in
  ``resilience.FAULT_SITES`` must appear (as a string) somewhere
  under tests/ — an untested fault site is a recovery path that has
  never once run.
* **TMG399** — stale suppressions of THIS tool's markers (the same
  contract tmoglint enforces for its own vocabulary): a marker that
  no longer silences anything is itself a warning.

The runtime analog of TMG801 is the ``utils.locks`` lock-order
witness: the hierarchy this pass derives statically is what the
witness checks per-thread under the chaos suites.

Static resolution is necessarily approximate; the approximations are
deliberately CONSERVATIVE for the graph (ambiguous attribute locks
never contribute cycle edges) and the escapes exist for the rest.

Runs as a CLI, through ``python -m transmogrifai_tpu_torch lint``, and
as a tier-1 pytest (``tests/test_torch_repo_lint.py`` asserts the port's
tree is clean)::

    python -m transmogrifai_tpu_torch.repo_lint.concurrency_lint
    python -m transmogrifai_tpu_torch.repo_lint.concurrency_lint --fail-on warning
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

#: the package this linter belongs to (the default program it analyzes)
#: and the repository's tests directory beside it
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "tests")

#: the test files TMG805 reads: the port's own
TESTS_GLOB = ("test_torch_", ".py")

__all__ = ["analyze_sources", "lint_paths", "fault_coverage_findings",
           "main", "MARKER_RULES", "ALLOW_LOCK_ORDER",
           "ALLOW_THREAD_ESCAPE", "ALLOW_LOCK_BLOCKING",
           "ALLOW_ATOMIC_WRITE", "PACKAGE_DIR", "TESTS_DIR"]

#: suppression markers, checked on the finding's own source line
ALLOW_LOCK_ORDER = "lint: lock-order"
ALLOW_THREAD_ESCAPE = "lint: thread-escape"
ALLOW_LOCK_BLOCKING = "lint: lock-blocking"
ALLOW_ATOMIC_WRITE = "lint: atomic-write"

#: marker word → the rule it silences (this tool's TMG399 vocabulary;
#: tmoglint owns the TMG3xx words)
MARKER_RULES: Dict[str, str] = {
    "lock-order": "TMG801",
    "thread-escape": "TMG802",
    "lock-blocking": "TMG803",
    "atomic-write": "TMG804",
}
_MARKER_RE = re.compile(r"lint:\s*([a-z][a-z-]*)")

#: threading constructors that create a lockable object (value = lock
#: kind; an RLock may legally be re-entered, so a self-edge on one is
#: not a deadlock)
_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock",
               "Condition": "condition", "Semaphore": "lock",
               "BoundedSemaphore": "lock"}

#: the utils.locks factory — its reentrant= kwarg decides the kind
_WITNESS_FACTORY = "witness_lock"

#: path-text fragments that mark a shared on-disk artifact family
#: (TMG804): files more than one process/thread reads back
_SHARED_ARTIFACT_HINTS = ("registry", "pointer", "current", "cost",
                          "manifest", "trace", "workload", "shard",
                          "version", "job", "bank")

#: container methods that mutate their receiver in place (TMG802)
_MUTATORS = {"append", "add", "update", "pop", "clear", "extend",
             "setdefault", "remove", "discard", "popleft",
             "appendleft", "insert"}


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


def _walk_shallow(node):
    """``ast.walk`` that does NOT descend into nested function/class
    defs — their bodies are summarized as their own ``_Func``."""
    stack = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)):
            stack.extend(ast.iter_child_nodes(n))


class _Func:
    """One function/method's summary. ``acquisitions`` are the locks
    the function takes DIRECTLY (with-items and flock calls) — what a
    caller holding a lock across a call pulls into the order graph
    (one call level deep, per the design)."""

    def __init__(self, module: "_Module", cls: Optional[str],
                 node: ast.AST, parent_locals: Dict[str, str]):
        self.module = module
        self.cls = cls
        self.node = node
        self.name = node.name
        self.qual = (f"{module.name}.{cls}.{node.name}" if cls
                     else f"{module.name}.{node.name}")
        #: local `x = threading.Lock()` names (closures inherit the
        #: enclosing function's, so a nested worker sees them)
        self.local_locks: Dict[str, str] = dict(parent_locals)
        self.acquisitions: List[Tuple[str, str, int]] = []  # lid, kind, line
        self.has_replace = False
        #: unmarked blocking calls that were NOT under a lock locally —
        #: candidates for one-call-deep TMG803 at a lock-holding caller
        self.lockfree_blocking: List[Tuple[int, str]] = []
        #: (ref, lineno, held) — calls made, with the locks held there
        #: as (lock id, acquisition line) pairs
        self.call_sites: List[Tuple[tuple, int,
                                    Tuple[Tuple[str, int], ...]]] = []
        #: (key, lineno, held) — shared-state mutations (TMG802)
        self.mutations: List[Tuple[tuple, int, Tuple[str, ...]]] = []


class _Module:
    def __init__(self, name: str, path: str, src: str):
        self.name = name
        self.path = path
        self.lines = src.splitlines()
        self.tree = ast.parse(src, filename=path)
        self.module_locks: Dict[str, str] = {}        # name → kind
        self.module_globals: Set[str] = set()         # module-level names
        self.class_locks: Dict[Tuple[str, str], str] = {}  # (cls, attr) → kind
        self.class_attrs: Dict[str, Set[str]] = {}    # attr → {cls, …}
        self.functions: Dict[str, _Func] = {}         # "fn"/"Cls.fn" → _Func
        self.aliases: Dict[str, str] = {}             # local → program module
        self.time_mods: Set[str] = set()
        self.sleep_funcs: Set[str] = set()
        self.subprocess_mods: Set[str] = set()
        self.popen_funcs: Set[str] = set()
        self.socket_mods: Set[str] = set()
        self.fcntl_mods: Set[str] = set()
        self.threading_mods: Set[str] = set()
        self.thread_funcs: Set[str] = set()
        self.witness_funcs: Set[str] = set()          # witness_lock imports
        self.urlopen_funcs: Set[str] = set()
        self.thread_targets: Set[str] = set()

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def marked(self, lineno: int, marker: str) -> bool:
        if 1 <= lineno <= len(self.lines):
            return marker in self.lines[lineno - 1]
        return False


def _module_name(path: str) -> str:
    """Package-relative dotted name ('models._hist'); plain basename for
    paths outside the package (test fixtures)."""
    parts = os.path.normpath(path).split(os.sep)
    if "transmogrifai_tpu_torch" in parts:
        rel = parts[parts.index("transmogrifai_tpu_torch") + 1:]
    else:
        rel = parts[-1:]
    rel = [p[:-3] if p.endswith(".py") else p for p in rel]
    if rel and rel[-1] == "__init__":
        rel = rel[:-1] or ["__init__"]
    return ".".join(rel)


class _Program:
    """The whole-program view: every product module parsed, lock
    identities resolved across modules, then the per-function walks
    and the cross-module phases (graph, escape, propagation)."""

    def __init__(self) -> None:
        self.modules: Dict[str, _Module] = {}
        self.findings: List[Finding] = []
        #: attr → [(module, cls, kind)] for `self.attr = Lock()` defs
        self.attr_locks: Dict[str, List[Tuple[str, str, str]]] = {}
        #: attr → {(module, cls)} for any `self.attr = …` in __init__
        self.attr_owners: Dict[str, Set[Tuple[str, str]]] = {}
        self.lock_kinds: Dict[str, str] = {}
        #: (A, B) → [(outer_loc, outer_src, inner_loc, inner_src)]
        self.edges: Dict[Tuple[str, str],
                         List[Tuple[str, str, str, str]]] = {}
        #: path → {lineno → {rules silenced there}} (TMG399)
        self.used_markers: Dict[str, Dict[int, Set[str]]] = {}

    # -- intake ------------------------------------------------------------
    def add_source(self, path: str, src: str) -> bool:
        try:
            mod = _Module(_module_name(path), path, src)
        except SyntaxError:
            return False          # tmoglint owns TMG305 for parse errors
        self.modules[mod.name] = mod
        return True

    def _use_marker(self, path: str, lineno: int, rule: str) -> None:
        self.used_markers.setdefault(path, {}).setdefault(
            lineno, set()).add(rule)

    def _add(self, rule: str, mod: _Module, lineno: int,
             message: str) -> None:
        self.findings.append(Finding(
            rule, message, location=f"{mod.path}:{lineno}"))

    def _suppressible(self, rule: str, marker: str, mod: _Module,
                      lineno: int, message: str,
                      marker_sites: Optional[Sequence[
                          Tuple[_Module, int]]] = None) -> bool:
        """Emit unless a marker on one of ``marker_sites`` (default:
        the finding line) silences it; returns True when emitted."""
        sites = marker_sites or [(mod, lineno)]
        for m, ln in sites:
            if m.marked(ln, marker):
                self._use_marker(m.path, ln, MARKER_RULES[
                    marker.split("lint: ")[1]])
                return False
        self._add(rule, mod, lineno, message)
        return True

    # -- phase 1: per-module collection ------------------------------------
    def collect(self) -> None:
        for mod in self.modules.values():
            self._collect_module(mod)
        for mod in self.modules.values():
            for (cls, attr), kind in mod.class_locks.items():
                self.attr_locks.setdefault(attr, []).append(
                    (mod.name, cls, kind))
            for attr, clss in mod.class_attrs.items():
                for cls in clss:
                    self.attr_owners.setdefault(attr, set()).add(
                        (mod.name, cls))

    def _lock_ctor_kind(self, mod: _Module, call: ast.Call
                        ) -> Optional[str]:
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _LOCK_CTORS \
                and isinstance(f.value, ast.Name) \
                and f.value.id in mod.threading_mods:
            return _LOCK_CTORS[f.attr]
        if isinstance(f, ast.Name) and f.id in mod.thread_funcs \
                and f.id in _LOCK_CTORS:
            return _LOCK_CTORS[f.id]
        is_factory = (isinstance(f, ast.Name)
                      and f.id in mod.witness_funcs) or \
                     (isinstance(f, ast.Attribute)
                      and f.attr == _WITNESS_FACTORY)
        if is_factory:
            for kw in call.keywords:
                if kw.arg == "reentrant" \
                        and isinstance(kw.value, ast.Constant) \
                        and kw.value.value:
                    return "rlock"
            return "lock"
        return None

    def _collect_module(self, mod: _Module) -> None:
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    tail = alias.name.split(".")[-1]
                    if alias.name == "time":
                        mod.time_mods.add(local)
                    elif alias.name == "threading":
                        mod.threading_mods.add(local)
                    elif alias.name == "subprocess":
                        mod.subprocess_mods.add(local)
                    elif alias.name == "socket":
                        mod.socket_mods.add(local)
                    elif alias.name == "fcntl":
                        mod.fcntl_mods.add(local)
                    elif tail in self.modules or alias.name in \
                            self.modules:
                        mod.aliases[alias.asname
                                    or alias.name] = alias.name
            elif isinstance(node, ast.ImportFrom):
                m = node.module or ""
                for alias in node.names:
                    local = alias.asname or alias.name
                    if m == "time" and alias.name == "sleep":
                        mod.sleep_funcs.add(local)
                    elif m == "threading":
                        mod.thread_funcs.add(local)
                    elif m == "subprocess" and alias.name == "Popen":
                        mod.popen_funcs.add(local)
                    elif alias.name == _WITNESS_FACTORY:
                        mod.witness_funcs.add(local)
                    elif alias.name == "urlopen":
                        mod.urlopen_funcs.add(local)
                    else:
                        # `from . import telemetry` / `from pkg import x`
                        mod.aliases[local] = alias.name
        # module-level names and locks
        for st in mod.tree.body:
            targets = []
            if isinstance(st, ast.Assign):
                targets = st.targets
                value = st.value
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                targets = [st.target]
                value = st.value
            else:
                continue
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                mod.module_globals.add(t.id)
                if isinstance(value, ast.Call):
                    kind = self._lock_ctor_kind(mod, value)
                    if kind:
                        mod.module_locks[t.id] = kind
                        self.lock_kinds[
                            f"{mod.name}.{t.id}"] = kind
        # classes: instance lock attrs + attr ownership
        for st in mod.tree.body:
            if not isinstance(st, ast.ClassDef):
                continue
            for sub in ast.walk(st):
                if not isinstance(sub, ast.Assign):
                    continue
                for t in sub.targets:
                    if isinstance(t, ast.Attribute) \
                            and isinstance(t.value, ast.Name) \
                            and t.value.id == "self":
                        mod.class_attrs.setdefault(
                            t.attr, set()).add(st.name)
                        if isinstance(sub.value, ast.Call):
                            kind = self._lock_ctor_kind(mod, sub.value)
                            if kind:
                                mod.class_locks[(st.name,
                                                 t.attr)] = kind
                                self.lock_kinds[
                                    f"{mod.name}.{st.name}."
                                    f"{t.attr}"] = kind
        # functions (methods + nested defs) and thread targets
        def add_funcs(body, cls, parent_locals):
            for st in body:
                if isinstance(st, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                    fn = _Func(mod, cls, st, parent_locals)
                    for sub in ast.walk(st):
                        if isinstance(sub, ast.Assign) \
                                and isinstance(sub.value, ast.Call):
                            kind = self._lock_ctor_kind(mod, sub.value)
                            if kind:
                                for t in sub.targets:
                                    if isinstance(t, ast.Name):
                                        fn.local_locks[t.id] = kind
                                        self.lock_kinds[
                                            f"{fn.qual}.{t.id}"] = kind
                    key = f"{cls}.{st.name}" if cls else st.name
                    mod.functions.setdefault(key, fn)
                    add_funcs(st.body, cls, fn.local_locks)
                elif isinstance(st, ast.ClassDef):
                    add_funcs(st.body, st.name, parent_locals)
        add_funcs(mod.tree.body, None, {})
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                f = node.func
                is_thread = (isinstance(f, ast.Attribute)
                             and f.attr == "Thread"
                             and isinstance(f.value, ast.Name)
                             and f.value.id in mod.threading_mods) or \
                            (isinstance(f, ast.Name)
                             and f.id in mod.thread_funcs
                             and f.id == "Thread")
                if is_thread:
                    for kw in node.keywords:
                        if kw.arg == "target":
                            v = kw.value
                            if isinstance(v, ast.Name):
                                mod.thread_targets.add(v.id)
                            elif isinstance(v, ast.Attribute):
                                mod.thread_targets.add(v.attr)

    # -- lock-expression resolution ----------------------------------------
    def resolve_lock_expr(self, mod: _Module, fn: _Func,
                          expr) -> Optional[Tuple[str, str]]:
        """(lock id, kind) for an expression naming a lock object;
        ambiguous cross-class attribute locks get a '?'-prefixed id
        (held for TMG803, excluded from the TMG801 graph)."""
        if isinstance(expr, ast.Name):
            if expr.id in mod.module_locks:
                return (f"{mod.name}.{expr.id}",
                        mod.module_locks[expr.id])
            if expr.id in fn.local_locks:
                return (f"{fn.qual}.{expr.id}",
                        fn.local_locks[expr.id])
            return None
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and fn.cls is not None:
                    kind = mod.class_locks.get((fn.cls, expr.attr))
                    if kind:
                        return (f"{mod.name}.{fn.cls}.{expr.attr}",
                                kind)
                alias = mod.aliases.get(base.id)
                if alias is not None:
                    m2 = self._module_for(alias)
                    if m2 and expr.attr in m2.module_locks:
                        return (f"{m2.name}.{expr.attr}",
                                m2.module_locks[expr.attr])
            matches = self.attr_locks.get(expr.attr, [])
            if len(matches) == 1:
                m2, cls, kind = matches[0]
                return (f"{m2}.{cls}.{expr.attr}", kind)
            if len(matches) > 1:
                return (f"?.{expr.attr}", matches[0][2])
        return None

    def _module_for(self, dotted: str) -> Optional[_Module]:
        if dotted in self.modules:
            return self.modules[dotted]
        tail = dotted.split(".")[-1]
        if tail in self.modules:
            return self.modules[tail]
        for name, m in self.modules.items():
            if name.endswith("." + tail):
                return m
        return None

    # -- phase 2: per-function walks ---------------------------------------
    def walk(self) -> None:
        # stage A: direct acquisitions + os.replace flags (these feed
        # the one-call-deep resolution in stage B)
        for mod in self.modules.values():
            for fn in mod.functions.values():
                self._direct_summary(mod, fn)
        # stage B: held-stack walks
        for mod in self.modules.values():
            for fn in mod.functions.values():
                _FuncWalk(self, mod, fn).run()

    def _direct_summary(self, mod: _Module, fn: _Func) -> None:
        for node in _walk_shallow(fn.node):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    r = self.resolve_lock_expr(mod, fn,
                                               item.context_expr)
                    if r:
                        fn.acquisitions.append(
                            (r[0], r[1], item.context_expr.lineno))
            elif isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) \
                        and f.attr == "replace" \
                        and isinstance(f.value, ast.Name) \
                        and f.value.id == "os":
                    fn.has_replace = True
                if self._flock_op(mod, node) == "acquire":
                    lid = f"{mod.name}.flock[{fn.name}]"
                    self.lock_kinds[lid] = "flock"
                    fn.acquisitions.append((lid, "flock",
                                            node.lineno))

    def _flock_op(self, mod: _Module, call: ast.Call) -> Optional[str]:
        f = call.func
        if not (isinstance(f, ast.Attribute) and f.attr == "flock"
                and isinstance(f.value, ast.Name)
                and f.value.id in mod.fcntl_mods):
            return None
        ops = {n.attr for a in call.args[1:2]
               for n in ast.walk(a)
               if isinstance(n, ast.Attribute)
               and n.attr.startswith("LOCK_")}
        if "LOCK_UN" in ops:
            return "release"
        return "acquire"

    # -- phase 3: cross-module rules ---------------------------------------
    def resolve_callees(self, mod: _Module, fn: _Func,
                        ref: tuple, unique: bool) -> List[_Func]:
        kind = ref[0]
        if kind == "bare":
            f = mod.functions.get(ref[1])
            if f is not None:
                return [f]
            cands = [g for q, g in mod.functions.items()
                     if q.endswith("." + ref[1])]
        elif kind == "self":
            if fn.cls is not None:
                f = mod.functions.get(f"{fn.cls}.{ref[1]}")
                if f is not None:
                    return [f]
            cands = [g for q, g in mod.functions.items()
                     if q.endswith("." + ref[1])]
        elif kind == "mod":
            m2 = self._module_for(mod.aliases.get(ref[1], ""))
            if m2 is None:
                return []
            f = m2.functions.get(ref[2])
            if f is not None:
                return [f]
            cands = [g for q, g in m2.functions.items()
                     if q.endswith("." + ref[2])]
        else:                       # ("attr", name): same-module methods
            cands = [g for q, g in mod.functions.items()
                     if q.split(".")[-1] == ref[1]]
        if unique and len(cands) != 1:
            return []
        return cands

    def record_edge(self, outer: str, inner: str,
                    outer_site: Tuple[_Module, int],
                    inner_site: Tuple[_Module, int]) -> None:
        if outer.startswith("?") or inner.startswith("?"):
            return                  # ambiguous locks never make cycles
        if outer == inner:
            if self.lock_kinds.get(outer) == "rlock":
                return              # re-entering an RLock is legal
        om, ol = outer_site
        im, il = inner_site
        self.edges.setdefault((outer, inner), []).append(
            (f"{om.path}:{ol}", om.line(ol),
             f"{im.path}:{il}", im.line(il)))

    def finish(self, stale_markers: bool = True) -> List[Finding]:
        self._call_edges_and_propagation()
        self._cycle_findings()
        self._thread_escape_findings()
        if stale_markers:
            self._stale_marker_findings()
        return sorted(self.findings, key=lambda f: f.location or "")

    def _call_edges_and_propagation(self) -> None:
        for mod in self.modules.values():
            for fn in mod.functions.values():
                for ref, lineno, held in fn.call_sites:
                    if not held or ref[0] == "attr":
                        continue    # bare attr calls resolve too
                                    # fuzzily for edge derivation
                    callees = self.resolve_callees(mod, fn, ref,
                                                   unique=True)
                    if not callees:
                        continue
                    callee = callees[0]
                    if callee is fn:
                        continue    # recursion is not a call edge
                    for lid, kind, acq_line in callee.acquisitions:
                        for h, h_line in held:
                            self.record_edge(
                                h, lid, (mod, h_line),
                                (callee.module, acq_line))
                    # one-call-deep TMG803: a lock held across a call
                    # into a function that blocks lock-free
                    for bl_line, reason in callee.lockfree_blocking:
                        locks = ", ".join(sorted(
                            h.lstrip("?") for h, _ln in held))
                        self._suppressible(
                            "TMG803", ALLOW_LOCK_BLOCKING, mod, lineno,
                            f"blocking {reason} reached while holding "
                            f"{locks}: {mod.path}:{lineno} calls "
                            f"{callee.qual} "
                            f"({callee.module.path}:{bl_line} "
                            f"'{callee.module.line(bl_line)}') with "
                            "the lock held — every thread needing it "
                            "stalls behind that wait (allow: "
                            f"'# {ALLOW_LOCK_BLOCKING} — <reason>')",
                            marker_sites=[(mod, lineno),
                                          (callee.module, bl_line)])

    def _cycle_findings(self) -> None:
        adj: Dict[str, Set[str]] = {}
        for (a, b) in self.edges:
            adj.setdefault(a, set()).add(b)
            adj.setdefault(b, set())
        # self-deadlocks first (a non-reentrant lock re-acquired)
        for (a, b) in sorted(self.edges):
            if a != b:
                continue
            self._emit_cycle(
                [a], [(a, a)],
                f"non-reentrant lock {a} re-acquired while already "
                f"held — self-deadlock")
        # cycles between distinct locks: DFS over the edge graph
        seen_cycles: Set[Tuple[str, ...]] = set()
        for start in sorted(adj):
            path: List[str] = []
            on_path: Set[str] = set()

            def dfs(n: str) -> None:
                path.append(n)
                on_path.add(n)
                for nxt in sorted(adj.get(n, ())):
                    if nxt == n:
                        continue
                    if nxt in on_path:
                        cyc = path[path.index(nxt):]
                        key = tuple(sorted(cyc))
                        if key not in seen_cycles:
                            seen_cycles.add(key)
                            edges = [(cyc[i], cyc[(i + 1) % len(cyc)])
                                     for i in range(len(cyc))]
                            self._emit_cycle(
                                cyc, edges,
                                "lock-order cycle "
                                f"{' -> '.join(cyc + [cyc[0]])} — two "
                                "threads on these paths deadlock")
                    elif len(path) < 16:
                        dfs(nxt)
                path.pop()
                on_path.discard(n)

            dfs(start)

    def _module_of_loc(self, loc: str) -> Optional[_Module]:
        path = loc.rsplit(":", 1)[0]
        for m in self.modules.values():
            if m.path == path:
                return m
        return None

    def _emit_cycle(self, cyc: List[str],
                    edges: List[Tuple[str, str]], headline: str) -> None:
        lines = [headline + ":"]
        marker_sites: List[Tuple[_Module, int]] = []
        first_loc = None
        for a, b in edges:
            sites = self.edges.get((a, b), [])
            if not sites:
                continue
            outer_loc, outer_src, inner_loc, inner_src = sites[0]
            if first_loc is None:
                first_loc = inner_loc
            lines.append(f"  {a} -> {b}:")
            lines.append(f"    {outer_loc}: {outer_src}")
            lines.append(f"    {inner_loc}: {inner_src}")
            for loc in (outer_loc, inner_loc):
                m = self._module_of_loc(loc)
                if m is not None:
                    marker_sites.append(
                        (m, int(loc.rsplit(":", 1)[1])))
        if first_loc is None:
            return
        mod = self._module_of_loc(first_loc)
        if mod is None:
            return
        self._suppressible(
            "TMG801", ALLOW_LOCK_ORDER, mod,
            int(first_loc.rsplit(":", 1)[1]),
            "\n".join(lines) + "\n  break the cycle (one global "
            "acquisition order) or mark a quoted line "
            f"'# {ALLOW_LOCK_ORDER} — <reason>'",
            marker_sites=marker_sites)

    def _thread_reachable(self, mod: _Module) -> Set[str]:
        """Function quals in ``mod`` reachable from a Thread target
        (TMG310's target resolution, made transitive over the module
        call graph)."""
        roots: Set[str] = set()
        for tgt in mod.thread_targets:
            for q, fn in mod.functions.items():
                if q == tgt or q.split(".")[-1] == tgt:
                    roots.add(fn.qual)
        reach = set(roots)
        frontier = list(roots)
        quals = {fn.qual: fn for fn in mod.functions.values()}
        while frontier:
            q = frontier.pop()
            fn = quals.get(q)
            if fn is None:
                continue
            for ref, _lineno, _held in fn.call_sites:
                for callee in self.resolve_callees(mod, fn, ref,
                                                   unique=False):
                    if callee.module is mod \
                            and callee.qual not in reach:
                        reach.add(callee.qual)
                        frontier.append(callee.qual)
        return reach

    def _thread_escape_findings(self) -> None:
        # group mutation sites program-wide by state key
        groups: Dict[tuple, List[Tuple[_Func, int,
                                       Tuple[str, ...]]]] = {}
        for mod in self.modules.values():
            for fn in mod.functions.values():
                for key, lineno, held in fn.mutations:
                    groups.setdefault(key, []).append(
                        (fn, lineno, held))
        reach_cache: Dict[str, Set[str]] = {}
        for key, sites in sorted(groups.items(), key=lambda kv:
                                 str(kv[0])):
            locked = [s for s in sites if s[2]]
            unlocked = [s for s in sites if not s[2]]
            if not locked or not unlocked:
                continue
            guard = ", ".join(sorted({h.lstrip("?") for s in locked
                                      for h in s[2]}))
            ex_fn, ex_line, ex_held = locked[0]
            state = (f"{key[1]}.{key[2]}" if key[0] == "g"
                     else f"{key[1]}.{key[2]}.{key[3]}")
            for fn, lineno, _held in unlocked:
                if fn.name == "__init__":
                    continue
                mod = fn.module
                if mod.name not in reach_cache:
                    reach_cache[mod.name] = self._thread_reachable(mod)
                if fn.qual not in reach_cache[mod.name]:
                    continue
                self._suppressible(
                    "TMG802", ALLOW_THREAD_ESCAPE, mod, lineno,
                    f"shared state {state} mutated lock-free on a "
                    "thread-reachable path while its other mutation "
                    f"sites hold {guard}:\n"
                    f"  unlocked: {mod.path}:{lineno}: "
                    f"{mod.line(lineno)}\n"
                    f"  locked:   {ex_fn.module.path}:{ex_line}: "
                    f"{ex_fn.module.line(ex_line)}\n"
                    "  guard the mutation (or mark it "
                    f"'# {ALLOW_THREAD_ESCAPE} — <reason>')")

    def _stale_marker_findings(self) -> None:
        for mod in self.modules.values():
            used = self.used_markers.get(mod.path, {})
            try:
                tokens = list(tokenize.generate_tokens(
                    io.StringIO("\n".join(mod.lines) + "\n").readline))
            except (tokenize.TokenError, IndentationError,
                    SyntaxError):
                continue
            for tok in tokens:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _MARKER_RE.search(tok.string)
                if m is None:
                    continue
                rule = MARKER_RULES.get(m.group(1))
                if rule is None:
                    continue        # tmoglint's vocabulary, not ours
                lineno = tok.start[0]
                if rule in used.get(lineno, ()):
                    continue
                self._add(
                    "TMG399", mod, lineno,
                    f"stale suppression: 'lint: {m.group(1)}' "
                    f"silences {rule} but nothing on this line "
                    "triggers that rule anymore — delete the marker "
                    "(or fix it if it names the wrong rule)")


class _FuncWalk:
    """Stage-B walk of one function: tracks the held-lock stack
    through nested ``with`` bodies and flock calls, recording
    acquisition edges, call sites, blocking calls and shared-state
    mutations with the locks held at each."""

    def __init__(self, prog: _Program, mod: _Module, fn: _Func):
        self.prog = prog
        self.mod = mod
        self.fn = fn
        #: flocks stay held from their call site to function end (or
        #: an explicit LOCK_UN) — function-scoped, not block-scoped;
        #: entries are (lock id, kind, acquisition line)
        self.extra: List[Tuple[str, str, int]] = []

    def run(self) -> None:
        body = getattr(self.fn.node, "body", [])
        self.stmts(body, [])

    def held_ids(self, held) -> Tuple[str, ...]:
        return tuple(lid for lid, _k, _ln in held + self.extra)

    def held_sites(self, held) -> Tuple[Tuple[str, int], ...]:
        return tuple((lid, ln) for lid, _k, ln in held + self.extra)

    # -- statements --------------------------------------------------------
    def stmts(self, body, held) -> None:
        for st in body:
            if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef)):
                continue            # summarized as their own _Func
            if isinstance(st, (ast.With, ast.AsyncWith)):
                self.with_stmt(st, held)
                continue
            for child in ast.iter_child_nodes(st):
                if isinstance(child, ast.expr):
                    self.expr(child, held)
            if isinstance(st, (ast.Assign, ast.AugAssign,
                               ast.AnnAssign)):
                self.mutation(st, held)
            for field in ("body", "orelse", "finalbody"):
                sub = getattr(st, field, None)
                if sub:
                    self.stmts(sub, held)
            for h in getattr(st, "handlers", []):
                self.stmts(h.body, held)

    def with_stmt(self, st, held) -> None:
        new: List[Tuple[str, str, int]] = []
        for item in st.items:
            expr = item.context_expr
            acquired: List[Tuple[str, str, int]] = []
            r = self.prog.resolve_lock_expr(self.mod, self.fn, expr)
            if r is not None:
                acquired.append((r[0], r[1], expr.lineno))
            elif isinstance(expr, ast.Call):
                # `with self._pointer_mutation(name):` — a context
                # manager call holds whatever IT directly acquires
                ref = self.call_ref(expr)
                if ref is not None:
                    for callee in self.prog.resolve_callees(
                            self.mod, self.fn, ref, unique=True):
                        for lid, kind, acq_line in callee.acquisitions:
                            acquired.append((lid, kind, expr.lineno))
                self.expr(expr, held + new)     # classify the call too
            else:
                self.expr(expr, held + new)
            for lid, kind, lineno in acquired:
                for h, _k, h_line in held + new + self.extra:
                    self.prog.record_edge(
                        h, lid, (self.mod, h_line),
                        (self.mod, lineno))
                new.append((lid, kind, lineno))
        self.stmts(st.body, held + new)

    def mutation(self, st, held) -> None:
        if self.fn.name == "__init__":
            return                  # construction is single-threaded
        targets = st.targets if isinstance(st, ast.Assign) \
            else [st.target]
        for t in targets:
            key = self.state_key(t)
            if key is not None:
                self.fn.mutations.append(
                    (key, st.lineno, self.held_ids(held)))

    def state_key(self, t) -> Optional[tuple]:
        """('g', module, name) for module-global stores, ('a', module,
        cls, attr) for shared-object attribute stores, else None."""
        # peel subscripts: `_TALLY[k] = v` mutates _TALLY
        while isinstance(t, ast.Subscript):
            t = t.value
        if isinstance(t, ast.Name):
            if t.id in self.mod.module_globals \
                    and t.id not in self.mod.module_locks:
                return ("g", self.mod.name, t.id)
            return None
        if isinstance(t, ast.Attribute) \
                and isinstance(t.value, ast.Name):
            attr = t.attr
            if t.value.id == "self" and self.fn.cls is not None:
                if (self.fn.cls, attr) in self.mod.class_locks:
                    return None
                return ("a", self.mod.name, self.fn.cls, attr)
            if t.value.id != "self":
                owners = self.prog.attr_owners.get(attr, set())
                if len(owners) == 1:
                    mname, cls = next(iter(owners))
                    m2 = self.prog._module_for(mname)
                    if m2 is not None \
                            and (cls, attr) in m2.class_locks:
                        return None
                    return ("a", mname, cls, attr)
        return None

    # -- expressions -------------------------------------------------------
    def expr(self, node, held) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                self.call(sub, held)

    def call_ref(self, call: ast.Call) -> Optional[tuple]:
        f = call.func
        if isinstance(f, ast.Name):
            return ("bare", f.id)
        if isinstance(f, ast.Attribute) \
                and isinstance(f.value, ast.Name):
            if f.value.id == "self":
                return ("self", f.attr)
            if f.value.id in self.mod.aliases:
                return ("mod", f.value.id, f.attr)
            return ("attr", f.attr)
        if isinstance(f, ast.Attribute):
            return ("attr", f.attr)
        return None

    def call(self, call: ast.Call, held) -> None:
        op = self.prog._flock_op(self.mod, call)
        if op == "acquire":
            lid = f"{self.mod.name}.flock[{self.fn.name}]"
            for h, _k, h_line in held + self.extra:
                self.prog.record_edge(h, lid, (self.mod, h_line),
                                      (self.mod, call.lineno))
            self.extra.append((lid, "flock", call.lineno))
            return
        if op == "release":
            self.extra = [e for e in self.extra if e[1] != "flock"]
            return
        # mutator-method calls on module globals are mutations too
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr in _MUTATORS \
                and isinstance(f.value, ast.Name) \
                and f.value.id in self.mod.module_globals \
                and f.value.id not in self.mod.module_locks \
                and self.fn.name != "__init__":
            self.fn.mutations.append(
                (("g", self.mod.name, f.value.id), call.lineno,
                 self.held_ids(held)))
        reason = self.blocking_reason(call)
        if reason is not None:
            if self.mod.marked(call.lineno, ALLOW_LOCK_BLOCKING):
                self.prog._use_marker(self.mod.path, call.lineno,
                                      "TMG803")
            elif held or self.extra:
                locks = ", ".join(sorted(
                    h.lstrip("?") for h, _k, _ln in held + self.extra))
                self.prog._add(
                    "TMG803", self.mod, call.lineno,
                    f"blocking {reason} while holding {locks} "
                    f"('{self.mod.line(call.lineno)}') — every other "
                    "thread needing the lock stalls behind I/O it "
                    "cannot see; move the call outside the lock body "
                    "(or mark it "
                    f"'# {ALLOW_LOCK_BLOCKING} — <reason>')")
            else:
                self.fn.lockfree_blocking.append((call.lineno, reason))
        ref = self.call_ref(call)
        if ref is not None:
            self.fn.call_sites.append(
                (ref, call.lineno, self.held_sites(held)))
        self.open_call(call)

    def blocking_reason(self, call: ast.Call) -> Optional[str]:
        f = call.func
        kwargs = {kw.arg for kw in call.keywords}
        if isinstance(f, ast.Name):
            if f.id in self.mod.sleep_funcs:
                return "time.sleep()"
            if f.id in self.mod.popen_funcs:
                return "subprocess.Popen()"
            if f.id in self.mod.urlopen_funcs:
                return "urlopen()"
            return None
        if not isinstance(f, ast.Attribute):
            return None
        base = _dotted(f.value) or ""
        if f.attr == "sleep" and isinstance(f.value, ast.Name) \
                and f.value.id in self.mod.time_mods:
            return "time.sleep()"
        if f.attr in ("get", "put"):
            b = base.lower()
            if "queue" in b or b.endswith("_q") or b == "q":
                if "timeout" in kwargs or "block" in kwargs:
                    return None
                if f.attr == "put" and len(call.args) > 1:
                    return None     # positional block= given
                if f.attr == "get" and call.args:
                    return None
                return f"queue.{f.attr}() with no timeout"
        if f.attr == "join" and not call.args and not call.keywords \
                and not isinstance(f.value, ast.Constant):
            return ".join() with no timeout"   # str.join has args
        if f.attr == "wait" and not call.args and not call.keywords:
            # cv.wait() RELEASES the condition it is called on — the
            # canonical pattern, not a block-while-holding
            r = self.prog.resolve_lock_expr(self.mod, self.fn,
                                            f.value)
            if r is not None and r[1] == "condition":
                return None
            return ".wait() with no timeout"
        if f.attr == "communicate" and "timeout" not in kwargs:
            return ".communicate() with no timeout"
        if isinstance(f.value, ast.Name):
            if f.value.id in self.mod.subprocess_mods and f.attr in (
                    "run", "call", "check_call", "check_output",
                    "Popen"):
                return f"subprocess.{f.attr}()"
            if f.value.id in self.mod.socket_mods:
                return f"socket.{f.attr}()"
        if f.attr in ("urlopen", "getresponse", "create_connection"):
            return f".{f.attr}()"
        return None

    def open_call(self, call: ast.Call) -> None:
        """TMG804: non-atomic writes into shared artifact families."""
        f = call.func
        if not (isinstance(f, ast.Name) and f.id == "open"):
            return
        mode = None
        if len(call.args) > 1 and isinstance(call.args[1],
                                             ast.Constant):
            mode = call.args[1].value
        for kw in call.keywords:
            if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
                mode = kw.value.value
        if not (isinstance(mode, str) and "w" in mode):
            return
        if not call.args:
            return
        seg = ast.get_source_segment(
            "\n".join(self.mod.lines) + "\n", call.args[0]) or ""
        low = seg.lower()
        if "tmp" in low or self.fn.has_replace:
            return
        if not any(h in low for h in _SHARED_ARTIFACT_HINTS):
            return
        self.prog._suppressible(
            "TMG804", ALLOW_ATOMIC_WRITE, self.mod, call.lineno,
            f"non-atomic write open({seg!r}, {mode!r}) into a shared "
            "artifact family with no tmp staging and no os.replace in "
            f"{self.fn.qual} — a crash mid-write leaves a torn file "
            "every reader then trusts; write to <path>.tmp.<pid> and "
            "os.replace() it into place (or mark a deliberate "
            f"in-place write '# {ALLOW_ATOMIC_WRITE} — <reason>')")


# -- TMG805: fault-site coverage -------------------------------------------
def fault_coverage_findings(tests_dir: str) -> List[Finding]:
    """Every registered fault site must be exercised by at least one
    test: its site string must appear in a ``tests_dir/test_torch_*.py``
    file. The sites of modules not ported yet
    (``resilience.UNPORTED_SITES``: no code of this package injects them)
    come with their modules and are not asked for."""
    from .. import resilience
    corpus = []
    prefix, suffix = TESTS_GLOB
    for root, dirs, files in os.walk(tests_dir):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for fname in sorted(files):
            if fname.startswith(prefix) and fname.endswith(suffix):
                with open(os.path.join(root, fname),
                          encoding="utf-8") as fh:
                    corpus.append(fh.read())
    text = "\n".join(corpus)
    res_path = resilience.__file__
    with open(res_path, encoding="utf-8") as fh:
        res_lines = fh.read().splitlines()
    findings: List[Finding] = []
    for site in sorted(resilience.FAULT_SITES
                       - set(resilience.UNPORTED_SITES)):
        if f'"{site}"' in text or f"'{site}'" in text:
            continue
        lineno = next((i + 1 for i, ln in enumerate(res_lines)
                       if f'"{site}"' in ln), 0)
        findings.append(Finding(
            "TMG805",
            f"fault site '{site}' (resilience.FAULT_SITES) is "
            f"exercised by NO test under {tests_dir} — an untested "
            "fault site is a recovery path that has never once run; "
            "add a chaos test injecting it",
            location=f"{res_path}:{lineno}"))
    return findings


# -- public API ------------------------------------------------------------
def _is_test_path(path: str) -> bool:
    parts = os.path.normpath(path).split(os.sep)
    return "tests" in parts or os.path.basename(path).startswith(
        "test_")


def analyze_sources(files: Dict[str, str],
                    stale_markers: bool = True) -> List[Finding]:
    """Run the whole-program TMG8xx pass over ``{path: source}``."""
    prog = _Program()
    for path, src in sorted(files.items()):
        prog.add_source(path, src)
    prog.collect()
    prog.walk()
    return prog.finish(stale_markers=stale_markers)


def lint_paths(paths: Sequence[str], tests_dir: Optional[str] = None,
               stale_markers: bool = True) -> List[Finding]:
    """Analyze every product ``.py`` under ``paths`` as ONE program
    (tests and ``__pycache__`` skipped); optionally cross-check fault-
    site coverage against ``tests_dir`` (TMG805)."""
    files: Dict[str, str] = {}
    for p in paths:
        if os.path.isfile(p):
            if not _is_test_path(p):
                with open(p, encoding="utf-8") as fh:
                    files[p] = fh.read()
            continue
        for root, dirs, fnames in os.walk(p):
            dirs[:] = sorted(d for d in dirs
                             if d not in ("__pycache__", "tests"))
            for fn in sorted(fnames):
                fp = os.path.join(root, fn)
                if fn.endswith(".py") and not _is_test_path(fp):
                    with open(fp, encoding="utf-8") as fh:
                        files[fp] = fh.read()
    findings = analyze_sources(files, stale_markers=stale_markers)
    if tests_dir is not None and os.path.isdir(tests_dir):
        findings.extend(fault_coverage_findings(tests_dir))
    return sorted(findings, key=lambda f: f.location or "")


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="concurrency_lint",
        description="whole-program concurrency & crash-safety "
                    "analysis (TMG8xx)")
    ap.add_argument("paths", nargs="*", default=[PACKAGE_DIR],
                    help="files/directories analyzed as one program "
                         "(default: the transmogrifai_tpu_torch package)")
    ap.add_argument("--tests", default=TESTS_DIR,
                    help="tests directory for the TMG805 fault-site "
                         "coverage cross-check (default: tests/)")
    ap.add_argument("--no-tests-check", action="store_true",
                    help="skip the TMG805 coverage cross-check")
    ap.add_argument("--fail-on", choices=("error", "warning"),
                    default="error",
                    help="exit non-zero when findings reach this "
                         "severity (default: error)")
    ap.add_argument("--no-stale-markers", action="store_true",
                    help="skip the TMG399 stale-suppression pass")
    args = ap.parse_args(argv)
    findings = lint_paths(
        args.paths,
        tests_dir=None if args.no_tests_check else args.tests,
        stale_markers=not args.no_stale_markers)
    for f in findings:
        print(f.format())
    counts: Dict[str, int] = {}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    summary = ", ".join(f"{counts.get(s, 0)} {s}(s)"
                        for s in (Severity.ERROR, Severity.WARNING,
                                  Severity.INFO))
    print(f"concurrency_lint: {summary}")
    try:
        enforce(findings, fail_on=args.fail_on)
    except Exception:   # lint: broad-except — CLI boundary: findings already printed
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
