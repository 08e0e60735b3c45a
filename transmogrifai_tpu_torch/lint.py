"""Findings of the serving tier: the part of ``transmogrifai_tpu/lint.py``
that ``serving.py`` and ``aot.py`` use.

* :class:`Severity` and :class:`Finding` (rule id, severity, subject;
  ``format()`` for a log line, ``to_json()`` for a document).
* The TMG5xx rows of :data:`RULES`: advisories of the program bank and
  the serving artifacts, which degrade and never fail a load.

Findings are logged as warnings by the modules that raise them. The
mirror into telemetry (``emit_findings``: the ``lint.*`` counters and the
``on_lint`` hook) waits for ``telemetry.py`` (ROADMAP queue A, A6.8); the
graph checker, the device pre-flight and the repo rules (TMG1xx–TMG3xx)
wait for A6.4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

__all__ = ["Severity", "Finding", "RULES"]


class Severity:
    """Finding severities."""

    ERROR = "error"
    WARNING = "warning"
    INFO = "info"

    ALL = (ERROR, WARNING, INFO)


#: rule id → (severity, what it flags)
RULES: Dict[str, tuple] = {
    # -- TMG5xx: serving / program-bank advisories (aot.py, serving.py) —
    #    degradation notices, never crash paths
    "TMG501": (Severity.WARNING,
               "program bank incompatible (torch or CUDA version skew, "
               "wrong device, plan/state digest mismatch) — the engine "
               "builds those buckets from its plan, the loader serves "
               "them through the batch-polymorphic program"),
    "TMG502": (Severity.WARNING,
               "program bank artifact corrupt/tampered/truncated — the "
               "affected program(s) are skipped and their buckets built "
               "or served by the batch-polymorphic program"),
    "TMG503": (Severity.WARNING,
               "serving export version skew: artifact exported under a "
               "different torch or CUDA runtime than this process runs"),
}


@dataclass
class Finding:
    """One structured lint finding (stable rule id + severity + subject)."""

    rule: str
    message: str
    severity: str = ""
    #: stage uid (graph/device rules)
    stage: Optional[str] = None
    #: feature name (graph rules)
    feature: Optional[str] = None
    #: a path, or ``file:line`` (repo rules)
    location: Optional[str] = None

    def __post_init__(self):
        if not self.severity:
            self.severity = RULES.get(self.rule, (Severity.WARNING, ""))[0]

    def format(self) -> str:
        subject = self.location or ""
        if self.stage:
            subject = f"stage={self.stage}"
            if self.feature:
                subject += f" feature={self.feature}"
        elif self.feature:
            subject = f"feature={self.feature}"
        head = f"{self.rule} {self.severity}"
        return f"{head} [{subject}] {self.message}" if subject \
            else f"{head} {self.message}"

    def to_json(self) -> Dict[str, Any]:
        out = {"rule": self.rule, "severity": self.severity,
               "message": self.message}
        for k in ("stage", "feature", "location"):
            v = getattr(self, k)
            if v:
                out[k] = v
        return out
