"""ASCII table pretty-printer (``utils/.../Table.scala`` analog), used by
``WorkflowModel.summary_pretty`` and ``ExecutionPlan.report``; the port
of ``transmogrifai_tpu/utils/table.py``."""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

__all__ = ["Table"]


class Table:
    """Render rows of cells as a boxed ASCII table with a title row."""

    def __init__(self, columns: Sequence[str],
                 rows: Sequence[Sequence[Any]],
                 name: Optional[str] = None):
        if not columns:
            raise ValueError("Table needs at least one column")
        for r in rows:
            if len(r) != len(columns):
                raise ValueError(
                    f"Row width {len(r)} != column count {len(columns)}")
        self.columns = [str(c) for c in columns]
        self.rows = [[_fmt(c) for c in r] for r in rows]
        self.name = name

    def render(self) -> str:
        widths = [len(c) for c in self.columns]
        for r in self.rows:
            for i, cell in enumerate(r):
                widths[i] = max(widths[i], len(cell))

        def line(ch: str = "-") -> str:
            return "+" + "+".join(ch * (w + 2) for w in widths) + "+"

        def row(cells: List[str]) -> str:
            return "| " + " | ".join(
                c.ljust(w) for c, w in zip(cells, widths)) + " |"

        out: List[str] = []
        if self.name:
            total = sum(widths) + 3 * len(widths) + 1
            out.append(line("="))
            out.append("|" + self.name.center(total - 2) + "|")
        out.append(line("="))
        out.append(row(self.columns))
        out.append(line("="))
        for r in self.rows:
            out.append(row(r))
        out.append(line("-"))
        return "\n".join(out)

    def __str__(self) -> str:
        return self.render()


def _fmt(v: Any) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return "" if v is None else str(v)
