"""Build/version stamping (``VersionInfo.scala`` analog); the port of
``transmogrifai_tpu/utils/version.py``.

The package version, the torch and CUDA versions, and the git commit of
the working tree (when there is one) identify what produced a saved
model; ``model_io`` records them in model.json under ``versionInfo``.
"""
from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional

__all__ = ["version_info"]

_cache: Optional[Dict[str, str]] = None


def _git_commit() -> Optional[str]:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(
            ["git", "-C", repo, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    return (out.stdout.strip() or None) if out.returncode == 0 else None


def version_info() -> Dict[str, str]:
    """``{"version", "torch", "cuda", "gitCommit"}``; ``cuda`` is the
    toolkit torch was built with (absent on a CPU build), ``gitCommit``
    absent outside a git checkout."""
    global _cache
    if _cache is None:
        import torch

        from .. import __version__
        _cache = {"version": __version__, "torch": torch.__version__}
        if torch.version.cuda:
            _cache["cuda"] = torch.version.cuda
        commit = _git_commit()
        if commit:
            _cache["gitCommit"] = commit
    return dict(_cache)
