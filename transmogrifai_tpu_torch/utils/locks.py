"""Runtime lock-order witness; the port of
``transmogrifai_tpu/utils/locks.py`` (host only, no torch).

In debug and test runs every :func:`witness_lock` records the per-thread
acquisition order it observes and raises (or records) the moment two
threads disagree about which of two locks comes first: the instant a
latent deadlock becomes demonstrable, not the rare run where it hangs.
The port's locks that are witnessed are telemetry's.

Disarmed (the default) a witnessed lock costs one attribute read per
acquisition on top of the underlying ``threading.Lock``.

Arm it three ways:

* ``locks.arm(raise_on_violation=True)`` / ``locks.disarm()``
* ``with locks.armed(): ...`` (tests; restores prior state)
* environment knob ``TMOG_LOCK_WITNESS=1`` (record) or ``=raise``
  read once at import, so the witness is armed before any lock of the
  package is taken.

``fcntl.flock`` regions have no lock object to wrap; bracket them with
:func:`witness_acquire` / :func:`witness_release` so kernel file locks
join the same ordering graph as in-process mutexes.
"""

from __future__ import annotations

import os
import threading
import traceback
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = [
    "LockOrderViolation",
    "WitnessedLock",
    "arm",
    "armed",
    "disarm",
    "is_armed",
    "reset",
    "violations",
    "witness_acquire",
    "witness_lock",
    "witness_release",
]


class LockOrderViolation(RuntimeError):
    """Two threads acquired the same pair of locks in opposite orders."""


_armed = False
_raise_on_violation = False
#: plain (never witnessed) mutex guarding the tables below
_mu = threading.Lock()
#: (first, second) -> human description of the first observation
_edges: Dict[Tuple[str, str], str] = {}
_violations: List[str] = []
_tls = threading.local()


def _held() -> List[Tuple[str, str]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _site() -> str:
    """Short 'file:line in func' stack for the current acquisition."""
    frames = [f for f in traceback.extract_stack(limit=12)
              if not f.filename.endswith("locks.py")]
    return " <- ".join(
        f"{os.path.basename(f.filename)}:{f.lineno} in {f.name}"
        for f in reversed(frames[-3:]))


def _record(name: str) -> Optional[str]:
    """Record an acquisition; return a violation message or None.

    The caller pushes onto the per-thread stack itself (so manual
    flock brackets and real locks share one code path) and decides
    whether a returned violation raises or is merely recorded.
    """
    held = _held()
    if any(h == name for h, _ in held):
        return None                       # reentrant re-entry: no edge
    site = _site()
    tname = threading.current_thread().name
    msg = None
    with _mu:
        for h, h_site in held:
            rev = _edges.get((name, h))
            if rev is not None:
                msg = (
                    f"lock-order inversion: thread '{tname}' holds "
                    f"'{h}' (acquired at {h_site}) and is acquiring "
                    f"'{name}' at {site}, but the opposite order was "
                    f"established earlier — {rev}")
                _violations.append(msg)
                break
            _edges.setdefault(
                (h, name),
                f"thread '{tname}' held '{h}' (at {h_site}) then "
                f"acquired '{name}' at {site}")
    return msg


def _push(name: str) -> None:
    _held().append((name, _site()))


def _pop(name: str) -> None:
    held = _held()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            del held[i]
            return


class WitnessedLock:
    """``threading.Lock``/``RLock`` proxy feeding the order witness."""

    __slots__ = ("name", "reentrant", "_inner")

    def __init__(self, name: str, reentrant: bool = False):
        self.name = name
        self.reentrant = reentrant
        self._inner = threading.RLock() if reentrant else threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got and _armed:
            msg = _record(self.name)
            if msg is not None and _raise_on_violation:
                self._inner.release()
                raise LockOrderViolation(msg)
            _push(self.name)
        return got

    def release(self) -> None:
        if _armed:
            _pop(self.name)
        self._inner.release()

    def __enter__(self) -> "WitnessedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._inner, "locked", None)
        return locked() if locked is not None else False

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        kind = "RLock" if self.reentrant else "Lock"
        return f"<WitnessedLock {self.name!r} ({kind})>"


def witness_lock(name: str, reentrant: bool = False) -> WitnessedLock:
    """Factory for a named, order-witnessed lock."""
    return WitnessedLock(name, reentrant=reentrant)


def witness_acquire(name: str) -> None:
    """Manually enter a named region (e.g. after ``fcntl.flock``)."""
    if not _armed:
        return
    msg = _record(name)
    if msg is not None and _raise_on_violation:
        raise LockOrderViolation(msg)
    _push(name)


def witness_release(name: str) -> None:
    """Manually leave a region opened with :func:`witness_acquire`."""
    if getattr(_tls, "held", None):
        _pop(name)


def arm(raise_on_violation: bool = False) -> None:
    """Start witnessing; clears previously recorded edges/violations."""
    global _armed, _raise_on_violation
    reset()
    _raise_on_violation = raise_on_violation
    _armed = True


def disarm() -> None:
    global _armed, _raise_on_violation
    _armed = False
    _raise_on_violation = False


def is_armed() -> bool:
    return _armed


def reset() -> None:
    """Forget all recorded edges and violations (keeps armed state)."""
    with _mu:
        _edges.clear()
        del _violations[:]


def violations() -> List[str]:
    with _mu:
        return list(_violations)


@contextmanager
def armed(raise_on_violation: bool = False) -> Iterator[None]:
    """Arm for the duration of a block, restoring the prior state."""
    prev = (_armed, _raise_on_violation)
    arm(raise_on_violation=raise_on_violation)
    try:
        yield
    finally:
        if prev[0]:
            arm(raise_on_violation=prev[1])
        else:
            disarm()


_env = os.environ.get("TMOG_LOCK_WITNESS", "").strip().lower()
if _env and _env not in ("0", "false", "no", "off"):
    arm(raise_on_violation=_env == "raise")
del _env
