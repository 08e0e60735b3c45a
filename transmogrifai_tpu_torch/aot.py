"""The program bank: a scoring engine's programs exported ahead of time, one
per bucket; the port of ``transmogrifai_tpu/aot.py``.

A cold process builds each bucket's program on its first request there
(the engine's ``compile_count``). The bank removes that step:

* **Export** (:func:`build_program_bank`, called by
  ``serving.export_scoring_fn``): for each bucket of the ladder, one
  static-shape ``torch.export`` program of
  ``ScoringEngine.program_callable``, saved as ``aot_bank/bucket_<b>.pt2``
  beside a manifest (``aot_bank/aot_manifest.json``, written atomically)
  that records the ladder, the block manifest, the outputs, the plan and
  fitted-state digests, the environment (torch and CUDA runtime
  versions, platform, device name) and each program's bytes and
  blake2b-128 digest. The engine's device tables are warmed by one eager
  call first: a trace never fills them (``models.base.device_table``).
* **Load** (:func:`load_program_bank`): check the environment against
  this process's device and the engine's identity (plan, state, outputs,
  bucket cap), then load each program and hand it to the engine through
  ``program_key`` / ``preload``: ``compile_count`` stays 0, and on the
  card a preloaded program is warmed, captured as a CUDA graph and
  replayed as a built one is.

Every failure of a bank (an incompatible environment, a stale or altered
manifest, a corrupt or missing program) is a TMG501/502 finding, logged
as a warning: the bucket it touches is then built from the plan by the
engine, or served by the batch-polymorphic ``scoring_fn.pt2`` by the
loader — on the same device, with the same kernel. That routes a cache
miss to a build; nothing drops to the CPU or to a plain version.

Not carried over: the JAX package's serialized XLA executables (the
programs here are ``ExportedProgram`` files, which need torch and the
port's ``tmog_torch::predict_trees`` registration to load) and the
telemetry spans and counters (ROADMAP queue A, A6.8).
"""
from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import shutil
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .lint import Finding
from .models import _hist  # noqa: F401  (registers tmog_torch::predict_trees)
from .models.base import resolve_device

logger = logging.getLogger(__name__)

__all__ = ["build_program_bank", "load_program_bank", "read_manifest",
           "environment_fingerprint", "bank_dir", "manifest_path",
           "load_flat_programs", "remove_bank", "bank_bytes", "aot_stats",
           "reset_aot_stats", "FORMAT_VERSION", "BANK_DIRNAME",
           "BANK_MANIFEST"]

FORMAT_VERSION = 1
BANK_DIRNAME = "aot_bank"
BANK_MANIFEST = "aot_manifest.json"

# ---------------------------------------------------------------------------
# always-on tallies
# ---------------------------------------------------------------------------

_TALLY_LOCK = threading.Lock()
_TALLY = {"banks_exported": 0, "programs_exported": 0,
          "banks_loaded": 0, "programs_loaded": 0,
          "programs_skipped": 0, "banks_incompatible": 0}


def aot_stats() -> Dict[str, int]:
    """Snapshot of the process-wide bank tallies: exports, loads,
    per-program skips and whole-bank rejections."""
    with _TALLY_LOCK:
        return dict(_TALLY)


def reset_aot_stats() -> None:
    with _TALLY_LOCK:
        for k in _TALLY:
            _TALLY[k] = 0


def _tally(key: str, n: int = 1) -> None:
    with _TALLY_LOCK:
        _TALLY[key] += n


# ---------------------------------------------------------------------------
# paths, fingerprints, blocks
# ---------------------------------------------------------------------------


def bank_dir(path: str) -> str:
    """The program-bank subdirectory of an export directory."""
    return os.path.join(path, BANK_DIRNAME)


def manifest_path(path: str) -> str:
    return os.path.join(bank_dir(path), BANK_MANIFEST)


def environment_fingerprint(device=None) -> Dict[str, Any]:
    """What an exported program is bound to: the torch and CUDA runtime
    versions, the platform (``cuda`` or ``cpu``) and the device's name,
    for ``device`` (default: the card). The loader compares them field
    for field."""
    dev = resolve_device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "platform": dev.type, "deviceKind": kind}


def _program_digest(blob: bytes) -> str:
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def _torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy dtype name (a manifest's ``dtype``)."""
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(name))).dtype


def _spec_blocks(blocks: List[Dict[str, Any]], bucket: int
                 ) -> Tuple[Dict[str, Dict[str, np.ndarray]],
                            Dict[str, np.ndarray]]:
    """(prepared, uploads) of zero-copy host arrays at ``bucket`` rows from
    the block manifest: the shapes and dtypes a program key reads."""
    prepared: Dict[str, Dict[str, np.ndarray]] = {}
    uploads: Dict[str, np.ndarray] = {}
    for spec in blocks:
        shape = (bucket, *[int(t) for t in spec["tail"]])
        a = np.broadcast_to(np.zeros((), dtype=np.dtype(spec["dtype"])),
                            shape)
        if spec["kind"] == "prepared":
            prepared.setdefault(spec["uid"], {})[spec["name"]] = a
        else:
            uploads[spec["name"]] = a
    return prepared, uploads


def _spec_tensors(blocks: List[Dict[str, Any]], bucket: int,
                  device: torch.device):
    """(prepared, uploads) of zero tensors on ``device`` at ``bucket``
    rows, in manifest order: a bank program's example inputs."""
    prepared: Dict[str, Dict[str, torch.Tensor]] = {}
    uploads: Dict[str, torch.Tensor] = {}
    for spec in blocks:
        t = torch.zeros((bucket, *[int(x) for x in spec["tail"]]),
                        dtype=_torch_dtype(spec["dtype"]), device=device)
        if spec["kind"] == "prepared":
            prepared.setdefault(spec["uid"], {})[spec["name"]] = t
        else:
            uploads[spec["name"]] = t
    return prepared, uploads


class _ProgramModule(torch.nn.Module):
    """``run(prepared, uploads)`` as a module, for ``torch.export``."""

    def __init__(self, run):
        super().__init__()
        self._run = run

    def forward(self, prepared, uploads):
        return self._run(prepared, uploads)


class BankProgram:
    """A loaded bank program: ``(prepared, uploads) -> outputs``. The dicts
    are put in the manifest's order, the order the program was traced
    in, before the call."""

    def __init__(self, module, blocks: List[Dict[str, Any]]):
        self.module = module
        self._order = [(s["kind"], s["uid"], s["name"]) for s in blocks]

    def __call__(self, prepared, uploads):
        p: Dict[str, Dict[str, Any]] = {}
        u: Dict[str, Any] = {}
        for kind, uid, name in self._order:
            if kind == "prepared":
                p.setdefault(uid, {})[name] = prepared[uid][name]
            else:
                u[name] = uploads[name]
        return self.module(p, u)


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def save_program(ep) -> bytes:
    """An ``ExportedProgram``'s bytes (``torch.export.save``), without the
    trace's example inputs (a bucket's worth of zeros or sample rows)."""
    ep.example_inputs = None
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    return buf.getvalue()


def build_program_bank(engine, blocks: List[Dict[str, Any]],
                       out_names: List[str], path: str,
                       ladder: Optional[List[int]] = None
                       ) -> Dict[str, Any]:
    """Export the engine's program at every ladder bucket (``ladder``, by
    default the full ladder up to the engine's cap) under ``path``'s
    ``aot_bank/``; returns the bank manifest written there.

    ``blocks`` is the export block manifest (``engine.export_manifest``).
    The device tables are warmed by one eager call at the smallest bucket
    first; a program that does not export raises."""
    from .scoring import bucket_ladder

    ladder = sorted({int(b) for b in (ladder
                     or bucket_ladder(engine.bucket_cap))})
    run = engine.program_callable(out_names)
    run(*_spec_tensors(blocks, ladder[0], engine.device))    # warm tables
    module = _ProgramModule(run)
    bdir = bank_dir(path)
    os.makedirs(bdir, exist_ok=True)
    programs: Dict[str, Dict[str, Any]] = {}
    for bucket in ladder:
        ep = torch.export.export(
            module, _spec_tensors(blocks, bucket, engine.device),
            strict=False)
        blob = save_program(ep)
        fname = f"bucket_{bucket}.pt2"
        with open(os.path.join(bdir, fname), "wb") as fh:
            fh.write(blob)
        programs[str(bucket)] = {"file": fname, "bytes": len(blob),
                                 "digest": _program_digest(blob)}
        _tally("programs_exported")
    manifest = {
        "formatVersion": FORMAT_VERSION,
        "bucketLadder": ladder,
        "bucketCap": int(engine.bucket_cap),
        "outNames": list(out_names),
        "blocks": blocks,
        "planDigest": engine.rewrite_digest(),
        "stateDigest": engine.state_digest(),
        "environment": environment_fingerprint(engine.device),
        "programs": programs,
    }
    tmp = manifest_path(path) + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(tmp, manifest_path(path))
    _tally("banks_exported")
    logger.info("program bank: %d program(s) at %s (%d bytes)",
                len(programs), bdir, bank_bytes(manifest))
    return manifest


def remove_bank(path: str) -> None:
    """Delete any program bank under export dir ``path``: an export that
    writes no bank must not leave an earlier export's bank (the old
    model's weights) beside its artifact."""
    shutil.rmtree(bank_dir(path), ignore_errors=True)


def bank_bytes(manifest: Optional[Dict[str, Any]]) -> int:
    """Total program bytes a bank manifest describes."""
    if not manifest:
        return 0
    try:
        return sum(int(p.get("bytes", 0))
                   for p in manifest.get("programs", {}).values())
    except (TypeError, ValueError, AttributeError):
        return 0


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------


def read_manifest(path: str) -> Tuple[Optional[Dict[str, Any]], List[Any]]:
    """(manifest, findings) for the bank under export dir ``path``. No
    bank is ``(None, [])``, not an error; a truncated or unreadable
    manifest is ``(None, [TMG502 finding])``."""
    mp = manifest_path(path)
    try:
        with open(mp) as fh:
            manifest = json.load(fh)
    except FileNotFoundError:
        return None, []
    except (json.JSONDecodeError, UnicodeDecodeError, OSError) as e:
        return None, [Finding(
            "TMG502", f"program bank manifest unreadable ({e}); the whole "
            "bank is ignored", location=mp)]
    if not isinstance(manifest, dict) \
            or not isinstance(manifest.get("programs"), dict) \
            or not isinstance(manifest.get("blocks"), list):
        return None, [Finding(
            "TMG502", "program bank manifest is missing its programs/"
            "blocks tables (truncated or hand-edited); the whole bank is "
            "ignored", location=mp)]
    return manifest, []


def _compat_findings(manifest: Dict[str, Any], path: str, engine=None,
                     device=None) -> List[Any]:
    """Environment (and, given an engine, identity) findings for a bank
    loaded on ``device`` (the engine's, or default the card). Any finding
    means the bank does not serve."""
    out: List[Any] = []
    loc = manifest_path(path)
    if manifest.get("formatVersion") != FORMAT_VERSION:
        out.append(Finding(
            "TMG501", "program bank format version "
            f"{manifest.get('formatVersion')!r} != {FORMAT_VERSION} — "
            "re-export the bank with this build", location=loc))
        return out
    env = environment_fingerprint(engine.device if engine is not None
                                  else device)
    want = manifest.get("environment") or {}
    for k in ("platform", "deviceKind", "torch", "cuda"):
        if want.get(k) != env[k]:
            out.append(Finding(
                "TMG501", f"program bank {k} mismatch: exported under "
                f"{want.get(k)!r}, this process runs {env[k]!r} — an "
                "exported program is bound to its environment, so the "
                "bank does not serve", location=loc))
    if engine is not None and not out:
        if manifest.get("planDigest") != engine.rewrite_digest():
            out.append(Finding(
                "TMG501", "program bank plan digest mismatch (the serving "
                "engine's fused plan differs from the exported one) — the "
                "engine builds its programs", location=loc))
        if manifest.get("stateDigest") != engine.state_digest():
            out.append(Finding(
                "TMG501", "program bank fitted-state digest mismatch (the "
                "banked programs hold other weights than this model "
                "carries) — the engine builds its programs",
                location=loc))
        if list(manifest.get("outNames") or []) \
                != list(engine._out_names(results_only=True)):
            out.append(Finding(
                "TMG501", "program bank output set differs from the "
                "serving engine's result features — the engine builds its "
                "programs", location=loc))
        if int(manifest.get("bucketCap", 0)) != int(engine.bucket_cap):
            out.append(Finding(
                "TMG501", f"program bank bucket cap "
                f"{manifest.get('bucketCap')!r} != engine cap "
                f"{engine.bucket_cap} — the engine builds its programs",
                location=loc))
    return out


def load_program_file(blob: bytes, what: str):
    """``torch.export.load`` of ``blob``; a failure is a ``ValueError``
    naming ``what``."""
    try:
        with warnings.catch_warnings():
            # the constants are read from the verified bytes in memory,
            # which torch may view without copying
            warnings.filterwarnings(
                "ignore", message="The given buffer is not writable")
            return torch.export.load(io.BytesIO(blob))
    except Exception as e:  # wrap and re-raise with the artifact named
        raise ValueError(f"{what}: torch.export.load failed "
                         f"({type(e).__name__}: {e})") from e


def _load_program(path: str, manifest: Dict[str, Any], bucket: int
                  ) -> BankProgram:
    """One banked program, its bytes and digest checked first; any
    integrity failure is a ``ValueError`` with the reason."""
    rec = manifest["programs"][str(bucket)]
    fpath = os.path.join(bank_dir(path), str(rec.get("file", "")))
    try:
        with open(fpath, "rb") as fh:
            blob = fh.read()
    except OSError as e:
        raise ValueError(f"program file unreadable ({e})") from None
    expect = rec.get("bytes")
    if expect is not None and len(blob) != int(expect):
        raise ValueError(
            f"truncated program: {len(blob)} bytes on disk, manifest "
            f"recorded {expect}")
    digest = rec.get("digest")
    if digest is not None and _program_digest(blob) != digest:
        raise ValueError(
            "program digest mismatch (bytes altered since export)")
    ep = load_program_file(blob, f"bucket {bucket}")
    return BankProgram(ep.module(), manifest["blocks"])


def load_program_bank(engine, path: str) -> Dict[str, Any]:
    """Check the bank under export dir ``path`` and preload every
    compatible program into ``engine``.

    Returns ``{"present", "compatible", "loaded": [buckets], "skipped":
    {bucket: reason}, "findings": [Finding]}``. Every failure is a
    finding (TMG501: the whole bank is incompatible; TMG502: an artifact
    is corrupt), logged as a warning; the engine builds what the bank
    does not give it."""
    report: Dict[str, Any] = {"present": False, "compatible": False,
                              "loaded": [], "skipped": {},
                              "findings": []}
    manifest, findings = read_manifest(path)
    report["findings"].extend(findings)
    if manifest is None:
        report["present"] = bool(findings)
        if findings:
            _tally("banks_incompatible")
        _log(report["findings"])
        return report
    report["present"] = True
    compat = _compat_findings(manifest, path, engine=engine)
    if compat:
        report["findings"].extend(compat)
        _tally("banks_incompatible")
        _log(report["findings"])
        return report
    out_names = list(manifest["outNames"])
    for bucket_s in sorted(manifest["programs"], key=int):
        bucket = int(bucket_s)
        try:
            fn = _load_program(path, manifest, bucket)
        except ValueError as e:
            report["skipped"][bucket] = str(e)
            report["findings"].append(Finding(
                "TMG502", f"program bank bucket {bucket}: {e} — the engine "
                "builds this bucket on first use",
                location=manifest_path(path)))
            _tally("programs_skipped")
            continue
        prepared, uploads = _spec_blocks(manifest["blocks"], bucket)
        engine.preload(engine.program_key(prepared, uploads, out_names), fn)
        report["loaded"].append(bucket)
        _tally("programs_loaded")
    report["compatible"] = bool(report["loaded"])
    if report["compatible"]:
        _tally("banks_loaded")
    _log(report["findings"])
    return report


def _log(findings) -> None:
    for f in findings:
        logger.warning("aot: %s", f.format())


def load_flat_programs(path: str,
                       expect_digests: Optional[Dict[str, Any]] = None,
                       device=None
                       ) -> Tuple[Optional[Dict[str, Any]],
                                  Dict[int, BankProgram], List[Any]]:
    """``serving.load_scoring_fn``'s bank: ``(manifest, {bucket:
    program}, findings)`` on ``device`` (default: the card). Environment
    checks, and — when ``expect_digests`` carries the export metadata's
    ``planDigest`` / ``stateDigest`` — a check of the bank against them,
    so a stale bank beside a newer export (other weights) is refused.
    Corrupt or missing programs are skipped with TMG502 findings. No bank
    is ``(None, {}, [])``."""
    manifest, findings = read_manifest(path)
    if manifest is None:
        if findings:
            _tally("banks_incompatible")
        return None, {}, findings
    compat = _compat_findings(manifest, path, device=device)
    if not compat:
        for key in ("planDigest", "stateDigest"):
            want = (expect_digests or {}).get(key)
            if want is not None and manifest.get(key) != want:
                compat.append(Finding(
                    "TMG501", f"program bank {key} does not match the "
                    "export metadata — the bank is STALE (left from an "
                    "earlier export of another model); the "
                    "batch-polymorphic program serves",
                    location=manifest_path(path)))
    if compat:
        _tally("banks_incompatible")
        return manifest, {}, findings + compat
    programs: Dict[int, BankProgram] = {}
    for bucket_s in sorted(manifest["programs"], key=int):
        bucket = int(bucket_s)
        try:
            programs[bucket] = _load_program(path, manifest, bucket)
            _tally("programs_loaded")
        except ValueError as e:
            findings.append(Finding(
                "TMG502", f"program bank bucket {bucket}: {e} — this "
                "bucket is served by the batch-polymorphic program",
                location=manifest_path(path)))
            _tally("programs_skipped")
    if programs:
        _tally("banks_loaded")
    return manifest, programs, findings
