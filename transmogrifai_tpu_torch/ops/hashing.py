"""Feature hashing — the MurmurHash3 hashing trick; the port of
``transmogrifai_tpu/ops/hashing.py``.

Parity: ``OPCollectionHashingVectorizer`` + ``HashingFun``: MurmurHash3 x86
32-bit of each token (seed 42), bucketed modulo ``num_features``, in a
shared or per-feature hash space.

Hashing is host work (strings live there). The C++ batch hasher and the
fused tokenize + hash + scatter pass come from ``native/fasthash.cc``,
compiled with ``g++`` at first use into ``build/torch_ext/`` (keyed by a
hash of source and flags); without a compiler the numpy/Python
:func:`murmur3_32` below, the plain version, does the same work
bit-identically.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..columns import ColumnStore, TextColumn, TextListColumn
from ..stages.base import register_stage
from ..types.feature_types import Text, TextList
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizer_base import (TransmogrifierDefaults, VEC_DTYPE,
                              VectorizerModel, null_indicator_meta)

__all__ = ["murmur3_32", "hash_tokens", "HashingVectorizerModel",
           "load_native"]

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "fasthash.cc"
_BUILD_DIR = _ROOT / "build" / "torch_ext"
_CXXFLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

_native = None
_native_lock = threading.Lock()


def load_native():
    """The native hasher library (built on first use), or False where it
    cannot be built — the callers then take the Python hasher."""
    global _native
    with _native_lock:
        if _native is not None:
            return _native
        _native = False
        if not _SRC.exists():
            return _native
        tag = hashlib.sha1(_SRC.read_bytes()
                           + " ".join(_CXXFLAGS).encode()).hexdigest()[:16]
        path = _BUILD_DIR / f"fasthash-{tag}.so"
        if not path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(
                    [os.environ.get("CXX", "g++"), *_CXXFLAGS, "-o", str(tmp),
                     str(_SRC)], check=True, capture_output=True,
                    timeout=300)
                os.replace(tmp, path)
            except (OSError, subprocess.SubprocessError):
                tmp.unlink(missing_ok=True)
                return _native
        lib = ctypes.CDLL(str(path))
        lib.murmur3_batch.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32)]
        lib.tokenized_hash_counts.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32]
        _native = lib
        return _native


def murmur3_32(data: bytes, seed: int = 42) -> int:
    """MurmurHash3 x86 32-bit (public algorithm, Austin Appleby)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    length = len(data)
    n_blocks = length // 4
    for i in range(n_blocks):
        k = int.from_bytes(data[4 * i:4 * i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[4 * n_blocks:]
    k = 0
    if len(tail) >= 3:
        k ^= tail[2] << 16
    if len(tail) >= 2:
        k ^= tail[1] << 8
    if len(tail) >= 1:
        k ^= tail[0]
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= length
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def hash_tokens(tokens: Sequence[str], seed: int = 42) -> np.ndarray:
    """uint32 murmur3 hash per token; the C++ batch hasher when built."""
    if not tokens:
        return np.zeros((0,), dtype=np.uint32)
    lib = load_native()
    if lib:
        encoded = [t.encode("utf-8") for t in tokens]
        offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        out = np.zeros(len(encoded), dtype=np.uint32)
        lib.murmur3_batch(
            b"".join(encoded),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(encoded), seed,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out
    return np.array([murmur3_32(t.encode("utf-8"), seed) for t in tokens],
                    dtype=np.uint32)


@register_stage
class HashingVectorizerModel(VectorizerModel):
    """Hashing-trick transform of Text / TextList columns: token counts
    scattered into hash buckets, in one shared ``num_features``-wide space
    (``shared_hash_space``) or a block per feature, plus null indicators."""

    operation_name = "hash"
    seq_type = (Text, TextList)
    device_math = False

    def __init__(self, num_features: int = TransmogrifierDefaults.HASH_SIZE,
                 shared_hash_space: bool = False,
                 track_nulls: bool = True,
                 binary_freq: bool = False,
                 seed: int = 42,
                 input_names: Sequence[str] = (),
                 ftype_name: str = "Text",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.num_features = num_features
        self.shared_hash_space = shared_hash_space
        self.track_nulls = track_nulls
        self.binary_freq = binary_freq
        self.seed = seed
        self.input_names_saved = list(input_names)
        self.ftype_name = ftype_name

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        from ._hostvec import hashed_count_block, hashed_count_flat
        names = self._names()
        n = store.n_rows
        k = len(names)
        width = (self.num_features if self.shared_hash_space
                 else self.num_features * k)
        mat = np.zeros((n, width + (k if self.track_nulls else 0)),
                       dtype=VEC_DTYPE)
        for j, name in enumerate(names):
            col = store[name]
            base = 0 if self.shared_hash_space else j * self.num_features
            if isinstance(col, TextColumn):
                # a Text column's tokens are its non-null values
                null_mask = np.fromiter((v is None for v in col.values),
                                        bool, count=n)
                rows = np.nonzero(~null_mask)[0]
                _, null_j = hashed_count_flat(
                    [col.values[r] for r in rows], rows, null_mask, n,
                    self.num_features, self.seed, self.binary_freq,
                    out=mat, col_offset=base)
            elif isinstance(col, TextListColumn):
                _, null_j = hashed_count_block(
                    [list(v) for v in col.values], self.num_features,
                    self.seed, self.binary_freq, out=mat, col_offset=base)
            else:
                raise TypeError(f"Cannot hash column {type(col).__name__}")
            if self.track_nulls:
                mat[:, width + j] = null_j
        return {"mat": mat}

    def vector_metadata(self) -> VectorMetadata:
        names = self._names()
        cols: List[VectorColumnMetadata] = []
        if self.shared_hash_space:
            parent = names[0] if len(names) == 1 else "shared"
            cols += [VectorColumnMetadata(
                parent_feature_name=parent,
                parent_feature_type=self.ftype_name,
                descriptor_value=f"hash_{i}")
                for i in range(self.num_features)]
        else:
            for name in names:
                cols += [VectorColumnMetadata(
                    parent_feature_name=name,
                    parent_feature_type=self.ftype_name,
                    descriptor_value=f"hash_{i}")
                    for i in range(self.num_features)]
        if self.track_nulls:
            cols += [null_indicator_meta(name, self.ftype_name)
                     for name in names]
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"input_names_saved": self._names()}
