"""Vectorized host-side feature-prep primitives; host copy of
``transmogrifai_tpu/ops/_hostvec.py``.

* string → vocab code mapping runs the Python dict only over the UNIQUE
  values (``np.unique(..., return_inverse=True)``); rows are recovered
  with one fancy-index;
* ragged token columns are flattened once with row offsets and scattered
  with one fancy-indexed accumulate;
* murmur3 hashing runs over unique tokens through the batch (C++ when
  built) hasher, and free text through the fused C++ tokenize + hash +
  scatter pass.

Strings stay on the host and enter the device as dense numeric arrays.
"""
from __future__ import annotations

import ctypes
import os
from collections import Counter
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .vectorizer_base import VEC_DTYPE

__all__ = ["string_codes", "onehot_block", "multihot_block",
           "hashed_count_block",
           "hashed_count_flat", "flatten_ragged", "value_counts",
           "hashed_text_block"]

#: sentinel that cannot collide with real values (contains a NUL byte)
_NULL = "\0\0null"


def string_codes(values: Sequence[Optional[str]], vocab: Sequence[str]
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row optional strings → (codes [n] int64, code k = OTHER;
    null_mask [n]). The vocab dict is consulted once per UNIQUE value."""
    k = len(vocab)
    null_mask = np.fromiter((v is None for v in values), bool,
                            count=len(values))
    arr = np.array([_NULL if v is None else v for v in values], dtype=object)
    uniq, inv = np.unique(arr, return_inverse=True)
    index = {v: i for i, v in enumerate(vocab)}
    uniq_codes = np.fromiter(
        (index.get(u, k) for u in uniq), dtype=np.int64, count=len(uniq))
    return uniq_codes[inv], null_mask


def value_counts(values: Sequence[str]) -> Counter:
    """Counter of non-null string values via one unique pass."""
    vals = [v for v in values if v is not None]
    if not vals:
        return Counter()
    uniq, counts = np.unique(np.asarray(vals, dtype=object),
                             return_counts=True)
    return Counter(dict(zip(uniq.tolist(), counts.tolist())))


def onehot_block(values: Sequence[Optional[str]], vocab: Sequence[str],
                 track_nulls: bool,
                 out: Optional[np.ndarray] = None) -> np.ndarray:
    """[n, K+1(+1)] pivot block: [cat_1..cat_K, OTHER(, Null)], written
    into ``out`` (a zeroed array or view of the right width) if given."""
    n = len(values)
    k = len(vocab)
    width = k + 1 + (1 if track_nulls else 0)
    block = out if out is not None else np.zeros((n, width), dtype=VEC_DTYPE)
    codes, null_mask = string_codes(values, vocab)
    rows = np.nonzero(~null_mask)[0]
    block[rows, codes[rows]] = 1.0
    if track_nulls:
        block[null_mask, k + 1] = 1.0
    return block


def flatten_ragged(row_values: Sequence[Sequence[str]]
                   ) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """Ragged per-row collections → (flat values, row of each, lengths)."""
    lengths = np.fromiter((len(v) for v in row_values), dtype=np.int64,
                          count=len(row_values))
    flat: List[str] = []
    for v in row_values:
        flat.extend(v)
    rows = np.repeat(np.arange(len(row_values)), lengths)
    return flat, rows, lengths


def multihot_block(row_values: Sequence[Sequence[str]], vocab: Sequence[str],
                   track_nulls: bool,
                   out: Optional[np.ndarray] = None) -> np.ndarray:
    """[n, K+1(+1)] multi-hot block of a set column: [cat_1..cat_K,
    OTHER(, Null)]; an empty set counts as null."""
    n = len(row_values)
    k = len(vocab)
    width = k + 1 + (1 if track_nulls else 0)
    block = out if out is not None else np.zeros((n, width), dtype=VEC_DTYPE)
    flat, rows, lengths = flatten_ragged(row_values)
    if flat:
        codes, _ = string_codes(flat, vocab)
        block[rows, codes] = 1.0          # an assignment: repeats set once
    if track_nulls:
        block[lengths == 0, k + 1] = 1.0
    return block


def hashed_count_block(row_tokens: Sequence[Sequence[str]], num_features: int,
                       seed: int, binary_freq: bool,
                       out: Optional[np.ndarray] = None,
                       col_offset: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Hashing-trick counts: [n, num_features] bucket counts + [n] null
    (empty-token-list) mask; ``out``/``col_offset`` accumulate into a
    shared block."""
    n = len(row_tokens)
    flat, rows, lengths = flatten_ragged(row_tokens)
    return hashed_count_flat(flat, rows, lengths == 0, n, num_features,
                             seed, binary_freq, out=out,
                             col_offset=col_offset)


def hashed_count_flat(flat: Sequence[str], rows: np.ndarray,
                      null_mask: np.ndarray, n: int, num_features: int,
                      seed: int, binary_freq: bool,
                      out: Optional[np.ndarray] = None,
                      col_offset: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Core of :func:`hashed_count_block` from a flat token list + row
    index: tokens hashed once per unique token, then unique (row, bucket)
    pairs with their multiplicities scattered in one accumulate."""
    from .hashing import hash_tokens

    counts = out if out is not None else np.zeros((n, num_features),
                                                  dtype=VEC_DTYPE)
    if len(flat):
        uniq, inv = np.unique(np.asarray(flat, dtype=object),
                              return_inverse=True)
        buckets = (hash_tokens(list(uniq), seed)
                   % np.uint32(num_features)).astype(np.int64)[inv]
        pair = rows * np.int64(num_features) + buckets
        upair, mult = np.unique(pair, return_counts=True)
        r = upair // num_features
        b = upair % num_features
        region = counts[:, col_offset:col_offset + num_features]
        if binary_freq:
            region[r, b] = 1.0
        else:
            region[r, b] += mult
    return counts, np.asarray(null_mask, VEC_DTYPE)


def hashed_text_block(values: Sequence[Optional[str]], num_features: int,
                      seed: int, binary_freq: bool,
                      out: np.ndarray, col_offset: int = 0) -> np.ndarray:
    """Free-text column → hashed token counts, written in place into
    ``out[:, col_offset:col_offset+num_features]``; returns the [n] null
    mask (f32).

    Fast path: the fused C++ tokenize + hash + scatter pass
    (``native/fasthash.cc tokenized_hash_counts``), bit-exact with
    :func:`~.text.tokenize_simple` + murmur3 for ASCII text; rows with
    non-ASCII bytes are flagged by it and redone through the Python
    tokenizer. Without the native library: tokenize per UNIQUE value,
    then one bulk hashed scatter."""
    from .hashing import hash_tokens, load_native
    from .text import _MIN_TOKEN_LENGTH, tokenize_simple

    n = len(values)
    null_mask = np.fromiter((v is None for v in values), bool, count=n)
    lib = load_native()
    if lib and out.flags.c_contiguous and out.dtype == np.float32:
        encoded = [b"" if v is None else v.encode("utf-8") for v in values]
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        blob = b"".join(encoded)
        flags = np.zeros(n, dtype=np.uint8)
        lib.tokenized_hash_counts(
            blob, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, np.uint32(seed), np.uint32(num_features),
            np.int32(_MIN_TOKEN_LENGTH), 1 if binary_freq else 0,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.shape[1], col_offset,
            flags.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            min(os.cpu_count() or 1, 16))
        region = out[:, col_offset:col_offset + num_features]
        for i in np.nonzero(flags)[0]:
            toks = tokenize_simple(values[i])
            if not toks:
                continue
            buckets = (hash_tokens(toks, seed)
                       % np.uint32(num_features)).astype(np.int64)
            if binary_freq:
                region[i, buckets] = 1.0
            else:
                np.add.at(region[i], buckets, 1.0)
        return np.asarray(null_mask, VEC_DTYPE)

    vals = np.array([v if v is not None else "" for v in values],
                    dtype=object)
    uniq, inv = np.unique(vals, return_inverse=True)
    toks = [tokenize_simple(u) for u in uniq.tolist()]
    row_tokens = [[] if null_mask[r] else toks[i]
                  for r, i in enumerate(inv)]
    hashed_count_block(row_tokens, num_features, seed, binary_freq,
                       out=out, col_offset=col_offset)
    return np.asarray(null_mask, VEC_DTYPE)
