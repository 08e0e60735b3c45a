"""Threefry-2x32 counter-based PRNG, bit-exact with ``jax.random``.

The tree engine draws its quantile-sketch row permutation from
``jax.random.permutation(PRNGKey(seed), n)`` (``_treefit.quantile_bin_edges``
beyond ``QUANTILE_SAMPLE_ROWS``), and the random forest its Poisson
bootstrap and per-node feature draws from ``jax.random.uniform`` under
``jax.random.fold_in`` keys, so the port reproduces those bits exactly. The
stream follows jax's ``jax_threefry_partitionable=True`` layout: the counter
of element ``i`` of a draw of shape ``s`` is the 64-bit flat index split
into (hi, lo) words, so a draw of shape (A, F) is the first A rows of a draw
of shape (cap, F).

A key is a ``(2,)`` uint32 numpy array. The numpy functions run on the host
(uint32 arithmetic wraps natively). :func:`uniform_batch` draws under many
keys at once on any torch device, through :func:`threefry2x32_torch` (int64
tensors masked to 32 bits), with the same bits as the numpy hash.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "permutation", "threefry2x32", "threefry2x32_torch",
           "uniform_batch"]

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x1: np.ndarray, x2: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of counter words (x1, x2) under
    key (k1, k2) — the same schedule as jax's ``threefry2x32_p``."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    for i in range(5):
        for r in _ROT[i % 2]:
            x[0] = x[0] + x[1]
            x[1] = _rotl(x[1], r)
            x[1] = x[0] ^ x[1]
        x[0] = x[0] + ks[(i + 1) % 3]
        x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def PRNGKey(seed: int) -> np.ndarray:
    """Raw key from an integer seed: (high 32 bits, low 32 bits)."""
    seed = int(seed)
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF],
                    dtype=np.uint32)


def _counters(shape):
    n = math.prod(shape)
    flat = np.arange(n, dtype=np.uint64)
    hi = (flat >> np.uint64(32)).astype(np.uint32).reshape(shape)
    lo = (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32).reshape(shape)
    return hi, lo


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: [num, 2] uint32 subkeys."""
    hi, lo = _counters((int(num),))
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """32-bit ``jax.random.bits``: the two hash words XOR-ed."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return b1 ^ b2


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: jax's ``_shuffle`` — a fixed
    number of rounds, each a STABLE sort of the running order by fresh
    32-bit keys drawn from a split of the key."""
    x = np.arange(int(n), dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        order = np.argsort(random_bits(sub, (n,)), kind="stable")
        x = x[order]
    return x


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: the hash of counter words
    (0, data) — jax's ``threefry_seed`` of a uint32 is (0, data)."""
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                          np.array([int(data) & 0xFFFFFFFF], np.uint32))
    return np.array([b1[0], b2[0]], dtype=np.uint32)


def _bits_to_unit(b1, b2, dtype):
    """[0, 1) floats from the hash words, as ``jax.random.uniform`` makes
    them: the top mantissa bits of the draw under exponent 0, minus 1.
    32-bit draws are b1 ^ b2; 64-bit draws are (b1 << 32) | b2."""
    if np.dtype(dtype) == np.float32:
        bits = (b1 ^ b2) >> np.uint32(9) | np.uint32(0x3F800000)
        return bits.view(np.float32) - np.float32(1.0)
    bits = (b1.astype(np.uint64) << np.uint64(32) | b2) >> np.uint64(12) \
        | np.uint64(0x3FF0000000000000)
    return bits.view(np.float64) - 1.0


def uniform(key: np.ndarray, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype)`` on [0, 1) (float32 or
    float64: the draw's width is the dtype's)."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(shape)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return _bits_to_unit(b1, b2, dtype)


# ---------------------------------------------------------------------------
# The same hash on torch tensors, many keys at once
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def threefry2x32_torch(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor):
    """:func:`threefry2x32` on int64 tensors holding uint32 values (keys
    and counters broadcast against each other); every sum is masked back
    to 32 bits, so the words equal the numpy hash's."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a, b = (x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            a = (a + b) & _M32
            b = ((b << r) & _M32) | (b >> (32 - r))
            b = a ^ b
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + ks[(i + 2) % 3] + (i + 1)) & _M32
    return a, b


def uniform_batch(keys: np.ndarray, shape, dtype: torch.dtype,
                  device) -> torch.Tensor:
    """[K, *shape] draws on ``device``: row k is
    ``jax.random.uniform(keys[k], shape, dtype)`` (float32: 32-bit draws;
    float64: 64-bit), bit for bit."""
    shape = tuple(int(s) for s in shape)
    keys = torch.as_tensor(np.asarray(keys, np.uint32).astype(np.int64),
                           device=device)
    k1, k2 = keys[:, :1], keys[:, 1:]
    flat = torch.arange(math.prod(shape), dtype=torch.int64,
                        device=device)[None, :]
    b1, b2 = threefry2x32_torch(k1, k2, flat >> 32, flat & _M32)
    if dtype == torch.float32:
        bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
        out = bits.view(torch.float32) - 1.0
    elif dtype == torch.float64:
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        out = bits.view(torch.float64) - 1.0
    else:
        raise TypeError(f"uniform_batch: no draw of dtype {dtype}")
    return out.reshape((len(keys),) + shape)
