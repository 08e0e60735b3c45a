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

:func:`normal` and :func:`categorical` reproduce ``jax.random.normal`` and
``jax.random.categorical`` bit for bit. They need XLA's own elementwise
math, not torch's: ``normal`` is ``sqrt(2)·erfinv(u)`` with XLA's ``ErfInv``
polynomials (Giles' single-precision form in f32, a three-region one in
f64) over XLA's ``log1p`` (a Cephes rational for small arguments), and the
Gumbel noise of ``categorical`` is ``−log(−log(u))`` with XLA's f32 ``log``
(a Cephes polynomial of the mantissa). ``torch.erfinv`` and ``torch.log``
round differently, so those three are written out here, one IEEE operation
at a time as XLA's CPU code generator emits them (no fused multiply-add),
on torch tensors: their bits are the same on the CPU and on the card. XLA's
f64 ``log`` is the C library's, which is called through :mod:`math`.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

__all__ = ["PRNGKey", "split", "fold_in", "random_bits", "uniform",
           "permutation", "threefry2x32", "threefry2x32_torch",
           "uniform_batch", "normal", "categorical", "xla_log_f32",
           "xla_log1p", "xla_erfinv"]

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


# ---------------------------------------------------------------------------
# XLA's elementwise math: log (f32), log1p and erfinv, bit for bit
# ---------------------------------------------------------------------------

def _hex(h: int) -> float:
    """A constant as XLA's LLVM IR spells it: the bits of a double."""
    return float(np.array([h], np.uint64).view(np.float64)[0])


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a·b + c rounded once, as the fused multiply-add that XLA's CPU
    compiler forms from a multiply whose only use is an add. f32: the
    product is exact in f64, and a sum that lands on an f32 midpoint is
    rounded by the exact error of the f64 sum (no double rounding). f64:
    Dekker's exact product and Knuth's two-sum, summed once more."""
    b = b if torch.is_tensor(b) else torch.full_like(a, b)
    c = c if torch.is_tensor(c) else torch.full_like(a, c)
    if a.dtype == torch.float32:
        p = a.double() * b.double()
        c64 = c.double()
        s = p + c64
        bb = s - p
        err = (p - (s - bb)) + (c64 - bb)
        r = s.float()
        diff = s - r.double()
        up = torch.nextafter(r, torch.where(diff > 0, torch.full_like(
            r, float("inf")), torch.full_like(r, -float("inf"))))
        half = (up.double() - r.double()) * 0.5
        bump = (diff != 0) & (diff == half) & (err != 0) \
            & ((err > 0) == (diff > 0))
        return torch.where(bump, up, r)
    split = 134217729.0
    p = a * b

    def _split(v):
        t = v * split
        hi = t - (t - v)
        return hi, v - hi
    ah, al = _split(a)
    bh, bl = _split(b)
    ep = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    es = (p - (s - bb)) + (c - bb)
    return s + (es + ep)


_LOG_MIN_NORMAL = _hex(0x3810000000000000)
_LOG_SQRTHF = _hex(0x3FE6A09E60000000)
#: the three interleaved Horner chains of XLA's f32 log polynomial
_LOG_P = ((_hex(0x3FB2043760000000), _hex(0xBFBD7A3700000000),
           _hex(0x3FBDE4A340000000)),
          (_hex(0xBFBFCBA9E0000000), _hex(0x3FC23D37E0000000),
           _hex(0xBFC555CA00000000)),
          (_hex(0x3FC999D580000000), _hex(0xBFCFFFFF80000000),
           _hex(0x3FD5555540000000)))
_LOG_Q1 = _hex(0xBF2BD01060000000)
_LOG_Q2 = _hex(0x3FE6300000000000)


def xla_log_f32(v: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``log`` (its CPU code generator's inline polynomial; XLA
    runs with subnormals read as zero)."""
    f32 = torch.float32
    v = torch.where(v.abs() < _LOG_MIN_NORMAL, torch.zeros_like(v), v)
    vc = torch.where(v > _LOG_MIN_NORMAL, v,
                     torch.full_like(v, _LOG_MIN_NORMAL))
    bits = vc.view(torch.int32)
    e = ((bits >> 23) - 127).to(f32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(f32)
    lt = m < _LOG_SQRTHF
    zero = torch.zeros_like(m)
    e = e - torch.where(lt, torch.ones_like(m), zero)
    x = (m - 1.0) + torch.where(lt, m, zero)
    z = x * x
    x3 = z * x
    (a0, a1, a2), (b0, b1, b2), (c0, c1, c2) = _LOG_P
    y1 = _fma(_fma(x, a0, a1), x, a2)
    y2 = _fma(_fma(x, b0, b1), x, b2)
    y3 = _fma(_fma(x, c0, c1), x, c2)
    y = _fma(_fma(_fma(y1, x3, y2), x3, y3), x3, e * _LOG_Q1)
    r = _fma(e, _LOG_Q2, _fma(z, -0.5, x) + y)
    # special values, as the emitted selects build them
    r_bits = torch.where(~(v > 0), torch.full_like(bits, -1),
                         r.view(torch.int32))
    special = torch.where(v == float("inf"),
                          torch.full_like(bits, 0x7F800000),
                          torch.zeros_like(bits))
    special = torch.where(v != 0, special, torch.full_like(bits, -8388608))
    finite = (v != 0) & (v != float("inf"))
    out = special | torch.where(finite, r_bits, torch.zeros_like(bits))
    return out.view(f32)


def _log_f64(v: torch.Tensor) -> torch.Tensor:
    """XLA's f64 ``log`` is the C library's: :func:`math.log` (host)."""
    out = np.array([math.log(x) if x > 0 else
                    (-math.inf if x == 0 else math.nan)
                    for x in v.cpu().numpy().tolist()], np.float64)
    return torch.from_numpy(out).reshape(v.shape).to(v.device)


#: XLA's Log1p small-argument rational (Cephes), highest degree first
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880


def _horner(x: torch.Tensor, coeffs, zero_x: torch.Tensor) -> torch.Tensor:
    p = zero_x + coeffs[0]
    for c in coeffs[1:]:
        p = _fma(p, x, c)
    return p


def xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``log1p``: the rational below |x| < √2 − 1, else log(1 + x)."""
    small_mask = x.abs() < _LOG1P_SMALL
    if x.dtype == torch.float32:
        large = xla_log_f32(x + 1.0)
    else:
        large = torch.zeros_like(x)
        big = ~small_mask
        if bool(big.any()):
            large[big] = _log_f64(x[big] + 1.0)
    x2 = x * x
    zero_x = x * 0.0
    ratio = _horner(x, _LOG1P_NUM, zero_x) / _horner(x, _LOG1P_DEN, zero_x)
    small = x + _fma(x2, -0.5, (x * x2) * ratio)
    return torch.where(small_mask, small, large)


#: XLA's ErfInv32 (Giles): w < 5 and w ≥ 5 coefficients
_ERFINV32 = ((2.81022636e-08, -0.000200214257),
             (3.43273939e-07, 0.000100950558),
             (-3.5233877e-06, 0.00134934322),
             (-4.39150654e-06, -0.00367342844),
             (0.00021858087, 0.00573950773),
             (-0.00125372503, -0.0076224613),
             (-0.00417768164, 0.00943887047),
             (0.246640727, 1.00167406),
             (1.50140941, 2.83297682))
#: XLA's ErfInv64: w < 6.25 (23), w < 16 (19) and w ≥ 16 (17) coefficients
_ERFINV64_A = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_B = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_C = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``ErfInv`` in the tensor's dtype (f32 or f64)."""
    lp = xla_log1p(x * -x)
    w = -lp
    full = torch.full_like
    if x.dtype == torch.float32:
        lt = w < 5.0
        ww = torch.where(lt, -2.5 - lp, torch.sqrt(w) - 3.0)
        p = torch.where(lt, full(x, _ERFINV32[0][0]), full(x, _ERFINV32[0][1]))
        for a, b in _ERFINV32[1:]:
            p = _fma(p, ww, torch.where(lt, full(x, a), full(x, b)))
    else:
        lt6, lt16 = w < 6.25, w < 16.0

        def coef(i):
            c = full(x, _ERFINV64_A[i])
            if i < 19:
                c = torch.where(lt6, c, full(x, _ERFINV64_B[i]))
            if i < 17:
                c = torch.where(lt16, c, full(x, _ERFINV64_C[i]))
            return c
        ww = torch.where(lt6, -3.125 - lp, torch.sqrt(w) - torch.where(
            lt16, full(x, 3.25), full(x, 5.0)))
        p = coef(0)
        for i in range(1, 17):
            p = _fma(p, ww, coef(i))
        for i in range(17, 19):
            p = torch.where(lt16, _fma(p, ww, coef(i)), p)
        for i in range(19, 23):
            p = torch.where(lt6, _fma(p, ww, coef(i)), p)
    p = torch.where(x.abs() == 1.0, full(x, float("inf")), p)
    return x * p


def normal(key: np.ndarray, shape, dtype=np.float32) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)`` bit for bit (host):
    √2 · erfinv(u), u uniform on (nextafter(−1, 0), 1)."""
    dtype = np.dtype(dtype)
    shape = tuple(int(s) for s in shape)
    lo = np.nextafter(dtype.type(-1), dtype.type(0))
    u = np.maximum(lo, uniform(key, shape, dtype) * (dtype.type(1) - lo)
                   + lo)
    e = xla_erfinv(torch.from_numpy(np.ascontiguousarray(u)))
    return (e * float(dtype.type(np.sqrt(2)))).numpy().astype(dtype)


#: rows whose two best Gumbel-perturbed logits lie closer than this are
#: drawn again with XLA's own ``log``; wider than any difference between
#: ``torch.log`` and XLA's twice-applied f32 ``log`` (a few ulp of values
#: below 90, ~1e-5 at most)
CATEGORICAL_MARGIN = 1e-3


def _gumbel_uniform(key: np.ndarray, flat: torch.Tensor) -> torch.Tensor:
    """The uniforms of ``jax.random.gumbel``'s draw at flat counters
    ``flat`` (f32 on [tiny, 1))."""
    keys = torch.as_tensor(np.asarray(key, np.uint32).astype(np.int64),
                           device=flat.device)
    b1, b2 = threefry2x32_torch(keys[0], keys[1], flat >> 32, flat & _M32)
    bits = (((b1 ^ b2) >> 9) | 0x3F800000).to(torch.int32)
    del b1, b2
    tiny = float(np.finfo(np.float32).tiny)
    return torch.clamp((bits.view(torch.float32) - 1.0) + tiny, min=tiny)


def categorical(key: np.ndarray, logits: torch.Tensor, shape,
                start: int = 0, stop: Optional[int] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=shape)`` for a 1-D f32
    ``logits`` [V]: the argmax over V of logits + Gumbel noise, the noise
    of shape ``shape + (V,)``. Only rows ``start:stop`` of the flattened
    leading shape are drawn (a row's counters are its flat indices, so a
    large sample is drawn in chunks with the same bits); the draw runs on
    ``logits``' device and returns int64 indices [stop − start].

    The noise is −log(−log(u)) with ``torch.log``; a row whose best two
    candidates lie within ``CATEGORICAL_MARGIN`` is drawn again with
    XLA's ``log`` (:func:`xla_log_f32`), so every argmax is the one
    XLA's noise gives, at a fraction of the exact path's cost."""
    V = int(logits.shape[0])
    stop = math.prod(int(s) for s in shape) if stop is None else stop
    rows = stop - start
    flat = torch.arange(start * V, stop * V, dtype=torch.int64,
                        device=logits.device)
    u = _gumbel_uniform(key, flat).reshape(rows, V)
    del flat
    vals = -torch.log(-torch.log(u)) + logits
    out = torch.argmax(vals, dim=1)
    if V > 1:
        top = torch.topk(vals, 2, dim=1).values
        near = torch.nonzero(top[:, 0] - top[:, 1] < CATEGORICAL_MARGIN)[:, 0]
        if near.numel():
            g = -xla_log_f32(-xla_log_f32(u[near]))
            out[near] = torch.argmax(g + logits, dim=1)
    return out
