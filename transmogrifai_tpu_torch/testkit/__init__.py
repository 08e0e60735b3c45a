"""Testkit — deterministic random typed-data generators; the port of
``transmogrifai_tpu/testkit``: the same streams for the same seed, made
into this package's columns.

Parity: the reference publishes a ``testkit`` module of random feature-type
generators (``testkit/src/main/scala/com/salesforce/op/testkit/RandomText.scala:1``,
``RandomReal``, ``RandomList``, ``RandomMap``, …) with a
``ProbabilityOfEmpty`` knob and deterministic streams, used by vectorizer
and checker tests. This is the columnar analog: every generator yields raw
Python values (``None`` = missing) and can materialize a
:class:`~transmogrifai_tpu_torch.columns.Column` directly.

Usage::

    col = RandomData.reals(mean=1.0).with_prob_empty(0.2).column(Real, 100)
    vals = RandomData.texts().take(50, seed=7)
"""
from __future__ import annotations

import string
from dataclasses import dataclass, replace
from typing import Any, Callable, List, Sequence, Type

import numpy as np

from ..columns import Column, column_from_values
from ..types.feature_types import FeatureType

__all__ = ["RandomData"]

_WORDS = ("alpha bravo charlie delta echo foxtrot golf hotel india juliet "
          "kilo lima mike november oscar papa quebec romeo sierra tango "
          "uniform victor whiskey xray yankee zulu").split()


@dataclass
class RandomData:
    """A sampler of one value kind with a probability of empty."""

    sampler: Callable[[np.random.Generator], Any]
    probability_of_empty: float = 0.0

    # -- stream ------------------------------------------------------------
    def with_prob_empty(self, p: float) -> "RandomData":
        return replace(self, probability_of_empty=p)

    def take(self, n: int, seed: int = 42) -> List[Any]:
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            if (self.probability_of_empty > 0
                    and rng.random() < self.probability_of_empty):
                out.append(None)
            else:
                out.append(self.sampler(rng))
        return out

    def column(self, ftype: Type[FeatureType], n: int,
               seed: int = 42) -> Column:
        return column_from_values(ftype, self.take(n, seed))

    # -- factories (RandomReal / RandomText / … analogs) -------------------
    @staticmethod
    def reals(mean: float = 0.0, sigma: float = 1.0) -> "RandomData":
        return RandomData(lambda r: float(r.normal(mean, sigma)))

    @staticmethod
    def integrals(low: int = 0, high: int = 100) -> "RandomData":
        return RandomData(lambda r: int(r.integers(low, high)))

    @staticmethod
    def binaries(p: float = 0.5) -> "RandomData":
        return RandomData(lambda r: bool(r.random() < p))

    @staticmethod
    def texts(n_words: int = 3, vocab: Sequence[str] = _WORDS) -> "RandomData":
        return RandomData(lambda r: " ".join(
            r.choice(vocab) for _ in range(max(1, int(r.integers(
                1, n_words + 1))))))

    @staticmethod
    def unique_texts(length: int = 8) -> "RandomData":
        chars = np.array(list(string.ascii_lowercase))
        return RandomData(lambda r: "".join(r.choice(chars, length)))

    @staticmethod
    def picklists(domain: Sequence[str] = ("red", "green", "blue", "teal")
                  ) -> "RandomData":
        return RandomData(lambda r: str(r.choice(list(domain))))

    @staticmethod
    def text_lists(max_len: int = 4, vocab: Sequence[str] = _WORDS
                   ) -> "RandomData":
        return RandomData(lambda r: [str(r.choice(vocab)) for _ in
                                     range(int(r.integers(0, max_len + 1)))])

    @staticmethod
    def multi_picklists(domain: Sequence[str] = ("a", "b", "c", "d"),
                        max_len: int = 3) -> "RandomData":
        return RandomData(lambda r: {
            str(v) for v in r.choice(list(domain),
                                     int(r.integers(0, max_len + 1)),
                                     replace=False)})

    @staticmethod
    def real_maps(keys: Sequence[str] = ("k1", "k2", "k3")) -> "RandomData":
        def sample(r):
            return {k: float(r.normal()) for k in keys
                    if r.random() < 0.8}
        return RandomData(sample)

    @staticmethod
    def text_maps(keys: Sequence[str] = ("k1", "k2"),
                  domain: Sequence[str] = ("x", "y", "z")) -> "RandomData":
        def sample(r):
            return {k: str(r.choice(list(domain))) for k in keys
                    if r.random() < 0.8}
        return RandomData(sample)

    @staticmethod
    def geolocations() -> "RandomData":
        return RandomData(lambda r: (float(r.uniform(-90, 90)),
                                     float(r.uniform(-180, 180)), 5.0))

    @staticmethod
    def dates(start_ms: int = 1_400_000_000_000,
              span_ms: int = 200_000_000_000) -> "RandomData":
        return RandomData(lambda r: int(start_ms + r.integers(0, span_ms)))

    @staticmethod
    def date_lists(max_len: int = 3,
                   start_ms: int = 1_400_000_000_000) -> "RandomData":
        return RandomData(lambda r: [
            int(start_ms + r.integers(0, 100_000_000_000))
            for _ in range(int(r.integers(0, max_len + 1)))])

    @staticmethod
    def vectors(dim: int = 4) -> "RandomData":
        return RandomData(lambda r: r.normal(size=dim))
