"""The port's monoid aggregators (``transmogrifai_tpu_torch/utils/
aggregators.py``) against the JAX package's: every monoid's fold on the
same seeded values, bit for bit, and ``aggregator_of`` for every feature
type of the registry."""
import math

import numpy as np
import pytest

from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu.utils import aggregators as JA
from transmogrifai_tpu_torch.types import feature_types as pft
from transmogrifai_tpu_torch.utils import aggregators as PA


def same(a, b):
    """Equal in type and value, floats bit for bit (NaN equal to NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
                and a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return (math.isnan(a) and math.isnan(b)) or \
            np.float64(a).tobytes() == np.float64(b).tobytes()
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    return a == b


def _holes(rng, vals, p=0.2):
    """``vals`` with about ``p`` of them replaced by None."""
    return [None if rng.random() < p else v for v in vals]


def _floats(rng, n=40):
    return _holes(rng, [float(x) for x in rng.gamma(2.0, 10.0, n)])


def _words(rng, n=40):
    return _holes(rng, [f"w{int(x)}" for x in rng.integers(0, 4, n)])


def _geo(rng, n=12):
    return _holes(rng, [(float(rng.uniform(-80, 80)),
                         float(rng.uniform(-170, 170)),
                         float(rng.integers(1, 6))) for _ in range(n)])


def _maps(rng, value, n=12):
    return _holes(rng, [{k: value(rng) for k in ("a", "b", "c")
                         if rng.random() < 0.7} for _ in range(n)])


CASES = {
    "sum": ("SumAggregator", (), _floats),
    "sum_ints": ("SumAggregator", (),
                 lambda r: [int(x) for x in r.integers(0, 9, 30)]),
    "mean": ("MeanAggregator", (), _floats),
    "max": ("MaxAggregator", (), _floats),
    "min": ("MinAggregator", (), _floats),
    "or": ("LogicalOrAggregator", (),
           lambda r: _holes(r, [bool(x) for x in r.random(30) < 0.1])),
    "or_all_false": ("LogicalOrAggregator", (), lambda r: [False] * 5),
    "mode": ("ModeAggregator", (), _words),
    "mode_tie": ("ModeAggregator", (), lambda r: ["b", "a", "b", "a"]),
    "concat_text": ("ConcatTextAggregator", (), _words),
    "concat_text_sep": ("ConcatTextAggregator", ("|",), _words),
    "concat_list": ("ConcatListAggregator", (),
                    lambda r: _holes(r, [[f"t{int(x)}" for x in
                                          r.integers(0, 5, 3)]
                                         for _ in range(10)])),
    "union_set": ("UnionSetAggregator", (),
                  lambda r: _holes(r, [{f"s{int(x)}" for x in
                                        r.integers(0, 6, 2)}
                                       for _ in range(10)])),
    "combine_vector": ("CombineVectorAggregator", (),
                       lambda r: [r.normal(size=5) for _ in range(9)]),
    "geo_midpoint": ("GeolocationMidpointAggregator", (), _geo),
    "union_map_sum": ("UnionMapAggregator", (),
                      lambda r: _maps(r, lambda q: float(q.normal()))),
    "first": ("FirstAggregator", (), _floats),
    "last": ("LastAggregator", (), _floats),
    "empty": ("SumAggregator", (), lambda r: [None, None]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fold_equals_the_jax_packages(case):
    name, args, values = CASES[case]
    vals = values(np.random.default_rng(sorted(CASES).index(case)))
    want = getattr(JA, name)(*args).fold(vals)
    got = getattr(PA, name)(*args).fold(vals)
    assert same(got, want), (case, got, want)


MAP_VALUES = {
    "text": ("ConcatTextAggregator", _words),
    "max": ("MaxAggregator", _floats),
    "mean": ("MeanAggregator", _floats),
    "or": ("LogicalOrAggregator",
           lambda r: [bool(x) for x in r.random(12) < 0.3]),
    "geo": ("GeolocationMidpointAggregator", _geo),
    "set": ("UnionSetAggregator",
            lambda r: [{f"s{int(x)}"} for x in r.integers(0, 4, 12)]),
}


@pytest.mark.parametrize("kind", sorted(MAP_VALUES))
def test_union_map_folds_each_value_type_alike(kind):
    """The per-key union under each value monoid the defaults use."""
    name, values = MAP_VALUES[kind]
    rng = np.random.default_rng(5)
    pool = [v for v in values(rng) if v is not None]
    maps = [{k: pool[int(rng.integers(0, len(pool)))]
             for k in ("x", "y") if rng.random() < 0.8} for _ in range(10)]
    want = JA.UnionMapAggregator(getattr(JA, name)()).fold(maps)
    got = PA.UnionMapAggregator(getattr(PA, name)()).fold(maps)
    assert same(got, want), kind


def _describe(agg):
    inner = getattr(agg, "value_agg", None)
    return (type(agg).__name__,
            None if inner is None else type(inner).__name__)


@pytest.mark.parametrize("type_name", sorted(pft.FEATURE_TYPE_REGISTRY))
def test_aggregator_of_every_feature_type(type_name):
    """The default monoid of each registered type, its map value monoid
    included, is the JAX package's."""
    assert type_name in jft.FEATURE_TYPE_REGISTRY
    want = JA.aggregator_of(jft.FEATURE_TYPE_REGISTRY[type_name])
    got = PA.aggregator_of(pft.FEATURE_TYPE_REGISTRY[type_name])
    assert _describe(got) == _describe(want)
