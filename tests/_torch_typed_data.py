"""Seeded raw values of every feature type, and one DAG run through both
packages, for the port's vectorizer tests (``test_torch_maps.py``,
``test_torch_more_vectorizers.py``)."""
import numpy as np
import torch

import transmogrifai_tpu as J
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
import transmogrifai_tpu_torch as P
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import uid as puid

KEYS = ("k0", "k1", "k2", "k3")
CATS = ("red", "green", "blue", "teal", "plum")
#: 2020-01-01 in epoch milliseconds
EPOCH_2020_MS = 1_577_836_800_000


def _elem(ft, kind, rng):
    """One present value of element kind ``kind`` (type ``ft``)."""
    K = JFT.ColumnKind
    if kind is K.REAL:
        return float(np.round(rng.normal() * 10.0, 3))
    if kind is K.INTEGRAL:
        if issubclass(ft, JFT.Date):
            return EPOCH_2020_MS + int(rng.integers(0, 400 * 86_400_000))
        return int(rng.integers(0, 5))
    if kind is K.BINARY:
        return bool(rng.random() < 0.5)
    if kind is K.TEXT:
        if issubclass(ft, (JFT.Text,)) and ft.__name__ in (
                "Text", "TextArea", "Base64", "Email", "URL", "Phone"):
            # free text: past the smart vectorizer's cardinality cap
            return f"tok{rng.integers(0, 400)} word{rng.integers(0, 6)}"
        return str(rng.choice(CATS))
    if kind is K.TEXT_LIST:
        return [str(rng.choice(CATS)) for _ in range(int(rng.integers(0, 4)))]
    if kind is K.TEXT_SET:
        return {str(rng.choice(CATS)) for _ in range(int(rng.integers(0, 3)))}
    if kind is K.GEO:
        return [float(np.round(rng.uniform(-60, 60), 4)),
                float(np.round(rng.uniform(-170, 170), 4)),
                float(rng.integers(1, 10))]
    if kind is K.INTEGRAL_LIST:
        return [EPOCH_2020_MS + int(rng.integers(0, 400 * 86_400_000))
                for _ in range(int(rng.integers(0, 4)))]
    if kind is K.VECTOR:
        return np.round(rng.normal(size=3), 3)
    raise AssertionError(kind)


def typed_values(type_name: str, n: int, rng, null_share: float = 0.15):
    """``n`` raw values of the JAX feature type ``type_name``: about
    ``null_share`` missing (none for RealNN); maps hold a random subset of
    :data:`KEYS`."""
    ft = JFT.FEATURE_TYPE_REGISTRY[type_name]
    kind = ft.column_kind
    out = []
    for _ in range(n):
        if kind is JFT.ColumnKind.MAP:
            out.append({k: _elem(ft.element_type, ft.map_element_kind, rng)
                        for k in KEYS if rng.random() > 0.3})
        elif (rng.random() < null_share and type_name != "RealNN"
              and kind is not JFT.ColumnKind.VECTOR):
            out.append(None)
        else:
            out.append(_elem(ft, kind, rng))
    return out


def stores(columns):
    """{name: (type name, values)} → (JAX store, port store)."""
    return (J.ColumnStore.from_dict(
        {n: (JFT.FEATURE_TYPE_REGISTRY[t], v)
         for n, (t, v) in columns.items()}),
        P.ColumnStore.from_dict(
        {n: (PFT.feature_type_by_name(t), v)
         for n, (t, v) in columns.items()}))


def raw_feature(pkg, type_name: str, name: str, response: bool = False):
    b = getattr(pkg.FeatureBuilder, type_name)(name).from_column()
    return b.as_response() if response else b.as_predictor()


def run_both(build, jstore, pstore, dtype=torch.float64):
    """``build(pkg)`` → a result feature, built in each package from fresh
    uid counters and trained on its store (the port on the CPU).
    Returns ((JAX model, feature, column), (port model, feature,
    column))."""
    out = []
    for pkg, store, uid_mod in ((J, jstore, juid), (P, pstore, puid)):
        uid_mod.reset()
        f = build(pkg)
        wf = pkg.Workflow().set_input_store(store).set_result_features(f)
        if pkg is J:
            model = wf.train()
            col = model.transform(store, engine=False)[f.name]
        else:
            model = wf.train(device="cpu", dtype=dtype)
            col = model.transform(store, device="cpu", engine=False)[f.name]
        out.append((model, f, col))
    return out


def assert_same_vector(jc, pc):
    """Exact values, dtype and metadata (None where a raw vector without
    metadata joined the combination, in both)."""
    assert pc.values.dtype == np.asarray(jc.values).dtype
    np.testing.assert_array_equal(pc.values, jc.values)
    if jc.metadata is None:
        assert pc.metadata is None
        return
    assert [c.to_json() for c in pc.metadata.columns] == \
        [c.to_json() for c in jc.metadata.columns]
