"""The port's testkit (``transmogrifai_tpu_torch/testkit``) against the JAX
package's: every generator's stream equal for the same seed, with and
without a probability of empty, and the columns made from them holding
the same values."""
import numpy as np
import pytest

from transmogrifai_tpu.testkit import RandomData as JRD
from transmogrifai_tpu.types import feature_types as jft
from transmogrifai_tpu_torch.testkit import RandomData as PRD
from transmogrifai_tpu_torch.types import feature_types as pft

#: factory → (arguments, feature type of its column)
FACTORIES = {
    "reals": ((), "Real"), "integrals": ((0, 7), "Integral"),
    "binaries": ((0.3,), "Binary"), "texts": ((4,), "Text"),
    "unique_texts": ((6,), "Text"), "picklists": ((), "PickList"),
    "text_lists": ((), "TextList"), "multi_picklists": ((), "MultiPickList"),
    "real_maps": ((), "RealMap"), "text_maps": ((), "TextMap"),
    "geolocations": ((), "Geolocation"), "dates": ((), "Date"),
    "date_lists": ((), "DateList"), "vectors": ((3,), None),
}


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b and type(a) is type(b)


@pytest.mark.parametrize("name", sorted(FACTORIES))
@pytest.mark.parametrize("p_empty", [0.0, 0.25])
def test_streams_equal_the_jax_testkits(name, p_empty):
    args, _ftype = FACTORIES[name]
    want = getattr(JRD, name)(*args).with_prob_empty(p_empty).take(40,
                                                                    seed=7)
    got = getattr(PRD, name)(*args).with_prob_empty(p_empty).take(40,
                                                                  seed=7)
    assert len(got) == len(want) == 40
    assert all(_same(g, w) for g, w in zip(got, want)), name
    if p_empty:
        assert any(v is None for v in got)


@pytest.mark.parametrize("name", sorted(k for k, (_a, t) in FACTORIES.items()
                                        if t is not None))
def test_columns_hold_the_jax_columns_values(name):
    args, ftype = FACTORIES[name]
    gen = getattr(PRD, name)(*args).with_prob_empty(0.2)
    jgen = getattr(JRD, name)(*args).with_prob_empty(0.2)
    col = gen.column(getattr(pft, ftype), 25, seed=3)
    jcol = jgen.column(getattr(jft, ftype), 25, seed=3)
    assert len(col) == len(jcol) == 25
    for i in range(25):
        got, want = col.get_raw(i), jcol.get_raw(i)
        assert _same(got, want) or (got == want), (name, i, got, want)
