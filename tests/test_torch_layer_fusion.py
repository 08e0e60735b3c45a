"""The port's fused layer transform (``workflow.apply_layer``: a layer's
vectorizers as one device program with one upload and one pull) on the
CPU: bitwise equal to the per-model path and to the JAX package's vectors
on the same store (one feature of every type through ``transmogrify``),
one upload and one pull a layer where the per-model path makes one a
block and one a model, every stage timed, and the gate (the card, from
``FUSE_MIN_ROWS`` rows)."""
import os
import sys

import numpy as np
import pytest
import torch

from transmogrifai_tpu.types import feature_types as JFT
import transmogrifai_tpu_torch.workflow as PW
from transmogrifai_tpu_torch.ops.vectorizer_base import VectorizerModel

sys.path.insert(0, os.path.dirname(__file__))
import _torch_typed_data as TD  # noqa: E402

N = 300
TYPES = sorted(n for n in JFT.FEATURE_TYPE_REGISTRY
               if n not in ("Prediction", "OPVector"))


@pytest.fixture(scope="module")
def trained():
    """Every type through one ``transmogrify`` in both packages (f64, the
    port on the CPU): ((JAX model, feature, vector), (port model,
    feature, vector), the port's store)."""
    rng = np.random.default_rng(7)
    cols = {f"f_{t}": (t, TD.typed_values(t, N, rng)) for t in TYPES}
    jstore, pstore = TD.stores(cols)
    (jm, jf, jc), (pm, pf, pc) = TD.run_both(
        lambda pkg: pkg.dsl.transmogrify(
            [TD.raw_feature(pkg, t, f"f_{t}") for t in TYPES]),
        jstore, pstore)
    return (jm, jf, jc), (pm, pf, pc), pstore


def _device_math(layer):
    return [m for m in layer
            if isinstance(m, VectorizerModel) and m.device_math]


def _layers(pm, store):
    """Each layer of the port's model with the store it reads."""
    out = []
    for layer in pm._resolved_dag():
        out.append((layer, store))
        store = PW.apply_layer(layer, store, "cpu", fuse=False)
    return out


def test_fused_equals_the_per_model_path_bitwise(trained):
    _j, (pm, _pf, _pc), store = trained
    fused_layers = 0
    for layer, src in _layers(pm, store):
        info = {}
        fused = PW.apply_layer(layer, src, "cpu", fuse=True, info=info)
        plain = PW.apply_layer(layer, src, "cpu", fuse=False)
        fused_layers += bool(info)
        assert bool(info) == bool(_device_math(layer))
        for m in layer:
            a, b = fused[m.output_name], plain[m.output_name]
            assert type(a) is type(b)
            if hasattr(b, "metadata"):
                assert a.values.dtype == b.values.dtype
                assert a.values.flags.c_contiguous
                assert [c.to_json() for c in a.metadata.columns] == \
                    [c.to_json() for c in b.metadata.columns]
            np.testing.assert_array_equal(a.values, b.values)
    assert fused_layers >= 1


def test_fused_vectors_equal_the_jax_packages(trained):
    """The fused transform of the whole DAG against the JAX package's
    vector on the same store."""
    (_jm, _jf, jc), (pm, pf, _pc), store = trained
    for layer in pm._resolved_dag():
        store = PW.apply_layer(layer, store, "cpu", fuse=True)
    TD.assert_same_vector(jc, store[pf.name])


class _TransferSpy:
    """Counts the tensor copies that cross a device boundary: ``to`` with
    a device, and ``copy_``."""

    def __init__(self, monkeypatch):
        self.to = self.copy = 0
        to, copy_ = torch.Tensor.to, torch.Tensor.copy_
        spy = self

        def counted_to(t, *args, **kw):
            if "device" in kw or any(isinstance(a, (str, torch.device))
                                     for a in args):
                spy.to += 1
            return to(t, *args, **kw)

        def counted_copy(t, *args, **kw):
            spy.copy += 1
            return copy_(t, *args, **kw)
        monkeypatch.setattr(torch.Tensor, "to", counted_to)
        monkeypatch.setattr(torch.Tensor, "copy_", counted_copy)


def test_one_upload_and_one_pull_a_layer(trained, monkeypatch):
    """A layer's device-math vectorizers move their blocks with one copy
    each way fused, and with one a block and one a model on the per-model
    path (the host models, one-hot and hashing, move nothing either
    way)."""
    _j, (pm, _pf, _pc), store = trained
    layers = [(_device_math(layer), src)
              for layer, src in _layers(pm, store) if _device_math(layer)]
    for vecs, src in layers:              # the fitted tables, once
        PW.apply_layer(vecs, src, "cpu", fuse=True)
    spy = _TransferSpy(monkeypatch)
    for vecs, src in layers:
        spy.to = spy.copy = 0
        PW.apply_layer(vecs, src, "cpu", fuse=True)
        assert (spy.to, spy.copy) == (1, 1)
        blocks = sum(len(m.host_prepare(src)) for m in vecs)
        spy.to = spy.copy = 0
        PW.apply_layer(vecs, src, "cpu", fuse=False)
        assert (spy.to, spy.copy) == (blocks + len(vecs), 0)
        assert blocks > 2


def test_every_stage_is_timed(trained):
    """Each model gets its seconds: a fused one its ``host_prepare`` and
    a share of the device program, the others their transform."""
    _j, (pm, _pf, _pc), store = trained
    for layer, src in _layers(pm, store):
        seconds, info = {}, {}
        PW.apply_layer(layer, src, "cpu", seconds, fuse=True, info=info)
        assert sorted(seconds) == sorted(m.uid for m in layer)
        assert all(s >= 0.0 for s in seconds.values())
        if info:
            assert (info["uploads"], info["pulls"]) == (1, 1)
            assert info["vectorizers"] == len(_device_math(layer))


def test_the_gate_fuses_on_the_card_from_the_row_floor(trained,
                                                       monkeypatch):
    """Unforced, the fused program runs only on the card and only from
    ``FUSE_MIN_ROWS`` rows; on the CPU the per-model path runs at any
    size."""
    _j, (pm, _pf, _pc), store = trained
    layer, src = next((l, s) for l, s in _layers(pm, store)
                      if _device_math(l))
    calls = []
    real = PW._fused_vectors

    def spy(*args, **kw):
        calls.append(args[2])
        return real(*args, **kw)
    monkeypatch.setattr(PW, "_fused_vectors", spy)
    monkeypatch.setattr(PW, "FUSE_MIN_ROWS", 1)
    PW.apply_layer(layer, src, "cpu")
    assert calls == []
    if torch.cuda.is_available():
        PW.apply_layer(layer, src, "cuda")
        monkeypatch.setattr(PW, "FUSE_MIN_ROWS", N + 1)
        PW.apply_layer(layer, src, "cuda")
        assert [d.type for d in calls] == ["cuda"]


@pytest.mark.cuda
def test_fused_on_the_card_equals_the_per_model_path(trained):
    """On the card: the fused program's vectors bitwise equal to the
    per-model path's there, and to the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA GPU present: the fused program runs on the "
                    "card")
    _j, (pm, _pf, _pc), store = trained
    for layer, src in _layers(pm, store):
        fused = PW.apply_layer(layer, src, "cuda", fuse=True)
        plain = PW.apply_layer(layer, src, "cuda", fuse=False)
        cpu = PW.apply_layer(layer, src, "cpu", fuse=False)
        for m in layer:
            np.testing.assert_array_equal(fused[m.output_name].values,
                                          plain[m.output_name].values)
            np.testing.assert_array_equal(fused[m.output_name].values,
                                          cpu[m.output_name].values)
