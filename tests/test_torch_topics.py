"""LDA and Word2Vec in the port against the JAX package on the CPU, f64.

Tolerances: LDA's vocabulary exact, β within 1e-9 (observed ~1e-16) and
the inferred θ within 1e-9; Word2Vec's vocabulary and pairs exact, its
negatives bitwise (``random.categorical``), its vectors within 1e-12 and
its transform within 1e-12 of the JAX package's (the gradient summed over
chunks with ``index_add_`` instead of XLA's scatter of the whole batch);
the chunked gradient (a few pairs a chunk) within 1e-12 of the unchunked
one. Fitted states carried over and saves loaded both ways transform
alike (within 1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transmogrifai_tpu import FeatureBuilder as JFB
from transmogrifai_tpu import Workflow as JWorkflow
from transmogrifai_tpu.columns import ColumnStore as JStore
from transmogrifai_tpu.ops import topics as JT
from transmogrifai_tpu.types import feature_types as JFT
from transmogrifai_tpu.utils import uid as juid
from transmogrifai_tpu.workflow import WorkflowModel as JWorkflowModel
from transmogrifai_tpu_torch import FeatureBuilder as PFB
from transmogrifai_tpu_torch import Workflow as PWorkflow
from transmogrifai_tpu_torch import WorkflowModel as PWorkflowModel
from transmogrifai_tpu_torch import random as R
from transmogrifai_tpu_torch.carry_over import fitted_stage_from_state
from transmogrifai_tpu_torch.columns import ColumnStore as PStore
from transmogrifai_tpu_torch.ops import topics as PT
from transmogrifai_tpu_torch.types import feature_types as PFT
from transmogrifai_tpu_torch.utils import uid as puid

F64 = dict(device="cpu", dtype=torch.float64)


def _docs(n=300, seed=0):
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(40)]
    return [[words[min(39, int(rng.exponential(8)))]
             for _ in range(rng.integers(0, 12))] for _ in range(n)]


def _fit(kind, docs, **kw):
    """(JAX model, JAX θ/vectors block, port model, port block)."""
    out = []
    for FB, W, Store, FT, uid, mod, train_kw in (
            (JFB, JWorkflow, JStore, JFT, juid, JT, {}),
            (PFB, PWorkflow, PStore, PFT, puid, PT, F64)):
        uid.reset()
        store = Store.from_dict({"t": (FT.TextList, docs)})
        t = FB.TextList("t").from_column().as_predictor()
        f = t.lda(**kw) if kind == "lda" else t.word2vec(**kw)
        model = W().set_input_store(store).set_result_features(f).train(
            **train_kw)
        block = model.transform(store, **({"device": "cpu", "engine": False}
                                          if train_kw else {}))[f.name]
        out += [model.fitted_stages[f.origin_stage.uid], block, model,
                store, f]
    return out


def test_lda_matches_jax():
    jm, jb, _, _, _, pm, pb, _, _, _ = _fit("lda", _docs(), n_topics=4)
    assert pm.vocab == jm.vocab
    np.testing.assert_allclose(pm.beta, jm.beta, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.asarray(pb.values), np.asarray(jb.values),
                               rtol=0, atol=1e-9)


def test_word2vec_negatives_bitwise():
    docs = _docs(seed=1)
    est = PT.OpWord2Vec(dim=8, epochs=3)
    vocab, counts, _rng, cen, _ctx = est.pairs(docs)
    uni = np.array([counts[t] for t in vocab], dtype=np.float64) ** 0.75
    logits = np.log(uni / uni.sum()).astype(np.float32)
    for e in range(3):
        ref = np.asarray(jax.random.categorical(
            jax.random.fold_in(jax.random.PRNGKey(42), e),
            jnp.asarray(logits), shape=(len(cen), 5))).reshape(-1)
        got = R.categorical(R.fold_in(R.PRNGKey(42), e),
                            torch.from_numpy(logits), (len(cen), 5))
        assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("chunk_bytes", [1 << 30, 20_000])
def test_word2vec_matches_jax(chunk_bytes, monkeypatch):
    """Whole (one chunk) and chunked (a few dozen pairs a chunk)."""
    monkeypatch.setattr(PT, "W2V_CHUNK_BYTES", chunk_bytes)
    jm, jb, _, _, _, pm, pb, _, _, _ = _fit("w2v", _docs(seed=2), dim=8,
                                            epochs=6)
    assert pm.vocab == jm.vocab
    np.testing.assert_allclose(pm.vectors, jm.vectors, rtol=0, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pb.values), np.asarray(jb.values),
                               rtol=0, atol=1e-12)


def test_chunked_gradient_equals_whole():
    torch.manual_seed(0)
    P, V, D, S = 500, 30, 6, 5
    cen, ctx = torch.randint(0, V, (P,)), torch.randint(0, V, (P,))
    W, C = torch.randn(V, D, dtype=torch.float64), torch.randn(
        V, D, dtype=torch.float64)
    logits = torch.log_softmax(torch.randn(V), 0).float()
    whole = PT.w2v_train(cen, ctx, W, C, logits, R.PRNGKey(1), 4, S, 0.5, P)
    stats = {}
    parts = PT.w2v_train(cen, ctx, W, C, logits, R.PRNGKey(1), 4, S, 0.5, 37,
                         stats=stats)
    assert stats["chunks_per_epoch"] == 14
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0,
                               atol=1e-12)
    assert PT.w2v_chunk_pairs(5, 100, 76, 4, 1 << 30) > 10_000


@pytest.mark.parametrize("kind", ["lda", "w2v"])
def test_saves_both_ways_and_carry_over(kind, tmp_path):
    kw = {"n_topics": 3} if kind == "lda" else {"dim": 6, "epochs": 3}
    jm, jb, jmodel, jstore, jf, pm, pb, pmodel, pstore, pf = _fit(
        kind, _docs(seed=4), **kw)
    jmodel.save(str(tmp_path / "j"))
    got = PWorkflowModel.load(str(tmp_path / "j")).transform(
        pstore, device="cpu", engine=False)[jf.name]
    np.testing.assert_allclose(np.asarray(got.values), np.asarray(jb.values),
                               rtol=0, atol=1e-12)
    pmodel.save(str(tmp_path / "p"))
    back = JWorkflowModel.load(str(tmp_path / "p")).transform(jstore)[
        pf.name]
    np.testing.assert_allclose(np.asarray(back.values),
                               np.asarray(pb.values), rtol=0, atol=1e-12)
    stage = fitted_stage_from_state(type(jm).__name__, jm.get_model_state(),
                                    jm.get_params())
    stage.input_features = pm.input_features
    stage._output_feature = pm._output_feature
    out = stage.transform_columns(
        pstore, **({"device": "cpu"} if kind == "lda" else {}))
    np.testing.assert_allclose(np.asarray(out.values), np.asarray(jb.values),
                               rtol=0, atol=1e-12)
