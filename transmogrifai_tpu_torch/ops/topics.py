"""Topic and embedding models — OpLDA and OpWord2Vec; the port of
``transmogrifai_tpu/ops/topics.py``.

* ``OpLDA`` (``core/.../impl/feature/OpLDA.scala``, Spark MLlib LDA over
  token-count vectors → per-document topic distribution): fitted by the
  JAX package's variational multiplicative EM — two dense products an
  iteration over the [n, V] count block — as a plain torch loop on the
  workflow's device; transform infers θ for a fixed β the same way.
* ``OpWord2Vec`` (``OpWord2Vec.scala``, Spark Word2Vec; transform is the
  mean of a document's token vectors): skip-gram with negative sampling.
  The (center, context) pairs are built on the host with the numpy RNG;
  each epoch is one full-batch gradient step, its negatives drawn by
  ``random.categorical`` (``jax.random.categorical``'s bits). The JAX
  package differentiates a loss that gathers ``C[negatives]`` as [P, S,
  D]; here the same loss's gradient is summed over chunks of pairs,
  taken in order, under ``W2V_CHUNK_BYTES``, with ``index_add_`` into W
  and C, so neither that gather nor the [P, S, V] Gumbel noise is ever
  whole. Only the summation order differs.

Fitted state is dense arrays (save / load through the npz path).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import random as R
from ..columns import Column, ColumnStore, VectorColumn
from ..models.base import resolve_device
from ..stages.base import (Estimator, FittedModel, FixedArity, InputSpec,
                           register_stage)
from ..types.feature_types import OPVector, TextList
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from ._hostvec import flatten_ragged

__all__ = ["OpLDA", "LDAModel", "OpWord2Vec", "Word2VecModel", "lda_em",
           "lda_infer", "w2v_train", "W2V_CHUNK_BYTES"]

#: bytes a Word2Vec gradient chunk may take: its [c, S, D] gather of
#: negative vectors and its [c·S, V] Gumbel noise with their temporaries
W2V_CHUNK_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# LDA
# ---------------------------------------------------------------------------

def lda_em(X: torch.Tensor, beta0: torch.Tensor, n_iter: int = 60,
           alpha: float = 1.1):
    """Variational multiplicative EM: X [n, V] counts, β [K, V] topics →
    (β, θ [n, K])."""
    n = X.shape[0]
    K = beta0.shape[0]
    beta = beta0
    theta = torch.full((n, K), 1.0 / K, dtype=X.dtype, device=X.device)
    for _ in range(n_iter):
        mix = theta @ beta                                   # [n, V]
        ratio = X / torch.clamp(mix, min=1e-12)
        del mix
        theta_new = torch.clamp(theta * (ratio @ beta.T) + (alpha - 1.0),
                                min=1e-12)
        theta_new = theta_new / theta_new.sum(dim=1, keepdim=True)
        beta_new = torch.clamp(beta * (theta.T @ ratio), min=1e-12)
        beta = beta_new / beta_new.sum(dim=1, keepdim=True)
        theta = theta_new
    return beta, theta


def lda_infer(X: torch.Tensor, beta: torch.Tensor, n_iter: int
              ) -> torch.Tensor:
    """Document-topic θ for a fixed β."""
    n = X.shape[0]
    K = beta.shape[0]
    theta = torch.full((n, K), 1.0 / K, dtype=X.dtype, device=X.device)
    for _ in range(n_iter):
        ratio = X / torch.clamp(theta @ beta, min=1e-12)
        th = torch.clamp(theta * (ratio @ beta.T), min=1e-12)
        theta = th / th.sum(dim=1, keepdim=True)
    return theta


def _count_block(values, vocab: Sequence[str]) -> np.ndarray:
    """[n, V] f64 token counts over ``vocab`` (out-of-vocabulary tokens
    dropped)."""
    index = {t: i for i, t in enumerate(vocab)}
    X = np.zeros((len(values), len(vocab)))
    flat, rows, _lengths = flatten_ragged(values)
    if flat:
        codes = np.fromiter((index.get(t, -1) for t in flat), np.int64,
                            count=len(flat))
        ok = codes >= 0
        np.add.at(X, (rows[ok], codes[ok]), 1.0)
    return X


@register_stage
class LDAModel(FittedModel):
    """Fitted topics: vocab + β [K, V]; transform infers θ per document
    on ``device`` in β's dtype."""

    operation_name = "lda"
    output_type = OPVector
    uses_device = True

    def __init__(self, vocab: Sequence[str] = (),
                 beta: Optional[np.ndarray] = None,
                 n_infer_iter: int = 30, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocab = list(vocab)
        self.beta = np.asarray(beta) if beta is not None else None
        self.n_infer_iter = n_infer_iter

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def _counts(self, col) -> np.ndarray:
        return _count_block(col.values, self.vocab)

    def transform_columns(self, store: ColumnStore, device=None) -> Column:
        col = store[self.input_features[0].name]
        K = self.beta.shape[0]
        if not self.vocab:
            theta = np.full((len(col), K), 1.0 / K)
        else:
            dev = resolve_device(device)
            beta = torch.as_tensor(np.array(self.beta), device=dev)
            X = torch.as_tensor(self._counts(col), dtype=beta.dtype,
                                device=dev)
            theta = lda_infer(X, beta, self.n_infer_iter).to(
                "cpu", torch.float64).numpy()
        meta = VectorMetadata(self.output_name, [
            VectorColumnMetadata(
                parent_feature_name=self.input_features[0].name,
                parent_feature_type="TextList",
                descriptor_value=f"topic_{k}") for k in range(K)])
        return VectorColumn(OPVector, theta, meta)

    def get_model_state(self) -> Dict[str, Any]:
        return {"vocab": self.vocab, "beta": self.beta}


@register_stage
class OpLDA(Estimator):
    """Estimator(TextList) → per-document topic distribution OPVector;
    EM on ``device`` in ``dtype``."""

    operation_name = "lda"
    output_type = OPVector
    uses_device = True

    def __init__(self, n_topics: int = 10, vocab_size: int = 1024,
                 n_iter: int = 60, seed: int = 42,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.n_topics = n_topics
        self.vocab_size = vocab_size
        self.n_iter = n_iter
        self.seed = seed

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def fit_columns(self, store: ColumnStore, device=None,
                    dtype: torch.dtype = torch.float32) -> LDAModel:
        col = store[self.input_features[0].name]
        df: Counter = Counter()
        for toks in col.values:
            df.update(toks)
        vocab = [t for t, _c in sorted(df.items(),
                                       key=lambda kv: (-kv[1], kv[0]))
                 [:self.vocab_size]]
        if not vocab:    # all-empty corpus: uniform-topic degenerate model
            return LDAModel(vocab=[], beta=np.zeros((self.n_topics, 0)))
        dev = resolve_device(device)
        X = torch.as_tensor(_count_block(col.values, vocab), dtype=dtype,
                            device=dev)
        rng = np.random.default_rng(self.seed)
        beta0 = rng.random((self.n_topics, len(vocab))) + 0.5
        beta0 /= beta0.sum(axis=1, keepdims=True)
        beta, _theta = lda_em(X, torch.as_tensor(beta0, dtype=dtype,
                                                 device=dev), self.n_iter)
        return LDAModel(vocab=vocab, beta=beta.to(
            "cpu", torch.float64).numpy())


# ---------------------------------------------------------------------------
# Word2Vec (skip-gram negative sampling)
# ---------------------------------------------------------------------------

def w2v_chunk_pairs(S: int, D: int, V: int, itemsize: int,
                    budget: int) -> int:
    """Pairs a gradient chunk may hold under ``budget`` bytes: its [c, S,
    D] negative vectors (with the product and update of that shape) and
    the [c·S, V] Gumbel draw (int64 counters and hash words, f64 fused
    multiply-add temporaries: ~64 bytes an element)."""
    per_pair = max(S * D * itemsize * 3, S * V * 64)
    return max(1, budget // per_pair)


def w2v_train(cen: torch.Tensor, ctx: torch.Tensor, W: torch.Tensor,
              C: torch.Tensor, neg_logits: torch.Tensor, key0: np.ndarray,
              epochs: int, S: int, lr: float, chunk: int,
              stats: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """``epochs`` full-batch gradient steps of the JAX package's loss
    −(mean log σ(w·c⁺) + mean log σ(−w·c⁻)), each summed over chunks of
    ``chunk`` pairs → (W + C) / 2."""
    P, D = cen.shape[0], W.shape[1]
    for e in range(epochs):
        key = R.fold_in(key0, e)
        gW = torch.zeros_like(W)
        gC = torch.zeros_like(C)
        for a in range(0, P, chunk):
            b = min(P, a + chunk)
            neg = R.categorical(key, neg_logits, (P, S), a * S,
                                b * S).reshape(b - a, S)
            ce, cx = cen[a:b], ctx[a:b]
            wv, cv = W[ce], C[cx]                           # [c, D]
            nv = C[neg]                                     # [c, S, D]
            pos = (wv * cv).sum(1)
            negs = torch.einsum("pd,psd->ps", wv, nv)
            gpos = -torch.sigmoid(-pos) / P                 # ∂/∂pos
            gneg = torch.sigmoid(negs) / (P * S)            # ∂/∂neg
            gW.index_add_(0, ce, gpos[:, None] * cv
                          + torch.einsum("ps,psd->pd", gneg, nv))
            gC.index_add_(0, cx, gpos[:, None] * wv)
            gC.index_add_(0, neg.reshape(-1),
                          (gneg[:, :, None] * wv[:, None, :]).reshape(-1, D))
            del nv, negs, neg
        W = W - lr * gW
        C = C - lr * gC
    if stats is not None:
        stats.update(pairs=P, chunk_pairs=min(chunk, P),
                     chunks_per_epoch=-(-P // chunk))
    return 0.5 * (W + C)


@register_stage
class Word2VecModel(FittedModel):
    """Fitted embeddings: vocab + vectors [V, D]; transform = mean of a
    document's token vectors (Spark Word2VecModel.transform semantics),
    on the host."""

    operation_name = "w2v"
    output_type = OPVector

    def __init__(self, vocab: Sequence[str] = (),
                 vectors: Optional[np.ndarray] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocab = list(vocab)
        self.vectors = np.asarray(vectors) if vectors is not None else None

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        index = {t: i for i, t in enumerate(self.vocab)}
        D = self.vectors.shape[1]
        n = len(col)
        out = np.zeros((n, D))
        flat, rows, _lengths = flatten_ragged(col.values)
        if flat:
            codes = np.fromiter((index.get(t, -1) for t in flat), np.int64,
                                count=len(flat))
            ok = codes >= 0
            rows, codes = rows[ok], codes[ok]
            np.add.at(out, rows, self.vectors[codes])
            cnt = np.bincount(rows, minlength=n)
            has = cnt > 0
            out[has] /= cnt[has, None]
        meta = VectorMetadata(self.output_name, [
            VectorColumnMetadata(
                parent_feature_name=self.input_features[0].name,
                parent_feature_type="TextList",
                descriptor_value=f"w2v_{d}") for d in range(D)])
        return VectorColumn(OPVector, out, meta)

    def get_model_state(self) -> Dict[str, Any]:
        return {"vocab": self.vocab, "vectors": self.vectors}


@register_stage
class OpWord2Vec(Estimator):
    """Estimator(TextList) → averaged skip-gram embeddings OPVector;
    trains on ``device`` in ``dtype``."""

    operation_name = "w2v"
    output_type = OPVector
    uses_device = True

    def __init__(self, dim: int = 100, window: int = 5, epochs: int = 100,
                 neg_samples: int = 5, lr: float = 0.5,
                 vocab_size: int = 65536, min_count: int = 5,
                 subsample_t: float = 1e-3,
                 seed: int = 42, uid: Optional[str] = None):
        # dim/window/min_count match Spark ml Word2Vec's defaults
        # (vectorSize=100, windowSize=5, minCount=5). One "epoch" is one
        # FULL-BATCH gradient step over every skip-gram pair, so the
        # defaults are GD-scale (many steps, large lr), not SGD-scale.
        super().__init__(uid=uid)
        self.dim = dim
        self.window = window
        self.epochs = epochs
        self.neg_samples = neg_samples
        self.lr = lr
        self.vocab_size = vocab_size
        self.min_count = min_count
        #: frequent-word subsampling threshold (word2vec's t; 0 disables):
        #: tokens with frequency f are kept with prob sqrt(t/f) (+ t/f)
        self.subsample_t = subsample_t
        self.seed = seed

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(TextList)

    def pairs(self, values):
        """(vocab, counts, rng, centers, contexts): the JAX package's host
        pass — vocabulary, subsampling draws and the skip-gram pairs."""
        counts: Counter = Counter()
        for toks in values:
            counts.update(toks)
        vocab = [t for t, c in sorted(counts.items(),
                                      key=lambda kv: (-kv[1], kv[0]))
                 if c >= self.min_count][:self.vocab_size]
        index = {t: i for i, t in enumerate(vocab)}
        V = len(vocab)
        rng = np.random.default_rng(self.seed)
        centers: List[int] = []
        contexts: List[int] = []
        if V == 0:
            return vocab, counts, rng, centers, contexts
        total_tokens = float(sum(counts[t] for t in vocab)) or 1.0
        keep_p = np.ones((V,))
        if self.subsample_t > 0:
            freq = np.array([counts[t] / total_tokens for t in vocab])
            with np.errstate(divide="ignore"):
                keep_p = np.minimum(
                    np.sqrt(self.subsample_t / freq)
                    + self.subsample_t / freq, 1.0)
        for toks in values:
            ids = [index[t] for t in toks if t in index]
            if self.subsample_t > 0 and ids:
                kept = rng.random(len(ids)) < keep_p[ids]
                ids = [i for i, k in zip(ids, kept) if k]
            for i, c in enumerate(ids):
                lo = max(0, i - self.window)
                for j in range(lo, min(len(ids), i + self.window + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(ids[j])
        return vocab, counts, rng, centers, contexts

    def fit_columns(self, store: ColumnStore, device=None,
                    dtype: torch.dtype = torch.float32) -> Word2VecModel:
        col = store[self.input_features[0].name]
        vocab, counts, rng, centers, contexts = self.pairs(col.values)
        V = len(vocab)
        if V == 0:
            return Word2VecModel(vocab=[], vectors=np.zeros((0, self.dim)))
        if not centers:
            return Word2VecModel(vocab=vocab,
                                 vectors=rng.normal(0, 0.1, (V, self.dim)))
        dev = resolve_device(device)
        cen = torch.as_tensor(np.array(centers, dtype=np.int64), device=dev)
        ctx = torch.as_tensor(np.array(contexts, dtype=np.int64), device=dev)
        W0 = torch.as_tensor(rng.normal(0, 0.1, (V, self.dim)), dtype=dtype,
                             device=dev)
        C0 = torch.as_tensor(rng.normal(0, 0.1, (V, self.dim)), dtype=dtype,
                             device=dev)
        # word2vec's unigram^0.75 negative-sampling distribution
        uni = np.array([counts[t] for t in vocab], dtype=np.float64) ** 0.75
        neg_logits = torch.as_tensor(np.log(uni / uni.sum()),
                                     dtype=torch.float32, device=dev)
        itemsize = torch.finfo(dtype).bits // 8
        chunk = w2v_chunk_pairs(self.neg_samples, self.dim, V, itemsize,
                                W2V_CHUNK_BYTES)
        self.fit_stats_: Dict[str, Any] = {}
        vectors = w2v_train(cen, ctx, W0, C0, neg_logits,
                            R.PRNGKey(self.seed), self.epochs,
                            self.neg_samples, self.lr, chunk,
                            stats=self.fit_stats_)
        return Word2VecModel(vocab=vocab, vectors=vectors.to(
            "cpu", torch.float64).numpy())
