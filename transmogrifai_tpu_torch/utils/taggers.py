"""Model-based POS / NER / sentence-boundary taggers — the port of
``transmogrifai_tpu/utils/taggers.py``, with its own copy of the weights.

The reference wires OpenNLP's pretrained maxent models through
``OpenNLPNameEntityTagger`` / ``OpenNLPSentenceSplitter`` /
``OpenNLPAnalyzer`` (``core/.../utils/text/OpenNLPNameEntityTagger.scala:1``,
``OpenNLPSentenceSplitter.scala:1``) with the binaries vendored as
resources (``models/README.md:1-5``). This package vendors learned
weights the same way: small **averaged-perceptron** taggers
(the classic Collins 2002 structure — also what NLTK's default English
POS tagger uses) trained OFFLINE by ``tools/train_taggers.py`` on a
synthesized annotated corpus (template grammar over curated name /
organization / location / vocabulary lexicons — this image has no
network egress, so no external treebank; the trainer and its corpus
generator are in-repo and reproducible). The weights live under
``transmogrifai_tpu_torch/resources/taggers/*.json.gz``, byte-identical
copies of the JAX package's.

Inference is on the host, one Python call a token (strings never reach
the device; OpenNLP-class work stays on the CPU feeding device arrays).
"""
from __future__ import annotations

import gzip
import json
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["AveragedPerceptron", "POSTagger", "NERTagger",
           "SentenceSplitter", "load_tagger", "resource_dir"]


def resource_dir() -> str:
    return os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "resources", "taggers")


class AveragedPerceptron:
    """Sparse multiclass averaged perceptron.

    ``weights``: feature → {class: weight}. Training keeps per-weight
    accumulators so the final weights are the average over all updates
    (Collins 2002) — the variance reduction that makes a plain
    perceptron competitive on tagging tasks.
    """

    def __init__(self, weights: Optional[Dict[str, Dict[str, float]]] = None,
                 classes: Optional[Sequence[str]] = None):
        self.weights: Dict[str, Dict[str, float]] = weights or {}
        self.classes: List[str] = list(classes or [])
        # training state
        self._totals: Dict[Tuple[str, str], float] = {}
        self._tstamps: Dict[Tuple[str, str], int] = {}
        self._i = 0

    def score(self, features: Iterable[str]) -> Dict[str, float]:
        scores: Dict[str, float] = {}
        for f in features:
            w = self.weights.get(f)
            if w is None:
                continue
            for c, v in w.items():
                scores[c] = scores.get(c, 0.0) + v
        return scores

    def predict(self, features: Sequence[str]) -> str:
        scores = self.score(features)
        if not scores:
            return self.classes[0]
        # deterministic tie-break by class name
        return max(self.classes, key=lambda c: (scores.get(c, 0.0), c))

    # -- training ---------------------------------------------------------
    def update(self, truth: str, guess: str,
               features: Sequence[str]) -> None:
        self._i += 1
        if truth == guess:
            return

        def upd(f: str, c: str, v: float) -> None:
            key = (f, c)
            w = self.weights.setdefault(f, {})
            self._totals[key] = self._totals.get(key, 0.0) \
                + (self._i - self._tstamps.get(key, 0)) * w.get(c, 0.0)
            self._tstamps[key] = self._i
            w[c] = w.get(c, 0.0) + v
        for f in features:
            upd(f, truth, 1.0)
            upd(f, guess, -1.0)

    def average(self) -> None:
        for f, w in self.weights.items():
            for c in list(w):
                key = (f, c)
                total = self._totals.get(key, 0.0) \
                    + (self._i - self._tstamps.get(key, 0)) * w[c]
                avg = total / max(self._i, 1)
                if abs(avg) > 1e-6:
                    w[c] = round(avg, 5)
                else:
                    del w[c]
        self.weights = {f: w for f, w in self.weights.items() if w}

    # -- persistence ------------------------------------------------------
    def save(self, path: str, extra: Optional[dict] = None) -> None:
        doc = {"classes": self.classes, "weights": self.weights,
               **(extra or {})}
        with gzip.open(path, "wt", encoding="utf-8") as fh:
            json.dump(doc, fh)

    @classmethod
    def load(cls, path: str) -> Tuple["AveragedPerceptron", dict]:
        with gzip.open(path, "rt", encoding="utf-8") as fh:
            doc = json.load(fh)
        return cls(doc["weights"], doc["classes"]), doc


def _shape(w: str) -> str:
    if w.isdigit():
        return "d"
    if w.isupper():
        return "A"
    if w[:1].isupper():
        return "Aa"
    if any(ch.isdigit() for ch in w):
        return "ad"
    return "a"


class POSTagger:
    """Greedy left-to-right POS tagging (PTB-style coarse tags)."""

    START = ["-S2-", "-S1-"]

    def __init__(self, model: AveragedPerceptron):
        self.model = model

    @staticmethod
    def features(tokens: Sequence[str], i: int,
                 prev: str, prev2: str) -> List[str]:
        w = tokens[i]
        lw = w.lower()
        p1 = tokens[i - 1].lower() if i > 0 else "-S1-"
        n1 = tokens[i + 1].lower() if i + 1 < len(tokens) else "-E1-"
        return [
            "b", f"w={lw}", f"sfx3={lw[-3:]}", f"sfx2={lw[-2:]}",
            f"sh={_shape(w)}", f"p1={p1}", f"n1={n1}",
            f"t1={prev}", f"t2={prev2}", f"t1w={prev}+{lw}",
            f"i0={i == 0}",
        ]

    def tag(self, tokens: Sequence[str]) -> List[str]:
        prev, prev2 = self.START[1], self.START[0]
        out: List[str] = []
        for i in range(len(tokens)):
            t = self.model.predict(self.features(tokens, i, prev, prev2))
            out.append(t)
            prev2, prev = prev, t
        return out


class NERTagger:
    """Greedy BIO tagging over PER/ORG/LOC with lexicon features."""

    def __init__(self, model: AveragedPerceptron, lexicons: dict):
        self.model = model
        self.lex = {k: set(v) for k, v in lexicons.items()}

    def features(self, tokens: Sequence[str], i: int,
                 prev_tag: str, pos: Optional[Sequence[str]] = None
                 ) -> List[str]:
        w = tokens[i]
        lw = w.lower()
        p1 = tokens[i - 1] if i > 0 else "-S1-"
        n1 = tokens[i + 1] if i + 1 < len(tokens) else "-E1-"
        feats = [
            "b", f"w={lw}", f"sh={_shape(w)}",
            f"p1={p1.lower()}", f"n1={n1.lower()}",
            f"p1sh={_shape(p1) if p1 != '-S1-' else 'S'}",
            f"n1sh={_shape(n1) if n1 != '-E1-' else 'E'}",
            f"t1={prev_tag}", f"i0={i == 0}",
            f"sfx2={lw[-2:]}",
        ]
        for name, vocab in self.lex.items():
            if lw in vocab:
                feats.append(f"lex={name}")
            if n1.lower() in vocab:
                feats.append(f"n1lex={name}")
        if pos is not None:
            feats.append(f"pos={pos[i]}")
        return feats

    def tag(self, tokens: Sequence[str],
            pos: Optional[Sequence[str]] = None) -> List[str]:
        prev = "O"
        out: List[str] = []
        for i in range(len(tokens)):
            t = self.model.predict(self.features(tokens, i, prev, pos))
            # BIO validity: an I- must continue a same-type span
            if t.startswith("I-") and not (
                    prev.endswith(t[2:]) and prev != "O"):
                t = "B-" + t[2:]
            out.append(t)
            prev = t
        return out

    @staticmethod
    def spans(tokens: Sequence[str], tags: Sequence[str]
              ) -> List[Tuple[str, str]]:
        """BIO tags → [(entity text, type)]."""
        out: List[Tuple[str, str]] = []
        cur: List[str] = []
        cur_t = ""
        for tok, tag in zip(tokens, tags):
            if tag.startswith("B-"):
                if cur:
                    out.append((" ".join(cur), cur_t))
                cur, cur_t = [tok], tag[2:]
            elif tag.startswith("I-") and cur:
                cur.append(tok)
            else:
                if cur:
                    out.append((" ".join(cur), cur_t))
                cur, cur_t = [], ""
        if cur:
            out.append((" ".join(cur), cur_t))
        return out


class SentenceSplitter:
    """Classify every [.?!] occurrence as boundary / not (abbreviations,
    initials, decimals stay inside their sentence)."""

    CANDIDATES = ".?!"

    def __init__(self, model: AveragedPerceptron):
        self.model = model

    @staticmethod
    def features(text: str, i: int) -> List[str]:
        ch = text[i]
        # fixed windows keep split() linear in document length — slicing
        # the whole prefix/suffix per candidate made long cells quadratic
        before = text[max(0, i - 40):i].rstrip()
        bparts = before.split()
        prev_tok = bparts[-1] if bparts else "-S-"
        after = text[i + 1:i + 41].lstrip()
        aparts = after.split()
        next_tok = aparts[0] if aparts else "-E-"
        prev_core = prev_tok.rstrip(".,;:!?\"')")
        return [
            "b", f"c={ch}",
            f"pt={prev_tok.lower()[-12:]}",
            f"ptlen1={len(prev_core) == 1}",
            f"ptcap={prev_core[:1].isupper()}",
            f"ptdig={prev_core.isdigit()}",
            f"ptdot={'.' in prev_tok[:-1]}",
            f"ntcap={next_tok[:1].isupper()}",
            f"ntdig={next_tok[:1].isdigit()}",
            f"ntlow={next_tok[:1].islower()}",
            f"nt={next_tok.lower()[:12]}",
            f"spc={i + 1 < len(text) and text[i + 1].isspace()}",
            f"eot={not after}",
        ]

    def split(self, text: str) -> List[str]:
        if not text:
            return []
        bounds: List[int] = []
        for i, ch in enumerate(text):
            if ch in self.CANDIDATES:
                # only positions followed by whitespace/EOT are candidates
                if i + 1 < len(text) and not text[i + 1].isspace():
                    continue
                if self.model.predict(self.features(text, i)) == "1":
                    bounds.append(i)
        out: List[str] = []
        start = 0
        for b in bounds:
            seg = text[start:b + 1].strip()
            if seg:
                out.append(seg)
            start = b + 1
        tail = text[start:].strip()
        if tail:
            out.append(tail)
        return out


_CACHE: Dict[str, object] = {}


def load_tagger(kind: str):
    """Load a vendored tagger ('pos' | 'ner' | 'sent'); None when the
    resource is absent (callers keep their documented fallback)."""
    if kind in _CACHE:
        return _CACHE[kind]
    path = os.path.join(resource_dir(), f"{kind}.json.gz")
    tagger = None
    if os.path.exists(path):
        model, doc = AveragedPerceptron.load(path)
        if kind == "pos":
            tagger = POSTagger(model)
        elif kind == "ner":
            tagger = NERTagger(model, doc.get("lexicons", {}))
        elif kind == "sent":
            tagger = SentenceSplitter(model)
    _CACHE[kind] = tagger
    return tagger
