"""Text processing — tokenization, analyzers, language detection (host-side).

The reference uses Lucene analyzers + Optimaize language detection
(``core/.../impl/feature/TextTokenizer.scala:1``, ``utils/.../text``
interfaces ``TextAnalyzer``/``LanguageDetector``). Here all tokenization
is host work feeding hashed/indexed device arrays, so the implementation is
a fast table-driven analyzer pipeline with the same interface:

    lowercase → unicode word split → min-length filter → stopword removal
    (per detected/declared language) → optional light stemming

Stemming is a compact Porter-style suffix stripper (plural/participle
steps), enough for bag-of-words feature parity without a linguistics
dependency.

Host copy of ``transmogrifai_tpu/ops/text.py``.
"""
from __future__ import annotations

import re
from typing import Dict, List, Optional

from ..columns import Column, ColumnStore, TextColumn, TextListColumn
from ..stages.base import FixedArity, InputSpec, Transformer, register_stage
from ..types.feature_types import Text, TextList

__all__ = ["tokenize_simple", "tokenize", "TextTokenizer",
           "detect_language", "STOPWORDS"]

_TOKEN_RE = re.compile(r"[\w']+", re.UNICODE)
_MIN_TOKEN_LENGTH = 1

#: small per-language stopword tables (Lucene analyzer stopword analog);
#: also drive the stopword-overlap language detector below
STOPWORDS: Dict[str, frozenset] = {
    "en": frozenset("""a an and are as at be but by for from has have he her
        his i in is it its my not of on or she that the their there they this
        to was we were will with you your""".split()),
    "es": frozenset("""de la que el en y a los del se las por un para con no
        una su al lo como mas pero sus le ya o este si porque esta entre
        cuando muy sin sobre tambien me hasta hay donde quien desde todo nos
        durante todos uno les ni contra otros ese eso ante ellos e esto mi
        antes algunos que unos yo otro otras otra el tanto esa estos mucho
        quienes nada muchos cual poco ella estar estas algunas algo
        nosotros""".split()),
    "fr": frozenset("""de la le et les des en un du une que est pour qui dans
        a par plus pas au sur ne se ce il sont la son avec ils mais comme ou
        si leur y dont elle deux ont ete cette aux tout nous sa meme ces
        son bien ou""".split()),
    "de": frozenset("""der die und in den von zu das mit sich des auf fur ist
        im dem nicht ein eine als auch es an werden aus er hat dass sie nach
        wird bei einer um am sind noch wie einem uber einen so zum war haben
        nur oder aber vor zur bis mehr durch man sein wurde sei""".split()),
    "it": frozenset("""di e il la che in a per un e del con non sono da una
        le si dei nel alla lo piu gli delle questo i ma ha anche al suo o
        come se della questa sulla loro tutti hanno essere fra cui tra""".split()),
    "pt": frozenset("""de a o que e do da em um para com nao uma os no se na
        por mais as dos como mas ao ele das seu sua ou quando muito nos ja
        eu tambem so pelo pela ate isso ela entre depois sem mesmo aos seus
        quem nas me esse eles voce essa num nem suas meu as minha numa pelos
        elas qual nos lhe deles essas esses pelas este dele""".split()),
}


def score_languages(text: str) -> dict:
    """Per-language stopword-overlap fractions (the one scoring formula
    shared by :func:`detect_language` and the ``LanguageDetector`` stage —
    the Optimaize n-gram profile replacement)."""
    toks = _TOKEN_RE.findall(text.lower())
    if not toks:
        return {}
    out = {}
    for lang, words in STOPWORDS.items():
        score = sum(1 for t in toks if t in words) / len(toks)
        if score > 0.0:
            out[lang] = score
    return out


def detect_language(text: str, default: str = "en") -> str:
    """Best language by stopword overlap; ties/no-signal fall back to
    ``default`` (scores below the 0.05 noise floor are ignored)."""
    scores = score_languages(text)
    if not scores:
        return default
    best = max(scores, key=scores.get)
    return best if scores[best] > 0.05 else default


_STEM_SUFFIXES = [
    ("ational", "ate"), ("iveness", "ive"), ("fulness", "ful"),
    ("ousness", "ous"), ("ization", "ize"), ("tional", "tion"),
    ("biliti", "ble"), ("entli", "ent"), ("ation", "ate"), ("alism", "al"),
    ("aliti", "al"), ("ement", ""), ("ness", ""), ("ing", ""), ("edly", ""),
    ("eed", "ee"), ("ies", "y"), ("ied", "y"), ("es", ""), ("ed", ""),
    ("ly", ""), ("s", ""),
]


def stem(token: str) -> str:
    """Compact Porter-style suffix stripping (plurals + participles)."""
    if len(token) <= 3:
        return token
    for suf, repl in _STEM_SUFFIXES:
        if token.endswith(suf) and len(token) - len(suf) + len(repl) >= 3:
            return token[:len(token) - len(suf)] + repl
    return token


def tokenize_simple(text: str, to_lowercase: bool = True,
                    min_token_length: int = _MIN_TOKEN_LENGTH) -> List[str]:
    """Unicode word tokenizer (Lucene SimpleAnalyzer analog)."""
    if to_lowercase:
        text = text.lower()
    return [t for t in _TOKEN_RE.findall(text) if len(t) >= min_token_length]


def tokenize(text: str, to_lowercase: bool = True, min_token_length: int = 1,
             remove_stopwords: bool = False, language: Optional[str] = None,
             auto_detect_language: bool = False,
             stemming: bool = False) -> List[str]:
    """Full analyzer pipeline (TextTokenizer.tokenize analog)."""
    toks = tokenize_simple(text, to_lowercase, min_token_length)
    if remove_stopwords:
        lang = (detect_language(text) if auto_detect_language
                else (language or "en"))
        stop = STOPWORDS.get(lang, STOPWORDS["en"])
        toks = [t for t in toks if t not in stop]
    if stemming:
        toks = [stem(t) for t in toks]
    return toks


@register_stage
class TextTokenizer(Transformer):
    """Text → TextList of tokens (TextTokenizer.scala analyzer pipeline)."""

    operation_name = "tokenize"
    output_type = TextList

    def __init__(self, to_lowercase: bool = True, min_token_length: int = 1,
                 remove_stopwords: bool = False,
                 language: Optional[str] = None,
                 auto_detect_language: bool = False,
                 stemming: bool = False,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.to_lowercase = to_lowercase
        self.min_token_length = min_token_length
        self.remove_stopwords = remove_stopwords
        self.language = language
        self.auto_detect_language = auto_detect_language
        self.stemming = stemming

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        assert isinstance(col, TextColumn)
        out = [tokenize(v, self.to_lowercase, self.min_token_length,
                        self.remove_stopwords, self.language,
                        self.auto_detect_language, self.stemming)
               if v is not None else []
               for v in col.values]
        return TextListColumn(TextList, out)
