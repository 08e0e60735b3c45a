"""Text feature suite — count vectorization, similarity, semantic parsers,
language detection and the taggers; the port of
``transmogrifai_tpu/ops/text_suite.py``.

Parity targets (host-side string work; outputs are dense arrays / typed
columns; the count vectorizer's block joins the device ``"vec"`` program
like every vectorizer's):

* ``OpCountVectorizer`` (``core/.../impl/feature/OpCountVectorizer.scala``):
  vocabulary-building token count vectorizer (minDF / vocabSize).
* ``NGramSimilarity`` (``NGramSimilarity.scala``): character n-gram cosine
  similarity between two text features.
* ``EmailParser`` / ``RichTextFeature.toEmailPrefix/Domain``
  (``core/.../dsl/RichTextFeature.scala``).
* ``PhoneNumberParser`` (``PhoneNumberParser.scala`` — libphonenumber
  replaced by a table of country calling codes + national length rules).
* URL validation/extraction (``RichTextFeature.toUrlProtocol/Domain``).
* ``MimeTypeDetector`` (``MimeTypeDetector.scala`` — Tika replaced by a
  magic-bytes table over Base64 content).
"""
from __future__ import annotations

import base64
import binascii
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..columns import (Column, ColumnStore, NumericColumn, TextColumn,
                       TextListColumn)
from ..stages.base import (FixedArity, InputSpec, Transformer,
                           register_stage)
from ..types.feature_types import (Base64, Binary, Email, MultiPickList,
                                   Phone, Real, Text, TextList, URL)
from ..vector_metadata import VectorColumnMetadata, VectorMetadata
from .vectorizer_base import VEC_DTYPE, VectorizerEstimator, VectorizerModel

__all__ = [
    "OpCountVectorizer", "CountVectorizerModel", "NGramSimilarity",
    "NameEntityRecognizer", "LanguageDetector", "OpSentenceSplitter",
    "OpPOSTagger", "split_sentences",
    "EmailParser", "PhoneNumberParser", "UrlParser", "MimeTypeDetector",
    "parse_email", "parse_phone", "parse_url", "detect_mime",
]


# ---------------------------------------------------------------------------
# Count vectorizer
# ---------------------------------------------------------------------------

@register_stage
class CountVectorizerModel(VectorizerModel):
    """Token counts over a fitted vocabulary, one block per input."""

    operation_name = "countVec"
    seq_type = TextList

    def __init__(self, vocabs: Sequence[Sequence[str]] = (),
                 binary: bool = False, input_names: Sequence[str] = (),
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocabs = [list(v) for v in vocabs]
        self.binary = binary
        self.input_names_saved = list(input_names)

    def host_prepare(self, store: ColumnStore) -> Dict[str, np.ndarray]:
        from ._hostvec import flatten_ragged
        names = self._names()
        n = store.n_rows
        widths = [len(v) for v in self.vocabs]
        mat = np.zeros((n, sum(widths)), dtype=VEC_DTYPE)
        off = 0
        for name, vocab in zip(names, self.vocabs):
            col = store[name]
            index = {t: i for i, t in enumerate(vocab)}
            flat, rows, _len = flatten_ragged(col.values)
            if flat:
                codes = np.fromiter((index.get(t, -1) for t in flat),
                                    np.int64, count=len(flat))
                okm = codes >= 0
                pair = rows[okm] * np.int64(len(vocab)) + codes[okm]
                upair, mult = np.unique(pair, return_counts=True)
                r, c = upair // len(vocab), upair % len(vocab)
                if self.binary:
                    mat[r, off + c] = 1.0
                else:
                    mat[r, off + c] += mult
            off += len(vocab)
        return {"mat": mat}

    def vector_metadata(self) -> VectorMetadata:
        cols: List[VectorColumnMetadata] = []
        for name, vocab in zip(self._names(), self.vocabs):
            for t in vocab:
                cols.append(VectorColumnMetadata(
                    parent_feature_name=name, parent_feature_type="TextList",
                    grouping=name, indicator_value=t))
        return VectorMetadata(self.meta_name, cols)

    def get_model_state(self):
        return {"vocabs": self.vocabs, "input_names_saved": self._names()}


@register_stage
class OpCountVectorizer(VectorizerEstimator):
    """Estimator(TextList…) → token count OPVector (OpCountVectorizer)."""

    operation_name = "countVec"
    seq_type = TextList

    def __init__(self, vocab_size: int = 512, min_df: int = 1,
                 binary: bool = False, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.vocab_size = vocab_size
        self.min_df = min_df
        self.binary = binary

    def fit_columns(self, store: ColumnStore) -> CountVectorizerModel:
        vocabs = []
        for name in self.input_names:
            col = store[name]
            df: Counter = Counter()
            for toks in col.values:
                for t in set(toks):
                    df[t] += 1
            kept = [(c, t) for t, c in df.items() if c >= self.min_df]
            kept.sort(key=lambda ct: (-ct[0], ct[1]))
            vocabs.append([t for _c, t in kept[:self.vocab_size]])
        return CountVectorizerModel(vocabs=vocabs, binary=self.binary,
                                    input_names=self.input_names)


# ---------------------------------------------------------------------------
# N-gram similarity
# ---------------------------------------------------------------------------

def _char_ngrams(s: str, n: int) -> Counter:
    s = f" {s.lower()} "
    return Counter(s[i:i + n] for i in range(max(len(s) - n + 1, 0)))


@register_stage
class NGramSimilarity(Transformer):
    """(Text, Text) → Real cosine similarity of char n-gram profiles
    (NGramSimilarity.scala; Spark's NGram + cosine distance)."""

    operation_name = "ngramSim"
    output_type = Real

    def __init__(self, n: int = 3, uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.n = n

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text, Text)

    def transform_columns(self, store: ColumnStore) -> Column:
        a = store[self.input_features[0].name]
        b = store[self.input_features[1].name]
        n_rows = store.n_rows
        vals = np.zeros(n_rows)
        mask = np.zeros(n_rows, bool)
        for i in range(n_rows):
            va, vb = a.values[i], b.values[i]
            if va is None or vb is None:
                continue
            mask[i] = True
            ca, cb = _char_ngrams(va, self.n), _char_ngrams(vb, self.n)
            dot = sum(c * cb.get(g, 0) for g, c in ca.items())
            na = sum(c * c for c in ca.values()) ** 0.5
            nb = sum(c * c for c in cb.values()) ** 0.5
            vals[i] = dot / (na * nb) if na > 0 and nb > 0 else 0.0
        return NumericColumn(Real, vals, mask)


# ---------------------------------------------------------------------------
# Semantic parsers (email / phone / url / mime)
# ---------------------------------------------------------------------------

_EMAIL_RE = re.compile(
    r"^(?P<prefix>[A-Za-z0-9._%+-]+)@(?P<domain>[A-Za-z0-9.-]+\.[A-Za-z]{2,})$")


def parse_email(value: Optional[str]) -> Tuple[Optional[str], Optional[str]]:
    """(prefix, domain) or (None, None) when invalid."""
    if not value:
        return None, None
    m = _EMAIL_RE.match(value.strip())
    return (m.group("prefix"), m.group("domain")) if m else (None, None)


#: country calling code → (iso region, min/max national significant digits)
#: (libphonenumber metadata subset; lengths per ITU-T E.164 national plans)
_PHONE_PLANS: Dict[str, Tuple[str, int, int]] = {
    "1": ("US", 10, 10), "44": ("GB", 9, 10), "49": ("DE", 6, 11),
    "33": ("FR", 9, 9), "34": ("ES", 9, 9), "39": ("IT", 8, 11),
    "81": ("JP", 9, 10), "86": ("CN", 10, 11), "91": ("IN", 10, 10),
    "61": ("AU", 9, 9), "55": ("BR", 10, 11), "7": ("RU", 10, 10),
    "52": ("MX", 10, 10), "82": ("KR", 8, 10), "31": ("NL", 9, 9),
}
_REGION_TO_CODE = {r: c for c, (r, _a, _b) in _PHONE_PLANS.items()}


def parse_phone(value: Optional[str], default_region: str = "US"
                ) -> Tuple[bool, Optional[str]]:
    """(is_valid, national digits) — PhoneNumberParser.scala semantics:
    '+'-prefixed numbers resolve their country plan, bare numbers use the
    default region's plan."""
    if not value:
        return False, None
    digits = re.sub(r"[\s().\-]", "", value.strip())
    if digits.startswith("+"):
        rest = digits[1:]
        if not rest.isdigit():
            return False, None
        for cc_len in (3, 2, 1):
            cc = rest[:cc_len]
            if cc in _PHONE_PLANS:
                _region, lo, hi = _PHONE_PLANS[cc]
                nat = rest[cc_len:]
                return (lo <= len(nat) <= hi), (nat or None)
        return False, None
    if not digits.isdigit():
        return False, None
    cc = _REGION_TO_CODE.get(default_region, "1")
    _region, lo, hi = _PHONE_PLANS[cc]
    return (lo <= len(digits) <= hi), digits


_URL_RE = re.compile(
    r"^(?P<protocol>https?|ftp)://(?P<domain>[A-Za-z0-9.-]+\.[A-Za-z]{2,})"
    r"(?P<rest>[/:?#].*)?$")


def parse_url(value: Optional[str]
              ) -> Tuple[Optional[str], Optional[str]]:
    """(protocol, domain) or (None, None) when invalid
    (RichTextFeature.toUrlProtocol/Domain)."""
    if not value:
        return None, None
    m = _URL_RE.match(value.strip())
    return (m.group("protocol"), m.group("domain")) if m else (None, None)


#: magic byte prefixes → mime (Tika replacement table)
_MAGIC: List[Tuple[bytes, str]] = [
    (b"%PDF", "application/pdf"),
    (b"\x89PNG", "image/png"),
    (b"GIF8", "image/gif"),
    (b"\xff\xd8\xff", "image/jpeg"),
    (b"PK\x03\x04", "application/zip"),
    (b"\x1f\x8b", "application/gzip"),
    (b"BM", "image/bmp"),
    (b"ID3", "audio/mpeg"),
    (b"OggS", "audio/ogg"),
    (b"fLaC", "audio/flac"),
    (b"RIFF", "audio/wav"),
    (b"MZ", "application/x-msdownload"),
    (b"%!PS", "application/postscript"),
    (b"<?xml", "application/xml"),
    (b"<html", "text/html"),
    (b"{\\rtf", "application/rtf"),
]


def detect_mime(b64: Optional[str]) -> Optional[str]:
    """Base64 content → mime type via magic bytes; text fallback when the
    payload decodes as UTF-8 (MimeTypeDetector.scala semantics)."""
    if not b64:
        return None
    try:
        head = base64.b64decode(b64[:64], validate=True)
    except (binascii.Error, ValueError):
        return None
    for magic, mime in _MAGIC:
        if head.startswith(magic):
            return mime
    try:
        head.decode("utf-8")
        return "text/plain"
    except UnicodeDecodeError:
        return "application/octet-stream"


class _UnaryTextTransformer(Transformer):
    """Shared shell: Text-ish input → parsed typed column."""

    input_type = Text

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(self.input_type)

    def _parse_one(self, value):
        raise NotImplementedError

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        out = np.empty(store.n_rows, dtype=object)
        for i, v in enumerate(col.values):
            out[i] = self._parse_one(v)
        return TextColumn(self.output_type, out)


@register_stage
class EmailParser(_UnaryTextTransformer):
    """Email → Text prefix or domain (RichTextFeature.toEmailPrefix/Domain)."""

    operation_name = "emailParse"
    output_type = Text
    input_type = Email

    def __init__(self, part: str = "domain", uid: Optional[str] = None):
        super().__init__(uid=uid)
        if part not in ("prefix", "domain"):
            raise ValueError(f"part must be prefix|domain, got {part!r}")
        self.part = part

    def _parse_one(self, value):
        prefix, domain = parse_email(value)
        return prefix if self.part == "prefix" else domain


@register_stage
class UrlParser(_UnaryTextTransformer):
    """URL → Text protocol or domain; invalid → None."""

    operation_name = "urlParse"
    output_type = Text
    input_type = URL

    def __init__(self, part: str = "domain", uid: Optional[str] = None):
        super().__init__(uid=uid)
        if part not in ("protocol", "domain"):
            raise ValueError(f"part must be protocol|domain, got {part!r}")
        self.part = part

    def _parse_one(self, value):
        protocol, domain = parse_url(value)
        return protocol if self.part == "protocol" else domain


@register_stage
class MimeTypeDetector(_UnaryTextTransformer):
    """Base64 → Text mime type (MimeTypeDetector.scala)."""

    operation_name = "mimeDetect"
    output_type = Text
    input_type = Base64

    def __init__(self, uid: Optional[str] = None):
        super().__init__(uid=uid)

    def _parse_one(self, value):
        return detect_mime(value)


#: sentence-leading words that look capitalized but are not names
_NER_STOP = frozenset("""the a an this that these those he she it they we i
    you my his her its their our your mr mrs ms dr monday tuesday wednesday
    thursday friday saturday sunday january february march april may june
    july august september october november december""".split())

_SENT_SPLIT = re.compile(r"[.!?]\s+")
_CAP_TOKEN = re.compile(r"^[A-Z][a-zA-Z'’-]*$")


@register_stage
class LanguageDetector(Transformer):
    """Text → RealMap of per-language confidence scores
    (``RichTextFeature.detectLanguages`` :403-417; the reference scores
    with Optimaize's n-gram profiles, here the stopword-overlap fraction
    each language's table achieves — same output contract: a RealMap
    keyed by language code)."""

    operation_name = "detectLanguages"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    @property
    def output_type(self):
        from ..types.feature_types import RealMap
        return RealMap

    def transform_columns(self, store: ColumnStore) -> Column:
        from ..columns import column_from_values
        from .text import score_languages

        col = store[self.input_features[0].name]
        rows = [None if (v := col.get_raw(i)) is None
                else score_languages(str(v))
                for i in range(store.n_rows)]
        return column_from_values(self.output_type, rows)


@register_stage
class NameEntityRecognizer(Transformer):
    """Text → MultiPickList of detected entity spans.

    The reference tags tokens with OpenNLP's pretrained NER models
    (``NameEntityRecognizer.scala:1``, binaries under ``models/``). This
    build vendors its own learned weights the same way: an averaged-
    perceptron BIO tagger (PER/ORG/LOC, lexicon + shape + context
    features; trained offline by ``tools/train_taggers.py``, weights
    under ``resources/taggers/``) — see ``utils/taggers.py`` for the
    model and its training-data provenance. ``entity_types`` filters the
    emitted spans (None → all). If the weight resources are missing the
    stage degrades to the round-2 capitalized-run heuristic. Override
    ``tag_sentence`` to swap in another tagger.
    """

    operation_name = "ner"
    output_type = MultiPickList

    def __init__(self, min_span_tokens: int = 1,
                 entity_types: Optional[List[str]] = None,
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        self.min_span_tokens = min_span_tokens
        self.entity_types = entity_types

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    def tag_sentence(self, tokens: List[str]) -> List[str]:
        """→ entity spans found in one sentence's tokens (model-based;
        heuristic fallback documented above)."""
        from ..utils.taggers import load_tagger
        ner = load_tagger("ner")
        if ner is not None:
            pos_tagger = load_tagger("pos")
            pos = pos_tagger.tag(tokens) if pos_tagger else None
            spans = ner.spans(tokens, ner.tag(tokens, pos))
            return [text for text, etype in spans
                    if (self.entity_types is None
                        or etype in self.entity_types)
                    and len(text.split()) >= self.min_span_tokens]
        if self.entity_types is not None \
                and not getattr(self, "_warned_types", False):
            self._warned_types = True
            import logging
            logging.getLogger(__name__).warning(
                "NameEntityRecognizer %s: entity_types filter requires "
                "the vendored NER weights (missing) — the heuristic "
                "fallback returns UNTYPED spans unfiltered", self.uid)
        return self._heuristic_spans(tokens)

    def _heuristic_spans(self, tokens: List[str]) -> List[str]:
        """Capitalized-run fallback (skips the ambiguous sentence-initial
        token) — only used when the vendored weights are absent."""
        spans: List[str] = []
        run: List[str] = []
        for i, tok in enumerate(tokens):
            word = tok.strip(",;:()\"'.!?")
            is_cap = bool(_CAP_TOKEN.match(word)) and \
                word.lower() not in _NER_STOP
            if is_cap and i > 0:
                run.append(word)
            else:
                if len(run) >= self.min_span_tokens:
                    spans.append(" ".join(run))
                run = []
        if len(run) >= self.min_span_tokens:
            spans.append(" ".join(run))
        return spans

    def transform_columns(self, store: ColumnStore) -> Column:
        from ..columns import TextSetColumn
        col = store[self.input_features[0].name]
        out = []
        for v in col.values:
            if not v:
                out.append(set())
                continue
            ents: set = set()
            for sent in split_sentences(v):
                ents.update(self.tag_sentence(_ner_tokenize(sent)))
            out.append(ents)
        return TextSetColumn(MultiPickList, out)


#: light word tokenizer for tagging: splits trailing/leading punctuation
#: into their own tokens while keeping internal dots/apostrophes/hyphens
#: ("U.S.", "3.5", "O'Brien", "state-of-the-art") together
_NER_TOK = re.compile(r"[A-Za-z0-9]+(?:['’.\-][A-Za-z0-9]+)*|[^\sA-Za-z0-9]")


def _ner_tokenize(sent: str) -> List[str]:
    return _NER_TOK.findall(sent)


def split_sentences(text: str) -> List[str]:
    """Model-based sentence splitting (``OpenNLPSentenceSplitter.scala:1``
    analog); regex fallback when the vendored weights are absent."""
    from ..utils.taggers import load_tagger
    splitter = load_tagger("sent")
    if splitter is not None:
        return splitter.split(text)
    return [s for s in _SENT_SPLIT.split(text) if s]


@register_stage
class OpSentenceSplitter(Transformer):
    """Text → TextList of sentences (the reference's ``SentenceSplitter``
    interface backed by OpenNLP's ``en-sent`` model; here an averaged-
    perceptron boundary classifier over punctuation contexts —
    abbreviations, initials and decimals stay inside their sentence).
    Weights vendored by ``tools/train_taggers.py``."""

    operation_name = "sentSplit"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    @property
    def output_type(self):
        from ..types.feature_types import TextList
        return TextList

    def transform_columns(self, store: ColumnStore) -> Column:
        from ..columns import TextListColumn
        col = store[self.input_features[0].name]
        rows = [split_sentences(str(v)) if v else []
                for v in col.values]
        return TextListColumn(self.output_type, rows)


@register_stage
class OpPOSTagger(Transformer):
    """Text → TextList of "token/TAG" pairs (OpenNLP POSTagger analog —
    the reference vendors ``en-pos-maxent.bin``; here the vendored
    averaged-perceptron tagger, see ``utils/taggers.py``)."""

    operation_name = "posTag"

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Text)

    @property
    def output_type(self):
        from ..types.feature_types import TextList
        return TextList

    def transform_columns(self, store: ColumnStore) -> Column:
        from ..columns import TextListColumn
        from ..utils.taggers import load_tagger
        tagger = load_tagger("pos")
        rows = []
        col = store[self.input_features[0].name]
        for v in col.values:
            if not v:
                rows.append([])
                continue
            # same tokenization the model was trained on (punctuation as
            # its own token) — whitespace splitting would feed it unseen
            # "word." forms
            toks = _ner_tokenize(str(v))
            tags = tagger.tag(toks) if tagger else ["UNK"] * len(toks)
            rows.append([f"{t}/{g}" for t, g in zip(toks, tags)])
        return TextListColumn(self.output_type, rows)


@register_stage
class PhoneNumberParser(Transformer):
    """Phone → Binary validity or Text national number
    (PhoneNumberParser.scala isValidPhoneNumber / parse)."""

    operation_name = "phoneParse"
    output_type = Binary

    def __init__(self, default_region: str = "US", output: str = "valid",
                 uid: Optional[str] = None):
        super().__init__(uid=uid)
        if output not in ("valid", "national"):
            raise ValueError(f"output must be valid|national, got {output!r}")
        self.default_region = default_region
        self.output = output
        if output == "national":
            self.output_type = Text

    @property
    def input_spec(self) -> InputSpec:
        return FixedArity(Phone)

    def transform_columns(self, store: ColumnStore) -> Column:
        col = store[self.input_features[0].name]
        n = store.n_rows
        if self.output == "valid":
            vals = np.zeros(n, dtype=bool)
            mask = np.zeros(n, dtype=bool)
            for i, v in enumerate(col.values):
                if v is None:
                    continue
                mask[i] = True
                vals[i], _ = parse_phone(v, self.default_region)
            return NumericColumn(Binary, vals, mask)
        out = np.empty(n, dtype=object)
        for i, v in enumerate(col.values):
            ok, nat = parse_phone(v, self.default_region)
            out[i] = nat if ok else None
        return TextColumn(Text, out)
