"""Avro Object Container File reader and writer, pure Python and numpy;
the port of ``transmogrifai_tpu/readers/avro.py``.

Parity: ``AvroReader`` / ``AvroInOut`` (``readers/.../DataReaders.scala``,
``utils/.../io/avro/AvroInOut.scala``). A compact codec of the Avro 1.x
container format (magic ``Obj\\x01``, a metadata map carrying
``avro.schema`` and ``avro.codec``, sync-marker-delimited blocks of
binary-encoded records; the null and deflate codecs) feeds the host
record path. It supports the schema subset AutoML data uses: primitives,
records, enums, arrays, maps, fixed and unions.

Two decode paths:

* :func:`read_avro_records` — the per-record Python decoder (any
  supported schema), returning ``List[Dict]``.
* :func:`read_avro_table` — the vectorized decode: when every record of
  a block verifies as fixed-stride (each field a fixed-width primitive —
  double, float, boolean — possibly behind a constant union branch), the
  block decodes as one ``np.frombuffer`` view and a strided slice per
  field. The result is a :class:`ColumnarRecords`, a sequence-of-dicts
  facade over the column arrays that iterates as the same dicts the
  Python decoder builds (the layout is verified by its branch bytes
  before it is trusted). Any other layout decodes through
  :func:`read_avro_records`: which decoder serves is a choice of host
  decode path, and both give the same records.

The encoder (:class:`AvroWriter`, :func:`write_avro_records`,
:func:`infer_avro_schema`) writes the runner's Avro score output and the
event logs the tests and ``chip_smoke.py`` read back.
"""
from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["read_avro_records", "read_avro_table", "ColumnarRecords",
           "AvroDecodeError", "AvroWriter",
           "write_avro_records", "infer_avro_schema"]

_MAGIC = b"Obj\x01"


class AvroDecodeError(ValueError):
    pass


class _Cursor:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise AvroDecodeError("Truncated avro data")
        self.pos += n
        return b

    # -- primitives (Avro binary encoding) --------------------------------
    def zigzag_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def float_(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def bytes_(self) -> bytes:
        return self.read(self.zigzag_long())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")


def _decode(cur: _Cursor, schema: Any, named: Dict[str, Any]) -> Any:
    if isinstance(schema, str):
        s = schema
        if s == "null":
            return None
        if s == "boolean":
            return cur.read(1) != b"\x00"
        if s in ("int", "long"):
            return cur.zigzag_long()
        if s == "float":
            return cur.float_()
        if s == "double":
            return cur.double()
        if s == "bytes":
            return cur.bytes_()
        if s == "string":
            return cur.string()
        if s in named:
            return _decode(cur, named[s], named)
        raise AvroDecodeError(f"Unknown schema reference {s!r}")
    if isinstance(schema, list):                  # union: branch index
        idx = cur.zigzag_long()
        if not (0 <= idx < len(schema)):
            raise AvroDecodeError(f"Bad union branch {idx}")
        return _decode(cur, schema[idx], named)
    t = schema["type"]
    if t == "record":
        _register(schema, named)
        return {f["name"]: _decode(cur, f["type"], named)
                for f in schema["fields"]}
    if t == "enum":
        _register(schema, named)
        return schema["symbols"][cur.zigzag_long()]
    if t == "fixed":
        _register(schema, named)
        return cur.read(schema["size"])
    if t == "array":
        out: List[Any] = []
        while True:
            n = cur.zigzag_long()
            if n == 0:
                break
            if n < 0:             # block with byte size prefix
                n = -n
                cur.zigzag_long()
            for _ in range(n):
                out.append(_decode(cur, schema["items"], named))
        return out
    if t == "map":
        m: Dict[str, Any] = {}
        while True:
            n = cur.zigzag_long()
            if n == 0:
                break
            if n < 0:
                n = -n
                cur.zigzag_long()
            for _ in range(n):
                # key must be read BEFORE the value — and Python evaluates
                # the assignment's RHS first, so m[cur.string()] = decode()
                # would consume them in the wrong order
                k = cur.string()
                m[k] = _decode(cur, schema["values"], named)
        return m
    return _decode(cur, t, named)     # e.g. {"type": "string"}


def _register(schema: Dict[str, Any], named: Dict[str, Any]) -> None:
    name = schema.get("name")
    if name:
        ns = schema.get("namespace")
        named[name] = schema
        if ns:
            named[f"{ns}.{name}"] = schema


def _read_container(path: str, decode) -> Any:
    """The one I/O and error ladder both decoders share: the
    ``avro.decode`` fault site, the magic check and the poison-file
    translation — a truncated varint (``IndexError``), a short struct
    read or a bad deflate stream are all the same :class:`AvroDecodeError`
    to the caller, naming the file (the streaming reader's quarantine
    routes on it). Keeping it in one place keeps the two decode paths'
    error contracts from drifting apart."""
    from .. import resilience
    resilience.inject("avro.decode", path=path)
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:4] != _MAGIC:
        raise AvroDecodeError(f"{path} is not an Avro container file")
    try:
        return decode(data)
    except AvroDecodeError as e:
        raise AvroDecodeError(f"{path}: {e}") from e
    except (IndexError, struct.error, KeyError, zlib.error,
            UnicodeDecodeError, json.JSONDecodeError) as e:
        raise AvroDecodeError(
            f"{path}: truncated or corrupt avro container "
            f"({type(e).__name__}: {e})") from e


def read_avro_records(path: str) -> List[Dict[str, Any]]:
    """Decode every record of an Avro container file into dicts.

    Decode failures always surface as :class:`AvroDecodeError` naming
    the file (see :func:`_read_container`)."""
    return _read_container(path, _decode_container)


def _parse_header(cur: _Cursor) -> Tuple[Any, str, bytes]:
    """Container header at ``cur`` (past the magic): schema, codec,
    sync marker."""
    meta: Dict[str, bytes] = {}
    while True:
        n = cur.zigzag_long()
        if n == 0:
            break
        if n < 0:
            n = -n
            cur.zigzag_long()
        for _ in range(n):
            k = cur.string()
            meta[k] = cur.bytes_()
    schema = json.loads(meta[b"avro.schema".decode()]
                        if isinstance(meta.get("avro.schema"), str)
                        else meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    sync = cur.read(16)
    return schema, codec, sync


def _iter_blocks(cur: _Cursor, codec: str,
                 sync: bytes) -> Iterator[Tuple[int, bytes]]:
    """Yield each block's (record count, decompressed bytes)."""
    data = cur.buf
    while cur.pos < len(data):
        count = cur.zigzag_long()
        size = cur.zigzag_long()
        block = cur.read(size)
        if codec == "deflate":
            block = zlib.decompress(block, -15)
        elif codec != "null":
            raise AvroDecodeError(f"Unsupported avro codec {codec!r}")
        if cur.read(16) != sync:
            raise AvroDecodeError("Sync marker mismatch")
        yield count, block


def _decode_container(data: bytes) -> List[Dict[str, Any]]:
    cur = _Cursor(data, 4)
    schema, codec, sync = _parse_header(cur)
    named: Dict[str, Any] = {}
    records: List[Dict[str, Any]] = []
    for count, block in _iter_blocks(cur, codec, sync):
        bcur = _Cursor(block)
        for _ in range(count):
            records.append(_decode(bcur, schema, named))
    return records


# ---------------------------------------------------------------------------
# Vectorized columnar decode
# ---------------------------------------------------------------------------

#: fixed-width primitive payloads the strided decode understands; every
#: other kind (varint ints/longs, length-prefixed strings/bytes,
#: containers) is variable-width and routes to the Python decoder
_FIXED_WIDTH = {"null": 0, "boolean": 1, "float": 4, "double": 8}


class ColumnarRecords:
    """Sequence-of-dicts facade over numpy column arrays.

    The vectorized decoder's output: code that iterates records (generic
    ``extract_fn``\\ s, a condition predicate) sees the same dicts the
    Python decoder builds — materialized lazily once per batch and shared
    across every iterating consumer (a per-iteration rebuild would charge
    O(rows × fields) to each feature whose type has no bulk lane) —
    while columnar consumers (``FeatureGeneratorStage.extract_column``,
    the temporal engine) read ``columns`` directly and never materialize
    a dict at all. ``null_fields`` are fields whose
    every row took the union's null branch (dict access yields None;
    the column array holds NaN so the bulk ingest path masks them
    missing, same as the dict path)."""

    __slots__ = ("columns", "null_fields", "_names", "n_rows", "_dicts")

    def __init__(self, columns: Dict[str, Any],
                 null_fields: Tuple[str, ...] = ()):
        self.columns = dict(columns)
        self.null_fields = frozenset(null_fields)
        self._names = list(columns)
        self.n_rows = (int(next(iter(columns.values())).shape[0])
                       if columns else 0)
        self._dicts: Optional[List[Dict[str, Any]]] = None

    def __len__(self) -> int:
        return self.n_rows

    def __bool__(self) -> bool:
        return self.n_rows > 0

    def _row(self, i: int) -> Dict[str, Any]:
        return {nm: (None if nm in self.null_fields
                     else self.columns[nm][i].item())
                for nm in self._names}

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._row(j) for j in range(*i.indices(self.n_rows))]
        n = self.n_rows
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        return self._row(i)

    def _materialize(self) -> List[Dict[str, Any]]:
        """The shared dict list, built in bulk on first full iteration:
        whole-column ``tolist()`` (C speed, same python scalars as
        ``_row``'s per-element ``.item()``) then one zip pass."""
        if self._dicts is None:
            lists = [([None] * self.n_rows if nm in self.null_fields
                      else self.columns[nm].tolist())
                     for nm in self._names]
            names = self._names
            self._dicts = [dict(zip(names, vals))
                           for vals in zip(*lists)]
        return self._dicts

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return iter(self._materialize())

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, ColumnarRecords):
            return (self._names == other._names
                    and self.null_fields == other.null_fields
                    and all(_np_eq(self.columns[nm], other.columns[nm])
                            for nm in self._names))
        if isinstance(other, (list, tuple)):
            return len(other) == self.n_rows \
                and all(a == b for a, b in zip(self, other))
        return NotImplemented

    def __repr__(self) -> str:
        return (f"ColumnarRecords({self.n_rows} rows × "
                f"{len(self._names)} cols)")

    def __reduce__(self):
        # pickles (and therefore compares, in tests that pickle both
        # sides) exactly like the Python decoder's list of dicts
        return (list, (list(self),))


def _np_eq(a, b) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype \
        and bool(np.array_equal(a, b))


def _probe_fixed_layout(block: bytes, schema: Any
                        ) -> Optional[List[Tuple[str, bytes, str, int]]]:
    """Walk the FIRST record of ``block`` and hypothesize a fixed-stride
    layout: per field ``(name, union-branch prefix bytes, kind, offset)``.
    None when any field is variable-width under the branch this record
    took (varint long/int, string/bytes, containers, named types)."""
    if not (isinstance(schema, dict) and schema.get("type") == "record"
            and schema.get("fields")):
        return None
    cur = _Cursor(block)
    plan: List[Tuple[str, bytes, str, int]] = []
    offset = 0
    for f in schema["fields"]:
        ft = f["type"]
        prefix = b""
        if isinstance(ft, list):              # union: record the branch
            idx = cur.zigzag_long()
            if not 0 <= idx < len(ft):
                return None
            prefix = _zigzag_bytes(idx)
            ft = ft[idx]
        if not isinstance(ft, str) or ft not in _FIXED_WIDTH:
            return None
        w = _FIXED_WIDTH[ft]
        cur.read(w)
        plan.append((f["name"], prefix, ft, offset))
        offset += len(prefix) + w
    if offset == 0:
        return None
    return plan


def _vector_decode_block(block: bytes, count: int, schema: Any
                         ) -> Optional[Tuple[Dict[str, Any], List[str]]]:
    """Decode one block as strided numpy columns — or None when the
    layout hypothesis from its first record does not VERIFY (stride ×
    count must equal the block size, and every union field's branch
    byte must be the same constant in every row; a mixed-branch column
    — some rows null, some not — fails the check and falls back to the
    exact Python decoder). Verified columns are bit-identical to the
    Python path: the payload bytes are reinterpreted, never re-encoded.
    """
    try:
        plan = _probe_fixed_layout(block, schema)
    except (AvroDecodeError, IndexError, struct.error):
        return None
    if plan is None:
        return None
    last_name, last_prefix, last_kind, last_off = plan[-1]
    stride = last_off + len(last_prefix) + _FIXED_WIDTH[last_kind]
    if stride * count != len(block):
        return None
    u8 = np.frombuffer(block, np.uint8).reshape(count, stride)
    cols: Dict[str, Any] = {}
    nulls: List[str] = []
    for name, prefix, kind, off in plan:
        for j, byte in enumerate(prefix):
            if not (u8[:, off + j] == byte).all():
                return None               # branch varies row-to-row
        po = off + len(prefix)
        if kind == "null":
            cols[name] = np.full(count, np.nan)
            nulls.append(name)
        elif kind == "boolean":
            cols[name] = u8[:, po] != 0
        else:
            dt = "<f8" if kind == "double" else "<f4"
            cols[name] = np.ascontiguousarray(
                u8[:, po:po + _FIXED_WIDTH[kind]]).view(dt).ravel()
    return cols, nulls


def _decode_container_columnar(data: bytes) -> Optional[ColumnarRecords]:
    """Whole-container vectorized decode; None = fall back to the
    Python decoder (never partially: one non-verifying block rejects
    the file, so the output is always all-columnar or all-dicts)."""
    cur = _Cursor(data, 4)
    schema, codec, sync = _parse_header(cur)
    parts: List[Tuple[Dict[str, Any], List[str]]] = []
    for count, block in _iter_blocks(cur, codec, sync):
        if count <= 0:
            continue
        dec = _vector_decode_block(block, count, schema)
        if dec is None:
            return None
        parts.append(dec)
    if not parts:
        # an empty container still needs the schema's field names; the
        # Python path returns [] — match it
        return ColumnarRecords({})
    cols0, nulls0 = parts[0]
    if len(parts) == 1:
        return ColumnarRecords(cols0, tuple(nulls0))
    # multi-block: merge only when every block agrees on names, dtypes
    # and null-branch fields (a field that is all-null in one block and
    # valued in another needs the dict decoder's per-row Nones)
    names = list(cols0)
    for cols, nulls in parts[1:]:
        if list(cols) != names or nulls != nulls0:
            return None
        if any(cols[nm].dtype != cols0[nm].dtype for nm in names):
            return None
    merged = {nm: np.concatenate([p[0][nm] for p in parts])
              for nm in names}
    return ColumnarRecords(merged, tuple(nulls0))


def read_avro_table(path: str):
    """Columnar decode: :class:`ColumnarRecords` when the file verifies as
    fixed-stride (the vectorized numpy path), else the exact
    ``List[Dict]`` the Python decoder produces. The same error contract
    as :func:`read_avro_records` (shared via :func:`_read_container`);
    both shapes iterate as the same dicts."""

    def _decode(data: bytes):
        table = _decode_container_columnar(data)
        if table is not None:
            return table
        return _decode_container(data)

    return _read_container(path, _decode)


# ---------------------------------------------------------------------------
# Encoder — score output (OpWorkflowModel.saveScores / RichDataset.saveAvro,
# core/.../OpWorkflowModel.scala:376-421). Counterpart of the decoder above:
# same container format, null/deflate codecs, same schema subset.
# ---------------------------------------------------------------------------

def _zigzag_bytes(v: int) -> bytes:
    u = (v << 1) ^ (v >> 63) if v < 0 else (v << 1)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _encode(buf: bytearray, schema: Any, value: Any,
            named: Dict[str, Any]) -> None:
    if isinstance(schema, str):
        s = schema
        if s == "null":
            return
        if s == "boolean":
            buf += b"\x01" if value else b"\x00"
        elif s in ("int", "long"):
            buf += _zigzag_bytes(int(value))
        elif s == "float":
            buf += struct.pack("<f", float(value))
        elif s == "double":
            buf += struct.pack("<d", float(value))
        elif s == "bytes":
            b = bytes(value)
            buf += _zigzag_bytes(len(b)) + b
        elif s == "string":
            b = str(value).encode("utf-8")
            buf += _zigzag_bytes(len(b)) + b
        elif s in named:
            _encode(buf, named[s], value, named)
        else:
            raise AvroDecodeError(f"Unknown schema reference {s!r}")
        return
    if isinstance(schema, list):                  # union: pick the branch
        # two passes: STRICT typing first (a long in ["null","string",
        # "long"] must encode as long, not be swallowed by an earlier
        # string branch), then the lenient pass where "string" acts as
        # the stringify-anything escape hatch for values the inferred
        # schema didn't anticipate
        for strict in (True, False):
            for idx, branch in enumerate(schema):
                if _union_matches(branch, value, strict=strict):
                    buf += _zigzag_bytes(idx)
                    _encode(buf, branch, value, named)
                    return
        raise AvroDecodeError(
            f"No union branch of {schema} matches {type(value).__name__}")
    t = schema["type"]
    if t == "record":
        _register(schema, named)
        for f in schema["fields"]:
            _encode(buf, f["type"], (value or {}).get(f["name"]), named)
    elif t == "enum":
        _register(schema, named)
        buf += _zigzag_bytes(schema["symbols"].index(value))
    elif t == "fixed":
        _register(schema, named)
        buf += bytes(value)
    elif t == "array":
        items = list(value or ())
        if items:
            buf += _zigzag_bytes(len(items))
            for it in items:
                _encode(buf, schema["items"], it, named)
        buf += _zigzag_bytes(0)
    elif t == "map":
        entries = dict(value or {})
        if entries:
            buf += _zigzag_bytes(len(entries))
            for k, v in entries.items():
                kb = str(k).encode("utf-8")
                buf += _zigzag_bytes(len(kb)) + kb
                _encode(buf, schema["values"], v, named)
        buf += _zigzag_bytes(0)
    else:
        _encode(buf, t, value, named)


def _union_matches(branch: Any, value: Any, strict: bool = True) -> bool:
    if branch == "null":
        return value is None
    if value is None:
        return False
    if branch == "boolean":
        return isinstance(value, bool)
    if branch in ("int", "long"):
        return isinstance(value, int) and not isinstance(value, bool)
    if branch in ("float", "double"):
        return isinstance(value, (int, float)) and not isinstance(value, bool)
    if branch == "string":
        if strict:
            return isinstance(value, str)
        # lenient pass: the stringify-anything escape hatch — better a
        # str()'d value than a torn container when a post-schema-lock
        # streaming batch surprises the inferred union
        return not isinstance(value, (bytes, bytearray))
    if branch == "bytes":
        return isinstance(value, (bytes, bytearray))
    if isinstance(branch, dict):
        t = branch.get("type")
        if t == "array":
            return isinstance(value, (list, tuple))
        if t in ("map", "record"):
            return isinstance(value, dict)
    return True


def _infer_value_schema(values: List[Any]) -> Any:
    """ALWAYS-nullable union schema for one field's observed values.

    Unconditional nullability (and a long+double pair for numerics) keeps
    a schema inferred from the FIRST streaming batch valid for later
    batches whose null pattern or int/float flavor differs — the sink
    locks the container schema at the first block. Collection element
    schemas are unions too, so None elements inside lists/maps encode.
    All-None fields get a catch-all branch set."""
    present = [v for v in values if v is not None]
    if not present:
        return ["null", "long", "double", "string"]
    # every union keeps a trailing "string" branch: the schema locks at
    # the first block, and the lenient stringify-anything escape hatch
    # (_union_matches strict=False) can only fire if the branch exists —
    # without it a later batch whose value type surprises the union
    # aborts the score output
    if all(isinstance(p, bool) for p in present):
        return ["null", "boolean", "string"]
    if all(isinstance(p, (int, float)) and not isinstance(p, bool)
           for p in present):
        return ["null", "long", "double", "string"]
    if all(isinstance(p, (bytes, bytearray)) for p in present):
        return ["null", "bytes", "string"]
    if all(isinstance(p, dict) for p in present):
        inner = _infer_value_schema(
            [x for p in present for x in p.values()])
        return ["null", {"type": "map", "values": inner}, "string"]
    if all(isinstance(p, (list, tuple, set, frozenset)) for p in present):
        inner = _infer_value_schema([x for p in present for x in p])
        return ["null", {"type": "array", "items": inner}, "string"]
    return ["null", "string"]


def infer_avro_schema(records: List[Dict[str, Any]],
                      name: str = "ScoreRecord") -> Dict[str, Any]:
    """Record schema from score rows (field order = first-seen order)."""
    fields: List[str] = []
    for r in records:
        for k in r:
            if k not in fields:
                fields.append(k)
    return {"type": "record", "name": name,
            "fields": [{"name": f,
                        "type": _infer_value_schema(
                            [r.get(f) for r in records])}
                       for f in fields]}


class AvroWriter:
    """Streaming Avro container writer (null/deflate codecs).

    Header (magic + metadata + sync marker) goes out on construction;
    each :meth:`append` emits one sync-delimited block, so the sink can
    stream scoring batches without holding the dataset (the
    StreamingScore regime)."""

    def __init__(self, path: str, schema: Dict[str, Any],
                 codec: str = "deflate"):
        import os as _os
        import secrets

        if codec not in ("null", "deflate"):
            raise AvroDecodeError(f"Unsupported avro codec {codec!r}")
        self.schema = schema
        self.codec = codec
        self._named: Dict[str, Any] = {}
        self._sync = secrets.token_bytes(16)
        d = _os.path.dirname(path)
        if d:
            _os.makedirs(d, exist_ok=True)
        self._fh = open(path, "wb")
        header = bytearray(_MAGIC)
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        header += _zigzag_bytes(len(meta))
        for k, v in meta.items():
            kb = k.encode()
            header += _zigzag_bytes(len(kb)) + kb
            header += _zigzag_bytes(len(v)) + v
        header += _zigzag_bytes(0)
        header += self._sync
        self._fh.write(bytes(header))

    def append(self, records: List[Dict[str, Any]]) -> None:
        if not records:
            return
        buf = bytearray()
        for r in records:
            _encode(buf, self.schema, r, self._named)
        block = bytes(buf)
        if self.codec == "deflate":
            co = zlib.compressobj(wbits=-15)
            block = co.compress(block) + co.flush()
        out = bytearray()
        out += _zigzag_bytes(len(records))
        out += _zigzag_bytes(len(block))
        out += block
        out += self._sync
        self._fh.write(bytes(out))

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def write_avro_records(path: str, records: List[Dict[str, Any]],
                       schema: Optional[Dict[str, Any]] = None,
                       codec: str = "deflate") -> None:
    """One-shot counterpart of :func:`read_avro_records`."""
    w = AvroWriter(path, schema or infer_avro_schema(records), codec)
    try:
        w.append(records)
    finally:
        w.close()
