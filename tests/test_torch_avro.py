"""The port's Avro codec (``transmogrifai_tpu_torch/readers/avro.py``)
against the JAX package's: files each package writes decode alike in the
other, by the Python decoder and by the columnar one; the columnar decode
equals the Python decoder bit for bit; layouts the strided decode cannot
verify fall back to it exactly; both codecs."""
import numpy as np
import pytest

from transmogrifai_tpu.readers import avro as JAV
from transmogrifai_tpu_torch.readers import avro as PAV


def _fixed(n=300, seed=3):
    """Fixed-stride records: doubles, booleans and an all-null field."""
    rng = np.random.default_rng(seed)
    return [{"label": float(i % 2), "flag": bool(i % 3 == 0), "gone": None,
             **{f"x{j}": float(v) for j, v in enumerate(rng.normal(size=4))}}
            for i in range(n)]


def _mixed(n=120, seed=4):
    """Every kind the schema subset has: longs, strings, nulls in a
    varying branch, lists, maps and nested maps."""
    rng = np.random.default_rng(seed)
    return [{"id": int(i), "name": f"r{i}" if i % 5 else None,
             "x": float(rng.normal()) if i % 4 else None,
             "ok": bool(rng.random() < 0.5),
             "tags": [f"t{int(t)}" for t in rng.integers(0, 5, i % 3)],
             "m": {"a": float(rng.normal()), "b": None} if i % 2 else {},
             "raw": bytes([i % 256, 7])}
            for i in range(n)]


DATA = {"fixed": _fixed, "mixed": _mixed}


def _both_ways(mod, path):
    return mod.read_avro_records(path), mod.read_avro_table(path)


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("data", sorted(DATA))
def test_jax_written_files_decode_in_the_port(tmp_path, data, codec):
    recs = DATA[data]()
    fp = str(tmp_path / "j.avro")
    JAV.write_avro_records(fp, recs, codec=codec)
    want = JAV.read_avro_records(fp)
    rows, table = _both_ways(PAV, fp)
    assert rows == want
    assert list(table) == want
    assert isinstance(table, PAV.ColumnarRecords) == (data == "fixed")


@pytest.mark.parametrize("codec", ["deflate", "null"])
@pytest.mark.parametrize("data", sorted(DATA))
def test_port_written_files_decode_in_the_jax_package(tmp_path, data, codec):
    recs = DATA[data]()
    fp = str(tmp_path / "p.avro")
    PAV.write_avro_records(fp, recs, codec=codec)
    assert PAV.infer_avro_schema(recs) == JAV.infer_avro_schema(recs)
    want = PAV.read_avro_records(fp)
    assert JAV.read_avro_records(fp) == want
    assert list(JAV.read_avro_table(fp)) == want
    # the payload the JAX package writes, but for the random sync marker
    fj = str(tmp_path / "j.avro")
    JAV.write_avro_records(fj, recs, codec=codec)
    a, b = open(fp, "rb").read(), open(fj, "rb").read()
    # every block ends with the file's sync marker
    assert a.replace(a[-16:], bytes(16)) == b.replace(b[-16:], bytes(16))


def test_columnar_decode_is_bit_identical_to_the_python_decoder(tmp_path):
    recs = _fixed(257)
    fp = str(tmp_path / "t.avro")
    PAV.write_avro_records(fp, recs)
    tab, py = PAV.read_avro_table(fp), PAV.read_avro_records(fp)
    assert isinstance(tab, PAV.ColumnarRecords) and len(tab) == 257
    assert all(a == b for a, b in zip(tab, py))
    assert tab[0] == py[0] and tab[-1] == py[-1]
    # iterating consumers share one memoized dict materialization
    assert all(a is b for a, b in zip(tab, tab))
    for j in range(4):
        col = tab.columns[f"x{j}"]
        assert col.tobytes() == np.array([r[f"x{j}"] for r in py]).tobytes()
    assert tab.null_fields == {"gone"}
    # a multi-block container merges its blocks
    fp2 = str(tmp_path / "m.avro")
    w = PAV.AvroWriter(fp2, PAV.infer_avro_schema(recs))
    w.append(recs[:100])
    w.append(recs[100:])
    w.close()
    tab2 = PAV.read_avro_table(fp2)
    assert isinstance(tab2, PAV.ColumnarRecords) and list(tab2) == py


@pytest.mark.parametrize("poison", ["string", "int", "mixed_null"])
def test_unverifiable_layouts_fall_back_exactly(tmp_path, poison):
    """Variable-width strings, varint longs and a union whose branch
    varies row to row decode through the Python decoder — the records
    the JAX package's fallback gives."""
    if poison == "string":
        recs = [{"a": float(i), "s": f"r{i}"} for i in range(50)]
    elif poison == "int":
        recs = [{"a": i, "b": float(i)} for i in range(50)]
    else:
        recs = [{"a": None if i % 2 else 1.5} for i in range(50)]
    fp = str(tmp_path / "p.avro")
    PAV.write_avro_records(fp, recs)
    got = PAV.read_avro_table(fp)
    assert isinstance(got, list)
    assert got == PAV.read_avro_records(fp) == JAV.read_avro_table(fp)


def test_a_corrupt_container_raises_the_decode_error(tmp_path):
    fp = str(tmp_path / "c.avro")
    PAV.write_avro_records(fp, _fixed(40))
    data = open(fp, "rb").read()
    open(fp, "wb").write(data[:len(data) - 30])
    for read in (PAV.read_avro_records, PAV.read_avro_table):
        with pytest.raises(PAV.AvroDecodeError, match="c.avro"):
            read(fp)
    open(fp, "wb").write(b"not avro")
    with pytest.raises(PAV.AvroDecodeError, match="not an Avro"):
        PAV.read_avro_records(fp)
