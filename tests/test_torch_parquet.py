"""The port's parquet codec (`sml_tpu_torch/frame/parquet/`, with its
snappy in `csrc/snappy.cc`) against pyarrow and the live JAX package,
on the CPU.

- snappy: the port's streams decompress in pyarrow, pyarrow's in the
  port, byte for byte; repeated text shrinks.
- Round trips of random frames with NULLs in every type (hypothesis,
  derandomized so that every run draws the same frames): through the
  port's writer and pyarrow's reader, and through pyarrow's writer and
  the port's reader. Values compare value for value, NULL
  positions equal, floats bit for bit (a vector's elements after the
  f32 rounding both packages write).
- Files pyarrow writes in the shapes a reader breaks on: several data
  pages a column chunk, a dictionary page whose data pages fall back to
  PLAIN, data page v2, several row groups, an all-NULL column, an empty
  file, SNAPPY / GZIP / NONE; ZSTD is refused by name.
- The JAX package's files: the port reads its part files partition for
  partition (`read.parquet`), the JAX package reads the port's, and
  pyarrow reads the port's clean Airbnb and MovieLens files to the
  Arrow schema of the JAX package's.
- `read_parquet_chunks` streams the rows of a file in `read.parquet`'s
  order across row groups; `partitionBy` and `append` lay files out as
  the JAX package does.
"""

import glob
import os

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sml_tpu_torch.courseware import (make_airbnb_dataset,
                                      make_movielens_dataset)
from sml_tpu_torch.frame import parquet as P
from sml_tpu_torch.frame.column import object_array
from sml_tpu_torch.frame.io import read_parquet_chunks
from sml_tpu_torch.frame.session import get_session
from sml_tpu_torch.native import snappy

from test_torch_frame_sql import assert_same_frame


@pytest.fixture(scope="module")
def psession():
    return get_session()


# ------------------------------------------------------------------ snappy
def _snappy_inputs():
    rng = np.random.default_rng(0)
    return {
        "empty": b"",
        "one": b"a",
        "repeat": b"abcd" * 5000,
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "text": b",".join(r.encode() for r in make_airbnb_dataset(
            n=3000)["neighbourhood_cleansed"]),
        "low_entropy": rng.integers(0, 4, 300_000, dtype=np.uint8).tobytes(),
        "long_match": b"x" * 200_000 + b"y" + b"x" * 70,
    }


@pytest.mark.parametrize("name", list(_snappy_inputs()))
def test_snappy_streams_cross_with_pyarrow(name):
    data = _snappy_inputs()[name]
    ours = snappy.compress(data)
    assert pa.decompress(ours, decompressed_size=len(data),
                         codec="snappy").to_pybytes() == data
    theirs = pa.compress(data, codec="snappy", asbytes=True)
    assert snappy.decompress(theirs) == data
    assert snappy.decompress(ours) == data


def test_snappy_compresses_repeated_text_and_refuses_corrupt_streams():
    data = _snappy_inputs()["text"]
    assert len(snappy.compress(data)) < len(data) / 3
    z = bytearray(snappy.compress(data))
    z[len(z) // 2] ^= 0xFF
    z = bytes(z[:len(z) - 7])
    with pytest.raises(ValueError, match="snappy"):
        snappy.decompress(z)


# ------------------------------------------------------- random round trips
def _random_block(seed: int, n: int):
    """A frame of every column type the port writes, NULLs in each."""
    rng = np.random.default_rng(seed)
    nul = rng.random((8, n)) < 0.2
    f = rng.normal(size=n) * 10.0 ** rng.integers(-5, 6, n)
    f[nul[0]] = np.nan
    words = ["", "a", "é", "naïve text", "x" * 70, "Mission Bay", "🙂"]
    s = object_array([None if nul[1][i] else
                      words[rng.integers(len(words))] + str(rng.integers(9))
                      for i in range(n)])
    b = object_array([None if nul[2][i] else bool(rng.random() < .5)
                      for i in range(n)])
    t = np.datetime64("1999-12-31T23:59:59", "us") + \
        rng.integers(-10 ** 15, 10 ** 15, n).astype("timedelta64[us]")
    t[nul[3]] = np.datetime64("NaT")
    d = np.datetime64("2001-01-01", "D") + \
        rng.integers(-40_000, 40_000, n).astype("timedelta64[D]")
    d[nul[4]] = np.datetime64("NaT")
    v = rng.normal(size=(n, 3))
    v[nul[5]] = np.nan
    f32 = rng.normal(size=n).astype(np.float32)
    f32[nul[6]] = np.nan
    return {"f": f, "s": s, "b": b, "t": t, "d": d, "v": v, "f32": f32,
            "i": rng.integers(-2 ** 62, 2 ** 62, n),
            "i32": rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32),
            "flag": rng.random(n) < 0.5,
            "u16": rng.integers(0, 2 ** 16, n).astype(np.uint16),
            "u32": rng.integers(0, 2 ** 32, n).astype(np.uint32),
            "i8": rng.integers(-128, 128, n).astype(np.int8),
            "none": object_array([None] * n)}


def _arrow_of(block):
    """pyarrow's table of the same values (NULLs as nulls)."""
    cols = {}
    for c, v in block.items():
        if v.ndim == 2:
            cols[c] = pa.array([None if np.isnan(r).all() else
                                list(r.astype(np.float32)) for r in v],
                               type=pa.list_(pa.float32()))
        elif v.dtype.kind == "f":
            cols[c] = pa.array(v, mask=np.isnan(v))
        elif v.dtype.kind == "M":
            cols[c] = pa.array(v, mask=np.isnat(v))
        elif c == "none":
            cols[c] = pa.nulls(len(v))
        else:
            cols[c] = pa.array(v.tolist() if v.dtype.kind == "O" else v)
    return pa.table(cols)


def _assert_block_equals(got, want):
    """Value for value: NULLs in the same rows, floats bit for bit."""
    assert list(got) == list(want)
    for c, w in want.items():
        g = got[c]
        if w.ndim == 2 and np.isnan(w).all():  # no row carries a width
            assert g.shape[0] == w.shape[0] and np.isnan(g).all(), c
        elif w.ndim == 2:
            w = w.astype(np.float32).astype(np.float64)
            assert g.shape == w.shape, c
            assert np.array_equal(g.view(np.int64), w.view(np.int64)) or \
                np.array_equal(np.isnan(g), np.isnan(w)) and np.array_equal(
                    g[~np.isnan(g)].view(np.int64),
                    w[~np.isnan(w)].view(np.int64)), c
        elif w.dtype.kind in "fiubM":
            assert g.dtype == w.dtype, (c, g.dtype, w.dtype)
            view = {8: np.int64, 4: np.int32, 2: np.int16,
                    1: np.int8}[w.dtype.itemsize]
            assert np.array_equal(g.view(view), w.view(view)), c
        else:  # an object column; booleans without a NULL read as bool
            assert g.dtype.kind == "O" or (
                g.dtype.kind == "b" and None not in w.tolist()), c
            assert g.tolist() == w.tolist(), c


def _assert_arrow_equals(table: pa.Table, block):
    """pyarrow's read of a port file: the same values, nulls where the
    frame has NULL."""
    for c, w in block.items():
        got = table.column(c).to_pylist()
        if w.ndim == 2:
            want = [None if np.isnan(r).all() else
                    r.astype(np.float32).tolist() for r in w]
            assert got == want, c
        elif w.dtype.kind == "f":
            want = [None if np.isnan(x) else x for x in w.tolist()]
            assert got == want, c
            if w.dtype.itemsize == 8:
                arr = table.column(c).to_numpy(zero_copy_only=False)
                ok = ~np.isnan(w)
                assert np.array_equal(arr[ok].view(np.int64),
                                      w[ok].view(np.int64)), c
        elif w.dtype.kind == "M":
            unit = np.datetime_data(w.dtype)[0]
            want = [None if np.isnat(x) else x for x in w]
            got = [None if x is None else np.datetime64(
                pd.Timestamp(x).to_datetime64(), unit) for x in got]
            assert got == want, c
        else:
            assert got == w.tolist(), c


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(0, 60))
def test_port_writer_pyarrow_reader(tmp_path_factory, seed, n):
    block = _random_block(seed, n)
    path = str(tmp_path_factory.mktemp("w") / "x.parquet")
    P.write_table(block, path)
    _assert_arrow_equals(pq.read_table(path), block)
    _assert_block_equals(P.read_table(path), block)


@settings(max_examples=25, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(seed=st.integers(0, 2 ** 32 - 1), n=st.integers(0, 60),
       dictionary=st.booleans(), version=st.sampled_from(["1.0", "2.0"]))
def test_pyarrow_writer_port_reader(tmp_path_factory, seed, n, dictionary,
                                    version):
    block = _random_block(seed, n)
    path = str(tmp_path_factory.mktemp("r") / "x.parquet")
    pq.write_table(_arrow_of(block), path, use_dictionary=dictionary,
                   data_page_version=version)
    _assert_block_equals(P.read_table(path), block)


# -------------------------------------------------- pyarrow's file shapes
def _shapes_table(n=4000):
    rng = np.random.default_rng(3)
    text = object_array([f"row {i} " + "y" * int(rng.integers(0, 40))
                         for i in range(n)])
    text[rng.random(n) < 0.1] = None
    cat = object_array(rng.choice(["a", "bb", "ccc"], n).tolist())
    x = rng.normal(size=n)
    x[rng.random(n) < 0.1] = np.nan
    return {"text": text, "cat": cat, "x": x,
            "k": rng.integers(0, 7, n), "all_null": object_array([None] * n)}


SHAPES = {
    # 1: several data pages in a column chunk
    "many_pages": dict(data_page_size=1024),
    # 2: a dictionary page, dictionary pages' data, then PLAIN fallback
    "dictionary_fallback": dict(dictionary_pagesize_limit=512,
                                data_page_size=1024),
    # 3: data page v2 (levels uncompressed before compressed values)
    "page_v2": dict(data_page_version="2.0", data_page_size=2048),
    # 4: several row groups
    "row_groups": dict(row_group_size=700),
    "plain_gzip": dict(use_dictionary=False, compression="gzip"),
    "none": dict(compression="none"),
    "v2_gzip_groups": dict(data_page_version="2.0", compression="gzip",
                           row_group_size=1500, data_page_size=700),
}


@pytest.mark.parametrize("shape", list(SHAPES))
def test_port_reads_the_files_pyarrow_writes(tmp_path, shape):
    block = _shapes_table()
    path = str(tmp_path / "x.parquet")
    pq.write_table(_arrow_of(block), path, **SHAPES[shape])
    meta = pq.ParquetFile(path).metadata
    col = meta.row_group(0).column(0)  # text
    if shape == "many_pages":
        assert col.total_uncompressed_size > 4 * 1024
    if shape == "dictionary_fallback":
        assert col.has_dictionary_page and "PLAIN" in col.encodings
        assert col.dictionary_page_offset < col.data_page_offset
    if shape.startswith("row_groups") or shape == "v2_gzip_groups":
        assert meta.num_row_groups > 1
    _assert_block_equals(P.read_table(path), block)
    # the row groups one at a time give the same rows
    pf = P.ParquetFile(path)
    assert len(pf.row_groups) == meta.num_row_groups
    parts = [pf.read_row_group(i) for i in range(len(pf.row_groups))]
    np.testing.assert_array_equal(np.concatenate([p["k"] for p in parts]),
                                  block["k"])


def test_empty_file_and_a_refused_codec(tmp_path):
    block = {c: v[:0] for c, v in _shapes_table().items()}
    path = str(tmp_path / "empty.parquet")
    pq.write_table(_arrow_of(block), path)
    got = P.read_table(path)
    assert list(got) == list(block) and all(len(v) == 0 for v in got.values())
    P.write_table(block, str(tmp_path / "port_empty.parquet"))
    assert pq.read_table(str(tmp_path / "port_empty.parquet")).num_rows == 0
    pq.write_table(_arrow_of(_shapes_table(50)), str(tmp_path / "z.parquet"),
                   compression="zstd")
    with pytest.raises(NotImplementedError, match="ZSTD"):
        P.read_table(str(tmp_path / "z.parquet"))


@pytest.mark.parametrize("groups", [1, 2, 3])
def test_pyarrow_reads_the_row_groups_the_port_writes(tmp_path, monkeypatch,
                                                      groups):
    block = _shapes_table(3000)
    monkeypatch.setattr(P, "ROW_GROUP_ROWS", -(-3000 // groups))
    path = str(tmp_path / "x.parquet")
    P.write_table(block, path)
    meta = pq.ParquetFile(path).metadata
    assert meta.num_row_groups == groups
    assert {meta.row_group(g).column(c).compression
            for g in range(groups) for c in range(len(block))} == {"SNAPPY"}
    _assert_arrow_equals(pq.read_table(path), block)
    _assert_block_equals(P.read_table(path), block)


def test_compressed_airbnb_text_is_smaller_than_uncompressed(tmp_path):
    """The footer's compressed size of each text column against its
    uncompressed size (the pages' bytes before snappy), as pyarrow
    reads them."""
    a = make_airbnb_dataset(n=10_000)
    text = {c: v for c, v in a.items() if v.dtype.kind == "O"}
    path = str(tmp_path / "text.parquet")
    P.write_table(text, path)
    rg = pq.ParquetFile(path).metadata.row_group(0)
    cols = [rg.column(i) for i in range(rg.num_columns)]
    sizes = {"snappy": sum(c.total_compressed_size for c in cols),
             "none": sum(c.total_uncompressed_size for c in cols)}
    assert sizes["snappy"] < 0.5 * sizes["none"], sizes
    assert os.path.getsize(path) < 0.5 * sizes["none"], sizes


# ------------------------------------------------------ the JAX package
def _jax_frame(spark, block, parts=None):
    pdf = pd.DataFrame({c: (pd.Series(v, dtype=object) if v.dtype.kind == "O"
                            else v) for c, v in block.items()})
    return spark.createDataFrame(pdf, numPartitions=parts)


@pytest.mark.parametrize("which", ["airbnb", "movielens"])
def test_pyarrow_reads_port_files_to_the_jax_files_schema(spark, psession,
                                                          tmp_path, which):
    """The clean tables as `ClassroomSetup.install_datasets` writes them
    in each package (the JAX package's frames from its own generators, so
    text is pandas' `str`, which pyarrow writes as large_string)."""
    from sml_tpu import courseware as jcw
    if which == "airbnb":
        jpdf = jcw.make_airbnb_dataset(n=2000).dropna().reset_index(drop=True)
        block = psession.createDataFrame(
            make_airbnb_dataset(n=2000)).dropna()._whole()
    else:
        jpdf = jcw.make_movielens_dataset(200, 80, 3000)
        block = make_movielens_dataset(200, 80, 3000)
    spark.createDataFrame(jpdf).write.parquet(str(tmp_path / "jax"))
    psession.createDataFrame(block).write.parquet(str(tmp_path / "port"))
    jf = sorted(glob.glob(str(tmp_path / "jax" / "*.parquet")))
    pf = sorted(glob.glob(str(tmp_path / "port" / "*.parquet")))
    assert [os.path.basename(f) for f in jf] == \
        [os.path.basename(f) for f in pf]
    for j, p in zip(jf, pf):
        assert pq.read_table(p).schema.remove_metadata() == \
            pq.read_table(j).schema.remove_metadata()
        assert pq.read_table(p).equals(pq.read_table(j))


@pytest.mark.parametrize("parts", [1, 3, 8])
def test_the_packages_read_each_others_part_files(spark, psession,
                                                  tmp_path, parts):
    block = make_airbnb_dataset(n=900, seed=5)
    _jax_frame(spark, block, parts).write.parquet(str(tmp_path / "jax"))
    psession.createDataFrame(block, numPartitions=parts).write.parquet(
        str(tmp_path / "port"))
    for d in ("jax", "port"):
        assert_same_frame(spark.read.parquet(str(tmp_path / d)),
                          psession.read.parquet(str(tmp_path / d)))
    assert_same_frame(
        spark.read.format("parquet").load(str(tmp_path / "port")),
        psession.read.format("parquet").load(str(tmp_path / "jax")))


def test_append_numbering_partition_by_and_modes(spark, psession, tmp_path):
    block = make_airbnb_dataset(n=400, seed=9)
    cols = ["room_type", "bedrooms", "price", "instant_bookable"]
    small = {c: block[c] for c in cols}
    for pkg, df in (("jax", _jax_frame(spark, small, 2)),
                    ("port", psession.createDataFrame(small,
                                                      numPartitions=2))):
        df.write.parquet(str(tmp_path / pkg / "a"))
        df.write.mode("append").parquet(str(tmp_path / pkg / "a"))
        df.write.mode("ignore").parquet(str(tmp_path / pkg / "a"))
        with pytest.raises(FileExistsError):
            df.write.parquet(str(tmp_path / pkg / "a"))
        df.write.partitionBy("room_type", "instant_bookable").parquet(
            str(tmp_path / pkg / "p"))
    assert sorted(os.listdir(tmp_path / "jax" / "a")) == \
        sorted(os.listdir(tmp_path / "port" / "a"))
    assert_same_frame(spark.read.parquet(str(tmp_path / "jax" / "a")),
                      psession.read.parquet(str(tmp_path / "port" / "a")))
    for root in ("jax", "port"):
        dirs = sorted(os.path.relpath(r, tmp_path / root / "p")
                      for r, _, fs in os.walk(tmp_path / root / "p")
                      if any(f.endswith(".parquet") for f in fs))
        assert dirs == sorted(
            os.path.relpath(r, tmp_path / "jax" / "p")
            for r, _, fs in os.walk(tmp_path / "jax" / "p")
            if any(f.endswith(".parquet") for f in fs))
        assert "room_type=Private room/instant_bookable=t" in dirs
    for r, _, fs in os.walk(tmp_path / "port" / "p"):
        for f in fs:
            if f.endswith(".parquet"):
                rel = os.path.relpath(os.path.join(r, f), tmp_path / "port")
                jax_rows = pq.read_table(os.path.join(r, f)).num_rows
                assert P.ParquetFile(os.path.join(r, f)).num_rows == jax_rows
                assert "room_type" not in pq.read_table(
                    os.path.join(r, f)).column_names, rel


@pytest.mark.parametrize("chunk_rows", [64, 1000, 5000])
def test_parquet_chunks_stream_read_parquet_rows(psession, tmp_path,
                                                 chunk_rows):
    block = make_airbnb_dataset(n=3000, seed=2)
    num = ["bedrooms", "accommodates", "bathrooms", "latitude"]
    path = str(tmp_path / "c")
    psession.createDataFrame(block, numPartitions=3).write.parquet(path)
    # one file of several row groups too
    pq.write_table(_arrow_of(block),
                   str(tmp_path / "c" / "part-00003.snappy.parquet"),
                   row_group_size=700)
    src = read_parquet_chunks(path, num, "price", chunkRows=chunk_rows)
    got = list(src.chunks())
    assert all(len(X) <= chunk_rows for X, _ in got)
    whole = psession.read.parquet(path)._whole()
    X = np.concatenate([X for X, _ in got])
    y = np.concatenate([y for _, y in got])
    np.testing.assert_array_equal(X, np.column_stack([whole[c] for c in num]))
    np.testing.assert_array_equal(y, whole["price"])
    assert src.n_rows == len(whole["price"]) == 6000
    assert src.fingerprint()[0] == "parquet"
