"""The port's C++ host text library (``kf2vecfsw_tpu_torch/io/native``) against
its plain Python versions and the JAX package.

Every formatter must write the bytes of its plain version (repr(float),
str(np.float32), "<int>.0") on random rows and on the edge values: NaN,
+-inf, -0.0, subnormals, the switch points between fixed and scientific
notation (1e16, 1e-4, 1e-5) and the int64 extremes. The parsers must read
the values Python reads; ragged and malformed tables take the row-by-row
route with the JAX package's result or error. The files the port writes
through them (`.kf`, `.di_mtrx`, chunk `.kf` rows, APPLES and `.emb` rows)
must equal the JAX package's byte for byte."""

import io
import os

import numpy as np
import pytest

from kf2vecfsw_tpu.io import kf as jax_kf
from kf2vecfsw_tpu.train.distance import f32_row as jax_f32_row
from kf2vecfsw_tpu.tree import distance as jax_tree_distance
from kf2vecfsw_tpu_torch.infer.query import read_embeddings_csv, read_embeddings_csv_plain
from kf2vecfsw_tpu_torch.io import kf
from kf2vecfsw_tpu_torch.io.fasta import encode_bases, encode_bases_plain
from kf2vecfsw_tpu_torch.io.native import lib
from kf2vecfsw_tpu_torch.train.distance import f32_row, f32_row_plain
from kf2vecfsw_tpu_torch.tree import distance as tree_distance

F64_EDGES = np.array([
    0.0, -0.0, np.nan, np.inf, -np.inf, 1.0, -1.5, 5e-324, -5e-324, 2.2250738585072014e-308,
    2.225073858507201e-308, 1e16, np.nextafter(1e16, 0), -1e16, 9999999999999998.0, 1e-4,
    np.nextafter(1e-4, 0), 9.999999999999999e-5, 1e-5, np.nextafter(1e-5, 1), 1.7976931348623157e308,
    0.1, 1 / 3, 123456789012345.67, 1e15, 1e15 + 0.5,
])
F32_EDGES = np.array([
    0.0, -0.0, np.nan, np.inf, -np.inf, 1e-45, -1e-45, 1.1754942e-38, 1.1754944e-38, 1e16,
    np.nextafter(np.float32(1e16), np.float32(0)), 9.9999996e15, 1.00000003e16, 1e-4,
    np.nextafter(np.float32(1e-4), np.float32(0)), 1e-5, np.nextafter(np.float32(1e-5), np.float32(1)),
    3.4028235e38, -3.4028235e38, 0.1, 16777217.0,
], dtype=np.float32)


@pytest.fixture(scope="module")
def textio():
    return lib.load()


def _random_f64(seed):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.random(2000) * s * sign for s in (1e-300, 1e-5, 1e-4, 1.0, 1e15, 1e16, 1e300)
                           for sign in (1, -1)])


@pytest.mark.parametrize("sep", [",", "\t"])
@pytest.mark.parametrize("case", ["random", "edges"])
def test_format_doubles_is_repr(textio, sep, case):
    vals = _random_f64(1) if case == "random" else F64_EDGES
    assert textio.format_doubles(vals, sep=sep) == sep.join(map(repr, vals.tolist())) + "\n"


@pytest.mark.parametrize("case", ["random", "edges"])
def test_format_floats_is_str_float32(textio, case):
    if case == "random":
        vals = np.concatenate([(np.random.default_rng(2).random(2000) * s * sign).astype(np.float32)
                               for s in (1e-38, 1e-4, 1.0, 1e15, 1e16, 1e38) for sign in (1, -1)])
    else:
        vals = F32_EDGES
    want = "\t".join(str(v) for v in vals) + "\n"
    assert textio.format_floats(vals) == want
    assert f32_row(vals) == f32_row_plain(vals) == jax_f32_row(vals) == want
    assert f32_row(vals.astype(np.float64), sep=",") == f32_row_plain(vals, sep=",")


def test_format_counts_int64_extremes(textio):
    rng = np.random.default_rng(3)
    vals = np.concatenate([np.array([0, -1, 1, 2**63 - 1, -(2**63), 10**18, -(10**18)], np.int64),
                           rng.integers(-(2**62), 2**62, 1000)])
    assert textio.format_counts(vals) == ".0,".join(map(str, vals.tolist())) + ".0\n"
    assert textio.format_counts(np.zeros(0, np.int64)) == "\n"


@pytest.mark.parametrize("case", ["integral", "frequencies", "edges", "large_integral"])
def test_append_kf_bytes_equal_plain_and_jax(case):
    rng = np.random.default_rng(4)
    values = {
        "integral": rng.integers(0, 5000, 512).astype(np.float64),  # chunk rows, raw counts
        "frequencies": rng.random(512) / 512,
        "edges": F64_EDGES,
        "large_integral": np.array([1e15, 2.0, -3.0]),  # past the counts route's 1e15 gate
    }[case]
    outs = []
    for append in (kf.append_kf, kf.append_kf_plain, jax_kf.append_kf):
        buf = io.StringIO()
        append(buf, "genome_1", values)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] == outs[2]


def test_encode_every_byte(textio):
    data = bytes(range(256)) * 3
    assert np.array_equal(encode_bases(data), encode_bases_plain(data))
    arr = np.frombuffer(b"ACGTNacgtn-", np.uint8)
    assert np.array_equal(encode_bases(arr), [0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 4])


def test_parse_doubles_reads_python_values(textio):
    vals = np.concatenate([_random_f64(5), F64_EDGES[~np.isnan(F64_EDGES)]])
    text = ",".join(map(repr, vals.tolist()))
    got = textio.parse_doubles(text.encode())
    assert np.array_equal(got, np.array([float(t) for t in text.split(",")]))
    assert np.array_equal(np.signbit(got), np.signbit(vals))
    assert textio.parse_doubles(b"1.0,abc") is None
    assert textio.parse_doubles(b"1.0,2.0", expect=3) is None


def _kf_text(rows):
    return "".join(name + "," + ",".join(map(repr, v.tolist())) + "\n" for name, v in rows)


def test_read_kf_equals_plain_and_jax(tmp_path):
    rng = np.random.default_rng(6)
    rows = [(f"g{i}", rng.random(64) * 10.0 ** rng.integers(-8, 8)) for i in range(5)]
    rows.append(("edges", np.resize(F64_EDGES[~np.isnan(F64_EDGES)], 64)))
    paths = []
    for i in range(3):
        p = tmp_path / f"f{i}.kf"
        p.write_text(_kf_text(rows[2 * i: 2 * i + 2]))
        paths.append(str(p))
    # a file without its last newline joins the table all the same
    paths.append(str(tmp_path / "nonl.kf"))
    (tmp_path / "nonl.kf").write_text(_kf_text(rows[:1])[:-1])
    for dtype in (np.float64, np.float32):
        got = kf.read_kf(paths[0], dtype=dtype)
        for other in (kf.read_kf_plain(paths[0], dtype=dtype), jax_kf.read_kf(paths[0], dtype=dtype)):
            assert got[0] == other[0] and got[1].dtype == other[1].dtype
            assert np.array_equal(got[1], other[1])
        got = kf.read_kf_files(paths, dtype=dtype)
        for other in (kf.read_kf_files_plain(paths, dtype=dtype),
                      jax_kf.read_kf_files(paths, dtype=dtype)):
            assert got[0] == other[0] and np.array_equal(got[1], other[1])
    assert got[1].shape == (7, 64)


@pytest.mark.parametrize("text, error", [
    ("a,1.0,2.0\nb,3.0\n", ValueError),  # ragged
    ("a,1.0,abc\n", ValueError),  # malformed token
    ("a,1.0,2.0\nb,3.0,4.0\n\n", None),  # blank lines are skipped
    ("a,+1.0,2.0\n", None),  # refused by the table parser, read by Python
    ("a,1e400,2.0\n", None),  # out of range: inf, as Python reads it
])
def test_refused_tables_take_the_row_route(tmp_path, textio, text, error):
    p = tmp_path / "x.kf"
    p.write_text(text)
    assert textio.parse_table(text.encode()) is None or error is None
    if error is not None:
        for read in (kf.read_kf, kf.read_kf_plain, jax_kf.read_kf):
            with pytest.raises(error):
                read(str(p))
        with pytest.raises(error):
            kf.read_kf_files([str(p), str(p)])
        return
    got = kf.read_kf(str(p))
    for other in (kf.read_kf_plain(str(p)), jax_kf.read_kf(str(p))):
        assert got[0] == other[0] and np.array_equal(got[1], other[1])


def test_di_mtrx_bytes_and_values_equal_plain_and_jax(tmp_path):
    rng = np.random.default_rng(7)
    labels = [f"leaf_{i}" for i in range(12)]
    d = rng.random((12, 12)) * 10.0 ** rng.integers(-6, 6, (12, 1))
    d[0] = np.resize(F64_EDGES[~np.isnan(F64_EDGES)], 12)
    files = {}
    for tag, write in (("port", tree_distance.write_di_mtrx), ("plain", tree_distance.write_di_mtrx_plain),
                       ("jax", jax_tree_distance.write_di_mtrx)):
        files[tag] = tmp_path / f"{tag}.di_mtrx"
        write(str(files[tag]), labels, d)
    assert files["port"].read_bytes() == files["plain"].read_bytes() == files["jax"].read_bytes()
    got = tree_distance.read_di_mtrx(str(files["port"]))
    for other in (tree_distance.read_di_mtrx_plain(str(files["port"])),
                  jax_tree_distance.read_di_mtrx(str(files["port"]))):
        assert got[0] == other[0] and got[1] == other[1] and np.array_equal(got[2], other[2])
    assert np.array_equal(got[2], d)
    # a body narrower than its header is read row by row, as in the JAX package
    bad = tmp_path / "narrow.di_mtrx"
    bad.write_text("\ta\tb\na\t0.0\nb\t1.0\n")
    assert np.array_equal(tree_distance.read_di_mtrx(str(bad))[2], jax_tree_distance.read_di_mtrx(str(bad))[2])


@pytest.mark.parametrize("case", ["f32_row", "float64_repr", "commas"])
def test_read_embeddings_csv_float32_equals_jax_parser(tmp_path, case):
    """Table parse (float64, then rounded) against np.array(parts,
    dtype=np.float32), on f32_row text, on float64 repr text of float32
    values (as some writers give) and on names that hold a comma."""
    rng = np.random.default_rng(8)
    rows = [rng.normal(size=16).astype(np.float32) * 10.0 ** rng.integers(-30, 30) for _ in range(9)]
    rows.append(np.resize(F32_EDGES, 16))
    p = tmp_path / "embeddings_subtree_0.csv"
    with open(p, "w") as f:
        for i, row in enumerate(rows):
            name = f"g,{i}" if case == "commas" else f"g{i}"
            if case == "float64_repr":
                f.write(name + "\t" + "\t".join(map(str, row.astype(np.float64).tolist())) + "\n")
            else:
                f.write(name + "\t" + f32_row(row))
    names, got = read_embeddings_csv(str(p))
    ref_names, ref = read_embeddings_csv_plain(str(p))
    assert names == ref_names and got.dtype == ref.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))  # bit for bit, NaN and -0.0 too


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "textio.cpp"
    broken.write_text("int f( {\n")
    monkeypatch.setattr(lib, "SOURCE", broken)
    monkeypatch.setattr(lib, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="build failed"):
        lib.build()
    assert not any(p.name.endswith(".so") for p in (tmp_path / "build").iterdir())


def test_the_library_is_built_into_the_ignored_directory():
    path = lib.build()
    assert path.parent == lib.BUILD_DIR and path.parent.name == "build"
    assert path.name.startswith("libtextio-") and path.suffix == ".so"
    assert os.path.exists(path)
