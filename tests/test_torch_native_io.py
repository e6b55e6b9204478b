"""The port's C++ TSV readers against the JAX package's.

- On the golden spec (tests/test_golden_e2e.py's) and the ``medium``
  scale, the port's native expression reader gives arrays byte-equal to
  ``g2vec_tpu.native.bindings.read_expression``'s and to the port's
  Python reader's, CRLF line ends and trailing blank lines included.
- Malformed files raise ``ValueError`` naming ``file:line``.
- A library that cannot be built or loaded warns once and falls back to
  the Python parser; ``use_native=False`` never touches the library.
- The native network reader gives the port's Python parser's names and
  id arrays and ``g2vec_tpu.io.readers.load_network``'s edges and genes,
  on synthetic networks and on the text-mode edge cases; where it cannot
  show that (a bare \r, Unicode whitespace, bytes that are not UTF-8, a
  malformed row) the Python parser reads the file, so every answer and
  every error is the Python reader's.
- ``preprocess_inputs`` gives the same bytes from either parser.
"""
import warnings

import numpy as np
import pytest

from g2vec_tpu import preprocess as jprep
from g2vec_tpu.io import readers as jreaders
from g2vec_tpu.native import bindings as jax_native
from g2vec_tpu_torch.data.synthetic import (SCALES, SyntheticSpec,
                                            write_synthetic_tsv)
from g2vec_tpu_torch.io import readers
from g2vec_tpu_torch.native import tsv_bindings
from g2vec_tpu_torch.pipeline import preprocess_inputs

pytestmark = pytest.mark.torch

GOLDEN = SyntheticSpec(n_good=24, n_poor=20, module_size=12, n_background=24,
                       n_expr_only=4, n_net_only=4, module_chords=2,
                       background_edges=40, seed=7)


def _assert_same(data, samples, genes, expr):
    assert data.sample.tolist() == samples.tolist()
    assert data.gene.tolist() == genes.tolist()
    assert data.expr.dtype == np.float32 and data.expr.shape == expr.shape
    assert data.expr.tobytes() == expr.tobytes()


@pytest.mark.parametrize("spec", [GOLDEN, SCALES["medium"]],
                         ids=["golden", "medium"])
def test_native_reader_is_byte_equal_to_reference_and_python(spec, tmp_path):
    path = write_synthetic_tsv(spec, str(tmp_path))["expression"]
    native = readers.load_expression(path)
    assert native.parser == "native"
    _assert_same(native, *jax_native.read_expression(path))
    python = readers.load_expression(path, use_native=False)
    assert python.parser == "python"
    _assert_same(native, python.sample, python.gene, python.expr)


def test_crlf_and_trailing_blank_lines(tmp_path):
    path = tmp_path / "crlf.txt"
    path.write_bytes(b"PATIENT\ts1\ts2 \r\nG1\t1.5\t-2e-3\r\n"
                     b"G2\t0\t7\t\r\n\r\n\n")
    native = readers.load_expression(str(path))
    _assert_same(native, *jax_native.read_expression(str(path)))
    python = readers.load_expression(str(path), use_native=False)
    _assert_same(native, python.sample, python.gene, python.expr)


@pytest.mark.parametrize("body,line,what", [
    ("PATIENT\ta\tb\nG1\t1\t2\nG2\t1\nG3\t1\t2\n", 3, "has 1 values"),
    ("PATIENT\ta\tb\nG1\t1\tx\n", 2, "non-numeric"),
    ("PATIENT\ta\tb\nG1\t1\t2\nG2\t1\t2\t3\n", 3, "has 3 values"),
    ("PATIENT\ta\tb\n", None, "at least one gene row"),
])
def test_malformed_files_name_file_and_line(tmp_path, body, line, what):
    path = tmp_path / "bad.txt"
    path.write_text(body)
    where = f"{path}:{line}:" if line else f"{path}:"
    with pytest.raises(ValueError, match=what) as err:
        readers.load_expression(str(path))
    assert str(err.value).startswith(where)


def test_unloadable_library_warns_once_and_falls_back(tmp_path, monkeypatch):
    path = write_synthetic_tsv(GOLDEN, str(tmp_path))["expression"]

    def unavailable(p):
        raise RuntimeError("build failed: g++ not found")

    monkeypatch.setattr(tsv_bindings, "read_expression", unavailable)
    monkeypatch.setattr(readers, "_warned_native", False)
    with pytest.warns(RuntimeWarning, match="native TSV reader unavailable"):
        first = readers.load_expression(path)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        second = readers.load_expression(path)
    assert first.parser == second.parser == "python"
    _assert_same(first, *jax_native.read_expression(path))


def test_python_parser_when_asked(tmp_path, monkeypatch):
    path = write_synthetic_tsv(GOLDEN, str(tmp_path))["expression"]

    def untouched(p):
        raise AssertionError("the native reader was called")

    monkeypatch.setattr(tsv_bindings, "read_expression", untouched)
    assert readers.load_expression(path, use_native=False).parser == "python"


# ---------------------------------------------------------------------------
# The network reader
# ---------------------------------------------------------------------------

def _assert_same_network(native, python, jax):
    assert native.names == python.names
    for a, b in ((native.src, python.src), (native.dst, python.dst)):
        assert a.dtype == b.dtype == np.int32 and a.tobytes() == b.tobytes()
    assert native.edges == jax.edges
    assert native.genes == jax.genes


@pytest.mark.parametrize("spec", [GOLDEN, SCALES["medium"]],
                         ids=["golden", "medium"])
def test_native_network_reader_matches_python_and_reference(spec, tmp_path):
    path = write_synthetic_tsv(spec, str(tmp_path))["network"]
    native = readers.load_network(path)
    python = readers.load_network(path, use_native=False)
    assert (native.parser, python.parser) == ("native", "python")
    _assert_same_network(native, python, jreaders.load_network(path))


@pytest.mark.parametrize("body,parser", [
    (b"src\tdest\r\nA\tB\r\nB\tC\r\n", "native"),
    (b"\n \n\t\nsrc\tdest\n\nA\tB\n \t\nC\tA\n\n\n", "native"),
    (b"src\tdest\tw\nA\tB\t0.5\tx\nB\tA\t1\n", "native"),
    (b"src\tdest\n\tB\nB\t\tz\n\t\tq\n", "native"),
    (b"src\tdest \nA\tB  \t\nB\tC\x0b\x0c\x1f\nC \t D \n", "native"),
    (b"src\tdest\nA\tB\nB\tA", "native"),
    (b"src\tdest\n", "native"),
    ("src\tdest\nG\u00c9NE\tB\n\u03b2\tC\u00e9x\n".encode(), "native"),
    ("src\tdest\nA\t\u03b2\n".encode(), "python"),
    (b"src\tdest\rA\tB\rB\tC\n", "python"),
    ("src\tdest\nA\tB\u00a0\nC\tD\u3000 \n".encode(), "python"),
    ("\u2028\nsrc\tdest\nA\tB\n".encode(), "python"),
], ids=["crlf", "blank-lines", "extra-columns", "empty-name",
        "trailing-whitespace", "no-final-newline", "header-only",
        "non-ascii-names", "non-ascii-line-end", "bare-cr",
        "unicode-whitespace",
        "unicode-blank-line"])
def test_network_edge_cases(tmp_path, body, parser):
    path = tmp_path / "net.txt"
    path.write_bytes(body)
    native = readers.load_network(str(path))
    assert native.parser == parser
    _assert_same_network(native, readers.load_network(str(path), False),
                         jreaders.load_network(str(path)))


@pytest.mark.parametrize("body", [
    b"src\tdest\nA\tB\nC\n",
    b"\n\nsrc\tdest\n\nA\tB\n\nC \t\nD\tE\n",
    b"",
    b"\n \r\n\t\n",
    b"src\tdest\nA\xff\tB\n",
    b"src\tdest\nA\xed\xa0\x80\tB\n",
    b"src\tdest\nA\tB\xc3\n",
], ids=["short-row", "short-row-after-blanks", "empty", "blank-only",
        "invalid-byte", "surrogate", "truncated-sequence"])
def test_malformed_networks_raise_the_python_readers_error(tmp_path, body):
    path = str(tmp_path / "bad.txt")
    with open(path, "wb") as f:
        f.write(body)
    errors = []
    for read in (readers.load_network,
                 lambda p: readers.load_network(p, use_native=False),
                 jreaders.load_network):
        with pytest.raises(ValueError) as err:
            read(path)
        errors.append((type(err.value), str(err.value)))
    assert errors[0] == errors[1] == errors[2]
    assert path in errors[0][1] or errors[0][0] is UnicodeDecodeError


@pytest.mark.parametrize("use_native", [True, False])
def test_forbid_full_network_raises_before_any_parse(tmp_path, monkeypatch,
                                                     use_native):
    path = write_synthetic_tsv(GOLDEN, str(tmp_path))["network"]

    def untouched(*a):
        raise AssertionError("the native reader was called")

    monkeypatch.setattr(tsv_bindings, "read_network", untouched)
    monkeypatch.setattr(readers, "_read_tsv_lines", untouched)
    monkeypatch.setenv(readers.FORBID_FULL_NETWORK_ENV, "1")
    with pytest.raises(RuntimeError, match=readers.FORBID_FULL_NETWORK_ENV):
        readers.load_network(path, use_native=use_native)


def test_unloadable_library_warns_once_for_both_readers(tmp_path,
                                                        monkeypatch):
    files = write_synthetic_tsv(GOLDEN, str(tmp_path))

    def unavailable(*a):
        raise RuntimeError("build failed: g++ not found")

    monkeypatch.setattr(tsv_bindings, "read_network", unavailable)
    monkeypatch.setattr(tsv_bindings, "read_expression", unavailable)
    monkeypatch.setattr(readers, "_warned_native", False)
    with pytest.warns(RuntimeWarning, match="native TSV reader unavailable"):
        first = readers.load_network(files["network"])
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        second = readers.load_network(files["network"])
        expression = readers.load_expression(files["expression"])
    assert first.parser == second.parser == expression.parser == "python"
    _assert_same_network(first, second,
                         jreaders.load_network(files["network"]))


def test_python_network_parser_when_asked(tmp_path, monkeypatch):
    path = write_synthetic_tsv(GOLDEN, str(tmp_path))["network"]

    def untouched(*a):
        raise AssertionError("the native reader was called")

    monkeypatch.setattr(tsv_bindings, "read_network", untouched)
    assert readers.load_network(path, use_native=False).parser == "python"


@pytest.mark.parametrize("spec", [GOLDEN, SCALES["medium"]],
                         ids=["golden", "medium"])
def test_preprocess_is_the_same_from_either_parser(spec, tmp_path):
    files = write_synthetic_tsv(spec, str(tmp_path))
    clinical = readers.load_clinical(files["clinical"])
    got = []
    for use_native in (True, False):
        got.append(preprocess_inputs(
            readers.load_expression(files["expression"], use_native=False),
            clinical, readers.load_network(files["network"], use_native)))
    jdata = jreaders.load_expression(files["expression"], use_native=False)
    jdata.label = jprep.match_labels(clinical, jdata.sample)
    network = jreaders.load_network(files["network"])
    common = jprep.find_common_genes(network.genes, jdata.gene)
    network = jprep.restrict_network(network, common)
    jdata = jprep.restrict_data(jdata, common)
    want = (jdata, *jprep.edges_to_indices(network,
                                          jprep.make_gene2idx(jdata.gene)))
    for data, src, dst in got:
        assert data.gene.tolist() == want[0].gene.tolist()
        assert data.expr.tobytes() == want[0].expr.tobytes()
        assert data.label.tobytes() == want[0].label.tobytes()
        for a, b in ((src, want[1]), (dst, want[2])):
            assert a.dtype == np.int32 and a.tobytes() == b.tobytes()
