"""The port's C++ expression reader against the JAX package's.

- On the golden spec (tests/test_golden_e2e.py's) and the ``medium``
  scale, the port's native reader gives arrays byte-equal to
  ``g2vec_tpu.native.bindings.read_expression``'s and to the port's
  Python reader's, CRLF line ends and trailing blank lines included.
- Malformed files raise ``ValueError`` naming ``file:line``.
- A library that cannot be built or loaded warns once and falls back to
  the Python parser; ``use_native=False`` never touches the library.
"""
import warnings

import numpy as np
import pytest

from g2vec_tpu.native import bindings as jax_native
from g2vec_tpu_torch.data.synthetic import (SCALES, SyntheticSpec,
                                            write_synthetic_tsv)
from g2vec_tpu_torch.io import readers
from g2vec_tpu_torch.native import tsv_bindings

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
