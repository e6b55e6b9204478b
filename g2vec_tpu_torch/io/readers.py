"""L1 — TSV readers (the Python parsers of ``g2vec_tpu/io/readers.py``).

File contracts (ref: G2Vec.py:436-503): whole-file read, ``rstrip()`` per
line (so trailing whitespace / CRLF files work), split on tabs, header row
skipped.

- Expression (ref: G2Vec.py:478-503): header = ``PATIENT\\t<sample ids...>``;
  each body row = ``gene\\tfloat...``; the matrix is stored gene-major in
  the file and transposed to samples x genes in memory.
- Clinical (ref: G2Vec.py:436-453): header + ``sample\\tint_label`` rows;
  label 0 = good prognosis, 1 = poor prognosis.
- Network (ref: G2Vec.py:455-476): header ``src\\tdest`` + one directed
  edge per row; edges keep file order and direction; the gene set is the
  set of all endpoints.

Malformed input raises ``ValueError`` naming the file and line. The
expression matrix is parsed by the port's C++ reader
(:mod:`g2vec_tpu_torch.native.tsv_bindings`) unless the caller asks for
the Python parser; when that library cannot be built or loaded, the reader
warns once and parses in Python (``g2vec_tpu/io/readers.py:69-86``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class ExpressionData:
    """samples x genes float32 matrix plus axis labels.

    ``expr[i, j]`` is the expression of ``gene[j]`` in ``sample[i]``.
    ``label`` is attached later by preprocess.match_labels.
    """

    sample: np.ndarray  # [n_samples] str
    gene: np.ndarray    # [n_genes] str
    expr: np.ndarray    # [n_samples, n_genes] float32
    label: np.ndarray | None = None  # [n_samples] int32, set by match_labels
    parser: str = "python"           # which parser read the file: native|python


@dataclasses.dataclass
class NetworkData:
    """Directed edge list (file order preserved) + endpoint gene set."""

    edges: List[Tuple[str, str]]
    genes: set


def _read_tsv_lines(path: str) -> List[List[str]]:
    with open(path) as fin:
        lines = fin.readlines()
    rows = [line.rstrip().split("\t") for line in lines]
    # Tolerate trailing blank lines (rstrip -> [''])
    return [r for r in rows if r != [""]]


_warned_native = False


def load_expression(path: str, use_native: bool = True) -> ExpressionData:
    """Read a gene-expression TSV (ref: G2Vec.py:478-503 contract).

    With ``use_native`` the C++ parser reads it. Its parse errors
    (``ValueError``) propagate: a malformed file is malformed in either
    language. When the library cannot be built or loaded, a
    ``RuntimeWarning`` says so once per process and the Python parser
    reads the file.
    """
    if use_native:
        from g2vec_tpu_torch.native import tsv_bindings

        try:
            sample, gene, expr = tsv_bindings.read_expression(path)
        except (RuntimeError, OSError) as e:
            global _warned_native
            if not _warned_native:
                _warned_native = True
                warnings.warn(f"native TSV reader unavailable ({e!r}); "
                              "using the Python parser", RuntimeWarning)
        else:
            return ExpressionData(sample=sample, gene=gene, expr=expr,
                                  parser="native")
    rows = _read_tsv_lines(path)
    if len(rows) < 2:
        raise ValueError(f"{path}: expression file needs a header and at least one gene row")
    sample = np.array(rows[0][1:])
    n_samples = len(sample)
    genes: List[str] = []
    values: List[List[str]] = []
    for ln, row in enumerate(rows[1:], start=2):
        if len(row) - 1 != n_samples:
            raise ValueError(
                f"{path}:{ln}: gene {row[0]!r} has {len(row) - 1} values, "
                f"expected {n_samples} (one per sample in the header)")
        genes.append(row[0])
        values.append(row[1:])
    gene = np.array(genes)
    try:
        expr = np.array(values, dtype=np.float32).T  # gene-major file -> samples x genes
    except ValueError as e:
        raise ValueError(f"{path}: non-numeric expression value ({e})") from e
    return ExpressionData(sample=sample, gene=gene, expr=expr)


def load_clinical(path: str) -> Dict[str, int]:
    """Read clinical labels (ref: G2Vec.py:436-453 contract)."""
    rows = _read_tsv_lines(path)
    if len(rows) < 2:
        raise ValueError(f"{path}: clinical file needs a header and at least one row")
    result: Dict[str, int] = {}
    for ln, row in enumerate(rows[1:], start=2):
        if len(row) < 2:
            raise ValueError(f"{path}:{ln}: expected 'sample\\tlabel', got {row!r}")
        try:
            label = int(row[1])
        except ValueError as e:
            raise ValueError(f"{path}:{ln}: label must be an integer, got {row[1]!r}") from e
        if label not in (0, 1):
            raise ValueError(f"{path}:{ln}: label must be 0 (good) or 1 (poor), got {label}")
        if row[0] in result and result[row[0]] != label:
            raise ValueError(
                f"{path}:{ln}: sample {row[0]!r} appears twice with conflicting labels")
        result[row[0]] = label
    return result


def load_network(path: str) -> NetworkData:
    """Read a directed gene-interaction edge list (ref: G2Vec.py:455-476 contract)."""
    rows = _read_tsv_lines(path)
    if len(rows) < 1:
        raise ValueError(f"{path}: network file needs a header row")
    edges: List[Tuple[str, str]] = []
    genes: set = set()
    for ln, row in enumerate(rows[1:], start=2):
        if len(row) < 2:
            raise ValueError(f"{path}:{ln}: expected 'src\\tdest', got {row!r}")
        edges.append((row[0], row[1]))
        genes.add(row[0])
        genes.add(row[1])
    return NetworkData(edges=edges, genes=genes)
