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
  set of all endpoints. :class:`NetworkData` holds the edges as two id
  arrays into the endpoint names, which either parser interns in
  first-seen order.

Under ``--edge-partition`` the edge list never exists whole on a rank
(``g2vec_tpu/io/readers.py:135-290``): :func:`scan_network_genes` streams
the endpoint names (O(G) strings, which the sorted common-gene list
needs) and :func:`load_network_range` streams the edges again, keeping
those whose source index lies in the rank's range. Both read the plain
network file and the pre-partitioned layout that
``make_synth_graph --partitions R`` writes (part files, a genes file and
a manifest of sha256s, checked before a part is read). With
:data:`FORBID_FULL_NETWORK_ENV` set, :func:`load_network` raises: the pin
that such a run never reads the whole list.

Malformed input raises ``ValueError`` naming the file and line. The
expression matrix and the network are parsed by the port's C++ readers
(:mod:`g2vec_tpu_torch.native.tsv_bindings`) unless the caller asks for
the Python parser (the network's hands the files it cannot show it reads
alike to the Python parser); when that library cannot be built or loaded,
the reader warns once and parses in Python
(``g2vec_tpu/io/readers.py:69-86``).
"""
from __future__ import annotations

import codecs
import dataclasses
import json
import locale
import os
import threading
import warnings
from typing import Dict, Iterable, List, Tuple

import numpy as np

#: When set, :func:`load_network` refuses to run: an ``--edge-partition``
#: run must never read the whole edge list (the tests and the chip smoke
#: set it in every rank's environment).
FORBID_FULL_NETWORK_ENV = "G2VEC_FORBID_FULL_NETWORK"


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
    """Directed edge list, file order preserved, endpoints interned: edge
    ``i`` runs ``names[src[i]] -> names[dst[i]]``; ``names`` holds each
    endpoint once, in first-seen order (source before dest in a row)."""

    names: List[str]
    src: np.ndarray   # [n_edges] int32 ids into names
    dst: np.ndarray   # [n_edges] int32
    parser: str = "python"  # which parser read the file: native|python

    @classmethod
    def from_edges(cls, edges: Iterable[Tuple[str, str]]) -> "NetworkData":
        """Intern an edge list of (source, dest) names."""
        ids: Dict[str, int] = {}
        ends = [ids.setdefault(g, len(ids)) for edge in edges for g in edge]
        ends = np.array(ends, dtype=np.int32).reshape(-1, 2)
        return cls(names=list(ids), src=np.ascontiguousarray(ends[:, 0]),
                   dst=np.ascontiguousarray(ends[:, 1]))

    @property
    def genes(self) -> frozenset:
        """The endpoint gene set."""
        return frozenset(self.names)

    @property
    def edges(self) -> List[Tuple[str, str]]:
        """The (source, dest) name pairs, in file order."""
        names = self.names
        return [(names[s], names[d])
                for s, d in zip(self.src.tolist(), self.dst.tolist())]


def _read_tsv_lines(path: str) -> List[List[str]]:
    with open(path) as fin:
        lines = fin.readlines()
    rows = [line.rstrip().split("\t") for line in lines]
    # Tolerate trailing blank lines (rstrip -> [''])
    return [r for r in rows if r != [""]]


_warned_native = False  # guarded-by: _warn_lock
_warn_lock = threading.Lock()


def _native_unavailable(e: Exception) -> None:
    """Warn, once per process, that the C++ parsers' library cannot be
    built or loaded; the caller parses in Python. The two readers may
    call it at once (the expression's on a scheduler thread)."""
    global _warned_native
    with _warn_lock:
        if _warned_native:
            return
        _warned_native = True
    warnings.warn(f"native TSV reader unavailable ({e!r}); "
                  "using the Python parser", RuntimeWarning)


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
            _native_unavailable(e)
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


def load_network(path: str, use_native: bool = True) -> NetworkData:
    """Read a directed gene-interaction edge list (ref: G2Vec.py:455-476
    contract).

    With ``use_native`` the C++ parser reads it where it can show that
    its answer is the Python reader's; on any other file (``native/
    tsv_reader.cpp`` lists them), a malformed one included, the Python
    reader reads the whole file and raises its own errors. When the
    library cannot be built or loaded, a ``RuntimeWarning`` says so once
    per process (:func:`load_expression`'s) and the Python parser reads
    the file.
    """
    if os.environ.get(FORBID_FULL_NETWORK_ENV):
        raise RuntimeError(
            f"load_network({path!r}) reached with {FORBID_FULL_NETWORK_ENV} "
            "set — an --edge-partition run tried to materialize the full "
            "edge list; use scan_network_genes + load_network_range")
    if use_native:
        from g2vec_tpu_torch.native import tsv_bindings

        utf8 = codecs.lookup(locale.getpreferredencoding(False)).name == "utf-8"
        try:
            parsed = tsv_bindings.read_network(path, utf8)
        except (RuntimeError, OSError) as e:
            _native_unavailable(e)
        else:
            if parsed is not None:
                names, src, dst = parsed
                return NetworkData(names=names, src=src, dst=dst,
                                   parser="native")
    rows = _read_tsv_lines(path)
    if len(rows) < 1:
        raise ValueError(f"{path}: network file needs a header row")

    def edges():
        for ln, row in enumerate(rows[1:], start=2):
            if len(row) < 2:
                raise ValueError(
                    f"{path}:{ln}: expected 'src\\tdest', got {row!r}")
            yield row[0], row[1]

    return NetworkData.from_edges(edges())


# ---------------------------------------------------------------------------
# Range-filtered reads (--edge-partition)
# ---------------------------------------------------------------------------

def _iter_network_rows(path: str):
    """Stream (lineno, src, dst) from a network TSV without holding the
    file; the tolerance (rstrip, blank lines) of :func:`load_network`."""
    with open(path) as fin:
        header = fin.readline()
        if not header:
            raise ValueError(f"{path}: network file needs a header row")
        for ln, line in enumerate(fin, start=2):
            row = line.rstrip().split("\t")
            if row == [""]:
                continue
            if len(row) < 2:
                raise ValueError(
                    f"{path}:{ln}: expected 'src\\tdest', got {row!r}")
            yield ln, row[0], row[1]


def scan_network_genes(path: str) -> set:
    """The endpoint gene set of a network TSV, streamed (the edges are
    dropped as they are read), or of a partition manifest (its genes
    file): ``load_network(path).genes`` without the edge list."""
    if path.endswith(".json"):
        manifest = read_partition_manifest(path)
        base = os.path.dirname(os.path.abspath(path))
        with open(os.path.join(base, manifest["genes_file"])) as f:
            return {line.rstrip("\n") for line in f if line.rstrip("\n")}
    genes: set = set()
    for _, a, b in _iter_network_rows(path):
        genes.add(a)
        genes.add(b)
    return genes


def load_network_range(path: str, gene2idx: Dict[str, int], lo: int,
                       hi: int) -> Tuple[np.ndarray, np.ndarray]:
    """Streamed ``restrict_network`` + ``edges_to_indices`` + a source
    range filter in one pass: (src, dst) int32 arrays of the directed
    edges whose ends are both in ``gene2idx`` and whose source index lies
    in [lo, hi), in file order.

    The order contract: dropping the edges whose source lies outside the
    range commutes with the |PCC| threshold's first-occurrence dedup (its
    key holds the source) and with ``edges_to_csr``'s stable sort by
    source (a row's order is the file order of its source's edges, all
    in this range), so the owned rows of the partitioned CSR are the
    bytes of the same rows of the whole CSR.
    """
    if path.endswith(".json"):
        return _load_partitioned_range(path, gene2idx, lo, hi)
    src: List[int] = []
    dst: List[int] = []
    for _, a, b in _iter_network_rows(path):
        si = gene2idx.get(a)
        if si is None or not (lo <= si < hi):
            continue
        di = gene2idx.get(b)
        if di is None:
            continue
        src.append(si)
        dst.append(di)
    return (np.array(src, dtype=np.int32), np.array(dst, dtype=np.int32))


def read_partition_manifest(path: str) -> dict:
    """Load a ``--partitions`` manifest (written by
    :func:`~g2vec_tpu_torch.data.synth.write_synth_graph_streamed`) and
    check its schema."""
    with open(path) as f:
        manifest = json.load(f)
    for key in ("format", "partitions", "genes_file", "files"):
        if key not in manifest:
            raise ValueError(f"{path}: partition manifest missing {key!r}")
    if manifest["format"] != "g2vec-network-partitions-v1":
        raise ValueError(
            f"{path}: unknown partition manifest format "
            f"{manifest['format']!r}")
    if len(manifest["files"]) != manifest["partitions"]:
        raise ValueError(
            f"{path}: manifest lists {len(manifest['files'])} files for "
            f"{manifest['partitions']} partitions")
    for entry in manifest["files"]:
        for key in ("name", "sha256", "n_edges", "gene_lo", "gene_hi"):
            if key not in entry:
                raise ValueError(
                    f"{path}: manifest file entry missing {key!r}")
    return manifest


def _load_partitioned_range(manifest_path: str, gene2idx: Dict[str, int],
                            lo: int, hi: int
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`load_network_range` over the part files: only the parts
    whose source-name range meets the requested one are opened (an index
    range of the sorted common genes is a contiguous name range), and
    each one's sha256 is checked against the manifest before it is
    read."""
    from g2vec_tpu_torch.utils.integrity import sha256_file

    manifest = read_partition_manifest(manifest_path)
    base = os.path.dirname(os.path.abspath(manifest_path))
    if hi <= lo:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    by_idx = sorted(gene2idx, key=gene2idx.get)
    name_lo, name_hi = by_idx[lo], by_idx[hi - 1]
    src_parts: List[np.ndarray] = []
    dst_parts: List[np.ndarray] = []
    for entry in manifest["files"]:
        # A part holds the sources named in [gene_lo, gene_hi].
        if entry["gene_hi"] < name_lo or entry["gene_lo"] > name_hi:
            continue
        part = os.path.join(base, entry["name"])
        digest = sha256_file(part)
        if digest != entry["sha256"]:
            raise ValueError(
                f"{part}: sha256 mismatch vs manifest ({digest} != "
                f"{entry['sha256']}) — partition file corrupt or stale")
        s, d = load_network_range(part, gene2idx, lo, hi)
        src_parts.append(s)
        dst_parts.append(d)
    if not src_parts:
        return (np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32))
    return np.concatenate(src_parts), np.concatenate(dst_parts)
