"""Fixed-point text of the benchmark's TSVs and of the G2Vec output files.

Both the generator (writing the inputs) and the reference (formatting the
program's values to compare with the files it wrote) use it. ``%.6f`` of
a float is the value rounded half-even to six decimals; with the value
given as signed micro-units that is integer arithmetic, done here for a
whole matrix in numpy.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def micro_units(v: np.ndarray):
    """float32 (or float64 holding a float32) values -> (negative mask,
    |v| rounded half-even to micro-units as int64). Exact for float32:
    ``float64(|v|) * 1e6`` needs 24 + 20 mantissa bits."""
    v64 = np.asarray(v, dtype=np.float64)
    if not np.isfinite(v64).all():
        raise ValueError("non-finite value in a fixed-point table")
    return np.signbit(v64), np.rint(np.abs(v64) * 1e6).astype(np.int64)


def fixed6_lines(names: Sequence[str], negative: np.ndarray,
                 micro: np.ndarray) -> bytes:
    """``name + "\\t%.6f" * cols + "\\n"`` for every row, from the sign
    mask and the micro-unit magnitudes of a [rows, cols] table."""
    rows, cols = micro.shape
    ip, fp = np.divmod(micro, 10 ** 6)
    n_int = max(1, len(str(int(ip.max(initial=0)))))
    width = 1 + 1 + n_int + 1 + 6          # tab, sign, digits, point, frac
    cell = np.zeros((rows, cols, width), np.uint8)
    keep = np.ones((rows, cols, width), bool)
    cell[..., 0] = ord("\t")
    cell[..., 1] = ord("-")
    keep[..., 1] = negative
    for d in range(n_int):
        place = 10 ** (n_int - 1 - d)
        cell[..., 2 + d] = 48 + (ip // place) % 10
        # Leading zeros are dropped; the units digit always stays.
        keep[..., 2 + d] = (ip >= place) | (d == n_int - 1)
    cell[..., 2 + n_int] = ord(".")
    for d in range(6):
        cell[..., 3 + n_int + d] = 48 + (fp // 10 ** (5 - d)) % 10
    name_b = np.array([n.encode("ascii") for n in names], dtype=bytes)
    nw = max(name_b.dtype.itemsize, 1)
    names_u8 = np.zeros((rows, nw), np.uint8)
    names_u8[:] = name_b.view(np.uint8).reshape(rows, nw)
    line = np.concatenate([names_u8, cell.reshape(rows, cols * width),
                           np.full((rows, 1), ord("\n"), np.uint8)], axis=1)
    mask = np.concatenate([names_u8 != 0, keep.reshape(rows, cols * width),
                           np.ones((rows, 1), bool)], axis=1)
    return line[mask].tobytes()


def vectors_text(genes: Sequence[str], w: np.ndarray) -> bytes:
    """The ``<NAME>_vectors.txt`` bytes of float32 embeddings ``w``."""
    head = "GeneSymbol" + "".join("\tV%d" % i for i in range(w.shape[1]))
    neg, micro = micro_units(np.asarray(w, dtype=np.float32))
    return (head + "\n").encode() + fixed6_lines(genes, neg, micro)


def lgroups_text(genes: Sequence[str], lgroups: np.ndarray) -> bytes:
    """The ``<NAME>_lgroups.txt`` bytes."""
    body = "".join("%s\t%d\n" % (g, int(x)) for g, x in zip(genes, lgroups))
    return ("GeneSymbol\tLgroup(0:good,1:poor,2:other)\n" + body).encode()


def biomarkers_text(biomarkers: Sequence[str]) -> bytes:
    """The ``<NAME>_biomarkers.txt`` bytes."""
    return ("GeneSymbol\n" + "".join(g + "\n" for g in biomarkers)).encode()
