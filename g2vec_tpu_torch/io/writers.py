"""L6 — output writers, byte-identical to the reference formats.

- ``<NAME>_biomarkers.txt`` (ref: G2Vec.py:127-131): header ``GeneSymbol``
  then one gene symbol per line.
- ``<NAME>_lgroups.txt`` (ref: G2Vec.py:159-165): header
  ``GeneSymbol\\tLgroup(0:good,1:poor,2:other)`` then ``gene\\t<int>`` for
  ALL genes in global (sorted-intersection) order.
- ``<NAME>_vectors.txt`` (ref: G2Vec.py:203-215): header
  ``GeneSymbol\\tV0...V{h-1}`` then ``gene`` + ``\\t%.6f`` per dim for ALL
  genes.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def write_biomarkers(result_name: str, biomarkers: Sequence[str]) -> str:
    path = result_name + "_biomarkers.txt"
    with open(path, "w") as fout:
        fout.write("GeneSymbol\n")
        for gene in biomarkers:
            fout.write("%s\n" % gene)
    return path


def write_lgroups(result_name: str, lgroup_idx: np.ndarray,
                  genes: Sequence[str]) -> str:
    if len(genes) != len(lgroup_idx):
        raise ValueError(f"write_lgroups: {len(genes)} genes vs "
                         f"{len(lgroup_idx)} L-group indices")
    path = result_name + "_lgroups.txt"
    with open(path, "w") as fout:
        fout.write("GeneSymbol\tLgroup(0:good,1:poor,2:other)\n")
        for gene, group in zip(genes, lgroup_idx):
            fout.write("%s\t%d\n" % (gene, group))
    return path


def write_vectors(result_name: str, vectors: np.ndarray,
                  genes: Sequence[str]) -> str:
    path = result_name + "_vectors.txt"
    vectors = np.asarray(vectors, dtype=np.float32)
    if len(genes) != vectors.shape[0]:
        raise ValueError(f"write_vectors: {len(genes)} genes vs "
                         f"{vectors.shape[0]} embedding rows")
    with open(path, "w") as fout:
        fout.write("GeneSymbol")
        for i in range(vectors.shape[1]):
            fout.write("\tV%d" % i)
        fout.write("\n")
        for gene, vector in zip(genes, vectors):
            fout.write(gene)
            for val in vector:
                fout.write("\t%.6f" % val)
            fout.write("\n")
    return path
