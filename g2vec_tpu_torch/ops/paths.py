"""Stage-3 path-set integration and gene votes (host numpy).

``integrate_path_sets``/``count_gene_freq`` of ``g2vec_tpu/ops/walker.py``
in their packed form: paths stay bit-packed (np.packbits rows) from the
walker into the trainer, and the dense [N, G] matrix is never built whole.
"""
from __future__ import annotations

from typing import Dict, Sequence, Set, Tuple

import numpy as np


def _packed_rows(packed: Set[bytes], n_genes: int) -> np.ndarray:
    """Set of packed rows -> [N, ceil(G/8)] uint8 (sorted for determinism)."""
    nb = (n_genes + 7) // 8
    if not packed:
        return np.zeros((0, nb), dtype=np.uint8)
    rows = np.frombuffer(b"".join(sorted(packed)), dtype=np.uint8)
    return rows.reshape(len(packed), nb)


def integrate_path_sets(path_set_good: Set[bytes], path_set_poor: Set[bytes],
                        n_genes: int) -> Tuple[np.ndarray, np.ndarray]:
    """Drop paths common to both groups; return (packed rows, labels).

    Reference: integrate_pathSet (G2Vec.py:310-322) — a path gene-set in
    BOTH groups' sets carries no prognosis signal and is removed from both;
    survivors get their group index as the label. Row order: good block
    then poor block, each sorted by packed bytes.
    """
    common = path_set_good & path_set_poor
    good = _packed_rows(path_set_good - common, n_genes)
    poor = _packed_rows(path_set_poor - common, n_genes)
    paths = np.concatenate([good, poor], axis=0)
    labels = np.concatenate([
        np.zeros(good.shape[0], dtype=np.int32),
        np.ones(poor.shape[0], dtype=np.int32)])
    return paths, labels


def count_gene_freq(paths: np.ndarray, labels: np.ndarray,
                    genes: Sequence[str]) -> Dict[str, int]:
    """Per-gene majority vote over the integrated (packed) path set.

    Reference: count_geneFreq (G2Vec.py:288-308) — for each gene in at
    least one path, count good vs poor paths containing it; majority ->
    0/1, tie -> 2. Genes in no path are absent (callers default them to 2,
    ref: G2Vec.py:172). Rows are expanded in bounded chunks.
    """
    n_genes = len(genes)
    if paths.shape[1] != (n_genes + 7) // 8:
        raise ValueError(
            f"packed paths width {paths.shape[1]} inconsistent with "
            f"{n_genes} genes (expected {(n_genes + 7) // 8})")

    def colsum(block):
        total = np.zeros(n_genes, dtype=np.int64)
        for lo in range(0, block.shape[0], 4096):
            rows = np.unpackbits(block[lo:lo + 4096], axis=1)[:, :n_genes]
            total += rows.sum(axis=0, dtype=np.int64)
        return total

    good_counts = colsum(paths[labels == 0])
    poor_counts = colsum(paths[labels == 1])
    result: Dict[str, int] = {}
    for i, g in enumerate(genes):
        fg, fp = int(good_counts[i]), int(poor_counts[i])
        if fg == 0 and fp == 0:
            continue
        result[g] = 0 if fg > fp else (1 if fg < fp else 2)
    return result
